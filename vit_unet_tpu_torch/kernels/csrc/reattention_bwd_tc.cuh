// Training backward of flash re-attention on the tensor cores: the bfloat16
// route of vit_train_bwd (flash_reattention_train.cu, route 1) at the
// (heads, dh) classes train_bwd_tc instantiates: the levels of base and
// large (8 heads, dh 24, 96, 384), lite's (4 heads, dh 12, 48, 192) and the
// classifier's 16-head levels (16, 12) and (16, 48); and its float32 route
// (route 4) at lite's classes, train_bwd_tc_f32 (below).
// The keras attention's identity-mix calls at (8, 192) take
// attention_identity_bwd.cuh.
//
// Replaces the Pallas TPU kernel vit_unet_tpu/kernels/flash_reattention_train.py
// ::_bwd (pallas_call body _bwd_dkv_kernel) there.  With A_h = P_h * mask_h:
//
//   S_h   = Q_h K_h^T,  P_h = exp(S_h - lse_h) on valid keys,  T_h1 = g_h1 V_h1^T
//   dA_h2 = sum_h1 M[h1,h2] T_h1  (+ kappa_h2 + sum_h3 G[h3,h2] A_h3, exact BN)
//   dS_h  = P_h * (dA_h * mask_h - D_h),  B_h1 = sum_h2 M[h1,h2] A_h2
//   dq_h += dS_h K_h,  dk_h += dS_h^T Q_h,  dv_h1 += B_h1^T g_h1
//
// Each piece is done once per map entry and head: one score product, one
// depth-dh product g_h1 V_h1^T, one H x H mix for dA and one for B, the BN
// term from the tiles in hand.  (The CUDA-core kernels take dA over all
// H * dh columns once per head, and recompute the scores of every head for
// dv and for the BN term.)
//
// Design.  A block of 8 warps owns BKEY keys of one image and all heads and
// loops over the queries in tiles of BQ rows.  K and V of its keys stay in
// shared memory; warp w keeps dk and dv of head w in f32 registers; dq goes
// out through f32 atomicAdd into the zeroed dq, so its last bits vary from
// run to run.  Per q tile:
//   1. q and g rows of all heads by cp.async (zero-filled past Nq); lse, D,
//      and the tile's dropout bits (below);
//   2. per sub-tile of 16 queries x 8 keys, one warp for all heads: S and T
//      by mma.sync m16n8k16 (bf16 in, f32 accumulate, fragments by
//      ldmatrix), then P, the dA mix, dS and the B mix in f32 registers; dS
//      and B go to shared memory as bf16 pairs hi + lo;
//   3. warp w, head w: dk += dS^T q and dv += B^T g (the transposed A
//      operands by ldmatrix.trans), dq = dS K, then the atomics; each of
//      those products is taken on hi and on lo.
//
// Why hi + lo.  Rounding dS and B to bf16 once, as the TPU kernel does
// (ds.astype, the fused form's A.astype), puts the gradients more than 1e-3
// off the f32 plain version (max|err| / max|plain|), the tolerance the port
// holds its f32 gradients to.  hi = bf16(x), lo = bf16(x - hi) carry 16
// significant bits (under 1e-4), for twice the MMAs of those three
// products; no operand goes through TF32.  tests/test_torch_train_route.py
// emulates both on the CPU.
//
// Dropout bits.  A Philox call gives the bits of keys c + 16 j (j < 4) of a
// 64-key window for one (b, h, row), c < 16 (reattention_common.cuh).  Step
// 1 calls it once per (head, row, c) of the tile and keeps all four words'
// keep bits in a byte, mb[h][row][c], so a 64-key tile uses every word and a
// 16-key tile one in four.  The bits are those of keep_scales and of the
// plain version's dropout_mask.
//
// What bounds it.  Per q tile a block passes three barriers; the products
// are small (dh 24: KS 2 k-steps; dh 96: 6), so the exp, the two H x H
// mixes, the shared-memory round trip of dS and B and the dq atomics
// weigh as much as the MMAs.  Shared memory and registers per class are in
// train_bwd_tc; one block an SM.  At 16 heads the same steps run with P and
// T staged through shared memory (staged_kernel, below).
//
// 4 heads (lite's levels).  Steps 1-2 are the same, over 4 heads (a
// sub-tile's S and T of all heads, 32 f32 a thread, stay in registers).
// Step 3 takes two warps a head: warp 2h keeps dv_h = B_h^T g_h, warp
// 2h + 1 dk_h = dS_h^T q_h, each a block's BKEY keys x dh in f32 registers,
// and each forms dq_h for half of dh's 8-column tiles (its atomics); the B
// fragments of g, q and K are read 16 columns at a time, so a warp never
// holds a whole row of dh 192.  dh 12 is copied in 8-byte pieces and
// zero-padded to one k16 step; the padding columns of dq, dk, dv are not
// written.
//
// Float32 at lite's classes (route 4 of vit_train_bwd, Cfg::F32): the same
// kernel in split precision, as attention_identity_bwd.cuh's f32 route.
// Every f32 operand (q, K, V_cat, g) is carried as the bf16 pair hi =
// bf16(x), lo = bf16(x - hi) in shared memory, split once as it is read
// from device memory (K and V once a block, q and g once a q tile; no f32
// stage), and the products take three MMAs with f32 accumulators: T =
// g V^T (lo hi, hi lo, hi hi), and dq = dS K, dk = dS^T q, dv = B^T g
// from the pairs of dS and B (dS_hi K_hi + dS_lo K_hi + dS_hi K_lo; lo lo
// is left out).  No operand goes through TF32.  A pair holds 16 significant
// bits; the error it leaves in the scores S = q K^T reaches dS through
// P = exp(S - lse) times dA - D, and at (4, 12)'s rows of 3,136 keys it put
// dq at 1.0e-4 of max|plain| on the card, on f32's tolerance of 1e-4.  So
// where shared memory allows (Cfg::TRIPLE: (4, 12) and (4, 48)) q and K
// are carried as triples hi, mid = bf16(x - hi), lo = bf16(x - hi - mid),
// f32's 24 bits, and S takes six MMAs (lo hi, hi lo, mid mid, mid hi, hi
// mid, hi hi), which leaves about 1e-5 (tests/test_torch_train_route.py
// emulates both on the CPU); (hi, mid) is the pair the other products
// take.  At (4, 192) (rows of 196 keys) S takes the pairs' three MMAs.
// That is 15 MMAs a 16 x 8 x 16 unit of work (18 with triples) against
// the bf16 route's 8.  The tiles hold every part, so the f32 classes take
// other tiles than the bf16 ones (train_bwd_tc_f32).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "attention_identity_f32.cuh"
#include "reattention_common.cuh"
#include "reattention_mma.cuh"
#include "reattention_tiles.cuh"

namespace vit_bwd {

using vit_idf::split_store;
using vit_mma::ldsm_x2;
using vit_mma::ldsm_x2_trans;
using vit_mma::ldsm_x4;
using vit_mma::ldsm_x4_trans;
using vit_mma::mma_bf16;
using vit_tile::bf16;
using vit_tile::cp_async_commit;
using vit_tile::cp_async_wait;
using vit_tile::fast_exp2;
using vit_tile::load_rows;
using vit_tile::LOG2E;

constexpr int NW = vit_tile::NW;   // warps per block
constexpr int NT = vit_tile::NT;   // threads per block

// MINB_: blocks an SM.  F32_: float32 inputs in split precision; TRIPLE_:
// q and K as triples for the scores (above).
template <int H_, int DH_, int BKEY_, int BQ_, int MINB_ = 1, bool F32_ = false,
          bool TRIPLE_ = false>
struct Cfg {
  static constexpr int H = H_, DH = DH_, BKEY = BKEY_, BQ = BQ_, MINB = MINB_;
  static constexpr bool F32 = F32_, TRIPLE = TRIPLE_;
  using T = typename std::conditional<F32, float, bf16>::type;   // the input type
  static constexpr int HALVES = F32 ? 2 : 1;      // bf16 tiles of V and g: hi (and lo)
  static constexpr int PARTS = TRIPLE ? 3 : HALVES;   // bf16 tiles of q and K
  static constexpr int WPH = NW / H;              // warps a head in step 3: 1 or 2
  static constexpr int DP = (DH + 15) / 16 * 16;  // depth padded for the MMA
  static constexpr int KS = DP / 16;              // k16 steps over the head dim
  static constexpr int NV = (DH + 7) / 8;         // 8-column tiles of one head's dh (dh 12: 2)
  static constexpr int NVH = NV / WPH;            // dq's column tiles a warp
  static constexpr int LD = DP + 8;               // bf16 pitch of the q, g, K, V tiles
  static constexpr int LDS = BKEY + 8;            // bf16 pitch of the dS and B tiles
  static constexpr int CH = DH % 8 == 0 ? 8 : 4;  // bf16 per cp.async (16 or 8 bytes)
  static constexpr int CPR = DH / CH;             // copies per row
  static constexpr int MK = BKEY / 16;            // 16-key row tiles of dk, dv
  static constexpr int NSUB = (BQ / 16) * (BKEY / 8);  // sub-tiles of step 2
  static constexpr int KV_ELEMS = H * BKEY * LD;  // one half (hi or lo) of the K or V tile
  static constexpr int QG_ELEMS = H * BQ * LD;    // one half of the q or g tile
  static constexpr int DS_ELEMS = H * BQ * LDS;
  static constexpr int TILE_ELEMS = (PARTS + HALVES) * (KV_ELEMS + QG_ELEMS);
  static constexpr size_t BF16_BYTES = sizeof(bf16) * (TILE_ELEMS + 4 * DS_ELEMS);
  static constexpr size_t SMEM =
      BF16_BYTES + sizeof(float) * (2 * H * BQ + 2 * H * H + H) + H * BQ * 16;
  static_assert(WPH * H == NW && (WPH == 1 || (WPH == 2 && NV % 2 == 0)),
                "step 3: warp w owns head w, or warps 2h, 2h + 1 head h");
  static_assert(!F32 || WPH == 2, "the f32 classes are lite's: two warps a head");
  static_assert(F32 || !TRIPLE, "triples carry f32 operands");
  static_assert(4 * H <= 32, "a thread's keep bits of a sub-tile fit one word");
  static_assert(DH % 4 == 0 && (WPH == 2 || DH % 8 == 0) && BKEY % 16 == 0 && BQ % 16 == 0 &&
                    64 % BKEY == 0, "shape");
  static_assert(SMEM <= 232448, "shared memory of a block");
};

// Four f32 values as triples: hi, mid = bf16(x - hi), lo = bf16(x - hi -
// mid) at the same offset of three tiles, 8 bytes each.
__device__ __forceinline__ void split3_store(float4 x, bf16* hi, bf16* mid, bf16* lo) {
  uint2 h, m, l;
  float r[4] = {x.x, x.y, x.z, x.w};
  uint32_t* hw = &h.x;
  uint32_t* mw = &m.x;
  uint32_t* lw = &l.x;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    uint32_t rest;
    vit_idf::split2(r[2 * i], r[2 * i + 1], hw[i], rest);   // rest: bf16(x - hi), the mid
    const __nv_bfloat162 hh = *reinterpret_cast<const __nv_bfloat162*>(&hw[i]);
    const __nv_bfloat162 mm = *reinterpret_cast<const __nv_bfloat162*>(&rest);
    const float2 hf = __bfloat1622float2(hh), mf = __bfloat1622float2(mm);
    const __nv_bfloat162 ll = __floats2bfloat162_rn((r[2 * i] - hf.x) - mf.x,
                                                    (r[2 * i + 1] - hf.y) - mf.y);
    mw[i] = rest;
    lw[i] = *reinterpret_cast<const uint32_t*>(&ll);
  }
  *reinterpret_cast<uint2*>(hi) = h;
  *reinterpret_cast<uint2*>(mid) = m;
  *reinterpret_cast<uint2*>(lo) = l;
}

// F32: rows row0 + r (r < ROWS) of heads hl < NHEADS of f32 src (element
// hl * head_stride + row * row_stride + col) split into PARTS (2: hi, lo;
// 3: hi, mid, lo) tiles dst + i * part, [NHEADS][ROWS][C::LD], columns
// [0, dh); rows at or past n zero.  Plain 16-byte loads, a thread's issued
// GROUP at a time before their stores (more in flight would spill beside
// dh 192's dk / dv).
template <typename C, int ROWS, int NHEADS, int PARTS = 2>
__device__ __forceinline__ void split_rows(bf16* dst, int part, const float* src,
                                           int64_t head_stride, int64_t row_stride, int row0,
                                           int n, int tid) {
  constexpr int CPR = C::DH / 4, TOTAL = NHEADS * ROWS * CPR;
  constexpr int ITERS = (TOTAL + NT - 1) / NT, GROUP = ITERS < 4 ? ITERS : 4;
#pragma unroll
  for (int i0 = 0; i0 < ITERS; i0 += GROUP) {
    float4 x[GROUP];
#pragma unroll
    for (int u = 0; u < GROUP; ++u) {
      const int c = tid + NT * (i0 + u);
      const int j = c % CPR, r = (c / CPR) % ROWS, hl = c / (CPR * ROWS);
      x[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i0 + u < ITERS && c < TOTAL && row0 + r < n)
        x[u] = __ldg(reinterpret_cast<const float4*>(src + hl * head_stride +
                                                     (row0 + r) * row_stride) + j);
    }
#pragma unroll
    for (int u = 0; u < GROUP; ++u) {
      const int c = tid + NT * (i0 + u);
      if (i0 + u >= ITERS || c >= TOTAL) break;
      const int j = c % CPR, r = (c / CPR) % ROWS, hl = c / (CPR * ROWS);
      bf16* d = dst + (hl * ROWS + r) * C::LD + 4 * j;
      if constexpr (PARTS == 3)
        split3_store(x[u], d, d + part, d + 2 * part);
      else
        split_store(x[u], d, d + part);
    }
  }
}

// s (16 x 8, f32) = rows r0.. of a [H][ROWS][LD] tile times rows c0.. of a
// [H][BKEY][LD] tile, transposed, over the whole head dim, for head h.
// PARTS 2: of the pairs, their lo tiles a_lo and b_lo after the hi ones,
// three MMAs a k16 step; 3: of the triples, mid at a_lo / b_lo and lo at
// twice that, six MMAs a k16 step.
template <typename C, int ROWS, int PARTS = C::HALVES>
__device__ __forceinline__ void prod_16x8(const bf16* a, const bf16* bt, int h, int r0,
                                          int c0, int lane, float (&s)[4], int a_lo = 0,
                                          int b_lo = 0) {
  const bf16* arow = a + (h * ROWS + r0 + (lane % 8) + 8 * ((lane / 8) % 2)) * C::LD +
                     8 * (lane / 16);
  const bf16* brow = bt + (h * C::BKEY + c0 + (lane % 8)) * C::LD + 8 * ((lane / 8) % 2);
#pragma unroll
  for (int e = 0; e < 4; ++e) s[e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < C::KS; ++ks) {
    uint32_t af[4], bf[2];
    ldsm_x4(af, arow + 16 * ks);
    ldsm_x2(bf, brow + 16 * ks);
    if constexpr (PARTS == 3) {   // the 2^-16 terms first, then mid hi, hi mid, hi hi
      uint32_t am[4], bm[2], x4[4], x2[2];
      ldsm_x4(x4, arow + 2 * a_lo + 16 * ks);
      ldsm_x2(x2, brow + 2 * b_lo + 16 * ks);
      ldsm_x4(am, arow + a_lo + 16 * ks);
      ldsm_x2(bm, brow + b_lo + 16 * ks);
      vit_idf::mma6(s, af, am, x4, bf, bm, x2);
    } else if constexpr (PARTS == 2) {
      uint32_t al[4], bl[2];
      ldsm_x4(al, arow + a_lo + 16 * ks);
      ldsm_x2(bl, brow + b_lo + 16 * ks);
      vit_idf::mma3(s, af, al, bf[0], bf[1], bl[0], bl[1]);
    } else {
      mma_bf16(s, af, bf[0], bf[1]);
    }
  }
}

// B fragments of 16 rows (k) of a tile of pitch C::LD, all NV column tiles:
// f[2 nv] holds rows 0..7, f[2 nv + 1] rows 8..15 of column tile nv.
template <typename C>
__device__ __forceinline__ void ldsm_b_trans(uint32_t* f, const bf16* rows, int lane) {
  const bf16* p = rows + ((lane % 8) + 8 * ((lane / 8) % 2)) * C::LD;
#pragma unroll
  for (int j = 0; j + 4 <= 2 * C::NV; j += 4) ldsm_x4_trans(f + j, p + 8 * (j / 2) + 8 * (lane / 16));
  if constexpr (C::NV % 2 == 1) ldsm_x2_trans(f + 2 * C::NV - 2, p + 8 * (C::NV - 1));
}

// x0, x1 as bf16 pairs hi = bf16(x), lo = bf16(x - hi) at hi + off, lo + off
__device__ __forceinline__ void store_split(bf16* hi, bf16* lo, int off, float x0, float x1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  *reinterpret_cast<__nv_bfloat162*>(hi + off) = h;
  *reinterpret_cast<__nv_bfloat162*>(lo + off) = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
}

// acc (16 rows x 8 n tiles col0 / 8 ..) += a_hi b + a_lo b for the A
// fragments ah, al and B = 16 rows of a tile of pitch C::LD from `rows`
// (row lane-addressed as ldsm_b_trans takes it), columns col0 .., N tiles,
// fetched a pair of tiles at a time; F32: B a pair too, its lo tile `lo`
// after `rows`, and a_hi b_lo added as the third MMA.
template <typename C, int N>
__device__ __forceinline__ void mma_pair_cols(float (*acc)[4], const uint32_t (&ah)[4],
                                              const uint32_t (&al)[4], const bf16* rows,
                                              int col0, int lane, int lo = 0) {
  const bf16* p = rows + ((lane % 8) + 8 * ((lane / 8) % 2)) * C::LD + col0;
#pragma unroll
  for (int nv = 0; nv + 2 <= N; nv += 2) {
    uint32_t f[4];   // b0, b1 of tile nv, then of nv + 1
    ldsm_x4_trans(f, p + 8 * nv + 8 * (lane / 16));
    mma_bf16(acc[nv], ah, f[0], f[1]);
    mma_bf16(acc[nv], al, f[0], f[1]);
    mma_bf16(acc[nv + 1], ah, f[2], f[3]);
    mma_bf16(acc[nv + 1], al, f[2], f[3]);
    if constexpr (C::F32) {
      ldsm_x4_trans(f, p + lo + 8 * nv + 8 * (lane / 16));
      mma_bf16(acc[nv], ah, f[0], f[1]);
      mma_bf16(acc[nv + 1], ah, f[2], f[3]);
    }
  }
  if constexpr (N % 2 == 1) {   // the last tile alone (lanes 0-15 address it)
    uint32_t f[2];
    ldsm_x2_trans(f, p + 8 * (N - 1));
    mma_bf16(acc[N - 1], ah, f[0], f[1]);
    mma_bf16(acc[N - 1], al, f[0], f[1]);
    if constexpr (C::F32) {
      ldsm_x2_trans(f, p + lo + 8 * (N - 1));
      mma_bf16(acc[N - 1], ah, f[0], f[1]);
    }
  }
}

// Step 3 at 4 heads, warp w of a q tile: head h = w / 2; warp 2h adds
// B_h^T g_h into acc (its dv), warp 2h + 1 dS_h^T q_h (its dk); then dq_h =
// dS_h K_h over the block's keys for this warp's half of dh's column tiles,
// added into dq by atomics (the padding columns of dh 12 are skipped).
// F32: q, g and K as pairs, their lo tiles C::QG_ELEMS and C::KV_ELEMS
// after the hi ones.
template <typename C>
__device__ __forceinline__ void step3_pair(const bf16* qs, const bf16* gs, const bf16* ks,
                                           const bf16* ds_hi, const bf16* ds_lo,
                                           const bf16* b_hi, const bf16* b_lo,
                                           float (&acc)[C::MK][C::NV][4], float* dq, int b,
                                           int q0, int nq, int warp, int lane) {
  constexpr int H = C::H, DH = C::DH, BQ = C::BQ, BKEY = C::BKEY, LD = C::LD, LDS = C::LDS;
  constexpr int NV = C::NV, NVH = C::NVH;
  const int h = warp / 2, half = warp % 2;
  const int gq = lane / 4, t4 = lane % 4;
  const bf16* mhi = half ? ds_hi : b_hi;
  const bf16* mlo = half ? ds_lo : b_lo;
  const bf16* rows = half ? qs : gs;
  // A operands dS^T, B^T (keys 16 mt.., queries kq..) of the [query][key]
  // tiles, by ldmatrix.trans
  const int a_t = (lane % 8) + 8 * (lane / 16), a_c = 8 * ((lane / 8) % 2);
#pragma unroll
  for (int kq = 0; kq < BQ; kq += 16) {
#pragma unroll
    for (int mt = 0; mt < C::MK; ++mt) {
      const int off = (h * BQ + kq + a_t) * LDS + 16 * mt + a_c;
      uint32_t ah[4], al[4];
      ldsm_x4_trans(ah, mhi + off);
      ldsm_x4_trans(al, mlo + off);
      mma_pair_cols<C, NV>(acc[mt], ah, al, rows + (h * BQ + kq) * LD, 0, lane,
                           C::QG_ELEMS);
    }
  }
  // dq_h (queries mq.., column tiles half NVH ..) = dS_h K_h over the block's keys
  for (int mq = 0; mq < BQ && q0 + mq < nq; mq += 16) {
    float dacc[NVH][4];
#pragma unroll
    for (int nv = 0; nv < NVH; ++nv)
#pragma unroll
      for (int e = 0; e < 4; ++e) dacc[nv][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < BKEY; kc += 16) {
      uint32_t ah[4], al[4];
      const int off = (h * BQ + mq + (lane % 8) + 8 * ((lane / 8) % 2)) * LDS + kc +
                      8 * (lane / 16);
      ldsm_x4(ah, ds_hi + off);
      ldsm_x4(al, ds_lo + off);
      mma_pair_cols<C, NVH>(dacc, ah, al, ks + (h * BKEY + kc) * LD, 8 * NVH * half, lane,
                            C::KV_ELEMS);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + mq + gq + 8 * r;
      if (row >= nq) continue;
      float* dst = dq + (((int64_t)b * H + h) * nq + row) * DH + 8 * NVH * half + 2 * t4;
#pragma unroll
      for (int nv = 0; nv < NVH; ++nv) {
        if (DH % 8 != 0 && 8 * (NVH * half + nv) + 2 * t4 >= DH) continue;   // padding
        atomicAdd(dst + 8 * nv, dacc[nv][2 * r]);
        atomicAdd(dst + 8 * nv + 1, dacc[nv][2 * r + 1]);
      }
    }
  }
}

// Grid (key tiles of BKEY, B).  dq must be zeroed; dk and dv are written.
// q, k, v, g in C::T (F32: float32, split into pairs as they are read).
template <typename C>
__global__ void __launch_bounds__(NT, C::MINB) bwd_kernel(
    const typename C::T* __restrict__ q, const typename C::T* __restrict__ k,
    const typename C::T* __restrict__ v, const typename C::T* __restrict__ g,
    const float* __restrict__ lse, const float* __restrict__ dvec,
    const float* __restrict__ m_eff, const float* __restrict__ gmat,
    const float* __restrict__ kappa, const int64_t* __restrict__ seed, int thr, float scale,
    float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv, int nq, int nk) {
  constexpr int H = C::H, DH = C::DH, BQ = C::BQ, BKEY = C::BKEY, LD = C::LD, LDS = C::LDS;
  constexpr int NV = C::NV, MK = C::MK, PROJ = H * DH;
  constexpr bool PAIR = C::WPH == 2;   // step 3: two warps a head
  extern __shared__ __align__(128) unsigned char bwd_smem[];
  // F32: each of K, V, q, g a hi tile and its lo tile right after it
  // (TRIPLE: K and q hi, mid, lo; (hi, mid) the pair of step 3)
  bf16* ks = reinterpret_cast<bf16*>(bwd_smem);  // [H][BKEY][LD]
  bf16* vs = ks + C::PARTS * C::KV_ELEMS;         // [H][BKEY][LD]
  bf16* qs = vs + C::HALVES * C::KV_ELEMS;        // [H][BQ][LD]
  bf16* gs = qs + C::PARTS * C::QG_ELEMS;         // [H][BQ][LD]
  bf16* ds_hi = gs + C::HALVES * C::QG_ELEMS;     // [H][BQ][LDS], and the three below
  bf16* ds_lo = ds_hi + C::DS_ELEMS;
  bf16* b_hi = ds_lo + C::DS_ELEMS;
  bf16* b_lo = b_hi + C::DS_ELEMS;
  float* lse_s = reinterpret_cast<float*>(bwd_smem + C::BF16_BYTES);  // [H][BQ] * log2(e), inf past Nq
  float* d_s = lse_s + H * BQ;                    // [H][BQ]
  float* m_s = d_s + H * BQ;                      // [H][H]: M[h1, h2]
  float* g_s = m_s + H * H;                       // [H][H]: G[h3, h2]
  float* kap_s = g_s + H * H;                     // [H]
  uint8_t* mb_s = reinterpret_cast<uint8_t*>(kap_s + H);  // [H][BQ][16] keep bits
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, t4 = lane % 4;
  const int k0 = blockIdx.x * BKEY, b = blockIdx.y;
  const bool bn = gmat != nullptr;
  const uint64_t sd = thr > 0 ? static_cast<uint64_t>(seed[0]) : 0;

  // the copies never write the padding columns [dh, DP), which the MMAs read
  vit_tile::zero_bf16<C::TILE_ELEMS>(ks, tid);
  for (int e = tid; e < H * H; e += NT) {
    m_s[e] = m_eff[e];
    g_s[e] = bn ? gmat[e] : 0.f;
  }
  if (tid < H) kap_s[tid] = bn ? kappa[tid] : 0.f;
  __syncthreads();
  if constexpr (C::F32) {   // read once a block: split straight from device memory
    split_rows<C, BKEY, H, C::PARTS>(ks, C::KV_ELEMS, k + (int64_t)b * H * nk * DH,
                                     (int64_t)nk * DH, DH, k0, nk, tid);
    split_rows<C, BKEY, H>(vs, C::KV_ELEMS, v + (int64_t)b * nk * PROJ, DH, PROJ, k0, nk, tid);
  } else {
    load_rows<C, BKEY, H>(ks, k + (int64_t)b * H * nk * DH, (int64_t)nk * DH, DH, k0, nk, tid);
    load_rows<C, BKEY, H>(vs, v + (int64_t)b * nk * PROJ, DH, PROJ, k0, nk, tid);
    cp_async_commit();
  }

  // PAIR: dk_acc holds this warp's dv (even warp) or dk (odd warp)
  float dk_acc[MK][NV][4], dv_acc[PAIR ? 1 : MK][NV][4];
#pragma unroll
  for (int mt = 0; mt < MK; ++mt)
#pragma unroll
    for (int nv = 0; nv < NV; ++nv)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk_acc[mt][nv][e] = 0.f;
#pragma unroll
  for (int mt = 0; mt < (PAIR ? 1 : MK); ++mt)
#pragma unroll
    for (int nv = 0; nv < NV; ++nv)
#pragma unroll
      for (int e = 0; e < 4; ++e) dv_acc[mt][nv][e] = 0.f;

  const uint32_t grp0 = static_cast<uint32_t>(k0 >> 6) * 16;
  const uint32_t t = static_cast<uint32_t>(thr);
  for (int q0 = 0; q0 < nq; q0 += BQ) {
    // ---- 1. the q tile's rows, lse, D and dropout bits
    __syncthreads();   // step 3 of the previous tile is done with q, g, dS, B
    if constexpr (C::F32) {
      split_rows<C, BQ, H, C::PARTS>(qs, C::QG_ELEMS, q + (int64_t)b * H * nq * DH,
                                     (int64_t)nq * DH, DH, q0, nq, tid);
      split_rows<C, BQ, H>(gs, C::QG_ELEMS, g + (int64_t)b * nq * PROJ, DH, PROJ, q0, nq, tid);
    } else {
      load_rows<C, BQ, H>(qs, q + (int64_t)b * H * nq * DH, (int64_t)nq * DH, DH, q0, nq, tid);
      load_rows<C, BQ, H>(gs, g + (int64_t)b * nq * PROJ, DH, PROJ, q0, nq, tid);
      cp_async_commit();
    }
    for (int e = tid; e < H * BQ; e += NT) {
      const int h = e / BQ, row = q0 + e % BQ;
      const int64_t i = ((int64_t)b * H + h) * nq + row;
      lse_s[e] = row < nq ? lse[i] * LOG2E : INFINITY;
      d_s[e] = row < nq ? dvec[i] : 0.f;
    }
    if (thr > 0) {
      for (int e = tid; e < H * BQ * 16; e += NT) {
        const int c = e % 16, r = (e / 16) % BQ, h = e / (16 * BQ);
        uint32_t bits = 0;
        if (q0 + r < nq) {
          const uint4 w = vit::philox4(sd, b, h, q0 + r, grp0 + c);
          bits = ((w.x >> 8) >= t ? 1u : 0u) | ((w.y >> 8) >= t ? 2u : 0u) |
                 ((w.z >> 8) >= t ? 4u : 0u) | ((w.w >> 8) >= t ? 8u : 0u);
        }
        mb_s[e] = static_cast<uint8_t>(bits);
      }
    }
    cp_async_wait<0>();
    __syncthreads();

    // ---- 2. dS and B of all heads, 16 queries x 8 keys a warp
    for (int st = warp; st < C::NSUB; st += NW) {
      const int r0 = (st % (BQ / 16)) * 16, c0 = (st / (BQ / 16)) * 8;
      float p[H][4], tt[H][4];
#pragma unroll
      for (int h = 0; h < H; ++h) {
        prod_16x8<C, BQ, C::PARTS>(qs, ks, h, r0, c0, lane, p[h], C::QG_ELEMS, C::KV_ELEMS);
        prod_16x8<C, BQ>(gs, vs, h, r0, c0, lane, tt[h], C::QG_ELEMS, C::KV_ELEMS);
      }
      // this thread's entries: rows ra (e < 2), ra + 8; keys kk + (e & 1)
      const int ra = r0 + gq, kk = c0 + 2 * t4;
      const bool ok0 = k0 + kk < nk, ok1 = k0 + kk + 1 < nk;
      uint32_t keep = 0xFFFFFFFFu;   // bit 4 h + e: entry e of head h is kept
      if (thr > 0) {
        keep = 0;
        const int ca = (k0 + kk) & 15, ja = ((k0 + kk) >> 4) & 3;
        const int cb = (k0 + kk + 1) & 15, jb = ((k0 + kk + 1) >> 4) & 3;
#pragma unroll
        for (int h = 0; h < H; ++h)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const uint8_t* row = mb_s + (h * BQ + ra + 8 * r) * 16;
            keep |= ((row[ca] >> ja) & 1u) << (4 * h + 2 * r);
            keep |= ((row[cb] >> jb) & 1u) << (4 * h + 2 * r + 1);
          }
      }
      auto msc = [&](int h, int e) { return (keep >> (4 * h + e)) & 1u ? scale : 0.f; };
#pragma unroll
      for (int h = 0; h < H; ++h) {
        const float la = lse_s[h * BQ + ra], lb = lse_s[h * BQ + ra + 8];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = fast_exp2(fmaf(p[h][e], LOG2E, -(e < 2 ? la : lb)));
          p[h][e] = ((e & 1) ? ok1 : ok0) ? x : 0.f;
        }
      }
#pragma unroll
      for (int h2 = 0; h2 < H; ++h2) {
        float da[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int h1 = 0; h1 < H; ++h1) {
          const float m = m_s[h1 * H + h2];
#pragma unroll
          for (int e = 0; e < 4; ++e) da[e] = fmaf(m, tt[h1][e], da[e]);
        }
        if (bn) {
          const float kp = kap_s[h2];
#pragma unroll
          for (int e = 0; e < 4; ++e) da[e] += kp;
#pragma unroll
          for (int h3 = 0; h3 < H; ++h3) {
            const float gw = g_s[h3 * H + h2];
#pragma unroll
            for (int e = 0; e < 4; ++e) da[e] = fmaf(gw, p[h3][e] * msc(h3, e), da[e]);
          }
        }
        const float da_ = d_s[h2 * BQ + ra], db_ = d_s[h2 * BQ + ra + 8];
        float x[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          x[e] = p[h2][e] * (da[e] * msc(h2, e) - (e < 2 ? da_ : db_));
        const int off = (h2 * BQ + ra) * LDS + kk;
        store_split(ds_hi, ds_lo, off, x[0], x[1]);
        store_split(ds_hi, ds_lo, off + 8 * LDS, x[2], x[3]);
      }
#pragma unroll
      for (int h = 0; h < H; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) p[h][e] *= msc(h, e);   // A = P * mask
#pragma unroll
      for (int h1 = 0; h1 < H; ++h1) {
        float bm[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int h2 = 0; h2 < H; ++h2) {
          const float m = m_s[h1 * H + h2];
#pragma unroll
          for (int e = 0; e < 4; ++e) bm[e] = fmaf(m, p[h2][e], bm[e]);
        }
        const int off = (h1 * BQ + ra) * LDS + kk;
        store_split(b_hi, b_lo, off, bm[0], bm[1]);
        store_split(b_hi, b_lo, off + 8 * LDS, bm[2], bm[3]);
      }
    }
    __syncthreads();

    // ---- 3. dk, dv, dq
    if constexpr (PAIR) {
      step3_pair<C>(qs, gs, ks, ds_hi, ds_lo, b_hi, b_lo, dk_acc, dq, b, q0, nq, warp, lane);
    } else {
      // warp w, head w
      const int h = warp;
      // A operands dS^T, B^T (keys 16 mt.., queries kq..) of the [query][key]
      // tiles, by ldmatrix.trans
      const int a_t = (lane % 8) + 8 * (lane / 16), a_c = 8 * ((lane / 8) % 2);
#pragma unroll
      for (int kq = 0; kq < BQ; kq += 16) {
        uint32_t qb[2 * NV];
        ldsm_b_trans<C>(qb, qs + (h * BQ + kq) * LD, lane);
#pragma unroll
        for (int mt = 0; mt < MK; ++mt) {
          const int off = (h * BQ + kq + a_t) * LDS + 16 * mt + a_c;
          uint32_t ah[4], al[4];
          ldsm_x4_trans(ah, ds_hi + off);
          ldsm_x4_trans(al, ds_lo + off);
#pragma unroll
          for (int nv = 0; nv < NV; ++nv) {
            mma_bf16(dk_acc[mt][nv], ah, qb[2 * nv], qb[2 * nv + 1]);
            mma_bf16(dk_acc[mt][nv], al, qb[2 * nv], qb[2 * nv + 1]);
          }
        }
      }
#pragma unroll
      for (int kq = 0; kq < BQ; kq += 16) {
        uint32_t gb[2 * NV];
        ldsm_b_trans<C>(gb, gs + (h * BQ + kq) * LD, lane);
#pragma unroll
        for (int mt = 0; mt < MK; ++mt) {
          const int off = (h * BQ + kq + a_t) * LDS + 16 * mt + a_c;
          uint32_t ah[4], al[4];
          ldsm_x4_trans(ah, b_hi + off);
          ldsm_x4_trans(al, b_lo + off);
#pragma unroll
          for (int nv = 0; nv < NV; ++nv) {
            mma_bf16(dv_acc[mt][nv], ah, gb[2 * nv], gb[2 * nv + 1]);
            mma_bf16(dv_acc[mt][nv], al, gb[2 * nv], gb[2 * nv + 1]);
          }
        }
      }
      // dq_h (queries mq.., all dh) = dS_h K_h over the block's keys
      for (int mq = 0; mq < BQ && q0 + mq < nq; mq += 16) {
        float acc[NV][4];
#pragma unroll
        for (int nv = 0; nv < NV; ++nv)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[nv][e] = 0.f;
#pragma unroll
        for (int kc = 0; kc < BKEY; kc += 16) {
          uint32_t kb[2 * NV], ah[4], al[4];
          ldsm_b_trans<C>(kb, ks + (h * BKEY + kc) * LD, lane);
          const int off = (h * BQ + mq + (lane % 8) + 8 * ((lane / 8) % 2)) * LDS + kc +
                          8 * (lane / 16);
          ldsm_x4(ah, ds_hi + off);
          ldsm_x4(al, ds_lo + off);
#pragma unroll
          for (int nv = 0; nv < NV; ++nv) {
            mma_bf16(acc[nv], ah, kb[2 * nv], kb[2 * nv + 1]);
            mma_bf16(acc[nv], al, kb[2 * nv], kb[2 * nv + 1]);
          }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = q0 + mq + gq + 8 * r;
          if (row >= nq) continue;
          float* dst = dq + (((int64_t)b * H + h) * nq + row) * DH + 2 * t4;
#pragma unroll
          for (int nv = 0; nv < NV; ++nv) {
            atomicAdd(dst + 8 * nv, acc[nv][2 * r]);
            atomicAdd(dst + 8 * nv + 1, acc[nv][2 * r + 1]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();   // no q tile: the K / V copies are still in flight

  if constexpr (PAIR) {
    // warp 2h: dv of head h; warp 2h + 1: dk; the padding columns of dh 12
    // are not written
    const int h = warp / 2;
    const bool is_dk = warp % 2;
#pragma unroll
    for (int mt = 0; mt < MK; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = k0 + 16 * mt + gq + 8 * r;
        if (key >= nk) continue;
        float* dst = is_dk ? dk + (((int64_t)b * H + h) * nk + key) * DH + 2 * t4
                           : dv + ((int64_t)b * nk + key) * PROJ + h * DH + 2 * t4;
#pragma unroll
        for (int nv = 0; nv < NV; ++nv) {
          if (DH % 8 != 0 && 8 * nv + 2 * t4 >= DH) continue;
          *reinterpret_cast<float2*>(dst + 8 * nv) =
              make_float2(dk_acc[mt][nv][2 * r], dk_acc[mt][nv][2 * r + 1]);
        }
      }
  } else {
    const int h = warp;
#pragma unroll
    for (int mt = 0; mt < MK; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = k0 + 16 * mt + gq + 8 * r;
        if (key >= nk) continue;
        float* dkr = dk + (((int64_t)b * H + h) * nk + key) * DH + 2 * t4;
        float* dvr = dv + ((int64_t)b * nk + key) * PROJ + h * DH + 2 * t4;
#pragma unroll
        for (int nv = 0; nv < NV; ++nv) {
          *reinterpret_cast<float2*>(dkr + 8 * nv) =
              make_float2(dk_acc[mt][nv][2 * r], dk_acc[mt][nv][2 * r + 1]);
          *reinterpret_cast<float2*>(dvr + 8 * nv) =
              make_float2(dv_acc[mt][nv][2 * r], dv_acc[mt][nv][2 * r + 1]);
        }
      }
  }
}

template <typename C>
int launch(const void* q, const void* k, const void* v, const void* g, const float* lse,
           const float* dvec, const float* m_eff, const float* gmat, const float* kappa,
           const int64_t* seed, int thr, float scale, float* dq, float* dk, float* dv,
           int batch, int nq, int nk, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      bwd_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(C::SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  using T = typename C::T;
  bwd_kernel<C><<<dim3((nk + C::BKEY - 1) / C::BKEY, batch), NT, C::SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(g), lse, dvec, m_eff, gmat, kappa, seed, thr, scale, dq, dk, dv,
      nq, nk);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// 16 heads (the classifier's (16, 12) and (16, 48)): P and T staged in f32
// ---------------------------------------------------------------------------
//
// At 16 heads the kernel above would keep S and T of all heads for a
// thread's 4 entries in registers (128 f32) beside dk and dv, and warp w
// could not own head w.  So the same products and mixes run in four steps
// a q tile, each one barrier apart:
//   1. q and g rows of all heads by cp.async, lse and D;
//   2a. per 16 x 8 sub-tile of one head, a warp: S and T by mma.sync, then
//       P = exp(S - lse) on valid keys; P and T go to a shared f32 stage;
//   2b. thread (rr, c) takes rows rr + 16 i and keys c + 16 jj of the block,
//       all heads (EPT entries, 1 or 2): it reads P and T of those, draws
//       the keep bits of all heads with one Philox call a (row, head) (keys
//       c + 16 j of the 64-key window are its four words), mixes dA and B
//       in f32 registers and writes dS and B as bf16 pairs hi + lo over the
//       stage;
//   3. warp w, heads w and w + 8: dk += dS^T q, dv += B^T g, dq = dS K by
//      atomics, on hi and on lo, as above.
// Each exp, each depth product and each mix is done once per map entry and
// head.  The stage and the dS / B tiles share their bytes, so a block fits
// one SM; the dk and dv accumulators of two heads stay in registers.
//
// What bounds it (tools/torch_bwd16_variants.py takes pieces out): at
// (16, 12) the two mixes, the Philox draws (32 keys a block use half of
// each call's words) and step 3 weigh about alike, the products little; as
// much again is in none of them: the stage's round trip, the exp, the loads
// and five barriers a q tile with 8 warps an SM.  At (16, 48) step 3's six
// column tiles a head lead.
template <int H_, int DH_, int BKEY_, int BQ_>
struct StagedCfg {
  static constexpr int H = H_, DH = DH_, BKEY = BKEY_, BQ = BQ_;
  static constexpr bool F32 = false;              // bf16 inputs only
  static constexpr int HALVES = 1;
  static constexpr int DP = (DH + 15) / 16 * 16;  // depth padded for the MMA
  static constexpr int KS = DP / 16;              // k16 steps over the head dim
  static constexpr int NV = (DH + 7) / 8;         // 8-column tiles of dq, dk, dv (dh 12: 2)
  static constexpr int LD = DP + 8;               // bf16 pitch of the q, g, K, V tiles
  static constexpr int LDS = BKEY + 8;            // bf16 pitch of the dS and B tiles
  static constexpr int SLD = BKEY + 8;            // f32 pitch of the P and T stage
  static constexpr int CH = DH % 8 == 0 ? 8 : 4;  // bf16 per cp.async
  static constexpr int CPR = DH / CH;             // copies per row
  static constexpr int MK = BKEY / 16;            // 16-key row tiles of dk, dv
  static constexpr int HPW = H / NW;              // heads a warp in step 3
  static constexpr int SUBS = (BQ / 16) * (BKEY / 8);   // 16 x 8 sub-tiles of a head
  static constexpr int RPT = BQ / 16, JPT = BKEY / 16;  // step 2b: rows, key groups a thread
  static constexpr int EPT = RPT * JPT;                 // step 2b: entries a thread
  static constexpr int KV_ELEMS = H * BKEY * LD;
  static constexpr int QG_ELEMS = H * BQ * LD;
  static constexpr int DS_ELEMS = H * BQ * LDS;
  static constexpr size_t TILE_BYTES = sizeof(bf16) * (2 * KV_ELEMS + 2 * QG_ELEMS);
  static constexpr size_t P_BYTES = sizeof(float) * 2 * H * BQ * SLD;
  static constexpr size_t DS_BYTES = sizeof(bf16) * 4 * DS_ELEMS;
  static constexpr size_t STAGE_BYTES = P_BYTES > DS_BYTES ? P_BYTES : DS_BYTES;
  static constexpr size_t SMEM =
      TILE_BYTES + STAGE_BYTES + sizeof(float) * (2 * H * BQ + 3 * H * H + H);
  static_assert(H % NW == 0 && H % 4 == 0 && H <= 32, "heads: a multiple of the warps, <= 32");
  static_assert(EPT * NT == BQ * BKEY, "step 2b: every entry of the tile once");
  static_assert(DH % 4 == 0 && BKEY % 16 == 0 && BQ % 16 == 0 && 64 % BKEY == 0, "shape");
  static_assert(TILE_BYTES % 16 == 0 && STAGE_BYTES % 16 == 0 && (2 * H * BQ) % 4 == 0,
                "16-byte alignment of the stage and of M");
  static_assert(SMEM <= 232448, "shared memory of a block");
};

__device__ __forceinline__ uint32_t philox_word(const uint4& w, int j) {
  return j == 0 ? w.x : j == 1 ? w.y : j == 2 ? w.z : w.w;
}

// Grid (key tiles of BKEY, B).  dq must be zeroed; dk and dv are written.
template <typename C>
__global__ void __launch_bounds__(NT, 1) staged_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ g, const float* __restrict__ lse, const float* __restrict__ dvec,
    const float* __restrict__ m_eff, const float* __restrict__ gmat,
    const float* __restrict__ kappa, const int64_t* __restrict__ seed, int thr, float scale,
    float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv, int nq, int nk) {
  constexpr int H = C::H, DH = C::DH, BQ = C::BQ, BKEY = C::BKEY, LD = C::LD, LDS = C::LDS;
  constexpr int SLD = C::SLD, NV = C::NV, MK = C::MK, HPW = C::HPW, PROJ = H * DH;
  constexpr int RPT = C::RPT, JPT = C::JPT, EPT = C::EPT;
  extern __shared__ __align__(128) unsigned char stg_smem[];
  bf16* ks = reinterpret_cast<bf16*>(stg_smem);   // [H][BKEY][LD]
  bf16* vs = ks + C::KV_ELEMS;                    // [H][BKEY][LD]
  bf16* qs = vs + C::KV_ELEMS;                    // [H][BQ][LD]
  bf16* gs = qs + C::QG_ELEMS;                    // [H][BQ][LD]
  unsigned char* stage = stg_smem + C::TILE_BYTES;
  float* p_s = reinterpret_cast<float*>(stage);   // [H][BQ][SLD] P, then T: steps 2a-2b
  float* t_s = p_s + H * BQ * SLD;
  bf16* ds_hi = reinterpret_cast<bf16*>(stage);   // [H][BQ][LDS] x 4 over the stage: 2b-3
  bf16* ds_lo = ds_hi + C::DS_ELEMS;
  bf16* b_hi = ds_lo + C::DS_ELEMS;
  bf16* b_lo = b_hi + C::DS_ELEMS;
  float* lse_s = reinterpret_cast<float*>(stage + C::STAGE_BYTES);  // [H][BQ] * log2(e), inf past Nq
  float* d_s = lse_s + H * BQ;                    // [H][BQ]
  float* m_s = d_s + H * BQ;                      // [H][H]: M[h1, h2] at h1 H + h2
  float* mt_s = m_s + H * H;                      // [H][H]: M[h1, h2] at h2 H + h1
  float* g_s = mt_s + H * H;                      // [H][H]: G[h3, h2] at h3 H + h2
  float* kap_s = g_s + H * H;                     // [H]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, t4 = lane % 4;
  const int rr = tid / 16, c = tid % 16;          // step 2b's rows and keys
  const int k0 = blockIdx.x * BKEY, b = blockIdx.y;
  const bool bn = gmat != nullptr;
  const uint64_t sd = thr > 0 ? static_cast<uint64_t>(seed[0]) : 0;

  // the copies never write the padding columns [dh, DP), which the MMAs read
  vit_tile::zero_bf16<2 * C::KV_ELEMS + 2 * C::QG_ELEMS>(ks, tid);
  for (int e = tid; e < H * H; e += NT) {
    const float m = m_eff[e];
    m_s[e] = m;
    mt_s[(e % H) * H + e / H] = m;
    g_s[e] = bn ? gmat[e] : 0.f;
  }
  if (tid < H) kap_s[tid] = bn ? kappa[tid] : 0.f;
  __syncthreads();
  load_rows<C, BKEY, H>(ks, k + (int64_t)b * H * nk * DH, (int64_t)nk * DH, DH, k0, nk, tid);
  load_rows<C, BKEY, H>(vs, v + (int64_t)b * nk * PROJ, DH, PROJ, k0, nk, tid);
  cp_async_commit();

  float dk_acc[HPW][MK][NV][4], dv_acc[HPW][MK][NV][4];
#pragma unroll
  for (int hw = 0; hw < HPW; ++hw)
#pragma unroll
    for (int mt = 0; mt < MK; ++mt)
#pragma unroll
      for (int nv = 0; nv < NV; ++nv)
#pragma unroll
        for (int e = 0; e < 4; ++e) dk_acc[hw][mt][nv][e] = dv_acc[hw][mt][nv][e] = 0.f;

  // the block's keys lie in one 64-key window: this thread's Philox group,
  // and the word of its first key
  const uint32_t grp = static_cast<uint32_t>(k0 >> 6) * 16 + c;
  const int j0 = (k0 >> 4) & 3;
  const uint32_t t = static_cast<uint32_t>(thr);
  for (int q0 = 0; q0 < nq; q0 += BQ) {
    // ---- 1. the q tile's rows, lse and D
    __syncthreads();   // step 3 of the previous tile is done with q, g, dS, B
    load_rows<C, BQ, H>(qs, q + (int64_t)b * H * nq * DH, (int64_t)nq * DH, DH, q0, nq, tid);
    load_rows<C, BQ, H>(gs, g + (int64_t)b * nq * PROJ, DH, PROJ, q0, nq, tid);
    cp_async_commit();
    for (int e = tid; e < H * BQ; e += NT) {
      const int h = e / BQ, row = q0 + e % BQ;
      const int64_t i = ((int64_t)b * H + h) * nq + row;
      lse_s[e] = row < nq ? lse[i] * LOG2E : INFINITY;
      d_s[e] = row < nq ? dvec[i] : 0.f;
    }
    cp_async_wait<0>();
    __syncthreads();

    // ---- 2a. P and T of every head, 16 queries x 8 keys a warp
    for (int st = warp; st < H * C::SUBS; st += NW) {
      const int h = st / C::SUBS, sub = st % C::SUBS;
      const int r0 = (sub % (BQ / 16)) * 16, c0 = (sub / (BQ / 16)) * 8;
      float s[4], tt[4];
      prod_16x8<C, BQ>(qs, ks, h, r0, c0, lane, s);
      prod_16x8<C, BQ>(gs, vs, h, r0, c0, lane, tt);
      const int ra = r0 + gq, kk = c0 + 2 * t4;
      const bool ok0 = k0 + kk < nk, ok1 = k0 + kk + 1 < nk;
      const float la = lse_s[h * BQ + ra], lb = lse_s[h * BQ + ra + 8];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = fast_exp2(fmaf(s[e], LOG2E, -(e < 2 ? la : lb)));
        s[e] = ((e & 1) ? ok1 : ok0) ? x : 0.f;
      }
      const int off = (h * BQ + ra) * SLD + kk;
      *reinterpret_cast<float2*>(p_s + off) = make_float2(s[0], s[1]);
      *reinterpret_cast<float2*>(p_s + off + 8 * SLD) = make_float2(s[2], s[3]);
      *reinterpret_cast<float2*>(t_s + off) = make_float2(tt[0], tt[1]);
      *reinterpret_cast<float2*>(t_s + off + 8 * SLD) = make_float2(tt[2], tt[3]);
    }
    __syncthreads();

    // ---- 2b. entry e = i JPT + jj: row rr + 16 i, key c + 16 jj; all heads
    float p[H][EPT], tv[H][EPT];
#pragma unroll
    for (int h = 0; h < H; ++h)
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int jj = 0; jj < JPT; ++jj) {
          const int off = (h * BQ + rr + 16 * i) * SLD + c + 16 * jj;
          p[h][i * JPT + jj] = p_s[off];
          tv[h][i * JPT + jj] = t_s[off];
        }
    uint32_t keep[EPT];   // bit h: the entry of head h is kept
#pragma unroll
    for (int e = 0; e < EPT; ++e) keep[e] = 0xFFFFFFFFu;
    if (thr > 0) {
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int row = q0 + rr + 16 * i;
#pragma unroll
        for (int jj = 0; jj < JPT; ++jj) keep[i * JPT + jj] = 0;
        if (row >= nq) continue;   // P is 0 there
#pragma unroll
        for (int h = 0; h < H; ++h) {
          const uint4 w = vit::philox4(sd, b, h, row, grp);
#pragma unroll
          for (int jj = 0; jj < JPT; ++jj)
            keep[i * JPT + jj] |= ((philox_word(w, j0 + jj) >> 8) >= t ? 1u : 0u) << h;
        }
      }
    }
    auto msc = [&](int h, int e) { return (keep[e] >> h) & 1u ? scale : 0.f; };
    __syncthreads();   // every thread holds its P and T: dS and B go over the stage

    float acc[H][EPT];   // dA, then B
#pragma unroll
    for (int h2 = 0; h2 < H; ++h2)
#pragma unroll
      for (int e = 0; e < EPT; ++e) acc[h2][e] = kap_s[h2];
#pragma unroll
    for (int h1 = 0; h1 < H; ++h1)
#pragma unroll
      for (int h2 = 0; h2 < H; h2 += 4) {
        const float4 m4 = *reinterpret_cast<const float4*>(m_s + h1 * H + h2);
#pragma unroll
        for (int e = 0; e < EPT; ++e) {
          acc[h2][e] = fmaf(m4.x, tv[h1][e], acc[h2][e]);
          acc[h2 + 1][e] = fmaf(m4.y, tv[h1][e], acc[h2 + 1][e]);
          acc[h2 + 2][e] = fmaf(m4.z, tv[h1][e], acc[h2 + 2][e]);
          acc[h2 + 3][e] = fmaf(m4.w, tv[h1][e], acc[h2 + 3][e]);
        }
      }
    if (bn) {
#pragma unroll
      for (int h3 = 0; h3 < H; ++h3) {
        float a[EPT];   // A = P * mask
#pragma unroll
        for (int e = 0; e < EPT; ++e) a[e] = p[h3][e] * msc(h3, e);
#pragma unroll
        for (int h2 = 0; h2 < H; h2 += 4) {
          const float4 g4 = *reinterpret_cast<const float4*>(g_s + h3 * H + h2);
#pragma unroll
          for (int e = 0; e < EPT; ++e) {
            acc[h2][e] = fmaf(g4.x, a[e], acc[h2][e]);
            acc[h2 + 1][e] = fmaf(g4.y, a[e], acc[h2 + 1][e]);
            acc[h2 + 2][e] = fmaf(g4.z, a[e], acc[h2 + 2][e]);
            acc[h2 + 3][e] = fmaf(g4.w, a[e], acc[h2 + 3][e]);
          }
        }
      }
    }
#pragma unroll
    for (int h2 = 0; h2 < H; ++h2)
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float dr = d_s[h2 * BQ + rr + 16 * i];
#pragma unroll
        for (int jj = 0; jj < JPT; ++jj) {
          const int e = i * JPT + jj;
          const float x = p[h2][e] * (acc[h2][e] * msc(h2, e) - dr);
          const bf16 hi = __float2bfloat16_rn(x);
          const int off = (h2 * BQ + rr + 16 * i) * LDS + c + 16 * jj;
          ds_hi[off] = hi;
          ds_lo[off] = __float2bfloat16_rn(x - __bfloat162float(hi));
        }
      }
#pragma unroll
    for (int h = 0; h < H; ++h)
#pragma unroll
      for (int e = 0; e < EPT; ++e) {
        p[h][e] *= msc(h, e);   // A = P * mask
        acc[h][e] = 0.f;
      }
#pragma unroll
    for (int h2 = 0; h2 < H; ++h2)
#pragma unroll
      for (int h1 = 0; h1 < H; h1 += 4) {
        const float4 m4 = *reinterpret_cast<const float4*>(mt_s + h2 * H + h1);
#pragma unroll
        for (int e = 0; e < EPT; ++e) {
          acc[h1][e] = fmaf(m4.x, p[h2][e], acc[h1][e]);
          acc[h1 + 1][e] = fmaf(m4.y, p[h2][e], acc[h1 + 1][e]);
          acc[h1 + 2][e] = fmaf(m4.z, p[h2][e], acc[h1 + 2][e]);
          acc[h1 + 3][e] = fmaf(m4.w, p[h2][e], acc[h1 + 3][e]);
        }
      }
#pragma unroll
    for (int h1 = 0; h1 < H; ++h1)
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int jj = 0; jj < JPT; ++jj) {
          const float x = acc[h1][i * JPT + jj];
          const bf16 hi = __float2bfloat16_rn(x);
          const int off = (h1 * BQ + rr + 16 * i) * LDS + c + 16 * jj;
          b_hi[off] = hi;
          b_lo[off] = __float2bfloat16_rn(x - __bfloat162float(hi));
        }
    __syncthreads();

    // ---- 3. warp w, heads w + NW hw: dk, dv, dq
    // A operands dS^T, B^T (keys 16 mt.., queries kq..) of the [query][key]
    // tiles, by ldmatrix.trans
    const int a_t = (lane % 8) + 8 * (lane / 16), a_c = 8 * ((lane / 8) % 2);
#pragma unroll
    for (int hw = 0; hw < HPW; ++hw) {
      const int h = warp + NW * hw;
#pragma unroll
      for (int kq = 0; kq < BQ; kq += 16) {
        uint32_t qb[2 * NV], gb[2 * NV];
        ldsm_b_trans<C>(qb, qs + (h * BQ + kq) * LD, lane);
        ldsm_b_trans<C>(gb, gs + (h * BQ + kq) * LD, lane);
#pragma unroll
        for (int mt = 0; mt < MK; ++mt) {
          const int off = (h * BQ + kq + a_t) * LDS + 16 * mt + a_c;
          uint32_t ah[4], al[4], bh[4], bl[4];
          ldsm_x4_trans(ah, ds_hi + off);
          ldsm_x4_trans(al, ds_lo + off);
          ldsm_x4_trans(bh, b_hi + off);
          ldsm_x4_trans(bl, b_lo + off);
#pragma unroll
          for (int nv = 0; nv < NV; ++nv) {
            mma_bf16(dk_acc[hw][mt][nv], ah, qb[2 * nv], qb[2 * nv + 1]);
            mma_bf16(dk_acc[hw][mt][nv], al, qb[2 * nv], qb[2 * nv + 1]);
            mma_bf16(dv_acc[hw][mt][nv], bh, gb[2 * nv], gb[2 * nv + 1]);
            mma_bf16(dv_acc[hw][mt][nv], bl, gb[2 * nv], gb[2 * nv + 1]);
          }
        }
      }
      // dq_h (queries mq.., all dh) = dS_h K_h over the block's keys
      for (int mq = 0; mq < BQ && q0 + mq < nq; mq += 16) {
        float dacc[NV][4];
#pragma unroll
        for (int nv = 0; nv < NV; ++nv)
#pragma unroll
          for (int e = 0; e < 4; ++e) dacc[nv][e] = 0.f;
#pragma unroll
        for (int kc = 0; kc < BKEY; kc += 16) {
          uint32_t kb[2 * NV], ah[4], al[4];
          ldsm_b_trans<C>(kb, ks + (h * BKEY + kc) * LD, lane);
          const int off = (h * BQ + mq + (lane % 8) + 8 * ((lane / 8) % 2)) * LDS + kc +
                          8 * (lane / 16);
          ldsm_x4(ah, ds_hi + off);
          ldsm_x4(al, ds_lo + off);
#pragma unroll
          for (int nv = 0; nv < NV; ++nv) {
            mma_bf16(dacc[nv], ah, kb[2 * nv], kb[2 * nv + 1]);
            mma_bf16(dacc[nv], al, kb[2 * nv], kb[2 * nv + 1]);
          }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = q0 + mq + gq + 8 * r;
          if (row >= nq) continue;
          float* dst = dq + (((int64_t)b * H + h) * nq + row) * DH + 2 * t4;
#pragma unroll
          for (int nv = 0; nv < NV; ++nv) {
            if (DH % 8 != 0 && 8 * nv + 2 * t4 >= DH) continue;   // dh 12: padding columns
            atomicAdd(dst + 8 * nv, dacc[nv][2 * r]);
            atomicAdd(dst + 8 * nv + 1, dacc[nv][2 * r + 1]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();   // no q tile: the K / V copies are still in flight

#pragma unroll
  for (int hw = 0; hw < HPW; ++hw) {
    const int h = warp + NW * hw;
#pragma unroll
    for (int mt = 0; mt < MK; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = k0 + 16 * mt + gq + 8 * r;
        if (key >= nk) continue;
        float* dkr = dk + (((int64_t)b * H + h) * nk + key) * DH + 2 * t4;
        float* dvr = dv + ((int64_t)b * nk + key) * PROJ + h * DH + 2 * t4;
#pragma unroll
        for (int nv = 0; nv < NV; ++nv) {
          if (DH % 8 != 0 && 8 * nv + 2 * t4 >= DH) continue;
          *reinterpret_cast<float2*>(dkr + 8 * nv) =
              make_float2(dk_acc[hw][mt][nv][2 * r], dk_acc[hw][mt][nv][2 * r + 1]);
          *reinterpret_cast<float2*>(dvr + 8 * nv) =
              make_float2(dv_acc[hw][mt][nv][2 * r], dv_acc[hw][mt][nv][2 * r + 1]);
        }
      }
  }
}

template <typename C>
int launch_staged(const void* q, const void* k, const void* v, const void* g, const float* lse,
                  const float* dvec, const float* m_eff, const float* gmat, const float* kappa,
                  const int64_t* seed, int thr, float scale, float* dq, float* dk, float* dv,
                  int batch, int nq, int nk, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      staged_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(C::SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  staged_kernel<C><<<dim3((nk + C::BKEY - 1) / C::BKEY, batch), NT, C::SMEM, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(g), lse, dvec, m_eff, gmat, kappa, seed, thr, scale, dq, dk, dv,
      nq, nk);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// dh 384 (base's N = 49 level): maps, then products
// ---------------------------------------------------------------------------
//
// At dh 384 one head's K and V rows of 16 keys take 25 KB, and dk, dv of a
// 16-key tile 384 registers a thread, so the kernel above does not fit.
// The function runs in two kernels through a bf16 workspace of four planes
// (dS hi, dS lo, B hi, B lo), each (B, H, Nq padded to 16, Nk padded to 64),
// small at base's 49 x 49 maps:
//   maps_kernel, grid (q tiles of 16, B), warp w = head w, a loop over the
//     key tiles of 64: S_w and T_w of 16 queries x 64 keys by mma.sync over
//     depth chunks of 32 staged per warp (cp.async, __syncwarp only),
//     through shared memory in f32 to one thread per (row, c) of the Philox
//     groups, which draws the four keys c + 16 j of all heads, mixes dA and
//     B as above and writes the planes;
//   prods_kernel, grid (dh / 64 column chunks, H, B), 4 warps: dq = dS K,
//     dk = dS^T q, dv = B^T g for 64 columns, each on hi and lo, every
//     output written once (no atomics).
template <int H_, int DH_>
struct MapCfg {
  static constexpr int H = H_, DH = DH_;
  static constexpr int BQ = 16, KT = 64;          // queries a block, keys a tile
  static constexpr int DC = 32, LDC = DC + 8;     // depth chunk, its bf16 pitch
  static constexpr int ST_LD = KT + 4;            // f32 pitch of the S and T tiles
  static constexpr int WARP_ELEMS = 2 * (BQ + KT) * LDC;  // q, K rows; g, V rows
  static constexpr size_t TILE_BYTES = sizeof(bf16) * NW * WARP_ELEMS;
  static constexpr size_t MAP_SMEM =
      TILE_BYTES + sizeof(float) * (2 * H * BQ * ST_LD + 2 * H * BQ + 2 * H * H + H);
  static constexpr int PC = 64, PT = 64, LDP = PT + 8;   // products: columns, rows, pitch
  static constexpr int PNT = 128;                         // products: threads
  static constexpr size_t PROD_SMEM = sizeof(bf16) * 3 * PT * LDP;
  static_assert(H == NW && DH % DC == 0 && DH % PC == 0, "shape");
  static_assert(MAP_SMEM <= 232448, "shared memory of a block");
};

// bytes of the workspace (0 where the class needs none)
inline size_t map_workspace(int batch, int heads, int nq, int nk, int dh) {
  if (heads != 8 || dh != 384) return 0;
  return sizeof(bf16) * 4 * (size_t)batch * heads * ((nq + 15) / 16 * 16) * ((nk + 63) / 64 * 64);
}

template <typename C>
__global__ void __launch_bounds__(NT, 1) maps_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ g, const float* __restrict__ lse, const float* __restrict__ dvec,
    const float* __restrict__ m_eff, const float* __restrict__ gmat,
    const float* __restrict__ kappa, const int64_t* __restrict__ seed, int thr, float scale,
    bf16* __restrict__ maps, int batch, int nq, int nk) {
  constexpr int H = C::H, DH = C::DH, BQ = C::BQ, KT = C::KT, DC = C::DC, LDC = C::LDC;
  constexpr int ST_LD = C::ST_LD, PROJ = H * DH;
  extern __shared__ __align__(128) unsigned char map_smem[];
  float* s_s = reinterpret_cast<float*>(map_smem + C::TILE_BYTES);  // [H][BQ][ST_LD]
  float* t_s = s_s + H * BQ * ST_LD;              // [H][BQ][ST_LD]
  float* lse_s = t_s + H * BQ * ST_LD;            // [H][BQ] * log2(e), inf past Nq
  float* d_s = lse_s + H * BQ;                    // [H][BQ]
  float* m_s = d_s + H * BQ;                      // [H][H]: M[h1, h2]
  float* g_s = m_s + H * H;                       // [H][H]: G[h3, h2]
  float* kap_s = g_s + H * H;                     // [H]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, t4 = lane % 4, h = warp;
  const int q0 = blockIdx.x * BQ, b = blockIdx.y;
  const int nqp = (nq + 15) / 16 * 16, nkp = (nk + KT - 1) / KT * KT;
  const bool bn = gmat != nullptr;
  const uint64_t sd = thr > 0 ? static_cast<uint64_t>(seed[0]) : 0;
  const int64_t plane = (int64_t)batch * H * nqp * nkp;

  for (int e = tid; e < H * H; e += NT) {
    m_s[e] = m_eff[e];
    g_s[e] = bn ? gmat[e] : 0.f;
  }
  if (tid < H) kap_s[tid] = bn ? kappa[tid] : 0.f;
  for (int e = tid; e < H * BQ; e += NT) {
    const int hh = e / BQ, row = q0 + e % BQ;
    const int64_t i = ((int64_t)b * H + hh) * nq + row;
    lse_s[e] = row < nq ? lse[i] * LOG2E : INFINITY;
    d_s[e] = row < nq ? dvec[i] : 0.f;
  }
  bf16* wt = reinterpret_cast<bf16*>(map_smem) + warp * C::WARP_ELEMS;  // this warp's tiles
  const bf16* qh = q + ((int64_t)b * H + h) * nq * DH;
  const bf16* kh = k + ((int64_t)b * H + h) * nk * DH;
  const bf16* gh = g + (int64_t)b * nq * PROJ + h * DH;
  const bf16* vh = v + (int64_t)b * nk * PROJ + h * DH;

  for (int k0 = 0; k0 < nk; k0 += KT) {
    float s[KT / 8][4], t[KT / 8][4];
#pragma unroll
    for (int nt = 0; nt < KT / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = t[nt][e] = 0.f;
    for (int d0 = 0; d0 < DH; d0 += DC) {
      // rows r < BQ + KT: q then K; rows BQ + KT + r: g then V; zero past Nq / Nk
      for (int c = lane; c < 2 * (BQ + KT) * (DC / 8); c += 32) {
        const int j = c % (DC / 8), r = c / (DC / 8);
        const int rr = r % (BQ + KT);
        const bool second = r >= BQ + KT, isq = rr < BQ;
        const int row = isq ? q0 + rr : k0 + rr - BQ;
        const bool valid = row < (isq ? nq : nk);
        const bf16* src = second ? (isq ? gh + (int64_t)row * PROJ : vh + (int64_t)row * PROJ)
                                 : (isq ? qh + (int64_t)row * DH : kh + (int64_t)row * DH);
        vit_tile::cp_async<16>(wt + r * LDC + 8 * j, valid ? src + d0 + 8 * j : q, valid);
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncwarp();
#pragma unroll
      for (int ks = 0; ks < DC / 16; ++ks) {
#pragma unroll
        for (int part = 0; part < 2; ++part) {
          const bf16* base = wt + part * (BQ + KT) * LDC;
          uint32_t af[4];
          ldsm_x4(af, base + ((lane % 8) + 8 * ((lane / 8) % 2)) * LDC + 8 * (lane / 16) + 16 * ks);
#pragma unroll
          for (int nt = 0; nt < KT / 8; ++nt) {
            uint32_t bf[2];
            ldsm_x2(bf, base + (BQ + 8 * nt + (lane % 8)) * LDC + 8 * ((lane / 8) % 2) + 16 * ks);
            mma_bf16(part == 0 ? s[nt] : t[nt], af, bf[0], bf[1]);
          }
        }
      }
      __syncwarp();   // the next chunk overwrites this warp's tiles
    }
    __syncthreads();  // the previous key tile's entries are done with s_s, t_s
#pragma unroll
    for (int nt = 0; nt < KT / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = (h * BQ + gq + 8 * (e / 2)) * ST_LD + 8 * nt + 2 * t4 + (e & 1);
        s_s[i] = s[nt][e];
        t_s[i] = t[nt][e];
      }
    __syncthreads();

    // thread (r, c): keys k0 + c + 16 j (j < 4) of row q0 + r, all heads
    const int r = tid / 16, c = tid % 16, row = q0 + r;
    uint32_t keep = 0xFFFFFFFFu;   // bit 4 h + j
    if (thr > 0) {
      keep = 0;
      const uint32_t tt = static_cast<uint32_t>(thr);
#pragma unroll
      for (int hh = 0; hh < H; ++hh) {
        const uint4 w = vit::philox4(sd, b, hh, row, (k0 >> 2) + c);
        keep |= (((w.x >> 8) >= tt ? 1u : 0u) | ((w.y >> 8) >= tt ? 2u : 0u) |
                 ((w.z >> 8) >= tt ? 4u : 0u) | ((w.w >> 8) >= tt ? 8u : 0u)) << (4 * hh);
      }
    }
    auto msc = [&](int hh, int j) { return (keep >> (4 * hh + j)) & 1u ? scale : 0.f; };
    float p[H][4];
#pragma unroll
    for (int hh = 0; hh < H; ++hh) {
      const float l = lse_s[hh * BQ + r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float x = fast_exp2(fmaf(s_s[(hh * BQ + r) * ST_LD + c + 16 * j], LOG2E, -l));
        p[hh][j] = k0 + c + 16 * j < nk ? x : 0.f;
      }
    }
    bf16* out = maps + (((int64_t)b * H) * nqp + row) * nkp + k0 + c;   // head 0, plane 0
    const int64_t hstride = (int64_t)nqp * nkp;
#pragma unroll
    for (int h2 = 0; h2 < H; ++h2) {
      float da[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int h1 = 0; h1 < H; ++h1) {
        const float m = m_s[h1 * H + h2];
#pragma unroll
        for (int j = 0; j < 4; ++j) da[j] = fmaf(m, t_s[(h1 * BQ + r) * ST_LD + c + 16 * j], da[j]);
      }
      if (bn) {
#pragma unroll
        for (int h3 = 0; h3 < H; ++h3) {
          const float gw = g_s[h3 * H + h2];
#pragma unroll
          for (int j = 0; j < 4; ++j) da[j] = fmaf(gw, p[h3][j] * msc(h3, j), da[j]);
        }
      }
      const float dr = d_s[h2 * BQ + r], kp = kap_s[h2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float x = p[h2][j] * ((da[j] + kp) * msc(h2, j) - dr);
        const bf16 hi = __float2bfloat16_rn(x);
        out[h2 * hstride + 16 * j] = hi;
        out[plane + h2 * hstride + 16 * j] = __float2bfloat16_rn(x - __bfloat162float(hi));
      }
    }
#pragma unroll
    for (int hh = 0; hh < H; ++hh)
#pragma unroll
      for (int j = 0; j < 4; ++j) p[hh][j] *= msc(hh, j);   // A = P * mask
#pragma unroll
    for (int h1 = 0; h1 < H; ++h1) {
      float bm[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int h2 = 0; h2 < H; ++h2) {
        const float m = m_s[h1 * H + h2];
#pragma unroll
        for (int j = 0; j < 4; ++j) bm[j] = fmaf(m, p[h2][j], bm[j]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bf16 hi = __float2bfloat16_rn(bm[j]);
        out[2 * plane + h1 * hstride + 16 * j] = hi;
        out[3 * plane + h1 * hstride + 16 * j] = __float2bfloat16_rn(bm[j] - __bfloat162float(hi));
      }
    }
  }
}

// One 64-column chunk of dq, dk and dv of head h, image b.
template <typename C>
__global__ void __launch_bounds__(C::PNT) prods_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ g,
    const bf16* __restrict__ maps, float* __restrict__ dq, float* __restrict__ dk,
    float* __restrict__ dv, int batch, int nq, int nk) {
  constexpr int H = C::H, DH = C::DH, PT = C::PT, LDP = C::LDP, PROJ = H * DH;
  constexpr int NV = C::PC / 8;
  extern __shared__ __align__(128) unsigned char prod_smem[];
  bf16* a_hi = reinterpret_cast<bf16*>(prod_smem);   // [PT][LDP] map tile [query][key]
  bf16* a_lo = a_hi + PT * LDP;
  bf16* bo = a_lo + PT * LDP;                        // [PT][LDP] rows of K, q or g
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, t4 = lane % 4;
  const int cc = blockIdx.x * C::PC, h = blockIdx.y, b = blockIdx.z;
  const int nqp = (nq + 15) / 16 * 16, nkp = (nk + PT - 1) / PT * PT;
  const int64_t plane = (int64_t)batch * H * nqp * nkp;
  const bf16* mhead = maps + ((int64_t)b * H + h) * nqp * nkp;

  // which 0: dq (rows queries, summed over keys); 1: dk, 2: dv (rows keys,
  // summed over queries)
  for (int which = 0; which < 3; ++which) {
    const int nrows = which == 0 ? nq : nk, nsum = which == 0 ? nk : nq;
    const bf16* mh = mhead + (which == 2 ? 2 : 0) * plane;
    for (int r0 = 0; r0 < nrows; r0 += PT) {
      float acc[NV][4];
#pragma unroll
      for (int nv = 0; nv < NV; ++nv)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nv][e] = 0.f;
      for (int s0 = 0; s0 < nsum; s0 += PT) {
        __syncthreads();   // the previous tile's readers are done
        const int mq0 = which == 0 ? r0 : s0, mk0 = which == 0 ? s0 : r0;  // map rows, cols
        for (int e = tid; e < 3 * PT * (PT / 8); e += C::PNT) {
          const int j = e % (PT / 8), rr = (e / (PT / 8)) % PT, part = e / (PT * (PT / 8));
          bool valid;
          const bf16* src;
          if (part < 2) {
            valid = mq0 + rr < nqp;
            src = mh + part * plane + (int64_t)(mq0 + rr) * nkp + mk0 + 8 * j;
          } else {
            const int row = s0 + rr;
            valid = row < nsum;
            src = which == 0 ? k + (((int64_t)b * H + h) * nk + row) * DH + cc + 8 * j
                  : which == 1 ? q + (((int64_t)b * H + h) * nq + row) * DH + cc + 8 * j
                               : g + ((int64_t)b * nq + row) * PROJ + h * DH + cc + 8 * j;
          }
          vit_tile::cp_async<16>(a_hi + (part * PT + rr) * LDP + 8 * j, valid ? src : maps, valid);
        }
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
#pragma unroll
        for (int ks = 0; ks < PT / 16; ++ks) {
          uint32_t ah[4], al[4], bf[2 * NV];
          int off;
          if (which == 0) {   // A = dS [query][key], rows 16 warp.., k = keys
            off = (16 * warp + (lane % 8) + 8 * ((lane / 8) % 2)) * LDP + 16 * ks + 8 * (lane / 16);
            ldsm_x4(ah, a_hi + off);
            ldsm_x4(al, a_lo + off);
          } else {            // A = map^T, rows keys 16 warp.., k = queries
            off = (16 * ks + (lane % 8) + 8 * (lane / 16)) * LDP + 16 * warp + 8 * ((lane / 8) % 2);
            ldsm_x4_trans(ah, a_hi + off);
            ldsm_x4_trans(al, a_lo + off);
          }
          const bf16* p = bo + (16 * ks + (lane % 8) + 8 * ((lane / 8) % 2)) * LDP;
#pragma unroll
          for (int jj = 0; jj < 2 * NV; jj += 4) ldsm_x4_trans(bf + jj, p + 8 * (jj / 2) + 8 * (lane / 16));
#pragma unroll
          for (int nv = 0; nv < NV; ++nv) {
            mma_bf16(acc[nv], ah, bf[2 * nv], bf[2 * nv + 1]);
            mma_bf16(acc[nv], al, bf[2 * nv], bf[2 * nv + 1]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + 16 * warp + gq + 8 * r;
        if (row >= nrows) continue;
        float* dst = which == 0 ? dq + (((int64_t)b * H + h) * nq + row) * DH + cc
                     : which == 1 ? dk + (((int64_t)b * H + h) * nk + row) * DH + cc
                                  : dv + ((int64_t)b * nk + row) * PROJ + h * DH + cc;
#pragma unroll
        for (int nv = 0; nv < NV; ++nv)
          *reinterpret_cast<float2*>(dst + 8 * nv + 2 * t4) = make_float2(acc[nv][2 * r], acc[nv][2 * r + 1]);
      }
    }
  }
}

template <typename C>
int launch_maps(const void* q, const void* k, const void* v, const void* g, const float* lse,
                const float* dvec, const float* m_eff, const float* gmat, const float* kappa,
                const int64_t* seed, int thr, float scale, float* dq, float* dk, float* dv,
                void* work, int batch, int nq, int nk, cudaStream_t stream) {
  if (work == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      maps_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(C::MAP_SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  bf16* maps = static_cast<bf16*>(work);
  maps_kernel<C><<<dim3((nq + C::BQ - 1) / C::BQ, batch), NT, C::MAP_SMEM, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(g), lse, dvec, m_eff, gmat, kappa, seed, thr, scale, maps, batch,
      nq, nk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  prods_kernel<C><<<dim3(C::DH / C::PC, C::H, batch), C::PNT, C::PROD_SMEM, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(g), maps,
      dq, dk, dv, batch, nq, nk);
  return static_cast<int>(cudaGetLastError());
}

// The route's classes.  Shared memory a block (one block an SM):
//   (8, 24): BKEY 64, BQ 16: K, V 81,920 + q, g 20,480 + dS, B (hi, lo)
//            73,728 + lse, D, M, G, kappa 1,568 + keep bits 2,048 = 179,744 B;
//            832 blocks at base b64 (13 key tiles x 64 images), 49 q tiles each;
//   (8, 96): BKEY 16, BQ 32: K, V 53,248 + q, g 106,496 + dS, B 24,576 +
//            2,592 + 4,096 = 191,008 B; 832 blocks at base b64, 7 q tiles each;
//            dk and dv keep 2 * (BKEY / 16) * (dh / 8) * 4 = 96 f32 registers
//            a thread in both;
//   (8, 384): maps_kernel 8 warp tiles 102,400 + S, T 69,632 + 1,568 =
//            173,600 B, 256 blocks at base b64; prods_kernel 27,648 B, 4 warps,
//            3,072 blocks; the workspace (map_workspace) 4 x B x H x 64 x 64
//            bf16 = 16.8 MB at base b64;
//   (16, 12): staged_kernel, BKEY 32, BQ 16: K, V 49,152 + q, g 24,576 +
//            the P, T stage (= dS, B hi, lo) 81,920 + lse, D, M, M^T, G,
//            kappa 5,184 = 160,832 B; 1,600 blocks at the classifier's b64
//            N 784 (25 key tiles x 64 images), 49 q tiles each; dk and dv of
//            two heads 64 f32 registers a thread;
//   (16, 48): staged_kernel, BKEY 16, BQ 16: K, V 57,344 + q, g 57,344 +
//            stage 49,152 + 5,184 = 169,024 B; 832 blocks at b64 N 196, 13 q
//            tiles each; dk and dv of two heads 96 registers a thread;
//   (4, 12): BKEY 64, BQ 32: K, V 24,576 + q, g 12,288 + dS, B 73,728 +
//            lse, D, M, G, kappa 1,168 + keep bits 2,048 = 113,808 B, two
//            blocks an SM; 3,136 blocks at lite b64 N 3,136 (49 key tiles x
//            64 images), 98 q tiles each; a warp's dk or dv 32 registers;
//   (4, 48): BKEY 64, BQ 32: K, V 57,344 + q, g 28,672 + 73,728 + 1,168 +
//            2,048 = 162,960 B; 832 blocks at b64 N 784, 25 q tiles each; a
//            warp's dk or dv 96 registers;
//   (4, 192): BKEY 16, BQ 32: K, V 51,200 + q, g 102,400 + 24,576 + 1,168 +
//            2,048 = 181,392 B; 832 blocks at b64 N 196, 7 q tiles each; a
//            warp's dk or dv 96 registers (step 2 has 4 sub-tiles a q tile:
//            half the warps wait there).
// cudaErrorInvalidValue for any other shape.  A template only so that a
// source that includes this header for its helpers (the eval source, through
// reattention_bnfwd_tc.cuh) compiles none of these kernels; so is
// train_bwd_tc_f32.
template <int = 0>
int train_bwd_tc(const void* q, const void* k, const void* v, const void* g,
                 const float* lse, const float* dvec, const float* m_eff,
                 const float* gmat, const float* kappa, const int64_t* seed, int thr,
                 float scale, float* dq, float* dk, float* dv, void* work, int batch,
                 int heads, int nq, int nk, int dh, cudaStream_t stream) {
#define VIT_BWD_TC(...)                                                                    \
  launch<Cfg<__VA_ARGS__>>(q, k, v, g, lse, dvec, m_eff, gmat, kappa, seed, thr, scale, dq, dk, \
                           dv, batch, nq, nk, stream)
  if (heads == 8 && dh == 24) return VIT_BWD_TC(8, 24, 64, 16);
  if (heads == 8 && dh == 96) return VIT_BWD_TC(8, 96, 16, 32);
  if (heads == 4 && dh == 12) return VIT_BWD_TC(4, 12, 64, 32, 2);
  if (heads == 4 && dh == 48) return VIT_BWD_TC(4, 48, 64, 32);
  if (heads == 4 && dh == 192) return VIT_BWD_TC(4, 192, 16, 32);
#undef VIT_BWD_TC
#define VIT_BWD_STAGED(DH, BKEY, BQ)                                                    \
  launch_staged<StagedCfg<16, DH, BKEY, BQ>>(q, k, v, g, lse, dvec, m_eff, gmat, kappa, seed, \
                                             thr, scale, dq, dk, dv, batch, nq, nk, stream)
  if (heads == 16 && dh == 12) return VIT_BWD_STAGED(12, 32, 16);
  if (heads == 16 && dh == 48) return VIT_BWD_STAGED(48, 16, 16);
#undef VIT_BWD_STAGED
#define VIT_BWD_MAPS(DH)                                                                \
  launch_maps<MapCfg<8, DH>>(q, k, v, g, lse, dvec, m_eff, gmat, kappa, seed, thr, scale, dq, \
                             dk, dv, work, batch, nq, nk, stream)
  if (heads == 8 && dh == 384) return VIT_BWD_MAPS(384);
#undef VIT_BWD_MAPS
  return static_cast<int>(cudaErrorInvalidValue);
}

// The float32 route's classes, lite's, in split precision (bwd_kernel with
// Cfg::F32; q, k, v, g float32).  Shared memory a block, V and g as hi +
// lo, K and q as triples at (4, 12) and (4, 48), as pairs at (4, 192):
//   (4, 12): BKEY 64, BQ 16: K 36,864, V 24,576, q 9,216, g 6,144 + dS, B
//            (hi, lo) 36,864 + lse, D, M, G, kappa 656 + keep bits 1,024 =
//            115,344 B, two blocks an SM as the bf16 class (232,736 of the
//            SM's 233,472 B with the 1,024 B each block reserves); 3,136
//            blocks at lite b64, 196 q tiles each;
//   (4, 48): BKEY 64, BQ 16: K 86,016, V 57,344, q 21,504, g 14,336 +
//            36,864 + 656 + 1,024 = 217,744 B; 832 blocks at b64 N 784 (13
//            key tiles x 64), 49 q tiles each; a warp's dk or dv 96
//            registers, 252 in all, no spill (BKEY 32, BQ 32: 3.08 against
//            2.47 ms a call, tools/torch_bwd_f32_tiling.py);
//   (4, 192): BKEY 16, BQ 16: K, V 102,400 + q, g 102,400 + 12,288 + 656 +
//            1,024 = 218,768 B (triples would need 51,200 B more); 832
//            blocks at b64 N 196, 13 q tiles each; step 2 has 2 sub-tiles a
//            q tile (6 warps wait there).
// cudaErrorInvalidValue for any other shape.
template <int = 0>
int train_bwd_tc_f32(const void* q, const void* k, const void* v, const void* g,
                     const float* lse, const float* dvec, const float* m_eff,
                     const float* gmat, const float* kappa, const int64_t* seed, int thr,
                     float scale, float* dq, float* dk, float* dv, int batch, int heads,
                     int nq, int nk, int dh, cudaStream_t stream) {
#define VIT_BWD_F32(DH, BKEY, BQ, MINB, TRIPLE)                                       \
  launch<Cfg<4, DH, BKEY, BQ, MINB, true, TRIPLE>>(q, k, v, g, lse, dvec, m_eff, gmat, kappa, \
                                                   seed, thr, scale, dq, dk, dv, batch, nq, nk, \
                                                   stream)
  if (heads == 4 && dh == 12) return VIT_BWD_F32(12, 64, 16, 2, true);
  if (heads == 4 && dh == 48) return VIT_BWD_F32(48, 64, 16, 1, true);
  if (heads == 4 && dh == 192) return VIT_BWD_F32(192, 16, 16, 1, false);
#undef VIT_BWD_F32
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace vit_bwd
