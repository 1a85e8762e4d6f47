// Training forward of flash re-attention on the tensor cores: the bfloat16
// routes of vit_bn_fwd (exact BN) and vit_train_fwd (frozen BN) in
// flash_reattention_train.cu, at the (heads, dh) classes bn_fwd_tc and
// train_fwd_tc instantiate: the levels of base and large, and for exact BN
// also lite's (4 heads: dh 12, 48, 192).
//
// Replaces the Pallas TPU kernels of vit_unet_tpu/kernels/flash_reattention_train.py
// ::_bn_fwd (pallas_call body _bn_fwd_kernel) and ::_fwd (body _fwd_kernel)
// there.  With P_h the pre-dropout softmax of q_h k_h^T and A_h = P_h * mask_h:
//
//   lse[b,h,n]      = log sum_m exp(q_h[n] . k_h[m])       f32, pre-dropout
//   o_norm[b,h,n,:] = A_h[n,:] @ V_cat                     bf16, all H * dh columns
// exact BN (_bn_fwd) also
//   S[b,h,n]        = sum_m A_h[n,m]                       f32
//   C[b,h2,h3,n]    = sum_m A_h2[n,m] A_h3[n,m]            f32, symmetric
// frozen BN (_fwd) instead the TPU epilogue's head mix
//   out[b,n,j]      = sum_h2 M[head(j),h2] o_norm[b,h2,n,j] + c[head(j)] vsum[b,j]
//                                                          bf16, from f32 o_norm
//
// What bounds the function on this card.  Its bytes are mostly o_norm's
// (H times the width of the output of an attention call), its operations
// mostly the product A_h @ V_cat (2 H dh operations per map entry); per map
// entry it also takes an exp, a dropout draw and the H (H + 1) / 2 products
// of C.  The CUDA-core kernels recomputed the scores once per head for
// o_norm and once more for S and C, drew the dropout bits twice, and ran
// every product as scalar f32 FMAs fed from shared memory.  The frozen
// forward's mix then read the bf16 o_norm back from device memory once per
// head, one thread per output entry.
//
// Design.  A block of 8 warps owns BQ = 16 query rows of one image and ALL
// heads, so each V_cat tile it stages serves the 8 heads at once.  Per key
// tile of KT = 64 keys (one Philox window):
//   1. warp h: S_h (16 x 64) = q_h K_h^T by mma.sync m16n8k16 (bf16 in, f32
//      accumulate, fragments by ldmatrix) over depth chunks of 32 that the
//      warp stages itself by cp.async into two buffers (the next chunk loads
//      while this one multiplies); the f32 scores go to shared memory;
//   2. thread (row r, group c) draws the Philox call of (b, h, r, c) for each
//      head once (keys c + 16 j, j < 4: all four words used), forms
//      A_h = exp(s - lse_h) * mask on valid keys in f32 registers, adds them
//      to its S and C sums (C's upper triangle, 36 products at H = 8), and
//      writes A_h rounded to bf16 once (the TPU kernel's p.astype(v.dtype))
//      to shared memory;
//   3. warp h: o_norm_h += A_h V_cat by mma.sync (V fragments by
//      ldmatrix.trans), f32 accumulators.
// S and C are thus taken from the f32 probabilities, as the TPU kernel's
// p_tiles are f32: the BN variance w^T C w / cnt - dev^2 is a difference of
// sums, and bf16-rounded A would cost it digits.  At the end the 16 threads
// of a row reduce their sums by shuffles and write S and both halves of C.
//
// Frozen BN (Cfg::MIX) compiles S and C out and mixes the heads once a block
// holds all heads' o_norm of a column range (mix_out): warp h leaves its f32
// accumulators of head h in shared memory, and after a barrier each thread
// forms out for 4 columns of a row at a time from all H heads, M and c
// staged beside them.  The mix is taken from the f32 accumulators, as the
// TPU epilogue mixes its f32 o_norm; o_norm itself is still written in bf16.
//
// Two forms, by the width P = H dh of o_norm:
//   * P = 192 (dh 24, base's N = 784 level): o_norm of the block's 16 rows
//     stays in registers over all keys (warp h: head h, 16 x 192 f32, 96 a
//     thread); V_cat's 64 x 192 tile is staged per key tile, its copy in
//     flight during step 2.
//   * P = 768, 3072 (dh 96, 384; N = 196, 49): o_norm does not fit in
//     registers, but A of all keys does fit in shared memory (8 heads x 16
//     rows x up to KC = 256 keys of bf16, 67.6 KB).  Steps 1-2 run once over
//     all keys; then step 3 runs per 64-column chunk of P, V_cat's chunk of
//     all keys staged by cp.async into two buffers (the next chunk loads
//     while this one multiplies).  With more than KC keys A is recomputed
//     per column chunk (its Philox bits too): no shape of the presets does
//     that.
// The mix's exchange: in the register form, once after the last key tile,
// 16 x 192 f32 of each head (102,688 B with M and c) over the score, A and
// warp-buffer regions, free by then; in the chunked form, after each
// 64-column chunk, 8 x 16 x 64 f32 (37,152 B) in the score region, which
// step 3 does not use.
// Ragged edges: every copy zero-fills rows past Nq and Nk (src-size 0); keys
// past Nk get A = 0 before S, C and the product; rows past Nq get
// lse = +inf, so A = 0, and write nothing.
//
// 4 heads (lite's levels, exact BN only).  The block keeps its 8 warps, two
// a head: in step 1 warp w takes head w / 2 and keys 32 (w % 2) .. + 31 of
// the tile (16 x 32 scores), in step 3 the same head and half the block's
// o_norm columns (P / 2 of a register tile, PC / 2 of a chunk); step 2 is
// the same thread per (row, Philox group), now over 4 heads (4 calls a tile,
// every word used; C's 10 sums).  The classes:
//   * (4, 12), P = 48: the register form; dh 12 is copied in 8-byte pieces
//     and zero-padded to one k16 step (depth chunk 16); a warp keeps 16 x 24
//     of o_norm (an odd count of 8-column tiles: the last B fragment by
//     ldmatrix.x2.trans);
//   * (4, 48), P = 192: the register form, three depth chunks of 16, a warp
//     16 x 96 of o_norm;
//   * (4, 192), P = 768: the chunked form with 128-column chunks (64 a warp)
//     and A of up to 256 keys, as base's (8, 96).
// At dh 12 and 48 the block takes 74,240 and 92,672 B of shared memory, and
// two blocks share an SM (at most 128 registers a thread).  There the
// log-sum-exp pass, a fifth of the call at (4, 12) (its scores and exps
// again), is folded into the sweep (Cfg::ONLINE, probs_tile_online): step 2
// keeps each row's running max of the scores, a half-warp's max per tile,
// and A, S, C and the normaliser l relative to it, rescaling their sums
// when it moves; step 3 rescales o_norm's rows by the factor step 2 leaves
// in shared memory; at the end the sweep divides o_norm, S and C by l and
// writes lse = max + log l.  A is rounded to bf16 unnormalised (its
// relative error is the same).  Dropout does not enter l: it stays the
// pre-dropout normaliser.
//
// The log-sum-exp pass comes first, and is kernel 1's tensor-core pass
// (reattention_tc.cuh::lse_kernel) at the same classes.
//
// What bounds it now (H100 80GB HBM3, 700 W, base b64; variants of this
// source timed in one process by tools/torch_bn_fwd_variants.py).  At
// N = 784 a call takes ~2.0 ms against a 0.14 ms bound: the LSE pass
// ~0.32 ms, the sweep ~1.44 ms at rate 0 and ~0.27 ms more at rate 0.2 (the
// Philox draws).  Taking out step 3 saves ~0.28 ms and C's products
// ~0.09 ms; most of the rest is the latency of steps 1-2 at one block of 8
// warps an SM (255 registers a thread) with two barriers a key tile.  A
// second V_cat buffer copying one tile ahead was tried: slower, and it
// spilled.  ptxas: dh 24 255 registers, dh 96 and 384 224, no spill.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "reattention_common.cuh"
#include "reattention_mma.cuh"
#include "reattention_tc.cuh"
#include "reattention_tiles.cuh"

namespace vit_bnfwd {

using vit_mma::ldsm_x2;
using vit_mma::ldsm_x2_trans;
using vit_mma::ldsm_x4;
using vit_mma::ldsm_x4_trans;
using vit_mma::mma_bf16;
using vit_mma::pack_bf16;
using vit_tile::bf16;
using vit_tile::cp_async;
using vit_tile::cp_async_commit;
using vit_tile::cp_async_wait;
using vit_tile::fast_exp2;
using vit_tile::LOG2E;

constexpr int NW = vit_tile::NW;   // warps per block
constexpr int NT = vit_tile::NT;   // threads per block
constexpr int BQ = 16;             // query rows per block
constexpr int KT = 64;             // keys of a score tile: one Philox window
constexpr int LDSF = KT + 16;      // f32 pitch of the score tiles

// The frozen forward takes the log-sum-exp itself where all keys fit one
// key tile (tile_lse); otherwise the log-sum-exp pass runs first.
__host__ __device__ constexpr bool own_lse(bool mix, int nk) { return mix && nk <= KT; }

// MIX_: the frozen forward (head mix into out, no S and C); else exact BN.
// DC_: the depth chunk of the score product; MINB_: blocks an SM; ONLINE_:
// exact BN in the register form with the log-sum-exp taken in the sweep
// (no log-sum-exp pass; probs_tile_online).
template <int H_, int DH_, int KC_, int PC_, bool MIX_ = false, int DC_ = 32, int MINB_ = 1,
          bool ONLINE_ = false>
struct Cfg {
  static constexpr int H = H_, DH = DH_, KC = KC_, PC = PC_, DC = DC_, MINB = MINB_;
  static constexpr bool MIX = MIX_, ONLINE = ONLINE_;
  static constexpr int P = H * DH;
  static constexpr int WPH = NW / H;              // warps a head: 1 (8 heads) or 2 (4)
  static constexpr int KTW = KT / WPH;            // keys of a warp's score tile
  static constexpr int PCW = PC / WPH;            // o_norm columns of a warp
  static constexpr int NVTW = PCW / 8;            // 8-column tiles of a warp's output
  static constexpr bool RES = PC == P;            // o_norm stays in registers
  static constexpr int NDC = (DH + DC - 1) / DC;  // depth chunks
  static constexpr int LDC = DC + 8;              // bf16 pitch of a warp's staged q / K rows
  static constexpr int CH = DH % 8 == 0 ? 8 : 4;  // bf16 a copy (16 or 8 bytes)
  static constexpr int CPR = (DH < DC ? DH : DC) / CH;  // copies a row and chunk
  static constexpr int WARP_ELEMS = (BQ + KTW) * LDC;   // one of a warp's two buffers
  static constexpr int NPAIR = H * (H + 1) / 2;   // C's upper triangle
  static constexpr int LDA = KC + 8;              // bf16 pitch of the A tiles
  static constexpr int LDV = PC + 8;              // bf16 pitch of a V_cat buffer
  static constexpr int NVT = PC / 8;              // 8-column tiles of a column chunk
  static constexpr int VROWS = RES ? KT : KC;     // keys of a V_cat buffer
  static constexpr int NVBUF = RES ? 1 : 2;
  static constexpr int V_ELEMS = VROWS * LDV;
  static constexpr size_t S_BYTES = sizeof(float) * H * BQ * LDSF;
  static constexpr size_t A_BYTES = sizeof(bf16) * H * BQ * LDA;
  static constexpr size_t W_BYTES = sizeof(bf16) * NW * 2 * WARP_ELEMS;
  static constexpr size_t V_BYTES = sizeof(bf16) * NVBUF * V_ELEMS;
  // the warps' q / K buffers and the V_cat chunks share a region where
  // steps 1-2 and step 3 do not overlap
  static constexpr size_t BODY =
      S_BYTES + A_BYTES + (RES ? W_BYTES + V_BYTES : (W_BYTES > V_BYTES ? W_BYTES : V_BYTES));
  // the frozen forward stages M (H x H) and c (H) once, after the body; the
  // online form keeps each (head, row)'s rescale factor of the tile and, at
  // the end, 1 / l there
  static constexpr size_t SMEM =
      BODY + (MIX ? sizeof(float) * (H * H + H) : 0) + (ONLINE ? sizeof(float) * 2 * H * BQ : 0);
  static_assert(!ONLINE || (RES && !MIX), "the online log-sum-exp: exact BN, register form");
  static_assert(WPH * H == NW && (WPH == 1 || WPH == 2), "a head's warps");
  static_assert(!MIX || WPH == 1, "the frozen forward's mix: warp h holds head h");
  static_assert(DH % 4 == 0 && DC % 16 == 0 && (DH < DC || DH % DC == 0), "depth chunks");
  static_assert(DH >= DC || RES, "zero padding of the warp buffers is never overwritten");
  static_assert(KC % KT == 0 && P % PC == 0 && PCW % 8 == 0, "tiles");
  static_assert(!RES || KC == KT, "the register form keeps one key tile of A");
  static_assert(SMEM <= 232448, "shared memory of a block");
  // the mix's exchange of the f32 accumulators, [H][BQ][LDX]; a thread mixes
  // NMIX column quads of the block's 16 x PC tile
  static constexpr int LDX = PC + 8;
  static constexpr size_t X_BYTES = sizeof(float) * H * BQ * LDX;
  static constexpr int NMIX = BQ * PC / 4 >= NT ? BQ * PC / 4 / NT : 1;
  static_assert(!MIX || X_BYTES <= (RES ? BODY : S_BYTES), "the mix's exchange region");
  static_assert(!MIX || BQ * PC / 4 % NT == 0, "column quads of the mix");
};

// The keep bits of thread (row, c) of step 2 for the key tile at k0: bit
// 4 h + j for key c + 16 j of head h, all four words of one Philox call a
// head; all kept without dropout or past Nq.
template <typename C>
__device__ __forceinline__ uint32_t keep_bits(uint64_t sd, int thr, int b, int row, bool rvalid,
                                              int k0, int c) {
  uint32_t keep = 0xFFFFFFFFu;
  if (thr > 0 && rvalid) {
    keep = 0;
    const uint32_t t = static_cast<uint32_t>(thr);
#pragma unroll
    for (int h = 0; h < C::H; ++h) {
      const uint4 w = vit::philox4(sd, b, h, row, (k0 >> 2) + c);
      keep |= (((w.x >> 8) >= t ? 1u : 0u) | ((w.y >> 8) >= t ? 2u : 0u) |
               ((w.z >> 8) >= t ? 4u : 0u) | ((w.w >> 8) >= t ? 8u : 0u)) << (4 * h);
    }
  }
  return keep;
}

// Step 2 for key tile t (keys k0 .. k0 + 63): thread (r, c) of the block.
template <typename C>
__device__ __forceinline__ void probs_tile(const float* ss, bf16* as, int aoff, int k0, int nk,
                                           int b, int row, bool rvalid, int r, int c,
                                           uint64_t sd, int thr, float scale,
                                           const float (&lse2)[C::H], bool acc_sc,
                                           float (&sacc)[C::H], float (&cacc)[C::NPAIR]) {
  constexpr int H = C::H;
  const uint32_t keep = keep_bits<C>(sd, thr, b, row, rvalid, k0, c);
  const float ks = thr > 0 ? scale : 1.f;
  float a[H][4];
#pragma unroll
  for (int h = 0; h < H; ++h)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float x = fast_exp2(fmaf(ss[(h * BQ + r) * LDSF + c + 16 * j], LOG2E, -lse2[h]));
      a[h][j] = (k0 + c + 16 * j < nk && ((keep >> (4 * h + j)) & 1u)) ? x * ks : 0.f;
      as[(h * BQ + r) * C::LDA + aoff + c + 16 * j] = __float2bfloat16_rn(a[h][j]);
    }
  if (C::MIX || !acc_sc) return;
#pragma unroll
  for (int h = 0; h < H; ++h) sacc[h] += (a[h][0] + a[h][1]) + (a[h][2] + a[h][3]);
  int p = 0;
#pragma unroll
  for (int h2 = 0; h2 < H; ++h2)
#pragma unroll
    for (int h3 = h2; h3 < H; ++h3, ++p)
#pragma unroll
      for (int j = 0; j < 4; ++j) cacc[p] = fmaf(a[h2][j], a[h3][j], cacc[p]);
}

// Step 2 with the log-sum-exp taken in the sweep (C::ONLINE), key tile at
// k0, thread (r, c): per head the row's running max m2 of the scores in
// log2 units (a half-warp's max, the same in its 16 threads) and this
// thread's sum lsum of exp2(s - m2) over its valid keys, pre-dropout; A, S
// and C relative to m2, their sums rescaled by alpha = exp2(m2_old -
// m2_new) when the max moves, and A written unnormalised (the sweep divides
// by l = sum lsum at the end).  Thread c = 0 leaves each head's alpha of its
// row in alpha_s[h][r] for step 3.
template <typename C>
__device__ __forceinline__ void probs_tile_online(const float* ss, bf16* as, int k0, int nk, int b,
                                                  int row, bool rvalid, int r, int c,
                                                  uint64_t sd, int thr, float scale,
                                                  float (&m2)[C::H], float (&lsum)[C::H],
                                                  float (&sacc)[C::H], float (&cacc)[C::NPAIR],
                                                  float* alpha_s) {
  constexpr int H = C::H;
  const uint32_t keep = keep_bits<C>(sd, thr, b, row, rvalid, k0, c);
  const float ks = thr > 0 ? scale : 1.f;
  float a[H][4], al[H];
#pragma unroll
  for (int h = 0; h < H; ++h) {
    float x[4], mt = -INFINITY;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x[j] = k0 + c + 16 * j < nk ? ss[(h * BQ + r) * LDSF + c + 16 * j] * LOG2E : -INFINITY;
      mt = fmaxf(mt, x[j]);
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
    const float mn = fmaxf(m2[h], mt);   // finite: key k0 of the tile is valid
    al[h] = fast_exp2(m2[h] - mn);       // 0 on the first tile (m2 = -inf)
    m2[h] = mn;
    float ps = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float pj = fast_exp2(x[j] - mn);   // 0 past Nk
      ps += pj;
      a[h][j] = (keep >> (4 * h + j)) & 1u ? pj * ks : 0.f;
      as[(h * BQ + r) * C::LDA + c + 16 * j] = __float2bfloat16_rn(a[h][j]);
    }
    lsum[h] = fmaf(lsum[h], al[h], ps);
    sacc[h] = fmaf(sacc[h], al[h], (a[h][0] + a[h][1]) + (a[h][2] + a[h][3]));
    if (c == 0) alpha_s[h * BQ + r] = al[h];
  }
  int p = 0;
#pragma unroll
  for (int h2 = 0; h2 < H; ++h2)
#pragma unroll
    for (int h3 = h2; h3 < H; ++h3, ++p) {
      float x = cacc[p] * (al[h2] * al[h3]);
#pragma unroll
      for (int j = 0; j < 4; ++j) x = fmaf(a[h2][j], a[h3][j], x);
      cacc[p] = x;
    }
}

// acc (16 rows of head h: gq, gq + 8 of this lane) *= f[h][row]
template <typename C>
__device__ __forceinline__ void scale_rows(float (&acc)[C::NVTW][4], const float* f, int h,
                                           int lane) {
  const float f0 = f[h * BQ + lane / 4], f1 = f[h * BQ + lane / 4 + 8];
#pragma unroll
  for (int nv = 0; nv < C::NVTW; ++nv) {
    acc[nv][0] *= f0;
    acc[nv][1] *= f0;
    acc[nv][2] *= f1;
    acc[nv][3] *= f1;
  }
}

// Step 3, one 16-key step kk: acc (16 rows x PCW columns col0.. of head h)
// += A (keys 16 kk .. 16 kk + 15 of the A tiles) @ vb (those keys' rows of a
// V_cat buffer).
template <typename C>
__device__ __forceinline__ void product_step(const bf16* as, const bf16* vb, int kk, int h,
                                             int col0, int lane, float (&acc)[C::NVTW][4]) {
  uint32_t af[4];
  ldsm_x4(af, as + (h * BQ + (lane % 8) + 8 * ((lane / 8) % 2)) * C::LDA + 8 * (lane / 16) +
                  16 * kk);
  const bf16* vrow = vb + (16 * kk + (lane % 8) + 8 * ((lane / 8) % 2)) * C::LDV + col0;
#pragma unroll
  for (int nv = 0; nv + 2 <= C::NVTW; nv += 2) {
    uint32_t vf[4];   // b0, b1 of column tile nv, then of nv + 1
    ldsm_x4_trans(vf, vrow + 8 * nv + 8 * (lane / 16));
    mma_bf16(acc[nv], af, vf[0], vf[1]);
    mma_bf16(acc[nv + 1], af, vf[2], vf[3]);
  }
  if constexpr (C::NVTW % 2 == 1) {   // the last tile alone (lanes 0-15 address it)
    uint32_t vf[2];
    ldsm_x2_trans(vf, vrow + 8 * (C::NVTW - 1));
    mma_bf16(acc[C::NVTW - 1], af, vf[0], vf[1]);
  }
}

// dst[r][0 .. PC) <- v_cat[b, key0 + r, c0 .. c0 + PC) for r < nrows, zero past Nk.
template <typename C>
__device__ __forceinline__ void load_v(bf16* dst, const bf16* v, int b, int key0, int nrows,
                                       int c0, int nk, int tid) {
  constexpr int CPR = C::PC / 8;
  for (int e = tid; e < nrows * CPR; e += NT) {
    const int j = e % CPR, r = e / CPR, key = key0 + r;
    const bool valid = key < nk;
    const bf16* src = valid ? v + ((int64_t)b * nk + key) * C::P + c0 + 8 * j : v;
    cp_async<16>(dst + r * C::LDV + 8 * j, src, valid);
  }
  cp_async_commit();
}

template <typename C>
__device__ __forceinline__ void zero_acc(float (&acc)[C::NVTW][4]) {
#pragma unroll
  for (int nv = 0; nv < C::NVTW; ++nv)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nv][e] = 0.f;
}

// acc (rows q0 + 16 rows, columns c0 .. c0 + PCW of head h) -> o_norm, bf16
template <typename C>
__device__ __forceinline__ void store_acc(const float (&acc)[C::NVTW][4], bf16* onorm, int b,
                                          int q0, int c0, int nq, int h, int lane) {
  const int gq = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + gq + 8 * r;
    if (row >= nq) continue;
    bf16* dst = onorm + (((int64_t)b * C::H + h) * nq + row) * C::P + c0 + 2 * t4;
#pragma unroll
    for (int nv = 0; nv < C::NVTW; ++nv)
      *reinterpret_cast<uint32_t*>(dst + 8 * nv) = pack_bf16(acc[nv][2 * r], acc[nv][2 * r + 1]);
  }
}

// The frozen forward's head mix: thread tid forms out for column quads
// e = tid + NT i (i < NMIX) of the block's 16 rows x PC columns c0 ..
// c0 + PC, row e / (PC / 4).  vsum[b] at those columns, loaded ahead of the
// mix so that its latency hides behind the products.
template <typename C>
__device__ __forceinline__ void load_vsum(float (&vq)[C::NMIX][4], const float* vsum, int b,
                                          int c0, int tid) {
  constexpr int NQD = C::PC / 4;
#pragma unroll
  for (int i = 0; i < C::NMIX; ++i) {
    const float* vs = vsum + (int64_t)b * C::P + c0 + 4 * ((tid + NT * i) % NQD);
#pragma unroll
    for (int e = 0; e < 4; ++e) vq[i][e] = vs[e];
  }
}

//   out[b, n, j] = sum_h2 M[head(j), h2] o_norm[b, h2, n, j] + c[head(j)] vsum[b, j]
// from the f32 accumulators (acc: head `warp`), with M and c staged in mc.
// xs (C::X_BYTES) must be free for every warp when this is called; it is
// read until the call returns.
template <typename C>
__device__ __forceinline__ void mix_out(const float (&acc)[C::NVTW][4], float* xs, const float* mc,
                                        const float (&vq)[C::NMIX][4], bf16* out, int b, int q0,
                                        int c0, int nq, int warp, int lane, int tid) {
  constexpr int H = C::H, LDX = C::LDX, NQD = C::PC / 4;   // column quads of a row
  const int gq = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int nv = 0; nv < C::NVTW; ++nv)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<float2*>(xs + (warp * BQ + gq + 8 * r) * LDX + 8 * nv + 2 * t4) =
          make_float2(acc[nv][2 * r], acc[nv][2 * r + 1]);
  __syncthreads();   // every head's accumulators are in
#pragma unroll
  for (int i = 0; i < C::NMIX; ++i) {
    const int e = tid + NT * i, r = e / NQD, j = 4 * (e % NQD), row = q0 + r;
    if (row >= nq) continue;
    const int col = c0 + j, hp = col / C::DH;
    const float cp = mc[H * H + hp];
    float x[4] = {cp * vq[i][0], cp * vq[i][1], cp * vq[i][2], cp * vq[i][3]};
#pragma unroll
    for (int h2 = 0; h2 < H; ++h2) {
      const float4 o = *reinterpret_cast<const float4*>(xs + (h2 * BQ + r) * LDX + j);
      const float w = mc[hp * H + h2];
      x[0] = fmaf(w, o.x, x[0]);
      x[1] = fmaf(w, o.y, x[1]);
      x[2] = fmaf(w, o.z, x[2]);
      x[3] = fmaf(w, o.w, x[3]);
    }
    *reinterpret_cast<uint2*>(out + ((int64_t)b * nq + row) * C::P + col) =
        make_uint2(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]));
  }
}

// The frozen forward's own log-sum-exp where all keys fit one key tile
// (nk <= KT): thread (r, c) of step 2 takes keys c + 16 j of row r from the
// f32 scores, and the row's 16 threads (a half-warp) reduce the max and the
// sum by shuffles.  lse2 <- lse * log2(e) as the pass would give it; thread
// c = h writes lse of head h.  Every thread of the block calls it.
template <typename C>
__device__ __forceinline__ void tile_lse(const float* ss, float* lse, int b, int row, bool rvalid,
                                         int r, int c, int nq, int nk, float (&lse2)[C::H]) {
#pragma unroll
  for (int h = 0; h < C::H; ++h) {
    float x[4], m = -INFINITY;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x[j] = c + 16 * j < nk ? ss[(h * BQ + r) * LDSF + c + 16 * j] : -INFINITY;
      m = fmaxf(m, x[j]);
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float l = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) l += fast_exp2((x[j] - m) * LOG2E);
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
    const float v = m + logf(l);
    if (!rvalid) continue;
    lse2[h] = v * LOG2E;
    if (c == h) lse[((int64_t)b * C::H + h) * nq + row] = v;
  }
}

// Grid (q tiles of 16, B).  lse comes from the log-sum-exp pass, except in
// the frozen forward where all keys fit one key tile: it writes lse itself.
// Exact BN writes srow and crow; frozen BN (C::MIX) reads vsum, m_eff, c_eff
// and writes out.  The other mode's pointers are not read.
template <typename C>
__global__ void __launch_bounds__(NT, C::MINB) bnfwd_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    float* __restrict__ lse, const int64_t* __restrict__ seed, int thr, float scale,
    bf16* __restrict__ onorm, float* __restrict__ srow, float* __restrict__ crow,
    const float* __restrict__ vsum, const float* __restrict__ m_eff,
    const float* __restrict__ c_eff, bf16* __restrict__ out, int nq, int nk) {
  constexpr int H = C::H, DH = C::DH, DC = C::DC, LDC = C::LDC, WARP_ELEMS = C::WARP_ELEMS;
  extern __shared__ __align__(128) unsigned char bn_smem[];
  float* ss = reinterpret_cast<float*>(bn_smem);                    // [H][BQ][LDSF] scores
  bf16* as = reinterpret_cast<bf16*>(bn_smem + C::S_BYTES);         // [H][BQ][LDA] bf16 A
  bf16* wbuf = reinterpret_cast<bf16*>(bn_smem + C::S_BYTES + C::A_BYTES);  // [NW][2][WARP_ELEMS]
  bf16* vbuf = C::RES ? wbuf + NW * 2 * WARP_ELEMS : wbuf;          // [NVBUF][VROWS][LDV]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // this warp's head; its key part (step 1) and column part (step 3)
  const int wh = warp / C::WPH, wpart = warp % C::WPH;
  const int wcol = wpart * C::PCW;
  const int q0 = blockIdx.x * BQ, b = blockIdx.y;
  const uint64_t sd = thr > 0 ? static_cast<uint64_t>(seed[0]) : 0;
  // step 2's thread: row er, Philox group ec; a row's 16 threads share a half-warp
  const int er = tid / 16, ec = tid % 16, erow = q0 + er;
  const bool rvalid = erow < nq;
  const bool lse_here = own_lse(C::MIX, nk);
  // lse2: lse * log2(e) of the row, or with C::ONLINE its running max m2
  float lse2[H], sacc[H], cacc[C::NPAIR];
  [[maybe_unused]] float lsum[H];
#pragma unroll
  for (int h = 0; h < H; ++h) {
    if constexpr (C::ONLINE)
      lse2[h] = -INFINITY;
    else
      lse2[h] = rvalid && !lse_here ? lse[((int64_t)b * H + h) * nq + erow] * LOG2E : INFINITY;
    sacc[h] = 0.f;
    if constexpr (C::ONLINE) lsum[h] = 0.f;
  }
#pragma unroll
  for (int p = 0; p < C::NPAIR; ++p) cacc[p] = 0.f;

  // at dh < 32 the copies never write a row's padding columns, which the
  // MMAs read
  if constexpr (DH < DC) vit_tile::zero_bf16<NW * 2 * WARP_ELEMS>(wbuf, tid);
  [[maybe_unused]] float* mc = reinterpret_cast<float*>(bn_smem + C::BODY);   // frozen BN: M, c
  [[maybe_unused]] float* alpha_s = mc;       // C::ONLINE: [H][BQ] alpha of the tile
  [[maybe_unused]] float* linv_s = mc + H * BQ;   // then [H][BQ] 1 / l
  if constexpr (C::MIX)
    if (tid < H * H + H) mc[tid] = tid < H * H ? m_eff[tid] : c_eff[tid - H * H];
  __syncthreads();

  const bf16* qh = q + ((int64_t)b * H + wh) * nq * DH;
  const bf16* kh = k + ((int64_t)b * H + wh) * nk * DH;
  bf16* wb = wbuf + warp * 2 * WARP_ELEMS;
  // this warp's stage (key tile t, depth chunk d): q_h rows, then its KTW K_h rows
  auto load_qk = [&](int t, int d, bf16* dst) {
    for (int e = lane; e < (BQ + C::KTW) * C::CPR; e += 32) {
      const int j = e % C::CPR, r = e / C::CPR;
      const bool isq = r < BQ;
      const int row = isq ? q0 + r : t * KT + wpart * C::KTW + r - BQ;
      const bool valid = row < (isq ? nq : nk);
      const bf16* src = (isq ? qh : kh) + (int64_t)row * DH + d * DC + C::CH * j;
      cp_async<2 * C::CH>(dst + r * LDC + C::CH * j, valid ? src : q, valid);
    }
    cp_async_commit();
  };

  float acc[C::NVTW][4];
  zero_acc<C>(acc);

  // Steps 1-2 over key tiles [t0, t1); A of tile t at column (t - t0) KT of
  // the A tiles; with RES, step 3 after each tile.
  auto sweep = [&](int t0, int t1, bool acc_sc) {
    const int total = (t1 - t0) * C::NDC;
    load_qk(t0, 0, wb);
    float st[C::KTW / 8][4];
    for (int s = 0; s < total; ++s) {
      const int t = t0 + s / C::NDC, d = s % C::NDC;
      if (s + 1 < total) {
        load_qk(t0 + (s + 1) / C::NDC, (s + 1) % C::NDC, wb + ((s + 1) & 1) * WARP_ELEMS);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncwarp();
      if (d == 0) {
#pragma unroll
        for (int nt = 0; nt < C::KTW / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[nt][e] = 0.f;
      }
      const bf16* buf = wb + (s & 1) * WARP_ELEMS;
#pragma unroll
      for (int kq = 0; kq < DC / 16; ++kq) {
        uint32_t af[4];
        ldsm_x4(af, buf + ((lane % 8) + 8 * ((lane / 8) % 2)) * LDC + 8 * (lane / 16) + 16 * kq);
#pragma unroll
        for (int nt = 0; nt < C::KTW / 8; ++nt) {
          uint32_t bf[2];
          ldsm_x2(bf, buf + (BQ + 8 * nt + (lane % 8)) * LDC + 8 * ((lane / 8) % 2) + 16 * kq);
          mma_bf16(st[nt], af, bf[0], bf[1]);
        }
      }
      __syncwarp();   // this buffer is refilled two stages on
      if (d != C::NDC - 1) continue;
      {
        const int gq = lane / 4, t4 = lane % 4;
#pragma unroll
        for (int nt = 0; nt < C::KTW / 8; ++nt)
#pragma unroll
          for (int r = 0; r < 2; ++r)
            *reinterpret_cast<float2*>(ss + (wh * BQ + gq + 8 * r) * LDSF + wpart * C::KTW +
                                       8 * nt + 2 * t4) =
                make_float2(st[nt][2 * r], st[nt][2 * r + 1]);
      }
      // every head's scores of tile t are stored; everyone is done with the
      // previous tile's A (and, with RES, its V_cat tile)
      __syncthreads();
      if constexpr (C::RES) load_v<C>(vbuf, v, b, t * KT, KT, 0, nk, tid);
      if (lse_here) tile_lse<C>(ss, lse, b, erow, rvalid, er, ec, nq, nk, lse2);
      // RES keeps one key tile of A; otherwise A of all the sweep's keys
      if constexpr (C::ONLINE)
        probs_tile_online<C>(ss, as, t * KT, nk, b, erow, rvalid, er, ec, sd, thr, scale, lse2,
                             lsum, sacc, cacc, alpha_s);
      else
        probs_tile<C>(ss, as, C::RES ? 0 : (t - t0) * KT, t * KT, nk, b, erow, rvalid, er, ec,
                      sd, thr, scale, lse2, acc_sc, sacc, cacc);
      if constexpr (C::RES) cp_async_wait<0>();
      __syncthreads();   // A of tile t is stored (and its V_cat tile has landed)
      if constexpr (C::RES) {
        if constexpr (C::ONLINE) scale_rows<C>(acc, alpha_s, wh, lane);
#pragma unroll
        for (int kk = 0; kk < KT / 16; ++kk) product_step<C>(as, vbuf, kk, wh, wcol, lane, acc);
      }
    }
  };

  const int n_tiles = (nk + KT - 1) / KT;
  if constexpr (C::RES) {
    sweep(0, n_tiles, true);
    [[maybe_unused]] float vq[C::NMIX][4];
    if constexpr (C::MIX) load_vsum<C>(vq, vsum, b, 0, tid);
    if constexpr (C::ONLINE) {
      // l of each (head, row) over the row's 16 threads: lse, and 1 / l for
      // o_norm (through linv_s), S and C
#pragma unroll
      for (int h = 0; h < H; ++h) {
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          lsum[h] += __shfl_xor_sync(0xffffffffu, lsum[h], off);
        if (ec == 0) linv_s[h * BQ + er] = 1.f / lsum[h];
        if (rvalid && ec == h)
          lse[((int64_t)b * H + h) * nq + erow] = (lse2[h] + log2f(lsum[h])) / LOG2E;
      }
      __syncthreads();
      scale_rows<C>(acc, linv_s, wh, lane);
    }
    store_acc<C>(acc, onorm, b, q0, wcol, nq, wh, lane);
    if constexpr (C::MIX) {
      __syncthreads();   // every warp is done with the A tile and V_cat tile
      mix_out<C>(acc, reinterpret_cast<float*>(bn_smem), mc, vq, out, b, q0, 0, nq, warp, lane,
                 tid);
    }
  } else {
    const int n_kc = (nk + C::KC - 1) / C::KC;
    for (int c0 = 0, ci = 0; c0 < C::P; c0 += C::PC, ++ci) {
      [[maybe_unused]] float vq[C::NMIX][4];
      if constexpr (C::MIX) load_vsum<C>(vq, vsum, b, c0, tid);
      for (int kc = 0; kc < n_kc; ++kc) {
        const int key0 = kc * C::KC, nkeys = min(C::KC, nk - key0);
        const int nks = (nkeys + 15) / 16;
        // one key chunk: A once, and the next column chunk's V_cat rows load
        // during this chunk's products
        const bool once = n_kc == 1;
        if (ci == 0 || !once) sweep(key0 / KT, key0 / KT + (nkeys + KT - 1) / KT, ci == 0);
        const int buf = once ? ci & 1 : 0;
        if (ci == 0 || !once) load_v<C>(vbuf + buf * C::V_ELEMS, v, b, key0, 16 * nks, c0, nk, tid);
        cp_async_wait<0>();
        __syncthreads();   // this chunk's V_cat rows are in
        if (once && c0 + C::PC < C::P)
          load_v<C>(vbuf + (buf ^ 1) * C::V_ELEMS, v, b, key0, 16 * nks, c0 + C::PC, nk, tid);
        for (int kk = 0; kk < nks; ++kk)
          product_step<C>(as, vbuf + buf * C::V_ELEMS, kk, wh, wcol, lane, acc);
        // the V_cat buffer (and the region it shares) is free; with one key
        // chunk the frozen forward needs no barrier here: the next copy into
        // this buffer starts after the next chunk's first barrier, and the
        // mix's exchange below uses the score region, which step 3 leaves alone
        if (!(C::MIX && once)) __syncthreads();
      }
      store_acc<C>(acc, onorm, b, q0, c0 + wcol, nq, wh, lane);
      if constexpr (C::MIX) {
        // the score region is free since this chunk's sweep; with more than
        // KC keys the next chunk's sweep writes it again
        mix_out<C>(acc, ss, mc, vq, out, b, q0, c0, nq, warp, lane, tid);
        if (n_kc > 1) __syncthreads();
      }
      zero_acc<C>(acc);
    }
  }
  if constexpr (C::MIX) return;

  // S and C: sum over the 16 threads of each row (one half-warp)
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
#pragma unroll
    for (int h = 0; h < H; ++h) sacc[h] += __shfl_xor_sync(0xffffffffu, sacc[h], off);
#pragma unroll
    for (int p = 0; p < C::NPAIR; ++p) cacc[p] += __shfl_xor_sync(0xffffffffu, cacc[p], off);
  }
  if constexpr (C::ONLINE) {   // relative to the running max: divide by l
    float inv[H];
#pragma unroll
    for (int h = 0; h < H; ++h) {
      inv[h] = 1.f / lsum[h];
      sacc[h] *= inv[h];
    }
    int p = 0;
#pragma unroll
    for (int h2 = 0; h2 < H; ++h2)
#pragma unroll
      for (int h3 = h2; h3 < H; ++h3, ++p) cacc[p] *= inv[h2] * inv[h3];
  }
  if (!rvalid) return;
  // the row's 16 threads share the H + NPAIR writes
#pragma unroll
  for (int h = 0; h < H; ++h)
    if (h % 16 == ec) srow[((int64_t)b * H + h) * nq + erow] = sacc[h];
  int p = 0;
#pragma unroll
  for (int h2 = 0; h2 < H; ++h2)
#pragma unroll
    for (int h3 = h2; h3 < H; ++h3, ++p)
      if ((H + p) % 16 == ec) {
        crow[(((int64_t)b * H + h2) * H + h3) * nq + erow] = cacc[p];
        crow[(((int64_t)b * H + h3) * H + h2) * nq + erow] = cacc[p];
      }
}

// The outputs of either mode: S and C rows (exact BN), or out from vsum, M
// and c (frozen BN).
struct Outs {
  float* srow;
  float* crow;
  const float* vsum;
  const float* m_eff;
  const float* c_eff;
  void* out;
};

template <typename C>
int launch(const void* q, const void* k, const void* v, const int64_t* seed, int thr,
           float scale, float* lse, void* onorm, const Outs& o, int batch, int nq, int nk,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      bnfwd_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(C::SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  bnfwd_kernel<C><<<dim3((nq + BQ - 1) / BQ, batch), NT, C::SMEM, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), lse,
      seed, thr, scale, static_cast<bf16*>(onorm), o.srow, o.crow, o.vsum, o.m_eff, o.c_eff,
      static_cast<bf16*>(o.out), nq, nk);
  return static_cast<int>(cudaGetLastError());
}

// The routes' classes: the log-sum-exp pass of reattention_tc.cuh (its
// configurations of these classes), then the sweep.  Shared memory a block,
// either mode (one block an SM but at lite's dh 12 and 48):
//   (8, 24):  scores 40,960 + A 18,432 + warp buffers 102,400 + V_cat tile
//             25,600 = 187,392 B; 3,136 blocks at base b64 (49 q tiles x 64);
//   (8, 96), (8, 384): scores 40,960 + A 67,584 + max(warp buffers 102,400,
//             V_cat chunks 73,728) = 210,944 B; 832 and 256 blocks at base b64.
// Exact BN also at lite's classes (the frozen forward's mix needs a warp a
// head), (4, 12) and (4, 48) with no log-sum-exp pass (ONLINE):
//   (4, 12):  scores 20,480 + A 9,216 + warp buffers 36,864 + V_cat tile
//             7,168 + rescale factors 512 = 74,240 B, two blocks an SM;
//             12,544 blocks at lite b64 (196 q tiles x 64), 49 key tiles each;
//   (4, 48):  20,480 + 9,216 + 36,864 + 25,600 + 512 = 92,672 B, two blocks
//             an SM; 3,136 blocks at b64 N 784;
//   (4, 192): 20,480 + A 33,792 + max(warp buffers 61,440, V_cat chunks
//             139,264) = 193,536 B; 832 blocks at b64 N 196.
// cudaErrorInvalidValue for any other shape.
template <bool MIX>
int forward_tc(const void* q, const void* k, const void* v, const int64_t* seed, int thr,
               float scale, float* lse, void* onorm, const Outs& o, int batch, int heads,
               int nq, int nk, int dh, cudaStream_t stream) {
#define VIT_BNFWD_LSE(...) \
  (own_lse(MIX, nk) ? 0 : vit_tc::launch_lse<vit_tc::Cfg<__VA_ARGS__>>(q, k, lse, batch, nq, nk, stream))
#define VIT_BNFWD(...) \
  launch<Cfg<__VA_ARGS__>>(q, k, v, seed, thr, scale, lse, onorm, o, batch, nq, nk, stream)
  int rc = static_cast<int>(cudaErrorInvalidValue);
  if (heads == 8 && dh == 24) {
    rc = VIT_BNFWD_LSE(8, 24, 32, 32, 8, 2, 2);
    return rc ? rc : VIT_BNFWD(8, 24, 64, 192, MIX);
  }
  if (heads == 8 && dh == 96) {
    rc = VIT_BNFWD_LSE(8, 96, 32, 32, 8, 2, 1);
    return rc ? rc : VIT_BNFWD(8, 96, 256, 64, MIX);
  }
  if (heads == 8 && dh == 384) {
    rc = VIT_BNFWD_LSE(8, 384, 16, 32, 1, 3, 1);
    return rc ? rc : VIT_BNFWD(8, 384, 256, 64, MIX);
  }
  if constexpr (!MIX) {
    // the register form takes the log-sum-exp in the sweep: no pass before
    if (heads == 4 && dh == 12) return VIT_BNFWD(4, 12, 64, 48, false, 16, 2, true);
    if (heads == 4 && dh == 48) return VIT_BNFWD(4, 48, 64, 192, false, 16, 2, true);
    if (heads == 4 && dh == 192) {
      rc = VIT_BNFWD_LSE(4, 192, 16, 32, 2, 2, 2);
      return rc ? rc : VIT_BNFWD(4, 192, 256, 128, false, 32, 1);
    }
  }
  return rc;
#undef VIT_BNFWD_LSE
#undef VIT_BNFWD
}

// Exact BN: lse, o_norm, S and C.
inline int bn_fwd_tc(const void* q, const void* k, const void* v, const int64_t* seed, int thr,
                     float scale, float* lse, void* onorm, float* srow, float* crow, int batch,
                     int heads, int nq, int nk, int dh, cudaStream_t stream) {
  return forward_tc<false>(q, k, v, seed, thr, scale, lse, onorm,
                           Outs{srow, crow, nullptr, nullptr, nullptr, nullptr}, batch, heads,
                           nq, nk, dh, stream);
}

// Frozen BN: lse, o_norm and the mixed out.
inline int train_fwd_tc(const void* q, const void* k, const void* v, const float* vsum,
                        const float* m_eff, const float* c_eff, const int64_t* seed, int thr,
                        float scale, float* lse, void* onorm, void* out, int batch, int heads,
                        int nq, int nk, int dh, cudaStream_t stream) {
  return forward_tc<true>(q, k, v, seed, thr, scale, lse, onorm,
                          Outs{nullptr, nullptr, vsum, m_eff, c_eff, out}, batch, heads, nq,
                          nk, dh, stream);
}

}  // namespace vit_bnfwd
