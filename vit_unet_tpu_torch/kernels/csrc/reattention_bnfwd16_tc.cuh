// Training forwards of flash re-attention at 16 heads on Hopper's tensor
// cores: the bfloat16 routes of vit_bn_fwd (exact BN) and vit_train_fwd
// (frozen BN) in flash_reattention_train.cu at the classifier's two classes,
// (16, 12) (its N = 784 level) and (16, 48) (its N = 196 level).
//
// Replaces the Pallas TPU kernels of vit_unet_tpu/kernels/flash_reattention_train.py
// ::_bn_fwd (pallas_call body _bn_fwd_kernel) and ::_fwd (body _fwd_kernel)
// there.  With P_h the pre-dropout softmax of q_h k_h^T and A_h = P_h * mask_h:
//
//   lse[b,h,n]      = log sum_m exp(q_h[n] . k_h[m])       f32, pre-dropout
//   o_norm[b,h,n,:] = A_h[n,:] @ V_cat                     bf16, all P = H dh columns
// exact BN (_bn_fwd) also
//   S[b,h,n]        = sum_m A_h[n,m]                       f32
//   C[b,h2,h3,n]    = sum_m A_h2[n,m] A_h3[n,m]            f32, symmetric
// frozen BN (_fwd, Cfg::MIX) instead the TPU epilogue's head mix
//   out[b,n,j]      = sum_h2 M[head(j),h2] o_norm[b,h2,n,j] + c[head(j)] vsum[b,j]
//                                                          bf16, from f32 o_norm
//
// Why not the 8-head sweep (reattention_bnfwd_tc.cuh).  It keeps a block's
// 16 rows of o_norm in registers, one warp a head (16 x P f32: 96 a thread
// at P = 192), and a thread's S and C sums of its row (C's upper triangle:
// 36 at 8 heads).  At 16 heads the first is 192 registers a thread and the
// second 136.
//
// Design.  A block of 8 warps owns BQ = 8 query rows of one image and all 16
// heads; warp w takes heads 2w and 2w + 1.  Half the 8-head block's rows keep
// o_norm at 96 registers a thread: warp w's 16 MMA rows are the 8 rows of
// head 2w and the 8 of head 2w + 1, which multiply the same V_cat tile.  Per
// key tile of KT = 64 keys (one Philox window):
//   1. warp w, head h = 2w, 2w + 1: S_h^T (64 keys x 8 rows) = K_h q_h^T by
//      mma.sync m16n8k16 (bf16 in, f32 accumulate, fragments by ldmatrix),
//      keys as the M dimension so that the 8 rows fill one n8 tile;
//   2. in those fragments: A_h = exp(s - lse_h) * mask on valid keys, f32.
//      A lane holds keys g and g + 8 of each 16-key step for rows 2t and
//      2t + 1, that is Philox groups g and g + 8 of the window with their
//      four words, one a step: 4 calls a head and tile, every word used.  A
//      goes to shared memory as bf16 hi = bf16(A), [head][row][key]; exact
//      BN also sums S from the f32 A in registers and keeps lo = bf16(A - hi);
//   3. warp w: o_norm += A_hi V_cat for its two heads (A rounded to bf16
//      once, as the TPU kernel's p.astype(v.dtype)), V fragments by
//      ldmatrix.trans; exact BN, for query row w, C_w += A_w A_w^T where A_w
//      is the row's 16 heads x 64 keys, taken as hi hi^T + hi lo^T + lo hi^T
//      by mma.sync (8 f32 accumulators a thread; one ldmatrix gives a 16-key
//      step's A and both B fragments).
// Why hi + lo for C.  C's 136 products an entry do not fit a thread's
// registers in f32, and the BN variance w^T C w / cnt - dev^2 is a
// difference of sums, where one bf16 rounding of A (2^-9) would cost digits;
// the pair carries 16 significant bits (lo lo, 2^-18 of A^2, is left out).
// S and C thus come from the f32 probabilities, as the TPU kernel's p_tiles
// are f32, to within 2^-17.  The frozen forward compiles S, C and lo out.
//
// Two forms, by the width P = H dh of o_norm:
//   * (16, 12), P = 192, the register form: o_norm stays in registers over
//     all keys.  Per key tile, K of all heads and the V_cat tile come through
//     a two-buffer cp.async ring (the next tile loads during this one), dh 12
//     in 8-byte copies zero-padded to one k-step of 16; steps 1-3 run per
//     tile, two barriers a tile.  The sweep takes the log-sum-exp itself
//     (Cfg::ONLINE, see reg_kernel): at the classifier's b64, rate 0.2, the
//     frozen forward 3.117 ms a call against 3.593 with kernel 1's pass
//     first, the exact one 3.649 against 3.952 (tools/torch_fwd_variants.py
//     --head16, variant twopass16; H100 80GB HBM3, 700 W).
//   * (16, 48), P = 768, the chunked form: a register o_norm would be 384
//     registers a thread.  Steps 1-2 run once over all keys, keeping A of up
//     to KC = 256 keys in shared memory (exact BN takes C per key tile
//     there, from the tile's lo, two buffers); then step 3 runs per column
//     chunk of PC = 192 (96 registers), V_cat's 64-key tiles of the chunk
//     through a two-buffer ring whose next tile (of the next chunk too)
//     loads during this one.  A K stage of all heads at dh 48 (16 x 64 x 56
//     bf16, 114,688 B) does not fit twice beside A, so each warp stages its
//     own two heads' K in depth chunks of 16 (2 x 64 x 24 bf16) through two
//     buffers, the next chunk loading during this one's product, with
//     __syncwarp only; q is staged once and kept as fragments.  With more
//     than KC keys A is recomputed per column chunk (its Philox bits too):
//     the route is chosen by shape alone, and sequence-parallel shard calls
//     are rectangular.
// The frozen forward's mix (per column chunk in the chunked form): each warp
// leaves its f32 accumulators of its two heads in an exchange, [head][row]
// [PC + 8] f32 (102,400 B), and after a barrier each thread forms out for
// 4 columns of a row at a time from all 16 heads, M, c and the image's
// vsum staged beside; o_norm is written in bf16 from the same exchange.  Exact BN writes o_norm
// through a bf16 stage of the same layout in 16-byte row copies, and S and C
// with each (head) and (head pair) plane's 8 rows together.
// Ragged edges: every copy zero-fills rows past Nq and Nk (src-size 0); keys
// past Nk get A = 0, and step 3 skips the k16 steps with no valid key; rows
// past Nq get lse = +inf, so A = 0 (with the log-sum-exp in the sweep they
// take their zero q's own), and write nothing.
//
// At (16, 48) the log-sum-exp pass comes first: kernel 1's tensor-core
// pass (reattention_tc.cuh::lse_kernel) at the same class, 0.151 ms of the
// call at the classifier's b64.
//
// Shared memory, one block an SM:
//   (16, 12): q 6,144 + two stages of K 49,152 and V_cat 25,600 + A hi 18,688
//     + (exact) lo 18,688 and the rescale factors 512 = 193,536 B, or
//     (frozen) M, c and vsum 1,856 = 176,192 B; the exchange lies over the
//     ring, free after the last tile; 6,272 blocks at the classifier's b64,
//     N 784 (98 q tiles x 64), 13 key tiles each;
//   (16, 48): A hi of 256 keys 67,840 + (exact) two lo tiles 37,376 + a
//     body where steps 1-2 use the warps' K buffers 98,304 and the q stage
//     14,336, and step 3 the V_cat ring 51,200 and the o_norm stage 51,200
//     (exact) or the exchange 102,400 (frozen) = 217,856 B exact, 225,600 B
//     frozen (M, c and vsum 4,160 B); 1,600 blocks at b64, N 196 (25 q
//     tiles x 64), 4 key tiles and 4 column chunks each.
// ptxas (sm_90a), registers a thread, no spill: reg_kernel frozen 230,
// exact 254; chunk_kernel frozen 238, exact 255.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "reattention_common.cuh"
#include "reattention_mma.cuh"
#include "reattention_tc.cuh"
#include "reattention_tiles.cuh"

namespace vit_bnfwd16 {

using vit_mma::ldsm_x2;
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
constexpr int H = 16;
constexpr int BQ = 8;              // query rows per block
constexpr int KT = 64;             // keys of a tile: one Philox window
constexpr int PC = 192;            // o_norm columns a block holds at a time
constexpr int LDV = PC + 8;        // bf16 pitch of V_cat tile rows and of the o_norm stage
constexpr int LDX = PC + 8;        // f32 pitch of the mix's exchange
constexpr int NVT = PC / 8;        // 8-column tiles of a warp's o_norm
constexpr int V_ELEMS = KT * LDV;
constexpr int O_ELEMS = H * BQ * LDV;
constexpr int X_FLOATS = H * BQ * LDX;
constexpr int MC_FLOATS = H * H + H;                // M and c, then vsum[b]
constexpr int NMIX = (BQ * PC / 4 + NT - 1) / NT;   // column quads a thread mixes
constexpr int SC_FLOATS = (H + H * H) * BQ;         // the S and C stage
static_assert(H == 2 * NW && BQ == NW, "warp w: heads 2w, 2w + 1 and C's row w");

// DH_: 12 (the register form) or 48 (the chunked form); MIX_: the frozen
// forward (head mix into out, no S and C), else exact BN; ONLINE_: the
// register form takes the log-sum-exp in the sweep (no log-sum-exp pass).
template <int DH_, bool MIX_, bool ONLINE_ = false>
struct Cfg {
  static constexpr int DH = DH_, P = H * DH;
  static constexpr bool MIX = MIX_, ONLINE = ONLINE_;
  static constexpr bool RES = P == PC;              // o_norm stays in registers
  static constexpr int NCC = P / PC;                // column chunks
  static constexpr int NKS = (DH + 15) / 16;        // k16 steps of the score product
  static constexpr int KC = RES ? KT : 256;         // keys of A in shared memory
  static constexpr int LDA = KC + 8;                // bf16 pitch of an A row
  static constexpr int HSA = BQ * LDA + 8;          // bf16 between heads: C's rows are heads
  static constexpr int A_ELEMS = H * HSA;
  // the register form: q and K rows (depth zero-padded to 16), the ring
  static constexpr int LDK = 24;
  static constexpr int CPR = DH / 4;                // 8-byte copies a q or K row
  static constexpr int Q_ELEMS = H * BQ * LDK;
  static constexpr int K_ELEMS = H * KT * LDK;
  static constexpr int STAGE_ELEMS = K_ELEMS + V_ELEMS;
  // the chunked form: a key tile's lo, a warp's K buffers (two heads, depth
  // chunk 16), the q stage
  static constexpr int LDT = KT + 8;
  static constexpr int HST = BQ * LDT + 8;
  static constexpr int T_ELEMS = H * HST;
  static constexpr int LDC = 24;
  static constexpr int WST = 2 * KT * LDC;
  static constexpr int LDQ = DH + 8;
  static constexpr size_t K_BYTES = sizeof(bf16) * NW * 2 * WST;
  static constexpr size_t Q_BYTES = sizeof(bf16) * H * BQ * LDQ;
  static constexpr size_t V_BYTES = sizeof(bf16) * 2 * V_ELEMS;
  static constexpr size_t O_BYTES = MIX ? sizeof(float) * X_FLOATS : sizeof(bf16) * O_ELEMS;
  static constexpr size_t BODY =
      K_BYTES + Q_BYTES > V_BYTES + O_BYTES ? K_BYTES + Q_BYTES : V_BYTES + O_BYTES;
  static constexpr size_t A_BYTES = sizeof(bf16) * A_ELEMS;
  static constexpr size_t LO_BYTES = MIX ? 0 : sizeof(bf16) * (RES ? A_ELEMS : 2 * T_ELEMS);
  // frozen BN stages M, c and the image's vsum; exact BN with ONLINE keeps
  // each (head, row)'s rescale factor of the tile, and at the end 1 / l
  static constexpr size_t MC_BYTES = MIX ? sizeof(float) * (MC_FLOATS + P) : 0;
  static constexpr size_t AL_BYTES = ONLINE && !MIX ? sizeof(float) * H * BQ : 0;
  static constexpr size_t RING_BYTES = sizeof(bf16) * 2 * STAGE_ELEMS;
  static constexpr size_t SMEM =
      RES ? sizeof(bf16) * Q_ELEMS + RING_BYTES + A_BYTES + LO_BYTES + MC_BYTES + AL_BYTES
          : A_BYTES + LO_BYTES + BODY + MC_BYTES;
  static_assert(!ONLINE || RES, "the online log-sum-exp: the register form");
  static_assert(DH % 4 == 0 && (RES ? DH <= 16 : DH % 16 == 0), "the score product's k-steps");
  static_assert(P % PC == 0 && (RES || NCC > 1), "the forms");
  static_assert(!RES || (sizeof(bf16) * O_ELEMS <= RING_BYTES &&
                         sizeof(float) * X_FLOATS <= RING_BYTES),
                "the o_norm stage and the exchange fit the ring");
  static_assert(MIX || sizeof(float) * SC_FLOATS <= (RES ? A_BYTES + LO_BYTES : A_BYTES),
                "the S and C stage fits the A tiles");
  static_assert(A_BYTES % 16 == 0 && LO_BYTES % 16 == 0 && BODY % 16 == 0 &&
                    K_BYTES % 16 == 0 && V_BYTES % 16 == 0 && RING_BYTES % 16 == 0 &&
                    HSA % 8 == 0 && LDA % 8 == 0 && HST % 8 == 0 && (RES || LDQ % 8 == 0),
                "16-byte alignment of the regions and rows");
  static_assert(SMEM <= 232448, "shared memory of a block");
};

// The keep bits of this lane's entries of head h in the key tile at k0: bit
// 4 (2 j + i) + mt for row q0 + 2 t4 + i, key k0 + 16 mt + g + 8 j; all kept
// without dropout; rows past Nq, which write nothing, draw nothing.
__device__ __forceinline__ uint32_t keep_bits(uint64_t sd, int thr, int b, int h, int q0,
                                              int t4, int g, int k0, int nq) {
  if (thr <= 0) return 0xFFFFu;
  uint32_t keep = 0;
  const uint32_t th = static_cast<uint32_t>(thr);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + 2 * t4 + i;
    if (row >= nq) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const uint4 w = vit::philox4(sd, b, h, row, (k0 >> 2) + g + 8 * j);
      keep |= (((w.x >> 8) >= th ? 1u : 0u) | ((w.y >> 8) >= th ? 2u : 0u) |
               ((w.z >> 8) >= th ? 4u : 0u) | ((w.w >> 8) >= th ? 8u : 0u))
              << (4 * (2 * j + i));
    }
  }
  return keep;
}

// Step 2 for one head from its score fragments s (s[mt][e]: key 16 mt + g +
// 8 (e / 2) of the tile at k0, row 2 t4 + e % 2): A to hi[row * LDH + key]
// as bf16; with LO and sc, lo[row * LDL + key] = bf16(A - hi) and the row
// sums of the f32 A in sacc.  l2: lse * log2(e) of the lane's two rows (or
// their running max); with PSUM the pre-dropout probabilities' sums of the
// lane's keys are added to psum[0 .. 1].
template <int LDH, int LDL, bool LO, bool PSUM = false>
__device__ __forceinline__ void store_probs(const float (&s)[4][4], uint32_t keep,
                                            const float (&l2)[2], int k0, int nk, float ks,
                                            int t4, int g, bf16* hi, bf16* lo, bool sc,
                                            float (&sacc)[2], float* psum = nullptr) {
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e % 2, j = e / 2, key = 16 * mt + g + 8 * j;
      const float p = k0 + key < nk ? fast_exp2(fmaf(s[mt][e], LOG2E, -l2[i])) : 0.f;
      if constexpr (PSUM) psum[i] += p;
      const float a = (keep >> (4 * (2 * j + i) + mt)) & 1u ? p * ks : 0.f;
      const bf16 h16 = __float2bfloat16_rn(a);
      hi[(2 * t4 + i) * LDH + key] = h16;
      if constexpr (LO) {
        if (sc) {
          sacc[i] += a;
          lo[(2 * t4 + i) * LDL + key] = __float2bfloat16_rn(a - __bfloat162float(h16));
        }
      }
    }
}

// The online log-sum-exp's step for one head and key tile (the register
// form with C::ONLINE): the max of the lane's two rows' valid scores in the
// tile, over the row's 8 lanes (g = lane / 4), in log2 units; m2, the rows'
// running max, moves to it where it is larger, and al is the factor
// 2^(m2_old - m2_new) the rows' sums take (0 on the first tile: m2 starts
// at -inf).  Key k0 of the tile is valid, so every max is finite.
__device__ __forceinline__ void online_max(const float (&s)[4][4], int k0, int nk, int g,
                                           float (&m2)[2], float (&al)[2]) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (k0 + 16 * mt + g + 8 * (e / 2) < nk) mx[e % 2] = fmaxf(mx[e % 2], s[mt][e]);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 4));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 8));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 16));
    const float mn = fmaxf(m2[i], mx[i] * LOG2E);
    al[i] = fast_exp2(m2[i] - mn);
    m2[i] = mn;
  }
}

// acc (warp w's 16 MMA rows: head 2w + e / 2, row g) *= f of that head and
// row, where f[hl][i] of rows 2 t4 + i is held by the lanes of that t4 (the
// lane (0, g / 2) gives it).
__device__ __forceinline__ void scale_acc_rows(float (&acc)[NVT][4], const float (&f)[2][2],
                                               int lane) {
  const int g = lane / 4;
  float r[2];
#pragma unroll
  for (int hl = 0; hl < 2; ++hl) {
    const float f0 = __shfl_sync(0xffffffffu, f[hl][0], g / 2);
    const float f1 = __shfl_sync(0xffffffffu, f[hl][1], g / 2);
    r[hl] = g % 2 ? f1 : f0;
  }
#pragma unroll
  for (int nv = 0; nv < NVT; ++nv) {
    acc[nv][0] *= r[0];
    acc[nv][1] *= r[0];
    acc[nv][2] *= r[1];
    acc[nv][3] *= r[1];
  }
}

// C of query row w (cacc[nt][e]: heads h2 = g + 8 (e / 2), h3 = 8 nt + 2 t4 +
// e % 2) *= f[h2][w] f[h3][w], f [H][BQ] in shared memory.
__device__ __forceinline__ void scale_c(float (&cacc)[2][4], const float* f, int warp, int lane) {
  const int g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      cacc[nt][e] *= f[(g + 8 * (e / 2)) * BQ + warp] * f[(8 * nt + 2 * t4 + e % 2) * BQ + warp];
}

// Step 3, one k16 step kk: warp w's o_norm (heads 2w, 2w + 1 x 8 rows; the
// PC columns of the V_cat tile vt) += A (keys acol + 16 kk .. of heads 2w,
// 2w + 1) @ those keys' rows of vt.
template <int LDA, int HSA>
__device__ __forceinline__ void product_step(const bf16* a_hi, int acol, const bf16* vt, int kk,
                                             int warp, int lane, float (&acc)[NVT][4]) {
  uint32_t af[4];
  ldsm_x4(af, a_hi + (2 * warp + (lane / 8) % 2) * HSA + (lane % 8) * LDA + 8 * (lane / 16) +
                  acol + 16 * kk);
  const bf16* vrow = vt + (16 * kk + (lane % 8) + 8 * ((lane / 8) % 2)) * LDV + 8 * (lane / 16);
#pragma unroll
  for (int nv = 0; nv < NVT; nv += 2) {
    uint32_t vf[4];   // b0, b1 of column tile nv, then of nv + 1
    ldsm_x4_trans(vf, vrow + 8 * nv);
    mma_bf16(acc[nv], af, vf[0], vf[1]);
    mma_bf16(acc[nv + 1], af, vf[2], vf[3]);
  }
}

// C of query row w += A_w A_w^T over k16 step kk, A_w the row's 16 heads x
// keys (hi at hi + head * HSH + w * LDH + key, lo likewise): hi hi^T +
// hi lo^T + lo hi^T.  x[0..3]: heads 0-7 / 8-15 (rows) x keys 0-7, then
// 8-15: the A fragment of A_w, and the B fragments of A_w^T (n tile 0: x0,
// x2; n tile 1: x1, x3).
template <int LDH, int HSH, int LDL, int HSL>
__device__ __forceinline__ void c_step(const bf16* hi, const bf16* lo, int kk, int warp, int lane,
                                       float (&cacc)[2][4]) {
  const int r = (lane % 8) + 8 * ((lane / 8) % 2), c = 8 * (lane / 16) + 16 * kk;
  uint32_t xh[4], xl[4];
  ldsm_x4(xh, hi + r * HSH + warp * LDH + c);
  ldsm_x4(xl, lo + r * HSL + warp * LDL + c);
  mma_bf16(cacc[0], xh, xh[0], xh[2]);
  mma_bf16(cacc[1], xh, xh[1], xh[3]);
  mma_bf16(cacc[0], xh, xl[0], xl[2]);
  mma_bf16(cacc[1], xh, xl[1], xl[3]);
  mma_bf16(cacc[0], xl, xh[0], xh[2]);
  mma_bf16(cacc[1], xl, xh[1], xh[3]);
}

__device__ __forceinline__ void zero_acc(float (&acc)[NVT][4]) {
#pragma unroll
  for (int nv = 0; nv < NVT; ++nv)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nv][e] = 0.f;
}

// Exact BN: warp w's accumulators (row 16 w + g + 8 r of the stage, that is
// head 2w + r, row g) to the bf16 o_norm stage [H][BQ][LDV]; after a barrier
// the block copies columns c0 .. c0 + PC of its rows out in 16-byte pieces.
__device__ __forceinline__ void stage_onorm(const float (&acc)[NVT][4], bf16* os, int warp,
                                            int lane) {
  const int g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int nv = 0; nv < NVT; ++nv)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<uint32_t*>(os + (16 * warp + g + 8 * r) * LDV + 8 * nv + 2 * t4) =
          pack_bf16(acc[nv][2 * r], acc[nv][2 * r + 1]);
}

template <int P>
__device__ __forceinline__ void copy_onorm(const bf16* os, bf16* onorm, int b, int q0, int c0,
                                           int nq, int tid) {
  const int nrows = min(BQ, nq - q0);
  for (int c = tid; c < H * BQ * (PC / 8); c += NT) {
    const int j = c % (PC / 8), rr = c / (PC / 8), h = rr / BQ, r = rr % BQ;
    if (r < nrows)
      *reinterpret_cast<uint4*>(onorm + (((int64_t)b * H + h) * nq + q0 + r) * P + c0 + 8 * j) =
          *reinterpret_cast<const uint4*>(os + rr * LDV + 8 * j);
  }
}

// Frozen BN: M, c and vsum[b] into mc, [H][H], [H], [P].
template <int P>
__device__ __forceinline__ void stage_mix(float* mc, const float* m_eff, const float* c_eff,
                                          const float* vsum, int b, int tid) {
  for (int i = tid; i < MC_FLOATS + P; i += NT)
    mc[i] = i < H * H       ? m_eff[i]
            : i < MC_FLOATS ? c_eff[i - H * H]
                            : vsum[(int64_t)b * P + i - MC_FLOATS];
}

// Frozen BN: warp w's f32 accumulators to the exchange [H][BQ][LDX] (the
// o_norm stage's layout); xs must be free for every warp.  A barrier, then
// o_norm (bf16) and
//   out[b, n, j] = sum_h2 M[head(j), h2] o_norm[b, h2, n, j] + c[head(j)] vsum[b, j]
// for columns c0 .. c0 + PC, both from the f32 exchange, M, c and vsum
// staged in mc.  xs is read until the call returns.
template <int DH>
__device__ __forceinline__ void mix_out(const float (&acc)[NVT][4], float* xs, const float* mc,
                                        bf16* onorm, bf16* out, int b, int q0, int c0, int nq,
                                        int warp, int lane, int tid) {
  constexpr int P = H * DH, NQD = PC / 4;   // column quads of a row
  const int g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int nv = 0; nv < NVT; ++nv)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<float2*>(xs + (16 * warp + g + 8 * r) * LDX + 8 * nv + 2 * t4) =
          make_float2(acc[nv][2 * r], acc[nv][2 * r + 1]);
  __syncthreads();   // every head's accumulators are in
  const int nrows = min(BQ, nq - q0);
  for (int c = tid; c < H * BQ * (PC / 8); c += NT) {
    const int j = c % (PC / 8), rr = c / (PC / 8), h = rr / BQ, r = rr % BQ;
    if (r >= nrows) continue;
    const float4 x0 = *reinterpret_cast<const float4*>(xs + rr * LDX + 8 * j);
    const float4 x1 = *reinterpret_cast<const float4*>(xs + rr * LDX + 8 * j + 4);
    *reinterpret_cast<uint4*>(onorm + (((int64_t)b * H + h) * nq + q0 + r) * P + c0 + 8 * j) =
        make_uint4(pack_bf16(x0.x, x0.y), pack_bf16(x0.z, x0.w), pack_bf16(x1.x, x1.y),
                   pack_bf16(x1.z, x1.w));
  }
#pragma unroll
  for (int i = 0; i < NMIX; ++i) {
    const int e = tid + NT * i, r = e / NQD, j = 4 * (e % NQD);
    if (r >= nrows) continue;
    const int col = c0 + j, hp = col / DH;
    const float cp = mc[H * H + hp];
    const float4 vs = *reinterpret_cast<const float4*>(mc + MC_FLOATS + col);
    float x[4] = {cp * vs.x, cp * vs.y, cp * vs.z, cp * vs.w};
#pragma unroll
    for (int h2 = 0; h2 < H; ++h2) {
      const float4 o = *reinterpret_cast<const float4*>(xs + (h2 * BQ + r) * LDX + j);
      const float w = mc[hp * H + h2];
      x[0] = fmaf(w, o.x, x[0]);
      x[1] = fmaf(w, o.y, x[1]);
      x[2] = fmaf(w, o.z, x[2]);
      x[3] = fmaf(w, o.w, x[3]);
    }
    *reinterpret_cast<uint2*>(out + ((int64_t)b * nq + q0 + r) * P + col) =
        make_uint2(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]));
  }
}

// Exact BN: S (reduced over the lanes of a t4, g = lane / 4) and C (the
// row's 16 x 16, upper triangle mirrored) to the stage ss (SC_FLOATS f32,
// free for every warp), a barrier, then each (head) and (head pair) plane's
// rows out: two 16-byte stores where the rows are 16-byte aligned.
__device__ __forceinline__ void store_sc(float (&sacc)[2][2], const float (&cacc)[2][4],
                                         float* ss, float* srow, float* crow, int b, int q0,
                                         int nq, int warp, int lane, int tid) {
  const int g = lane / 4, t4 = lane % 4;
  float* cs = ss + H * BQ;   // [H][H][BQ] after [H][BQ]
#pragma unroll
  for (int hl = 0; hl < 2; ++hl)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float x = sacc[hl][i];
      x += __shfl_xor_sync(0xffffffffu, x, 4);
      x += __shfl_xor_sync(0xffffffffu, x, 8);
      x += __shfl_xor_sync(0xffffffffu, x, 16);
      if (g == 0) ss[(2 * warp + hl) * BQ + 2 * t4 + i] = x;
    }
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h2 = g + 8 * (e / 2), h3 = 8 * nt + 2 * t4 + e % 2;
      if (h2 <= h3) {   // the upper triangle's sums, mirrored
        cs[(h2 * H + h3) * BQ + warp] = cacc[nt][e];
        cs[(h3 * H + h2) * BQ + warp] = cacc[nt][e];
      }
    }
  __syncthreads();
  const int nrows = min(BQ, nq - q0);
  const bool vec = nrows == BQ && nq % 4 == 0;
  for (int c = tid; c < (H + H * H) * BQ; c += NT) {
    const int plane = c / BQ, r = c % BQ;
    float* dst = plane < H ? srow + ((int64_t)b * H + plane) * nq
                           : crow + ((int64_t)b * H * H + plane - H) * nq;
    if (vec) {
      if (r % 4 == 0)
        *reinterpret_cast<float4*>(dst + q0 + r) = *reinterpret_cast<const float4*>(ss + plane * BQ + r);
    } else if (r < nrows) {
      dst[q0 + r] = ss[plane * BQ + r];
    }
  }
}

// this lane's rows q0 + 2 t4 + i of heads 2w, 2w + 1: lse * log2(e), +inf
// past Nq (so A = 0 there)
__device__ __forceinline__ void load_lse2(float (&lse2)[2][2], const float* lse, int b, int q0,
                                          int nq, int warp, int t4) {
#pragma unroll
  for (int hl = 0; hl < 2; ++hl)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + 2 * t4 + i;
      lse2[hl][i] = row < nq ? lse[((int64_t)b * H + 2 * warp + hl) * nq + row] * LOG2E : INFINITY;
    }
}

// The register form, (16, 12).  Grid (q tiles of 8, B).  lse from the
// log-sum-exp pass, or with C::ONLINE written here; exact BN writes o_norm,
// srow (B, H, Nq) and crow (B, H, H, Nq); frozen BN (C::MIX) reads vsum,
// m_eff, c_eff and writes o_norm and out.  The other mode's pointers are
// not read.
//
// C::ONLINE, as the TPU kernel's own sweep keeps m_s, l_s and alpha: per
// tile and head, each row's running max m2 of the scores (online_max), A
// relative to it (rounded to bf16 unnormalised: the same relative error),
// and the pre-dropout normaliser l, S, C and o_norm rescaled by 2^(m2_old -
// m2_new) when it moves; at the end o_norm, S and C are divided by l (the
// frozen forward before its exchange, so the mix takes the normalised f32
// o_norm) and lse = (m2 + log2 l) ln 2.  Dropout does not enter l.  A row's
// o_norm is rescaled in the warp that holds it; C's rows are all heads of
// a query row, so exact BN leaves the factors in shared memory.
template <typename C>
__global__ void __launch_bounds__(NT, 1) reg_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    float* __restrict__ lse, const int64_t* __restrict__ seed, int thr, float scale,
    bf16* __restrict__ onorm, float* __restrict__ srow, float* __restrict__ crow,
    const float* __restrict__ vsum, const float* __restrict__ m_eff,
    const float* __restrict__ c_eff, bf16* __restrict__ out, int nq, int nk) {
  constexpr int DH = C::DH, P = C::P, LDK = C::LDK, CPR = C::CPR, LDA = C::LDA, HSA = C::HSA;
  extern __shared__ __align__(128) unsigned char b16_smem[];
  bf16* qs = reinterpret_cast<bf16*>(b16_smem);   // [H][BQ][LDK]
  bf16* ring = qs + C::Q_ELEMS;                    // [2][K: H][KT][LDK, V_cat: KT][LDV]
  bf16* a_hi = ring + 2 * C::STAGE_ELEMS;          // [H][BQ][LDA], heads HSA apart
  bf16* a_lo = a_hi + C::A_ELEMS;                  // exact BN
  // frozen BN: M, c, vsum[b]; exact BN with C::ONLINE: [H][BQ] factors
  [[maybe_unused]] float* mc = reinterpret_cast<float*>(a_hi + C::A_ELEMS);
  [[maybe_unused]] float* al_s = reinterpret_cast<float*>(a_lo + C::A_ELEMS);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int q0 = blockIdx.x * BQ, b = blockIdx.y;
  const uint64_t sd = thr > 0 ? static_cast<uint64_t>(seed[0]) : 0;
  const float ks = thr > 0 ? scale : 1.f;

  // the copies never write columns DH .. LDK of q and K rows, part of which
  // the score product reads
  vit_tile::zero_bf16<C::Q_ELEMS + 2 * C::STAGE_ELEMS>(qs, tid);
  if constexpr (C::MIX) stage_mix<P>(mc, m_eff, c_eff, vsum, b, tid);
  __syncthreads();
  for (int c = tid; c < H * BQ * CPR; c += NT) {
    const int j = c % CPR, r = (c / CPR) % BQ, h = c / (CPR * BQ);
    const bool valid = q0 + r < nq;
    const bf16* src = valid ? q + (((int64_t)b * H + h) * nq + q0 + r) * DH + 4 * j : q;
    cp_async<8>(qs + (h * BQ + r) * LDK + 4 * j, src, valid);
  }
  auto load_tile = [&](int t, bf16* dst) {
    for (int c = tid; c < H * KT * CPR; c += NT) {
      const int j = c % CPR, r = (c / CPR) % KT, h = c / (CPR * KT), key = t * KT + r;
      const bool valid = key < nk;
      const bf16* src = valid ? k + (((int64_t)b * H + h) * nk + key) * DH + 4 * j : k;
      cp_async<8>(dst + (h * KT + r) * LDK + 4 * j, src, valid);
    }
    bf16* vd = dst + C::K_ELEMS;
    for (int c = tid; c < KT * (P / 8); c += NT) {
      const int j = c % (P / 8), r = c / (P / 8), key = t * KT + r;
      const bool valid = key < nk;
      const bf16* src = valid ? v + ((int64_t)b * nk + key) * P + 8 * j : v;
      cp_async<16>(vd + r * LDV + 8 * j, src, valid);
    }
  };
  const int n_tiles = (nk + KT - 1) / KT;
  if (n_tiles > 0) load_tile(0, ring);
  cp_async_commit();   // the q tile joins tile 0's group

  // lse2: lse * log2(e) of the lane's rows, or with C::ONLINE their running
  // max; lsum: the lane's part of their pre-dropout normaliser
  float lse2[2][2], sacc[2][2] = {{0.f, 0.f}, {0.f, 0.f}}, acc[NVT][4];
  [[maybe_unused]] float lsum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  [[maybe_unused]] float cacc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  if constexpr (C::ONLINE)
    lse2[0][0] = lse2[0][1] = lse2[1][0] = lse2[1][1] = -INFINITY;
  else
    load_lse2(lse2, lse, b, q0, nq, warp, t4);
  zero_acc(acc);
  uint32_t qb[2][2];

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<0>();
    __syncthreads();   // tile t has landed; everyone is done with tile t - 1 and its A
    if (t == 0) {
#pragma unroll
      for (int hl = 0; hl < 2; ++hl)
        ldsm_x2(qb[hl], qs + ((2 * warp + hl) * BQ + (lane % 8)) * LDK + 8 * ((lane / 8) % 2));
    }
    if (t + 1 < n_tiles) load_tile(t + 1, ring + ((t + 1) & 1) * C::STAGE_ELEMS);
    cp_async_commit();
    const bf16* kt = ring + (t & 1) * C::STAGE_ELEMS;
    const bf16* vt = kt + C::K_ELEMS;
    const int k0 = t * KT;

    // steps 1-2, heads 2w and 2w + 1
    [[maybe_unused]] float al[2][2];
#pragma unroll
    for (int hl = 0; hl < 2; ++hl) {
      const int h = 2 * warp + hl;
      float s[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        uint32_t af[4];
        ldsm_x4(af, kt + (h * KT + 16 * mt + (lane % 8) + 8 * ((lane / 8) % 2)) * LDK +
                        8 * (lane / 16));
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][e] = 0.f;
        mma_bf16(s[mt], af, qb[hl][0], qb[hl][1]);
      }
      if constexpr (C::ONLINE) {
        online_max(s, k0, nk, g, lse2[hl], al[hl]);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          lsum[hl][i] *= al[hl][i];
          if constexpr (!C::MIX) {
            sacc[hl][i] *= al[hl][i];
            if (g == 0) al_s[h * BQ + 2 * t4 + i] = al[hl][i];
          }
        }
      }
      const uint32_t keep = keep_bits(sd, thr, b, h, q0, t4, g, k0, nq);
      store_probs<LDA, LDA, !C::MIX, C::ONLINE>(s, keep, lse2[hl], k0, nk, ks, t4, g,
                                                a_hi + h * HSA, a_lo + h * HSA, true, sacc[hl],
                                                lsum[hl]);
    }
    __syncthreads();   // A of every head is in (and the rescale factors)
    if constexpr (C::ONLINE) {
      scale_acc_rows(acc, al, lane);
      if constexpr (!C::MIX) scale_c(cacc, al_s, warp, lane);
    }

    // step 3: o_norm of heads 2w, 2w + 1, and (exact BN) C of row w
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      if (k0 + 16 * kk >= nk) break;   // A = 0 and V_cat = 0 there
      product_step<LDA, HSA>(a_hi, 0, vt, kk, warp, lane, acc);
      if constexpr (!C::MIX) c_step<LDA, HSA, LDA, HSA>(a_hi, a_lo, kk, warp, lane, cacc);
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring, the A tiles and the factors are free

  if constexpr (C::ONLINE) {
    // l of each (head, row) over the row's 8 lanes: lse, and 1 / l for
    // o_norm, S and (through shared memory) C
    float inv[2][2];
#pragma unroll
    for (int hl = 0; hl < 2; ++hl)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float l = lsum[hl][i];
        l += __shfl_xor_sync(0xffffffffu, l, 4);
        l += __shfl_xor_sync(0xffffffffu, l, 8);
        l += __shfl_xor_sync(0xffffffffu, l, 16);
        inv[hl][i] = 1.f / l;
        const int row = q0 + 2 * t4 + i;
        if (g == 0 && row < nq)
          lse[((int64_t)b * H + 2 * warp + hl) * nq + row] = (lse2[hl][i] + log2f(l)) / LOG2E;
        if constexpr (!C::MIX) {
          sacc[hl][i] *= inv[hl][i];
          if (g == 0) al_s[(2 * warp + hl) * BQ + 2 * t4 + i] = inv[hl][i];
        }
      }
    scale_acc_rows(acc, inv, lane);
    if constexpr (!C::MIX) {
      __syncthreads();
      scale_c(cacc, al_s, warp, lane);
    }
  }
  if constexpr (C::MIX) {
    mix_out<DH>(acc, reinterpret_cast<float*>(ring), mc, onorm, out, b, q0, 0, nq, warp, lane,
                tid);
  } else {
    stage_onorm(acc, ring, warp, lane);
    store_sc(sacc, cacc, reinterpret_cast<float*>(a_hi), srow, crow, b, q0, nq, warp, lane, tid);
    copy_onorm<P>(ring, onorm, b, q0, 0, nq, tid);
  }
}

// The chunked form, (16, 48).  Grid (q tiles of 8, B); the arguments as
// reg_kernel's, lse from the log-sum-exp pass.
template <typename C>
__global__ void __launch_bounds__(NT, 1) chunk_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    float* __restrict__ lse, const int64_t* __restrict__ seed, int thr, float scale,
    bf16* __restrict__ onorm, float* __restrict__ srow, float* __restrict__ crow,
    const float* __restrict__ vsum, const float* __restrict__ m_eff,
    const float* __restrict__ c_eff, bf16* __restrict__ out, int nq, int nk) {
  constexpr int DH = C::DH, P = C::P, NKS = C::NKS, LDA = C::LDA, HSA = C::HSA;
  constexpr int LDC = C::LDC, WST = C::WST, LDQ = C::LDQ, LDT = C::LDT, HST = C::HST;
  extern __shared__ __align__(128) unsigned char c16_smem[];
  bf16* a_hi = reinterpret_cast<bf16*>(c16_smem);   // [H][BQ][LDA]: A of a key chunk
  [[maybe_unused]] bf16* a_lo = a_hi + C::A_ELEMS;   // exact: [2][H][BQ][LDT], a tile's lo
  unsigned char* body = c16_smem + C::A_BYTES + C::LO_BYTES;
  bf16* kbuf = reinterpret_cast<bf16*>(body);        // steps 1-2: [NW][2][2 heads][KT][LDC]
  bf16* qst = reinterpret_cast<bf16*>(body + C::K_BYTES);   // [H][BQ][LDQ], at the start
  bf16* vring = reinterpret_cast<bf16*>(body);       // step 3: [2][KT][LDV]
  unsigned char* ostage = body + C::V_BYTES;         // the o_norm stage or the exchange
  // frozen: M, c, vsum[b]
  [[maybe_unused]] float* mc = reinterpret_cast<float*>(body + C::BODY);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int q0 = blockIdx.x * BQ, b = blockIdx.y;
  const uint64_t sd = thr > 0 ? static_cast<uint64_t>(seed[0]) : 0;
  const float ks = thr > 0 ? scale : 1.f;

  for (int c = tid; c < H * BQ * (DH / 8); c += NT) {
    const int j = c % (DH / 8), r = (c / (DH / 8)) % BQ, h = c / ((DH / 8) * BQ);
    const bool valid = q0 + r < nq;
    const bf16* src = valid ? q + (((int64_t)b * H + h) * nq + q0 + r) * DH + 8 * j : q;
    cp_async<16>(qst + (h * BQ + r) * LDQ + 8 * j, src, valid);
  }
  cp_async_commit();
  if constexpr (C::MIX) stage_mix<P>(mc, m_eff, c_eff, vsum, b, tid);
  float lse2[2][2], sacc[2][2] = {{0.f, 0.f}, {0.f, 0.f}}, acc[NVT][4];
  [[maybe_unused]] float cacc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  load_lse2(lse2, lse, b, q0, nq, warp, t4);
  zero_acc(acc);
  cp_async_wait<0>();
  __syncthreads();
  // q of heads 2w, 2w + 1 as B fragments, one pair a k16 step; the q stage
  // lies past the K buffers, and step 3 writes over it only after the
  // sweep's barriers
  uint32_t qb[2][NKS][2];
#pragma unroll
  for (int hl = 0; hl < 2; ++hl)
#pragma unroll
    for (int d = 0; d < NKS; ++d)
      ldsm_x2(qb[hl][d], qst + ((2 * warp + hl) * BQ + (lane % 8)) * LDQ + 8 * ((lane / 8) % 2) +
                             16 * d);

  // this warp's K stage (key tile t, depth chunk d): heads 2w, 2w + 1
  const bf16* kw = k + ((int64_t)b * H + 2 * warp) * nk * DH;
  bf16* wb = kbuf + warp * 2 * WST;
  auto load_k = [&](int t, int d, bf16* dst) {
    for (int e = lane; e < 2 * KT * 2; e += 32) {
      const int j = e % 2, r = (e / 2) % KT, hl = e / (2 * KT), key = t * KT + r;
      const bool valid = key < nk;
      const bf16* src = valid ? kw + ((int64_t)hl * nk + key) * DH + 16 * d + 8 * j : k;
      cp_async<16>(dst + (hl * KT + r) * LDC + 8 * j, src, valid);
    }
    cp_async_commit();
  };
  // Steps 1-2 over key tiles [t0, t1): A of tile t at column (t - t0) KT of
  // the A tiles; with sc, exact BN's S and C too.
  auto sweep = [&](int t0, int t1, bool sc) {
    load_k(t0, 0, wb);
    int st = 0;
    for (int t = t0; t < t1; ++t) {
      float s[2][4][4];
#pragma unroll
      for (int d = 0; d < NKS; ++d, ++st) {
        if (d + 1 < NKS || t + 1 < t1) {
          load_k(d + 1 < NKS ? t : t + 1, (d + 1) % NKS, wb + ((st + 1) & 1) * WST);
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncwarp();
        const bf16* buf = wb + (st & 1) * WST;
#pragma unroll
        for (int hl = 0; hl < 2; ++hl)
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) {
            uint32_t af[4];
            ldsm_x4(af, buf + (hl * KT + 16 * mt + (lane % 8) + 8 * ((lane / 8) % 2)) * LDC +
                            8 * (lane / 16));
            if (d == 0) {
#pragma unroll
              for (int e = 0; e < 4; ++e) s[hl][mt][e] = 0.f;
            }
            mma_bf16(s[hl][mt], af, qb[hl][d][0], qb[hl][d][1]);
          }
        __syncwarp();   // this buffer is refilled two stages on
      }
      const int k0 = t * KT, col = (t - t0) * KT;
      bf16* lo = a_lo + (t & 1) * C::T_ELEMS;
#pragma unroll
      for (int hl = 0; hl < 2; ++hl) {
        const int h = 2 * warp + hl;
        const uint32_t keep = keep_bits(sd, thr, b, h, q0, t4, g, k0, nq);
        store_probs<LDA, LDT, !C::MIX>(s[hl], keep, lse2[hl], k0, nk, ks, t4, g,
                                       a_hi + h * HSA + col, lo + h * HST, sc, sacc[hl]);
      }
      // A of tile t is in; every warp is done with the lo buffer it now
      // rewrites (its C products come before this barrier of tile t - 1)
      __syncthreads();
      if constexpr (!C::MIX) {
        if (sc) {
#pragma unroll
          for (int kk = 0; kk < KT / 16; ++kk) {
            if (k0 + 16 * kk >= nk) break;
            c_step<LDA, HSA, LDT, HST>(a_hi + col, lo, kk, warp, lane, cacc);
          }
        }
      }
    }
  };

  // V_cat rows of key tile t, columns of chunk ci, into a ring buffer
  auto load_v = [&](int ci, int t, bf16* dst) {
    for (int e = tid; e < KT * (PC / 8); e += NT) {
      const int j = e % (PC / 8), r = e / (PC / 8), key = t * KT + r;
      const bool valid = key < nk;
      const bf16* src = valid ? v + ((int64_t)b * nk + key) * P + ci * PC + 8 * j : v;
      cp_async<16>(dst + r * LDV + 8 * j, src, valid);
    }
  };
  const int n_tiles = (nk + KT - 1) / KT, n_kc = (nk + C::KC - 1) / C::KC;
  const bool once = n_kc == 1;   // A of all keys is computed once
  int gs = 0;                    // V_cat stages so far: the ring's buffer
  for (int ci = 0; ci < C::NCC; ++ci) {
    for (int kc = 0; kc < n_kc; ++kc) {
      const int t0 = kc * (C::KC / KT), t1 = min(t0 + C::KC / KT, n_tiles);
      if (ci == 0 || !once) {
        if (ci + kc > 0) __syncthreads();   // the ring, the stage and A are free
        sweep(t0, t1, ci == 0);
        load_v(ci, t0, vring + (gs & 1) * V_ELEMS);   // after the sweep's last barrier
        cp_async_commit();
      }
      for (int t = t0; t < t1; ++t, ++gs) {
        cp_async_wait<0>();
        __syncthreads();   // this tile's V_cat has landed; the other buffer is free
        if (t + 1 < t1)
          load_v(ci, t + 1, vring + ((gs + 1) & 1) * V_ELEMS);
        else if (once && ci + 1 < C::NCC)
          load_v(ci + 1, t0, vring + ((gs + 1) & 1) * V_ELEMS);
        cp_async_commit();
        const bf16* vt = vring + (gs & 1) * V_ELEMS;
#pragma unroll
        for (int kk = 0; kk < KT / 16; ++kk) {
          if (t * KT + 16 * kk >= nk) break;   // A = 0 and V_cat = 0 there
          product_step<LDA, HSA>(a_hi, (t - t0) * KT, vt, kk, warp, lane, acc);
        }
      }
    }
    // the stage was last read before this chunk's first barrier
    if constexpr (C::MIX) {
      mix_out<DH>(acc, reinterpret_cast<float*>(ostage), mc, onorm, out, b, q0, ci * PC, nq,
                  warp, lane, tid);
    } else {
      bf16* os = reinterpret_cast<bf16*>(ostage);
      stage_onorm(acc, os, warp, lane);
      __syncthreads();
      copy_onorm<P>(os, onorm, b, q0, ci * PC, nq, tid);
    }
    zero_acc(acc);
  }
  if constexpr (!C::MIX) {
    __syncthreads();   // every warp is done with the A tiles
    store_sc(sacc, cacc, reinterpret_cast<float*>(a_hi), srow, crow, b, q0, nq, warp, lane, tid);
  }
}

template <typename C>
int launch(const void* q, const void* k, const void* v, const int64_t* seed, int thr,
           float scale, float* lse, void* onorm, float* srow, float* crow,
           const float* vsum, const float* m_eff, const float* c_eff, void* out, int batch,
           int nq, int nk, cudaStream_t stream) {
#define VIT_BNFWD16_LAUNCH(KERNEL)                                                              \
  do {                                                                                          \
    cudaError_t err = cudaFuncSetAttribute(KERNEL<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, \
                                           static_cast<int>(C::SMEM));                          \
    if (err != cudaSuccess) return static_cast<int>(err);                                       \
    KERNEL<C><<<dim3((nq + BQ - 1) / BQ, batch), NT, C::SMEM, stream>>>(                        \
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),  \
        lse, seed, thr, scale, static_cast<bf16*>(onorm), srow, crow, vsum, m_eff, c_eff,       \
        static_cast<bf16*>(out), nq, nk);                                                       \
  } while (0)
  if constexpr (C::RES)
    VIT_BNFWD16_LAUNCH(reg_kernel);
  else
    VIT_BNFWD16_LAUNCH(chunk_kernel);
#undef VIT_BNFWD16_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

// (16, 12): the sweep alone, which takes the log-sum-exp itself; (16, 48):
// the log-sum-exp pass (kernel 1's configuration of the class), then the
// sweep.  cudaErrorInvalidValue for any other shape.
template <bool MIX>
int forward16_tc(const void* q, const void* k, const void* v, const int64_t* seed, int thr,
                 float scale, float* lse, void* onorm, float* srow, float* crow,
                 const float* vsum, const float* m_eff, const float* c_eff, void* out,
                 int batch, int heads, int nq, int nk, int dh, cudaStream_t stream) {
  if (heads != H) return static_cast<int>(cudaErrorInvalidValue);
  int rc;
  // the register form takes the log-sum-exp in the sweep: no pass before
  if (dh == 12)
    return launch<Cfg<12, MIX, true>>(q, k, v, seed, thr, scale, lse, onorm, srow, crow, vsum,
                                      m_eff, c_eff, out, batch, nq, nk, stream);
  if (dh == 48) {
    rc = vit_tc::launch_lse<vit_tc::Cfg<16, 48, 16, 64, 8, 2, 1>>(q, k, lse, batch, nq, nk,
                                                                   stream);
    return rc ? rc : launch<Cfg<48, MIX>>(q, k, v, seed, thr, scale, lse, onorm, srow, crow,
                                          vsum, m_eff, c_eff, out, batch, nq, nk, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Exact BN: lse, o_norm, S and C.
inline int bn_fwd16_tc(const void* q, const void* k, const void* v, const int64_t* seed, int thr,
                       float scale, float* lse, void* onorm, float* srow, float* crow, int batch,
                       int heads, int nq, int nk, int dh, cudaStream_t stream) {
  return forward16_tc<false>(q, k, v, seed, thr, scale, lse, onorm, srow, crow, nullptr, nullptr,
                             nullptr, nullptr, batch, heads, nq, nk, dh, stream);
}

// Frozen BN: lse, o_norm and the mixed out.
inline int train_fwd16_tc(const void* q, const void* k, const void* v, const float* vsum,
                          const float* m_eff, const float* c_eff, const int64_t* seed, int thr,
                          float scale, float* lse, void* onorm, void* out, int batch, int heads,
                          int nq, int nk, int dh, cudaStream_t stream) {
  return forward16_tc<true>(q, k, v, seed, thr, scale, lse, onorm, nullptr, nullptr, vsum, m_eff,
                            c_eff, out, batch, heads, nq, nk, dh, stream);
}

}  // namespace vit_bnfwd16
