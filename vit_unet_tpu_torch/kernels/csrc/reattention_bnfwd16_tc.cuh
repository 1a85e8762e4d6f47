// Exact-BN training forward of flash re-attention at 16 heads on Hopper's
// tensor cores: the bfloat16 route of vit_bn_fwd (flash_reattention_train.cu)
// at the classifier's (16, 12) class (its N = 784 level).
//
// Replaces the Pallas TPU kernel vit_unet_tpu/kernels/flash_reattention_train.py
// ::_bn_fwd (pallas_call body _bn_fwd_kernel) there.  The outputs are those
// of reattention_bnfwd_tc.cuh's exact-BN sweep: with P_h the pre-dropout
// softmax of q_h k_h^T and A_h = P_h * mask_h,
//
//   lse[b,h,n]      = log sum_m exp(q_h[n] . k_h[m])       f32 (the LSE pass)
//   o_norm[b,h,n,:] = A_h[n,:] @ V_cat                     bf16, all P = H dh columns
//   S[b,h,n]        = sum_m A_h[n,m]                       f32
//   C[b,h2,h3,n]    = sum_m A_h2[n,m] A_h3[n,m]            f32, symmetric
//
// Why not the 8-head sweep.  It keeps a block's 16 rows of o_norm in
// registers, one warp a head (16 x P f32: 96 a thread at P = 192), and a
// thread's S and C sums of its row (C's upper triangle: 36 at 8 heads).  At
// 16 heads the first is 192 registers a thread and the second 136.
//
// Design.  A block of 8 warps owns BQ = 8 query rows of one image and all 16
// heads; warp w takes heads 2w and 2w + 1.  Half the 8-head block's rows keep
// o_norm at 96 registers a thread: warp w's 16 MMA rows are the 8 rows of
// head 2w and the 8 of head 2w + 1, which multiply the same V_cat tile.  Per
// key tile of KT = 64 keys (one Philox window), K of all heads and the V_cat
// tile come through a two-buffer cp.async ring (the next tile loads during
// this one), two barriers a tile:
//   1. warp w, head h = 2w, 2w + 1: S_h^T (64 keys x 8 rows) = K_h q_h^T by
//      mma.sync m16n8k16 (bf16 in, f32 accumulate, fragments by ldmatrix;
//      dh 12 zero-padded to one k-step of 16), keys as the M dimension so
//      that the 8 rows fill one n8 tile;
//   2. in those fragments: A_h = exp(s - lse_h) * mask on valid keys, f32.
//      A lane holds keys g and g + 8 of each 16-key step for rows 2t and
//      2t + 1, that is Philox groups g and g + 8 of the window with their
//      four words, one a step: 4 calls a head and tile, every word used.  S
//      is summed from the f32 A in registers; A goes to shared memory as
//      bf16 hi = bf16(A) and lo = bf16(A - hi), [head][row][key];
//   3. warp w: o_norm += A_hi V_cat for its two heads (A rounded to bf16
//      once, as the TPU kernel's p.astype(v.dtype)), V fragments by
//      ldmatrix.trans; and for query row w, C_w += A_w A_w^T where A_w is
//      the row's 16 heads x 64 keys, taken as hi hi^T + hi lo^T + lo hi^T by
//      mma.sync (8 f32 accumulators a thread; one ldmatrix gives a 16-key
//      step's A and both B fragments).
// Why hi + lo for C.  C's 136 products an entry do not fit a thread's
// registers in f32, and the BN variance w^T C w / cnt - dev^2 is a
// difference of sums, where one bf16 rounding of A (2^-9) would cost digits;
// the pair carries 16 significant bits (lo lo, 2^-18 of A^2, is left out).
// S and C thus come from the f32 probabilities, as the TPU kernel's p_tiles
// are f32, to within 2^-17.
// At the end o_norm goes out through shared memory in 16-byte row copies,
// and S and C with each (head) and (head pair) plane's 8 rows together.
// Ragged edges: every copy zero-fills rows past Nq and Nk (src-size 0); keys
// past Nk get A = 0; rows past Nq get lse = +inf, so A = 0, and write
// nothing.
//
// The log-sum-exp pass comes first: kernel 1's tensor-core pass
// (reattention_tc.cuh::lse_kernel) at (16, 12).
//
// Shared memory: q 6,144 + two stages of K 49,152 and V_cat 25,600 + A hi
// and lo 2 x 18,688 = 193,024 B, one block an SM; 6,272 blocks at the
// classifier's b64, N 784 (98 q tiles x 64 images), 13 key tiles each.
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
constexpr int H = 16, DH = 12, P = H * DH;
constexpr int BQ = 8;              // query rows per block
constexpr int KT = 64;             // keys of a tile: one Philox window
constexpr int LDK = 24;            // bf16 pitch of q and K rows (depth 12, zero to 16)
constexpr int CPR = DH / 4;        // 8-byte copies a q or K row
constexpr int LDV = P + 8;         // bf16 pitch of V_cat rows (and of the o_norm stage)
constexpr int LDA = KT + 8;        // bf16 pitch of an A row
constexpr int HSA = BQ * LDA + 8;  // bf16 between heads of the A tiles: C's rows are heads
constexpr int NVT = P / 8;         // 8-column tiles of o_norm
constexpr int Q_ELEMS = H * BQ * LDK;
constexpr int K_ELEMS = H * KT * LDK;
constexpr int V_ELEMS = KT * LDV;
constexpr int STAGE_ELEMS = K_ELEMS + V_ELEMS;
constexpr int A_ELEMS = H * HSA;
constexpr size_t SMEM = sizeof(bf16) * (Q_ELEMS + 2 * STAGE_ELEMS + 2 * A_ELEMS);
static_assert(H == 2 * NW && BQ == NW, "warp w: heads 2w, 2w + 1 and C's row w");
static_assert(DH % 4 == 0 && DH <= 16, "one k-step of the score product");
static_assert(NW * 16 * LDV <= 2 * STAGE_ELEMS, "the o_norm stage fits the ring");
static_assert(sizeof(float) * (H * H + H) * BQ <= sizeof(bf16) * 2 * A_ELEMS,
              "the S and C stage fits the A tiles");
static_assert((Q_ELEMS + 2 * STAGE_ELEMS) % 8 == 0 && A_ELEMS % 8 == 0 && HSA % 8 == 0 &&
                  LDA % 8 == 0, "16-byte alignment of the regions and rows");
static_assert(SMEM <= 232448, "shared memory of a block");

// Grid (q tiles of 8, B).  lse from the log-sum-exp pass; writes o_norm,
// srow (B, H, Nq) and crow (B, H, H, Nq).
__global__ void __launch_bounds__(NT, 1) bnfwd16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ lse, const int64_t* __restrict__ seed, int thr, float scale,
    bf16* __restrict__ onorm, float* __restrict__ srow, float* __restrict__ crow, int nq,
    int nk) {
  extern __shared__ __align__(128) unsigned char b16_smem[];
  bf16* qs = reinterpret_cast<bf16*>(b16_smem);   // [H][BQ][LDK]
  bf16* ring = qs + Q_ELEMS;                       // [2][K: H][KT][LDK, V_cat: KT][LDV]
  bf16* a_hi = ring + 2 * STAGE_ELEMS;             // [H][BQ][LDA], heads HSA apart
  bf16* a_lo = a_hi + A_ELEMS;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int q0 = blockIdx.x * BQ, b = blockIdx.y;
  const uint64_t sd = thr > 0 ? static_cast<uint64_t>(seed[0]) : 0;
  const float ks = thr > 0 ? scale : 1.f;

  // the copies never write columns DH .. LDK of q and K rows, part of which
  // the score product reads
  vit_tile::zero_bf16<Q_ELEMS + 2 * STAGE_ELEMS>(qs, tid);
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
    bf16* vd = dst + K_ELEMS;
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

  // this lane's rows 2t, 2t + 1 of heads 2w, 2w + 1: lse * log2(e), +inf past Nq
  float lse2[2][2], sacc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
  for (int hl = 0; hl < 2; ++hl)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + 2 * t4 + i;
      lse2[hl][i] = row < nq ? lse[((int64_t)b * H + 2 * warp + hl) * nq + row] * LOG2E : INFINITY;
    }
  float acc[NVT][4], cacc[2][4];
#pragma unroll
  for (int nv = 0; nv < NVT; ++nv)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nv][e] = 0.f;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) cacc[nt][e] = 0.f;
  uint32_t qb[2][2];

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<0>();
    __syncthreads();   // tile t has landed; everyone is done with tile t - 1 and its A
    if (t == 0) {
#pragma unroll
      for (int hl = 0; hl < 2; ++hl)
        ldsm_x2(qb[hl], qs + ((2 * warp + hl) * BQ + (lane % 8)) * LDK + 8 * ((lane / 8) % 2));
    }
    if (t + 1 < n_tiles) load_tile(t + 1, ring + ((t + 1) & 1) * STAGE_ELEMS);
    cp_async_commit();
    const bf16* kt = ring + (t & 1) * STAGE_ELEMS;
    const bf16* vt = kt + K_ELEMS;
    const int k0 = t * KT;

    // steps 1-2, heads 2w and 2w + 1
#pragma unroll
    for (int hl = 0; hl < 2; ++hl) {
      const int h = 2 * warp + hl;
      float s[4][4];   // s[mt]: keys 16 mt + g (e < 2), + 8 (e >= 2); rows 2t + e % 2
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        uint32_t af[4];
        ldsm_x4(af, kt + (h * KT + 16 * mt + (lane % 8) + 8 * ((lane / 8) % 2)) * LDK +
                        8 * (lane / 16));
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][e] = 0.f;
        mma_bf16(s[mt], af, qb[hl][0], qb[hl][1]);
      }
      // keep bit 4 (2 j + i) + mt: row 2t + i, key 16 mt + g + 8 j of the tile
      uint32_t keep = 0xFFFFu;
      if (thr > 0) {
        keep = 0;
        const uint32_t th = static_cast<uint32_t>(thr);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = q0 + 2 * t4 + i;
          if (row >= nq) continue;   // A = 0 there: lse = +inf
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const uint4 w = vit::philox4(sd, b, h, row, (k0 >> 2) + g + 8 * j);
            keep |= (((w.x >> 8) >= th ? 1u : 0u) | ((w.y >> 8) >= th ? 2u : 0u) |
                     ((w.z >> 8) >= th ? 4u : 0u) | ((w.w >> 8) >= th ? 8u : 0u))
                    << (4 * (2 * j + i));
          }
        }
      }
      bf16* hrow = a_hi + h * HSA;
      bf16* lrow = a_lo + h * HSA;
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e % 2, j = e / 2, key = 16 * mt + g + 8 * j;
          const bool kept = k0 + key < nk && ((keep >> (4 * (2 * j + i) + mt)) & 1u);
          const float a = kept ? fast_exp2(fmaf(s[mt][e], LOG2E, -lse2[hl][i])) * ks : 0.f;
          sacc[hl][i] += a;
          const bf16 hi = __float2bfloat16_rn(a);
          hrow[(2 * t4 + i) * LDA + key] = hi;
          lrow[(2 * t4 + i) * LDA + key] = __float2bfloat16_rn(a - __bfloat162float(hi));
        }
    }
    __syncthreads();   // A of every head is in

    // step 3: o_norm of heads 2w, 2w + 1, and C of row w
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      uint32_t af[4];
      ldsm_x4(af, a_hi + (2 * warp + (lane / 8) % 2) * HSA + (lane % 8) * LDA +
                      8 * (lane / 16) + 16 * kk);
      const bf16* vrow = vt + (16 * kk + (lane % 8) + 8 * ((lane / 8) % 2)) * LDV + 8 * (lane / 16);
#pragma unroll
      for (int nv = 0; nv < NVT; nv += 2) {
        uint32_t vf[4];   // b0, b1 of column tile nv, then of nv + 1
        ldsm_x4_trans(vf, vrow + 8 * nv);
        mma_bf16(acc[nv], af, vf[0], vf[1]);
        mma_bf16(acc[nv + 1], af, vf[2], vf[3]);
      }
      // x[0..3]: heads 0-7 / 8-15 (rows) x keys 0-7, then 8-15: the A
      // fragment of A_w, and the B fragments of A_w^T (n tile 0: x0, x2;
      // n tile 1: x1, x3)
      const int coff = ((lane % 8) + 8 * ((lane / 8) % 2)) * HSA + warp * LDA + 8 * (lane / 16) +
                       16 * kk;
      uint32_t xh[4], xl[4];
      ldsm_x4(xh, a_hi + coff);
      ldsm_x4(xl, a_lo + coff);
      mma_bf16(cacc[0], xh, xh[0], xh[2]);
      mma_bf16(cacc[1], xh, xh[1], xh[3]);
      mma_bf16(cacc[0], xh, xl[0], xl[2]);
      mma_bf16(cacc[1], xh, xl[1], xl[3]);
      mma_bf16(cacc[0], xl, xh[0], xh[2]);
      mma_bf16(cacc[1], xl, xh[1], xh[3]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring and the A tiles are free

  // o_norm: warp w's 16 rows (head 2w rows 0-7, head 2w + 1 rows 0-7) via the ring
  bf16* ostage = ring + warp * 16 * LDV;
#pragma unroll
  for (int nv = 0; nv < NVT; ++nv)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<uint32_t*>(ostage + (g + 8 * r) * LDV + 8 * nv + 2 * t4) =
          pack_bf16(acc[nv][2 * r], acc[nv][2 * r + 1]);
  // S: reduce over the lanes of a t (g = lane / 4); C: the row's 16 x 16
  float* sstage = reinterpret_cast<float*>(a_hi);   // [H][BQ]
  float* cstage = sstage + H * BQ;                   // [H][H][BQ]
#pragma unroll
  for (int hl = 0; hl < 2; ++hl)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float x = sacc[hl][i];
      x += __shfl_xor_sync(0xffffffffu, x, 4);
      x += __shfl_xor_sync(0xffffffffu, x, 8);
      x += __shfl_xor_sync(0xffffffffu, x, 16);
      if (g == 0) sstage[(2 * warp + hl) * BQ + 2 * t4 + i] = x;
    }
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h2 = g + 8 * (e / 2), h3 = 8 * nt + 2 * t4 + e % 2;
      if (h2 <= h3) {   // the upper triangle's sums, mirrored
        cstage[(h2 * H + h3) * BQ + warp] = cacc[nt][e];
        cstage[(h3 * H + h2) * BQ + warp] = cacc[nt][e];
      }
    }
  __syncthreads();
  const int nrows = min(BQ, nq - q0);
  for (int c = tid; c < H * BQ * (P / 8); c += NT) {
    const int j = c % (P / 8), rr = c / (P / 8), h = rr / BQ, r = rr % BQ;
    if (r < nrows)
      *reinterpret_cast<uint4*>(onorm + (((int64_t)b * H + h) * nq + q0 + r) * P + 8 * j) =
          *reinterpret_cast<const uint4*>(ring + ((h / 2) * 16 + 8 * (h % 2) + r) * LDV + 8 * j);
  }
  // each plane's 8 rows: two 16-byte stores where rows are 16-byte aligned
  const bool vec = nrows == BQ && nq % 4 == 0;
  for (int c = tid; c < (H + H * H) * BQ; c += NT) {
    const int plane = c / BQ, r = c % BQ;
    float* dst = plane < H ? srow + ((int64_t)b * H + plane) * nq
                           : crow + ((int64_t)b * H * H + plane - H) * nq;
    if (vec) {
      if (r % 4 == 0)
        *reinterpret_cast<float4*>(dst + q0 + r) =
            *reinterpret_cast<const float4*>(sstage + plane * BQ + r);
    } else if (r < nrows) {
      dst[q0 + r] = sstage[plane * BQ + r];
    }
  }
}

// The log-sum-exp pass, then the sweep.  cudaErrorInvalidValue for any
// other shape than (16, 12).
inline int bn_fwd16_tc(const void* q, const void* k, const void* v, const int64_t* seed, int thr,
                       float scale, float* lse, void* onorm, float* srow, float* crow, int batch,
                       int heads, int nq, int nk, int dh, cudaStream_t stream) {
  if (heads != H || dh != DH) return static_cast<int>(cudaErrorInvalidValue);
  int rc = vit_tc::launch_lse<vit_tc::Cfg<16, 12, 32, 32, 8, 2, 1>>(q, k, lse, batch, nq, nk,
                                                                     stream);
  if (rc) return rc;
  cudaError_t err = cudaFuncSetAttribute(
      bnfwd16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  bnfwd16_kernel<<<dim3((nq + BQ - 1) / BQ, batch), NT, SMEM, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), lse,
      seed, thr, scale, static_cast<bf16*>(onorm), srow, crow, nq, nk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace vit_bnfwd16
