// Flash re-attention with the identity head mix, on Hopper's tensor cores in
// one pass, bfloat16, at the keras-attention classes (8, 192) and (4, 192):
// route 2 of vit_flash_reattention (flash_reattention.cu, eval) and route 2
// of vit_train_fwd (flash_reattention_train.cu, the training forward, with
// the in-map dropout).
//
// Replaces the Pallas TPU kernels vit_unet_tpu/kernels/flash_reattention.py
// ::flash_reattention (body _kernel) and vit_unet_tpu/kernels/
// flash_reattention_train.py::_fwd (body _fwd_kernel) at the calls of the
// keras attention (vit_unet_tpu/nn/mha.py), whose head mix is M = I, c = 0.
// There the function is plain attention of each head,
//
//   out[b, n, h*dh:(h+1)*dh] = sum_m A_h[n, m] V_h[m],  A_h = exp(s - lse) * mask
//   lse[b, h, n]             = log sum_m exp(q_h[n] . k_h[m])   (before dropout)
//
// (mask = 1 in eval; in training the dropout scale of vit::keep_scales'
// rule, 0 or 1/(1 - rate)), and the caller says so (identity_mix=True): this
// kernel never reads w, b, m_eff or c_eff and writes no o_norm.  The
// two-pass routes take the log-sum-exp in a pass of their own, because the
// mix needs every head's normalised map; without a mix a row's running max
// and sum do.
//
// What bounds the function on this card.  Its bytes: q, k, v read once and
// out written once, 4 B N H dh bf16 (0.060 ms at (8, 192), N 256, b64, at
// 3.35 TB/s); its two products take 4 B H Nq Nk dh operations (0.026 ms at
// the bf16 peak).  Per map entry one exp and a few f32 operations, and in
// training a quarter of a Philox-4x32-10 call (ten rounds of two 32-bit
// multiplies): 8.4 M calls at (8, 192), N 256, b64.
//
// Design (the flash-attention forward):
//   * grid (q tiles of BQ = 64 rows, H, B): a block of 4 warps owns 64 query
//     rows of one (image, head), warp w rows 16 w .. 16 w + 15;
//   * the q tile is staged once by cp.async, and each warp takes its A
//     fragments (16 x dh bf16, dh / 4 registers a thread) into registers by
//     ldmatrix;
//   * K and V tiles of BK = 32 keys come through a two-buffer cp.async ring
//     (the next tile loads while this one computes), one barrier a tile; rows
//     past Nk and Nq are zero-filled by the copies (src-size 0);
//   * S = q K^T by mma.sync m16n8k16 (bf16 in, f32 accumulate, K fragments by
//     ldmatrix), scores of keys past Nk set to -inf;
//   * online softmax in registers, in base 2: the tile's row max (a row's
//     four lanes reduce by shuffles), the accumulator and the lane's part of
//     the row sum scaled by exp(m_old - m_new), P = exp(s - m_new), the row
//     sum taken before the dropout;
//   * with the dropout, at a 64-key window's first tile a lane draws the four
//     Philox calls of each of its two rows (window_keep) and keeps the
//     window's 32 keep bits of its entries in one register for both 32-key
//     tiles; a dropped entry of P is 0, a kept one is scaled by 1/(1 - rate);
//   * P is rounded to bf16 once, as kernel 1 rounds its probabilities
//     (p.astype(v.dtype)), and used in registers as the A operand of
//     acc += P V (V fragments by ldmatrix.trans): the C fragments of two
//     8-key score tiles are the A fragment of one 16-key step;
//   * at the end acc / l goes to bf16 through the warp's own rows of the q
//     tile (16-byte stores of whole rows), and lse = m + log l.  Without keys
//     l = 0: the output is 0 and lse +inf, as on the other routes.
// The probabilities are rounded before they are normalised (kernel 1 rounds
// the normalised ones): both round each entry once, to within bf16's
// relative step.
//
// Registers at dh 192: the accumulator 96 a thread, the q fragments 48.
// Shared memory at dh 192, BK 32: q 64 x 200 + 2 x (K, V) 32 x 200 bf16 =
// 25,600 + 51,200 = 76,800 B, two blocks (8 warps) an SM.  2,048 blocks at
// HViTUNetTF's (8, 192), N 256, b64.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "reattention_common.cuh"
#include "reattention_mma.cuh"
#include "reattention_tiles.cuh"

namespace vit_id {

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

constexpr int NW = 4;         // warps per block
constexpr int NT = 32 * NW;   // threads per block
constexpr int BQ = 16 * NW;   // query rows per block: 16 a warp

template <int DH_, int BK_>
struct Cfg {
  static constexpr int DH = DH_, BK = BK_;
  static constexpr int KS = DH / 16;              // k16 steps of a score tile
  static constexpr int NV = DH / 8;               // 8-column tiles of the output
  static constexpr int NS = BK / 8;               // 8-key tiles of a score tile
  static constexpr int LD = DH + 8;               // bf16 row pitch of the q, K, V tiles
  static constexpr int CPR = DH / 8;              // 16-byte copies a row
  static constexpr int Q_ELEMS = BQ * LD;
  static constexpr int KV_ELEMS = BK * LD;
  static constexpr int STAGE_ELEMS = 2 * KV_ELEMS;   // K rows, then V rows
  static constexpr size_t SMEM = sizeof(bf16) * (Q_ELEMS + 2 * STAGE_ELEMS);
  static_assert(DH % 16 == 0 && KS % 2 == 0 && NV % 2 == 0, "shape");
  static_assert(BK == 32, "a tile is half a 64-key dropout window");
  static_assert(2 * (SMEM + 1024) <= 233472, "two blocks an SM");
};

// The keep bits of lane (g, t)'s 32 entries of 64-key window w, rows r0 and
// r0 + 8 (a row at or past nq draws nothing): bit 16 ri + 2 j + p for row
// r0 + 8 ri, column 64 w + 8 j + 2 t + p.  Column c of the window takes word
// (c >> 4) & 3 = j >> 1 of group 16 w + (c & 15) = 16 w + 8 (j & 1) + 2 t + p.
__device__ __forceinline__ uint32_t window_keep(uint64_t seed, uint32_t thr, int b, int h,
                                                int r0, int nq, int w, int t4) {
  uint32_t keep = 0;
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int row = r0 + 8 * ri;
    if (row >= nq) continue;
#pragma unroll
    for (int odd = 0; odd < 2; ++odd)
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const uint4 wd = vit::philox4(seed, b, h, row, 16 * w + 8 * odd + 2 * t4 + p);
        const uint32_t words[4] = {wd.x, wd.y, wd.z, wd.w};
#pragma unroll
        for (int wi = 0; wi < 4; ++wi)
          keep |= static_cast<uint32_t>((words[wi] >> 8) >= thr)
                  << (16 * ri + 2 * (2 * wi + odd) + p);
      }
  }
  return keep;
}

// dst[r][0 .. DH) <- src[(row0 + r) * row_stride + 0 .. DH) for r < ROWS, by
// 16-byte copies; rows at or past n are zero-filled.
template <typename C, int ROWS>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int64_t row_stride,
                                          int row0, int n, int tid) {
  for (int c = tid; c < ROWS * C::CPR; c += NT) {
    const int j = c % C::CPR, r = c / C::CPR;
    const bool valid = row0 + r < n;
    const bf16* s = valid ? src + (row0 + r) * row_stride + 8 * j : src;
    cp_async<16>(dst + r * C::LD + 8 * j, s, valid);
  }
}

// Grid (q tiles, H, B).  q (B, H, Nq, dh) pre-scaled, k (B, H, Nk, dh),
// v (B, Nk, H dh); out (B, Nq, H dh) bf16, lse (B, H, Nq) f32.  DROP: the
// dropout of seed[0], keep iff bits >> 8 >= thr, kept entries times scale.
template <typename C, bool DROP>
__global__ void __launch_bounds__(NT, 2) attend_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    float* __restrict__ lse, bf16* __restrict__ out, int heads, int nq, int nk,
    const int64_t* __restrict__ seed, uint32_t thr, float scale) {
  extern __shared__ __align__(128) unsigned char id_smem[];
  bf16* qs = reinterpret_cast<bf16*>(id_smem);   // [BQ][LD]
  bf16* ring = qs + C::Q_ELEMS;                   // [2][K, V][BK][LD]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int64_t proj = (int64_t)heads * C::DH;
  const int64_t bh = (int64_t)b * heads + h;
  const bf16* kh = k + bh * nk * C::DH;
  const bf16* vh = v + (int64_t)b * nk * proj + h * C::DH;

  load_rows<C, BQ>(qs, q + bh * nq * C::DH, C::DH, q0, nq, tid);
  const int n_tiles = (nk + C::BK - 1) / C::BK;
  auto load_tile = [&](int t, bf16* dst) {
    load_rows<C, C::BK>(dst, kh, C::DH, t * C::BK, nk, tid);
    load_rows<C, C::BK>(dst + C::KV_ELEMS, vh, proj, t * C::BK, nk, tid);
  };
  if (n_tiles > 0) load_tile(0, ring);
  cp_async_commit();   // the q tile joins tile 0's group

  float acc[C::NV][4];
#pragma unroll
  for (int nv = 0; nv < C::NV; ++nv)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nv][e] = 0.f;
  // rows g and g + 8 of the warp's 16: running max (of the scores times
  // log2 e) and this lane's part of the running sum
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  uint32_t qa[C::KS][4];
  uint64_t sd = 0;
  uint32_t keep = 0;   // this lane's keep bits of the current 64-key window
  if constexpr (DROP) sd = static_cast<uint64_t>(seed[0]);

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<0>();
    __syncthreads();   // tile t has landed; everyone is done with tile t - 1
    if (t == 0) {
      const bf16* qrow =
          qs + (16 * warp + (lane % 8) + 8 * ((lane / 8) % 2)) * C::LD + 8 * (lane / 16);
#pragma unroll
      for (int ks = 0; ks < C::KS; ++ks) ldsm_x4(qa[ks], qrow + 16 * ks);
    }
    if (t + 1 < n_tiles) load_tile(t + 1, ring + ((t + 1) & 1) * C::STAGE_ELEMS);
    cp_async_commit();
    const bf16* ks_t = ring + (t & 1) * C::STAGE_ELEMS;
    const bf16* vs_t = ks_t + C::KV_ELEMS;

    // S = q K^T: s[nt] is the C fragment of keys 8 nt .. 8 nt + 7
    float s[C::NS][4];
#pragma unroll
    for (int nt = 0; nt < C::NS; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
      // matrix j of a copy: depth 8 j .. 8 j + 7 of the 8 keys
      const bf16* krow = ks_t + (8 * nt + (lane % 8)) * C::LD + 8 * (lane / 8);
#pragma unroll
      for (int ks = 0; ks < C::KS; ks += 2) {
        uint32_t kb[4];
        ldsm_x4(kb, krow + 16 * ks);
        mma_bf16(s[nt], qa[ks], kb[0], kb[1]);
        mma_bf16(s[nt], qa[ks + 1], kb[2], kb[3]);
      }
    }
    const int k0 = t * C::BK;
    const bool full = k0 + C::BK <= nk;
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < C::NS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool valid = full || k0 + 8 * nt + 2 * t4 + (e % 2) < nk;
        s[nt][e] = valid ? s[nt][e] * LOG2E : -INFINITY;
        mt[e / 2] = fmaxf(mt[e / 2], s[nt][e]);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
      const float m_new = fmaxf(m_run[r], mt[r]);   // finite: key k0 is valid
      alpha[r] = fast_exp2(m_run[r] - m_new);       // 0 on the first tile
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int nv = 0; nv < C::NV; ++nv)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nv][e] *= alpha[e / 2];
#pragma unroll
    for (int nt = 0; nt < C::NS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = fast_exp2(s[nt][e] - m_run[e / 2]);   // 0 past Nk
        l_run[e / 2] += s[nt][e];
      }
    if constexpr (DROP) {
      if ((k0 & 63) == 0) keep = window_keep(sd, thr, b, h, q0 + 16 * warp + g, nq, k0 >> 6, t4);
      const int j0 = (k0 & 63) >> 3;   // 8-key tiles of the window before this one
#pragma unroll
      for (int nt = 0; nt < C::NS; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[nt][e] = (keep >> (16 * (e / 2) + 2 * (j0 + nt) + e % 2)) & 1u ? s[nt][e] * scale
                                                                           : 0.f;
    }

    // acc += P V, 16 keys a step
#pragma unroll
    for (int kk = 0; kk < C::BK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const bf16* vrow =
          vs_t + (16 * kk + (lane % 8) + 8 * ((lane / 8) % 2)) * C::LD + 8 * (lane / 16);
#pragma unroll
      for (int nv = 0; nv < C::NV; nv += 2) {
        uint32_t vb[4];   // b0, b1 of column tile nv, then of nv + 1
        ldsm_x4_trans(vb, vrow + 8 * nv);
        mma_bf16(acc[nv], pa, vb[0], vb[1]);
        mma_bf16(acc[nv + 1], pa, vb[2], vb[3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // every copy has landed (the q tile too, without keys)

  // out = acc / l through this warp's own 16 rows of the q tile, which only
  // this warp read (its fragments are in registers)
  bf16* stage = qs + 16 * warp * C::LD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = l > 0.f ? 1.f / l : 0.f;
#pragma unroll
    for (int nv = 0; nv < C::NV; ++nv)
      *reinterpret_cast<uint32_t*>(stage + (g + 8 * r) * C::LD + 8 * nv + 2 * t4) =
          pack_bf16(acc[nv][2 * r] * inv, acc[nv][2 * r + 1] * inv);
    const int row = q0 + 16 * warp + g + 8 * r;
    if (t4 == 0 && row < nq)
      lse[bh * nq + row] = l > 0.f ? m_run[r] / LOG2E + logf(l) : INFINITY;
  }
  __syncwarp();
  for (int c = lane; c < 16 * C::CPR; c += 32) {
    const int r = c / C::CPR, j = c % C::CPR, row = q0 + 16 * warp + r;
    if (row < nq)
      *reinterpret_cast<uint4*>(out + ((int64_t)b * nq + row) * proj + h * C::DH + 8 * j) =
          *reinterpret_cast<const uint4*>(stage + r * C::LD + 8 * j);
  }
}

// The routes' classes: (8, 192) and (4, 192), bf16; the kernel depends on
// dh alone.  cudaErrorInvalidValue for any other shape.  seed: a device
// int64, read only with DROP (thr > 0).
template <bool DROP>
int launch(const void* q, const void* k, const void* v, const int64_t* seed, int thr,
           float scale, float* lse, void* out, int batch, int heads, int nq, int nk, int dh,
           cudaStream_t stream) {
  if (dh != 192 || (heads != 8 && heads != 4)) return static_cast<int>(cudaErrorInvalidValue);
  using C = Cfg<192, 32>;
  cudaError_t err = cudaFuncSetAttribute(attend_kernel<C, DROP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(C::SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  attend_kernel<C, DROP><<<dim3((nq + BQ - 1) / BQ, heads, batch), NT, C::SMEM, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), lse,
      static_cast<bf16*>(out), heads, nq, nk, seed, static_cast<uint32_t>(thr), scale);
  return static_cast<int>(cudaGetLastError());
}

// Kernel 1's route: no dropout.
inline int launch_eval(const void* q, const void* k, const void* v, float* lse, void* out,
                       int batch, int heads, int nq, int nk, int dh, cudaStream_t stream) {
  return launch<false>(q, k, v, nullptr, 0, 1.f, lse, out, batch, heads, nq, nk, dh, stream);
}

}  // namespace vit_id
