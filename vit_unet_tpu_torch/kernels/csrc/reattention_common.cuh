// Device code shared by the re-attention kernels: the f32 score tile, the
// half-warp row reductions, the per-row log-sum-exp pass and the counter-
// based dropout generator.  Included by flash_reattention.cu and
// flash_reattention_train.cu; each is its own shared library.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace vit {

constexpr int BQ = 32;   // query rows per block
constexpr int BK = 64;   // keys per tile
constexpr int NT = 128;  // threads per block: 8 row groups x 16 column lanes
constexpr int VC = 16;   // value rows staged per shared-memory chunk
constexpr int MAX_HEADS = 16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Thread (ty, tx) = (tid / 16, tid % 16) owns score rows ty + 8*i and key
// columns tx + 16*j, i, j < 4, of a BQ x BK tile.
template <typename T, int DK>
__device__ __forceinline__ void score_tile(
    const T* __restrict__ qh, const T* __restrict__ kh, int q0, int k0,
    int nq, int nk, int dh, float (*qs)[DK + 1], float (*ks)[DK + 1],
    float s[4][4], int tid, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  for (int d0 = 0; d0 < dh; d0 += DK) {
    __syncthreads();
    for (int e = tid; e < BQ * DK; e += NT) {
      const int r = e / DK, d = e % DK;
      float x = 0.f;
      if (q0 + r < nq && d0 + d < dh) x = to_f32(qh[(int64_t)(q0 + r) * dh + d0 + d]);
      qs[r][d] = x;
    }
    for (int e = tid; e < BK * DK; e += NT) {
      const int r = e / DK, d = e % DK;
      float x = 0.f;
      if (k0 + r < nk && d0 + d < dh) x = to_f32(kh[(int64_t)(k0 + r) * dh + d0 + d]);
      ks[r][d] = x;
    }
    __syncthreads();
#pragma unroll 8
    for (int d = 0; d < DK; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[ty + 8 * i][d];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ks[tx + 16 * j][d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }
  }
}

// The 16 lanes that share a row sit in one half-warp: xor offsets < 16.
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Per-row log-sum-exp of softmax(q_h . k_h^T), grid (q tiles, H, B).
template <typename T, int DK>
__global__ void __launch_bounds__(NT) lse_kernel(
    const T* __restrict__ q, const T* __restrict__ k, float* __restrict__ lse,
    int heads, int nq, int nk, int dh) {
  __shared__ float qs[BQ][DK + 1];
  __shared__ float ks[BK][DK + 1];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int64_t bh = (int64_t)b * heads + h;
  const T* qh = q + bh * nq * dh;
  const T* kh = k + bh * nk * dh;

  float m[4], l[4], s[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) { m[i] = -INFINITY; l[i] = 0.f; }
  for (int k0 = 0; k0 < nk; k0 += BK) {
    score_tile<T, DK>(qh, kh, q0, k0, nq, nk, dh, qs, ks, s, tid, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (k0 + tx + 16 * j < nk) mt = fmaxf(mt, s[i][j]);
      mt = row_max(mt);               // finite: key k0 is valid
      const float mn = fmaxf(m[i], mt);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (k0 + tx + 16 * j < nk) sum += expf(s[i][j] - mn);
      sum = row_sum(sum);
      l[i] = l[i] * expf(m[i] - mn) + sum;
      m[i] = mn;
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 8 * i;
      // l == 0 only without keys: exp(s - inf) = 0 then drops every term,
      // as the TPU epilogue's l_inv = 1 on an all-zero accumulator does
      if (row < nq) lse[bh * nq + row] = l[i] > 0.f ? m[i] + logf(l[i]) : INFINITY;
    }
  }
}

// Philox-4x32-10 with key (seed lo, seed hi) and counter (grp, row, head,
// batch).  One call gives the dropout bits of four attention-map entries:
// entry (row, col) takes word (col >> 4) & 3 of group
// grp = (col >> 6) * 16 + (col & 15), so the thread that owns columns
// k0 + tx + 16 j (j < 4) of a 64-key tile gets all four from one call.  The
// key holds absolute indices, so every kernel that visits an entry, whatever
// its tiling, draws the same bits, and the plain PyTorch version regenerates
// them exactly.
__device__ __forceinline__ uint4 philox4(uint64_t seed, uint32_t b, uint32_t h,
                                         uint32_t row, uint32_t grp) {
  uint32_t c0 = grp, c1 = row, c2 = h, c3 = b;
  uint32_t k0 = static_cast<uint32_t>(seed), k1 = static_cast<uint32_t>(seed >> 32);
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return make_uint4(c0, c1, c2, c3);
}

// Dropout scales of entries (row, k0 + tx + 16 j), j < 4, for a key tile
// starting at k0 (a multiple of 64): 1/(1-rate) if kept, else 0.  Keep iff
// the top 24 bits reach thr = ceil(f32(rate) * 2^24), the TPU kernel's rule.
__device__ __forceinline__ void keep_scales(uint64_t seed, int thr, float scale,
                                            int b, int h, int row, int k0, int tx,
                                            float out[4]) {
  const uint4 w = philox4(seed, b, h, row, (k0 >> 2) + tx);
  const uint32_t t = static_cast<uint32_t>(thr);
  out[0] = (w.x >> 8) >= t ? scale : 0.f;
  out[1] = (w.y >> 8) >= t ? scale : 0.f;
  out[2] = (w.z >> 8) >= t ? scale : 0.f;
  out[3] = (w.w >> 8) >= t ? scale : 0.f;
}

}  // namespace vit
