// Eval flash re-attention for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel vit_unet_tpu/kernels/flash_reattention.py
// ::flash_reattention (body _kernel).  Computes, without writing the N x N
// attention map to device memory,
//
//   A_h2  = softmax(q_h2 . k_h2^T)            (q pre-scaled, keys >= Nk masked)
//   A'_h  = sum_h2 M[h, h2] * A_h2 + c[h]     (1x1 head-mix conv + eval BN,
//                                             folded; only on valid keys)
//   out[:, :, h*dh:(h+1)*dh] = A'_h @ V_h
//
// M and c are read from the expanded epilogue form the public function
// takes: M[h, h2] = w[h2, h*dh], c[h] = b[h*dh].
//
// Two routes, named by the caller (the Python wrapper's kernel_route picks
// one from dtype and shape alone; nothing here falls back):
//
//   route 1, tensor cores: bfloat16 inputs at the shape classes listed in
//     reattention_tc.cuh, which holds the kernels, what bounds them on this
//     card and the shared-memory budget per class.
//   route 0, CUDA cores: this file; float32 and bfloat16, any H <= 16,
//     dh <= 384.  Every product is an f32 FMA (no tensor cores, hence no
//     TF32 either), so float32 inputs are computed in full float32.
//
// Design of route 0.  The TPU kernel keeps an (H, bq, H*dh) f32 accumulator
// per q tile.  At base's coarse level (H*dh = 3072) that is far beyond a
// Hopper block's 227 KB of shared memory, so the work is split in two passes:
//
//   pass 1 (lse_kernel):  grid (q tiles, H, B).  Online max / sum over the
//     key tiles of one head; writes the per-row log-sum-exp (B, H, Nq) f32.
//   pass 2 (out_kernel):  grid (q tiles, H / G, B).  One block per group
//     of G output heads.  For each key tile it computes the H score tiles
//     once, keeps the normalised probabilities exp(s_h2 - lse_h2) of all
//     heads in shared memory (each thread reads back only the entries it
//     wrote), then for each output head h of its group forms the mixed
//     probabilities P' = sum_h2 M[h,h2] P_h2 + c[h], stages P' and
//     accumulates P' @ V_h into a (32 x dh) f32 register accumulator.
//     G is the largest power of two dividing H with G * NJ <= 16 (dh rounded
//     up to 16 * NJ), so the G accumulators fit the registers: G = H at
//     base's finest level (no score recomputation), G = 1 at its coarse
//     level (H recomputations).
//
// What bounds route 0.  Scores are recomputed H / G times, the head mix
// costs H * G multiply-adds per map entry, and the passes are limited by
// shared-memory loads (8 scalar loads per 16 FMAs in the score
// tile) and by the synchronous global load and two barriers of each 32-deep
// chunk at 8 warps per SM, far above the f32 operation count.  Route 1 is
// the answer to that for bfloat16; route 0 stays as the float32 path.
//
// Shapes: any Nq, Nk >= 0 with the ragged edges masked in the kernel (no
// padding copies), Nq != Nk.  All tensors are contiguous; the caller
// allocates every output and scratch buffer and passes the stream.

#include "reattention_common.cuh"
#include "reattention_tc.cuh"

using namespace vit;

namespace {

// Dynamic shared memory of out_kernel: the H normalised probability tiles.
__host__ __device__ constexpr int prob_tile_floats() { return BQ * (BK + 1); }

template <typename T, int NJ, int G>
__global__ void __launch_bounds__(NT) out_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ w, const float* __restrict__ bvec,
    const float* __restrict__ lse, T* __restrict__ out,
    int heads, int nq, int nk, int dh) {
  constexpr int DK = NJ == 1 ? 16 : 32;
  constexpr int DV = 16 * NJ;
  extern __shared__ float pt[];   // [heads][BQ][BK + 1]
  __shared__ float qs[BQ][DK + 1];
  __shared__ float ks[BK][DK + 1];
  __shared__ float ps[BQ][BK + 1];
  __shared__ float vs[VC][DV];
  __shared__ float mix[G][MAX_HEADS];
  __shared__ float cvec[G];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int q0 = blockIdx.x * BQ, h0 = blockIdx.y * G, b = blockIdx.z;
  const int proj = heads * dh;

  for (int e = tid; e < G * heads; e += NT) {      // mix[g][h2] = M[h0+g, h2]
    const int g = e / heads, h2 = e % heads;
    mix[g][h2] = w[(int64_t)h2 * proj + (h0 + g) * dh];
  }
  if (tid < G) cvec[tid] = bvec[(h0 + tid) * dh];  // c[h0+g]

  float acc[G][4][NJ];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[g][i][j] = 0.f;

  float s[4][4];
  for (int k0 = 0; k0 < nk; k0 += BK) {
    for (int h2 = 0; h2 < heads; ++h2) {
      const int64_t bh2 = (int64_t)b * heads + h2;
      score_tile<T, DK>(q + bh2 * nq * dh, k + bh2 * nk * dh, q0, k0, nq, nk,
                        dh, qs, ks, s, tid, ty, tx);
      float* tile = pt + h2 * prob_tile_floats();
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + ty + 8 * i;
        const float L = row < nq ? lse[bh2 * nq + row] : 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool valid = k0 + tx + 16 * j < nk;
          tile[(ty + 8 * i) * (BK + 1) + tx + 16 * j] = valid ? expf(s[i][j] - L) : 0.f;
        }
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float p[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) p[i][j] = (k0 + tx + 16 * j < nk) ? cvec[g] : 0.f;
      for (int h2 = 0; h2 < heads; ++h2) {
        const float mm = mix[g][h2];
        const float* tile = pt + h2 * prob_tile_floats();
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            p[i][j] = fmaf(mm, tile[(ty + 8 * i) * (BK + 1) + tx + 16 * j], p[i][j]);
      }
      __syncthreads();   // the previous head's P' @ V is done with ps
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) ps[ty + 8 * i][tx + 16 * j] = p[i][j];
      const int hv = (h0 + g) * dh;
      for (int c0 = 0; c0 < BK; c0 += VC) {
        __syncthreads();   // ps written / previous vs chunk consumed
        for (int e = tid; e < VC * DV; e += NT) {
          const int r = e / DV, d = e % DV;
          const int key = k0 + c0 + r;
          float x = 0.f;
          if (key < nk && d < dh) x = to_f32(v[((int64_t)b * nk + key) * proj + hv + d]);
          vs[r][d] = x;
        }
        __syncthreads();
#pragma unroll 4
        for (int cc = 0; cc < VC; ++cc) {
          float a[4], vv[NJ];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = ps[ty + 8 * i][c0 + cc];
#pragma unroll
          for (int j = 0; j < NJ; ++j) vv[j] = vs[cc][tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < NJ; ++j) acc[g][i][j] = fmaf(a[i], vv[j], acc[g][i][j]);
        }
      }
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 8 * i;
      if (row >= nq) continue;
      T* orow = out + ((int64_t)b * nq + row) * proj + (h0 + g) * dh;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = tx + 16 * j;
        if (col < dh) orow[col] = from_f32<T>(acc[g][i][j]);
      }
    }
}

template <typename T, int NJ, int G>
int launch(const void* q, const void* k, const void* v, const float* w,
           const float* b, float* lse, void* out, int batch, int heads,
           int nq, int nk, int dh, int passes, cudaStream_t stream) {
  constexpr int DK = NJ == 1 ? 16 : 32;
  const int q_tiles = (nq + BQ - 1) / BQ;
  cudaError_t err;
  if (passes & 1) {
    lse_kernel<T, DK><<<dim3(q_tiles, heads, batch), NT, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), lse, heads, nq, nk, dh);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (passes & 2) {
    const size_t dyn = sizeof(float) * heads * prob_tile_floats();
    err = cudaFuncSetAttribute(out_kernel<T, NJ, G>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(dyn));
    if (err != cudaSuccess) return static_cast<int>(err);
    out_kernel<T, NJ, G><<<dim3(q_tiles, heads / G, batch), NT, dyn, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), w, b, lse, static_cast<T*>(out), heads, nq,
        nk, dh);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// G: the largest power of two dividing H with G * NJ <= 16.
template <typename T, int NJ>
int launch_grouped(const void* q, const void* k, const void* v, const float* w,
                   const float* b, float* lse, void* out, int batch, int heads,
                   int nq, int nk, int dh, int passes, cudaStream_t stream) {
  if constexpr (NJ <= 1) {
    if (heads % 16 == 0) return launch<T, NJ, 16>(q, k, v, w, b, lse, out, batch, heads, nq, nk, dh, passes, stream);
  }
  if constexpr (NJ <= 2) {
    if (heads % 8 == 0) return launch<T, NJ, 8>(q, k, v, w, b, lse, out, batch, heads, nq, nk, dh, passes, stream);
  }
  if constexpr (NJ <= 4) {
    if (heads % 4 == 0) return launch<T, NJ, 4>(q, k, v, w, b, lse, out, batch, heads, nq, nk, dh, passes, stream);
  }
  if constexpr (NJ <= 8) {
    if (heads % 2 == 0) return launch<T, NJ, 2>(q, k, v, w, b, lse, out, batch, heads, nq, nk, dh, passes, stream);
  }
  return launch<T, NJ, 1>(q, k, v, w, b, lse, out, batch, heads, nq, nk, dh, passes, stream);
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const float* w,
             const float* b, float* lse, void* out, int batch, int heads,
             int nq, int nk, int dh, int passes, cudaStream_t stream) {
  // accumulator width: the smallest 16 * NJ >= dh (every preset's dh fits
  // one of these exactly, apart from dh 4, 8 and 12)
  if (dh <= 16) return launch_grouped<T, 1>(q, k, v, w, b, lse, out, batch, heads, nq, nk, dh, passes, stream);
  if (dh <= 32) return launch_grouped<T, 2>(q, k, v, w, b, lse, out, batch, heads, nq, nk, dh, passes, stream);
  if (dh <= 48) return launch_grouped<T, 3>(q, k, v, w, b, lse, out, batch, heads, nq, nk, dh, passes, stream);
  if (dh <= 96) return launch_grouped<T, 6>(q, k, v, w, b, lse, out, batch, heads, nq, nk, dh, passes, stream);
  if (dh <= 192) return launch_grouped<T, 12>(q, k, v, w, b, lse, out, batch, heads, nq, nk, dh, passes, stream);
  return launch_grouped<T, 24>(q, k, v, w, b, lse, out, batch, heads, nq, nk, dh, passes, stream);
}

}  // namespace

namespace vit_tc {

// The shape classes of reattention_tc.cuh's table; any other is refused.
// Here and not in the header, so that the training source, which includes
// the header for its log-sum-exp pass alone, does not compile every class's
// kernels.
inline int dispatch(const void* q, const void* k, const void* v, const float* w,
                    const float* b, float* lse, void* out, int batch, int heads, int nq,
                    int nk, int dh, int passes, cudaStream_t stream) {
#define VIT_TC_CASE(H, DH, BQ, BK, HG, NSTAGE, MINB, MMA_OUT)                             \
  if (heads == H && dh == DH)                                                             \
    return launch<Cfg<H, DH, BQ, BK, HG, NSTAGE, MINB>, MMA_OUT>(q, k, v, w, b, lse, out, \
                                                                 batch, nq, nk, passes, stream);
  VIT_TC_CASE(8, 384, 16, 32, 1, 3, 1, false)
  VIT_TC_CASE(8, 192, 16, 32, 4, 2, 1, false)
  VIT_TC_CASE(8, 96, 32, 32, 8, 2, 1, false)
  VIT_TC_CASE(8, 24, 32, 32, 8, 2, 2, true)
  VIT_TC_CASE(4, 192, 16, 32, 2, 2, 2, false)
  VIT_TC_CASE(4, 48, 32, 64, 4, 2, 2, false)
  VIT_TC_CASE(4, 12, 32, 64, 4, 2, 2, false)
  VIT_TC_CASE(16, 48, 16, 64, 8, 2, 1, false)
  VIT_TC_CASE(16, 12, 32, 32, 8, 2, 1, false)
#undef VIT_TC_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace vit_tc

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  route: 0 = CUDA cores, 1 = tensor cores
// (bfloat16 at the shape classes of reattention_tc.cuh).  passes: bit 0 the
// log-sum-exp pass (writes lse), bit 1 the output pass (reads lse); 3 is the
// function.  Returns the first CUDA error of the launches (0 on success), or
// cudaErrorInvalidValue for what the route does not take.
int vit_flash_reattention(const void* q, const void* k, const void* v,
                          const float* w, const float* b, float* lse, void* out,
                          int batch, int heads, int nq, int nk, int dh,
                          int dtype, int route, int passes, void* stream) {
  if (batch <= 0 || nq <= 0 || nk < 0 || heads <= 0 || heads > MAX_HEADS ||
      dh <= 0 || dh > 384 || batch > 65535 || heads > 65535 || passes < 1 ||
      passes > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1 && dtype == 1)
    return vit_tc::dispatch(q, k, v, w, b, lse, out, batch, heads, nq, nk, dh, passes, s);
  if (route == 0 && dtype == 0)
    return dispatch<float>(q, k, v, w, b, lse, out, batch, heads, nq, nk, dh, passes, s);
  if (route == 0 && dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, w, b, lse, out, batch, heads, nq, nk, dh, passes, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* vit_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
