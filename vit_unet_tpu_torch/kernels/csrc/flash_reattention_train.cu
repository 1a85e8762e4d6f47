// Training flash re-attention for Hopper (sm_90a), plain C interface.
//
// Replaces the three Pallas TPU kernels of
// vit_unet_tpu/kernels/flash_reattention_train.py:
//
//   vit_train_fwd  <- _fwd (:363, body _fwd_kernel :107): frozen-BN forward
//   vit_bn_fwd     <- _bn_fwd (:741, body _bn_fwd_kernel :636): exact-BN sweep
//   vit_train_bwd  <- _bwd (:451, body _bwd_dkv_kernel :214): the backward
//
// Notation: q (B,H,Nq,dh) pre-scaled, k (B,H,Nk,dh), v (B,Nk,P) with the
// heads concatenated (P = H*dh).  p_h = softmax(q_h . k_h^T) with the keys
// >= Nk masked, mask the dropout scale (0 or 1/(1-rate), keep_scales in
// reattention_common.cuh, keyed on absolute indices), A_h = p_h * mask.
//
//   o_norm[b,h,n,:] = A_h[n,:] @ v                  (B,H,Nq,P), storage type
//   out[b,n,j]      = sum_h2 M[head(j),h2] o_norm[b,h2,n,j] + c[head(j)] vsum[b,j]
//   S[b,h,n]        = sum_m A_h[n,m]                (B,H,Nq) f32
//   C[b,h2,h3,n]    = sum_m A_h2[n,m] A_h3[n,m]     (B,H,H,Nq) f32
//
// Backward, with g = d out (B,Nq,P), D (B,H,Nq) the softmax-dot term computed
// outside, and the optional exact-BN correction (G (H,H), kappa (H,)):
//
//   dA_h2 = sum_j g[n,j] M[head(j),h2] v[m,j]  (+ kappa_h2 + sum_h3 G[h3,h2] A_h3)
//   ds_h2 = p_h2 * (dA_h2 * mask - D_h2)
//   dq_h2 = ds_h2 @ k_h2,  dk_h2 = ds_h2^T @ q_h2,
//   dv[m,j] = sum_h2 M[head(j),h2] sum_n A_h2[n,m] g[n,j]
//
// Design.  The TPU kernels carry (H, bq, P) f32 accumulators across a
// sequential grid axis; at base's coarse level (P = 3072) one 32-row tile of
// that is 3 MB, far beyond a block's 227 KB.  So each function is split into
// passes whose blocks own a few registers of output:
//
//   forward: lse_kernel (the eval kernel's pass 1: pre-dropout LSE, which is
//     exactly what the training forward needs), then onorm_kernel, grid
//     (q tiles, H, B): with the LSE known it forms A_h directly, no online
//     rescale, and multiplies it with v, all of P at once up to P = 192;
//     wider P goes in 128-column chunks, with A_h of up to 1024 keys kept
//     in shared memory so the scores are computed once.  The frozen forward then runs mix_kernel
//     (the TPU epilogue's head mix, one thread per output entry); the exact-
//     BN forward runs sc_kernel, grid (q tiles, B), which keeps all H
//     probability tiles of a (q, k) block in shared memory for S and the
//     upper triangle of C.
//   backward: dqk_kernel, grid (q tiles, H, B), loops over key tiles; dq
//     stays in registers, dk goes out by atomicAdd (f32, so its summation
//     order changes from run to run); the exact-BN term recomputes the other
//     heads' probability tiles.  dv_kernel, grid (key tiles, column chunks
//     of P as onorm_kernel's, B), loops over q tiles and heads and recomputes
//     the score tiles once per column chunk.
//
// What bounds it.  All arithmetic is f32 FMAs on the CUDA cores (no tensor
// cores, so no TF32 either); scores are recomputed in the dv pass and for the
// BN term, and the kernels are limited by shared-memory loads and load
// latency well above their operation bound.
//
// Shapes: f32 or bf16 storage, any Nq >= 1, Nk >= 1 with the ragged edges
// masked in the kernel, Nq != Nk allowed, H <= 16, dh <= 384.  All tensors
// are contiguous; the caller allocates every output (dk zeroed).
//
// Each function has a second route, chosen by the caller (train_fwd_route,
// bn_fwd_route, train_bwd_route in kernels/flash_reattention_train.py): bf16
// on the tensor cores at base's, large's and lite's level shapes and the
// classifier's (16, 12) and (16, 48), each piece computed once
// (reattention_bnfwd_tc.cuh for both forwards at 4 and 8 heads,
// reattention_bnfwd16_tc.cuh for both at 16, reattention_bwd_tc.cuh).  The
// frozen forward has two more for the keras attention's identity mix (M = I, c = 0)
// at (8, 192) and (4, 192), one pass with the dropout writing out and lse and
// no o_norm: attention_identity_tc.cuh in bf16, attention_identity_f32.cuh in
// f32 (split precision); and so has the backward, with no head-mix or BN
// term and no workspace: attention_identity_bwd.cuh in both.  The backward
// has one more at lite's classes in f32, reattention_bwd_tc.cuh's fused
// kernel in split precision.  The kernels here are the CUDA-core route, for
// f32 and every other shape.

#include "attention_identity_bwd.cuh"
#include "attention_identity_f32.cuh"
#include "attention_identity_tc.cuh"
#include "reattention_bnfwd16_tc.cuh"
#include "reattention_bnfwd_tc.cuh"
#include "reattention_bwd_tc.cuh"
#include "reattention_common.cuh"

using namespace vit;

namespace {

constexpr int KC_MAX = 1024;  // keys of A kept in shared memory by onorm_kernel

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// Thread (ty, tx) owns o_norm rows ty + 8i (i < 4) and columns tx + 16j
// (j < NJ) of a 32 x 16NJ chunk.  kc keys of A stay in shared memory: all of
// them (up to KC_MAX) when P takes several chunks, so the scores are
// computed once; one key tile when a chunk covers P.
template <typename T, int DK, int NJ>
__global__ void __launch_bounds__(NT) onorm_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ lse, const int64_t* __restrict__ seed, int thr,
    float scale, T* __restrict__ onorm, int heads, int nq, int nk, int dh,
    int kc) {
  constexpr int DV = 16 * NJ;
  extern __shared__ float pr[];   // [BQ][kc + 1]
  __shared__ float qs[BQ][DK + 1];
  __shared__ float ks[BK][DK + 1];
  __shared__ float vs[VC][DV];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int64_t bh = (int64_t)b * heads + h;
  const int proj = heads * dh;
  const T* qh = q + bh * nq * dh;
  const T* kh = k + bh * nk * dh;
  const uint64_t sd = seed ? static_cast<uint64_t>(seed[0]) : 0;
  const int ld = kc + 1;

  float L[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 8 * i;
    L[i] = row < nq ? lse[bh * nq + row] : 0.f;
  }
  const bool one_chunk = nk <= kc;
  float s[4][4];
  for (int c0 = 0; c0 < proj; c0 += DV) {
    float acc[4][NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
    for (int kb = 0; kb < nk; kb += kc) {
      const int kend = min(nk, kb + kc);
      if (!one_chunk || c0 == 0) {
        for (int k0 = kb; k0 < kend; k0 += BK) {
          score_tile<T, DK>(qh, kh, q0, k0, nq, nk, dh, qs, ks, s, tid, ty, tx);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int row = q0 + ty + 8 * i;
            float mk[4] = {1.f, 1.f, 1.f, 1.f};
            if (thr > 0 && row < nq) keep_scales(sd, thr, scale, b, h, row, k0, tx, mk);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int col = k0 + tx + 16 * j;
              const float a = (row < nq && col < kend) ? expf(s[i][j] - L[i]) * mk[j] : 0.f;
              pr[(ty + 8 * i) * ld + col - kb] = a;
            }
          }
        }
      }
      for (int r0 = kb; r0 < kend; r0 += VC) {
        __syncthreads();   // pr written / previous vs chunk consumed
        for (int e = tid; e < VC * DV; e += NT) {
          const int r = e / DV, d = e % DV;
          float x = 0.f;
          if (r0 + r < kend && c0 + d < proj)
            x = to_f32(v[((int64_t)b * nk + r0 + r) * proj + c0 + d]);
          vs[r][d] = x;
        }
        __syncthreads();
#pragma unroll 4
        for (int cc = 0; cc < VC; ++cc) {
          float a[4], vv[NJ];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = pr[(ty + 8 * i) * ld + r0 - kb + cc];
#pragma unroll
          for (int j = 0; j < NJ; ++j) vv[j] = vs[cc][tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(a[i], vv[j], acc[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 8 * i;
      if (row >= nq) continue;
      T* orow = onorm + (bh * nq + row) * proj;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = c0 + tx + 16 * j;
        if (col < proj) orow[col] = from_f32<T>(acc[i][j]);
      }
    }
  }
}

// out[b,n,j] = sum_h2 M[head(j),h2] o_norm[b,h2,n,j] + c[head(j)] vsum[b,j]
template <typename T>
__global__ void __launch_bounds__(256) mix_kernel(
    const T* __restrict__ onorm, const float* __restrict__ vsum,
    const float* __restrict__ m_eff, const float* __restrict__ c_eff,
    T* __restrict__ out, int batch, int heads, int nq, int dh) {
  const int proj = heads * dh;
  const int64_t total = (int64_t)batch * nq * proj;
  for (int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * blockDim.x) {
    const int j = e % proj;
    const int64_t bn = e / proj;
    const int n = bn % nq, b = bn / nq;
    const int hp = j / dh;
    float x = c_eff[hp] * vsum[(int64_t)b * proj + j];
    for (int h2 = 0; h2 < heads; ++h2)
      x = fmaf(m_eff[hp * heads + h2],
               to_f32(onorm[(((int64_t)b * heads + h2) * nq + n) * proj + j]), x);
    out[e] = from_f32<T>(x);
  }
}

// S and C rows of a q tile.  Dynamic shared memory: the H probability tiles
// of the current key tile, then the S and C accumulators (each entry owned
// by one thread), then the pair table of the upper triangle of C.
template <typename T, int DK>
__global__ void __launch_bounds__(NT) sc_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const float* __restrict__ lse, const int64_t* __restrict__ seed, int thr,
    float scale, float* __restrict__ srow, float* __restrict__ crow,
    int heads, int nq, int nk, int dh) {
  extern __shared__ float smem[];
  constexpr int TILE = BQ * (BK + 1);
  const int npairs = heads * (heads + 1) / 2;
  float* pt = smem;                              // [heads][BQ][BK + 1]
  float* acc = pt + heads * TILE;                // [heads + npairs][BQ]
  int* pair = reinterpret_cast<int*>(acc + (heads + npairs) * BQ);  // [npairs]
  __shared__ float qs[BQ][DK + 1];
  __shared__ float ks[BK][DK + 1];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int q0 = blockIdx.x * BQ, b = blockIdx.y;
  const uint64_t sd = seed ? static_cast<uint64_t>(seed[0]) : 0;

  for (int e = tid; e < (heads + npairs) * BQ; e += NT) acc[e] = 0.f;
  if (tid == 0) {
    int pi = 0;
    for (int h2 = 0; h2 < heads; ++h2)
      for (int h3 = h2; h3 < heads; ++h3) pair[pi++] = h2 * heads + h3;
  }
  float s[4][4];
  for (int k0 = 0; k0 < nk; k0 += BK) {
    for (int h = 0; h < heads; ++h) {
      const int64_t bh = (int64_t)b * heads + h;
      score_tile<T, DK>(q + bh * nq * dh, k + bh * nk * dh, q0, k0, nq, nk, dh,
                        qs, ks, s, tid, ty, tx);
      float* tile = pt + h * TILE;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + ty + 8 * i;
        const float L = row < nq ? lse[bh * nq + row] : 0.f;
        float mk[4] = {1.f, 1.f, 1.f, 1.f};
        if (thr > 0 && row < nq) keep_scales(sd, thr, scale, b, h, row, k0, tx, mk);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = k0 + tx + 16 * j;
          tile[(ty + 8 * i) * (BK + 1) + tx + 16 * j] =
              (row < nq && col < nk) ? expf(s[i][j] - L) * mk[j] : 0.f;
        }
      }
    }
    __syncthreads();
    for (int e = tid; e < (heads + npairs) * BQ; e += NT) {
      const int r = e % BQ, idx = e / BQ;
      int ha = idx, hb = -1;
      if (idx >= heads) {
        const int p = pair[idx - heads];
        ha = p / heads;
        hb = p % heads;
      }
      const float* ta = pt + ha * TILE + r * (BK + 1);
      float x = 0.f;
      if (hb < 0) {
#pragma unroll 8
        for (int c = 0; c < BK; ++c) x += ta[c];
      } else {
        const float* tb = pt + hb * TILE + r * (BK + 1);
#pragma unroll 8
        for (int c = 0; c < BK; ++c) x = fmaf(ta[c], tb[c], x);
      }
      acc[e] += x;
    }
    // the next key tile's score_tile starts with a barrier before pt is rewritten
  }
  __syncthreads();
  for (int e = tid; e < (heads + npairs) * BQ; e += NT) {
    const int r = e % BQ, idx = e / BQ, row = q0 + r;
    if (row >= nq) continue;
    if (idx < heads) {
      srow[((int64_t)b * heads + idx) * nq + row] = acc[e];
    } else {
      const int p = pair[idx - heads], h2 = p / heads, h3 = p % heads;
      crow[(((int64_t)b * heads + h2) * heads + h3) * nq + row] = acc[e];
      crow[(((int64_t)b * heads + h3) * heads + h2) * nq + row] = acc[e];
    }
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// Normalised probabilities and dropout scale of one score tile.
__device__ __forceinline__ void probs(const float s[4][4], const float L[4],
                                      int q0, int k0, int nq, int nk, int b,
                                      int h, uint64_t sd, int thr, float scale,
                                      int ty, int tx, float p[4][4],
                                      float mk[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 8 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) mk[i][j] = 1.f;
    if (thr > 0 && row < nq) keep_scales(sd, thr, scale, b, h, row, k0, tx, mk[i]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = k0 + tx + 16 * j;
      p[i][j] = (row < nq && col < nk) ? expf(s[i][j] - L[i]) : 0.f;
    }
  }
}

// dq, dk and the dA / ds algebra.  Thread (ty, tx) owns ds rows ty + 8i and
// keys tx + 16j (i, j < 4), and dq rows ty + 8i, columns tx + 16j (j < NJ).
// Dynamic shared memory: the block's q tile, [BQ][dh] f32, then the head-mix
// weight of every column, w_h2[j] = M[head(j), h2], [P].
template <typename T, int NJ>
__global__ void __launch_bounds__(NT) dqk_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ g, const float* __restrict__ lse,
    const float* __restrict__ dvec, const float* __restrict__ m_eff,
    const float* __restrict__ gmat, const float* __restrict__ kappa,
    const int64_t* __restrict__ seed, int thr, float scale,
    float* __restrict__ dq, float* __restrict__ dk, int heads, int nq, int nk,
    int dh) {
  constexpr int DK = NJ == 1 ? 16 : 32;
  extern __shared__ float qt[];   // [BQ][dh], then wfull [P]
  __shared__ float qs[BQ][DK + 1];
  __shared__ float ks[BK][DK + 1];
  __shared__ float ps[BQ][BK + 1];
  __shared__ float kv[VC][16 * NJ];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int q0 = blockIdx.x * BQ, h2 = blockIdx.y, b = blockIdx.z;
  const int64_t bh = (int64_t)b * heads + h2;
  const int proj = heads * dh;
  const T* qh = q + bh * nq * dh;
  const T* kh = k + bh * nk * dh;
  const uint64_t sd = seed ? static_cast<uint64_t>(seed[0]) : 0;

  float* wfull = qt + BQ * dh;
  for (int e = tid; e < BQ * dh; e += NT) {
    const int r = e / dh, d = e % dh;
    qt[e] = q0 + r < nq ? to_f32(qh[(int64_t)(q0 + r) * dh + d]) : 0.f;
  }
  for (int j = tid; j < proj; j += NT) wfull[j] = m_eff[(j / dh) * heads + h2];
  float L[4], Dr[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 8 * i;
    L[i] = row < nq ? lse[bh * nq + row] : 0.f;
    Dr[i] = row < nq ? dvec[bh * nq + row] : 0.f;
  }
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  float s[4][4], p[4][4], mk[4][4], da[4][4];
  for (int k0 = 0; k0 < nk; k0 += BK) {
    score_tile<T, DK>(qh, kh, q0, k0, nq, nk, dh, qs, ks, s, tid, ty, tx);
    probs(s, L, q0, k0, nq, nk, b, h2, sd, thr, scale, ty, tx, p, mk);

    // dA = (g * w_h2) @ v^T over the P columns in chunks of DK,
    // w_h2[j] = M[head(j), h2]
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) da[i][j] = 0.f;
    for (int c0 = 0; c0 < proj; c0 += DK) {
      __syncthreads();
      for (int e = tid; e < BQ * DK; e += NT) {
        const int r = e / DK, c = e % DK;
        float x = 0.f;
        if (q0 + r < nq && c0 + c < proj)
          x = to_f32(g[((int64_t)b * nq + q0 + r) * proj + c0 + c]) * wfull[c0 + c];
        qs[r][c] = x;
      }
      for (int e = tid; e < BK * DK; e += NT) {
        const int r = e / DK, c = e % DK;
        float x = 0.f;
        if (k0 + r < nk && c0 + c < proj)
          x = to_f32(v[((int64_t)b * nk + k0 + r) * proj + c0 + c]);
        ks[r][c] = x;
      }
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < DK; ++c) {
        float a[4], bb[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qs[ty + 8 * i][c];
#pragma unroll
        for (int j = 0; j < 4; ++j) bb[j] = ks[tx + 16 * j][c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) da[i][j] = fmaf(a[i], bb[j], da[i][j]);
      }
    }
    if (gmat) {   // exact-BN correction: kappa + sum_h3 G[h3,h2] A_h3
      const float kp = kappa[h2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) da[i][j] += kp;
      for (int h3 = 0; h3 < heads; ++h3) {
        const float gw = gmat[h3 * heads + h2];
        if (h3 == h2) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) da[i][j] = fmaf(gw, p[i][j] * mk[i][j], da[i][j]);
          continue;
        }
        const int64_t bh3 = (int64_t)b * heads + h3;
        float s3[4][4], p3[4][4], m3[4][4], L3[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = q0 + ty + 8 * i;
          L3[i] = row < nq ? lse[bh3 * nq + row] : 0.f;
        }
        score_tile<T, DK>(q + bh3 * nq * dh, k + bh3 * nk * dh, q0, k0, nq, nk,
                          dh, qs, ks, s3, tid, ty, tx);
        probs(s3, L3, q0, k0, nq, nk, b, h3, sd, thr, scale, ty, tx, p3, m3);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) da[i][j] = fmaf(gw, p3[i][j] * m3[i][j], da[i][j]);
      }
    }
    __syncthreads();   // the previous key tile's ps readers are done
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ps[ty + 8 * i][tx + 16 * j] = p[i][j] * (da[i][j] * mk[i][j] - Dr[i]);

    // dq += ds @ k_h2
    for (int r0 = 0; r0 < BK; r0 += VC) {
      __syncthreads();
      for (int e = tid; e < VC * 16 * NJ; e += NT) {
        const int r = e / (16 * NJ), d = e % (16 * NJ);
        float x = 0.f;
        if (k0 + r0 + r < nk && d < dh) x = to_f32(kh[(int64_t)(k0 + r0 + r) * dh + d]);
        kv[r][d] = x;
      }
      __syncthreads();
#pragma unroll 4
      for (int cc = 0; cc < VC; ++cc) {
        float a[4], kk[NJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = ps[ty + 8 * i][r0 + cc];
#pragma unroll
        for (int j = 0; j < NJ; ++j) kk[j] = kv[cc][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(a[i], kk[j], acc[i][j]);
      }
    }
    // dk += ds^T @ q_h2, one atomicAdd per entry of the key tile
    for (int e = tid; e < BK * dh; e += NT) {
      const int m = e / dh, d = e % dh;
      if (k0 + m >= nk) continue;
      float x = 0.f;
#pragma unroll 8
      for (int r = 0; r < BQ; ++r) x = fmaf(ps[r][m], qt[r * dh + d], x);
      atomicAdd(dk + (bh * nk + k0 + m) * dh + d, x);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 8 * i;
    if (row >= nq) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = tx + 16 * j;
      if (col < dh) dq[(bh * nq + row) * dh + col] = acc[i][j];
    }
  }
}

// dv for a key tile and a 16NJ-column chunk of P: thread (ty, tx) owns keys
// ty + 8i (i < 8) and columns tx + 16j (j < NJ).
template <typename T, int DK, int NJ>
__global__ void __launch_bounds__(NT) dv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ g,
    const float* __restrict__ lse, const float* __restrict__ m_eff,
    const int64_t* __restrict__ seed, int thr, float scale,
    float* __restrict__ dv, int heads, int nq, int nk, int dh) {
  __shared__ float qs[BQ][DK + 1];
  __shared__ float ks[BK][DK + 1];
  __shared__ float at[BQ][BK + 1];
  constexpr int DV = 16 * NJ;
  __shared__ float gw[BQ][DV];
  __shared__ float wcol[DV];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int k0 = blockIdx.x * BK, c0 = blockIdx.y * DV, b = blockIdx.z;
  const int proj = heads * dh;
  const uint64_t sd = seed ? static_cast<uint64_t>(seed[0]) : 0;

  float acc[8][NJ];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  float s[4][4], p[4][4], mk[4][4], L[4];
  for (int q0 = 0; q0 < nq; q0 += BQ) {
    for (int h2 = 0; h2 < heads; ++h2) {
      const int64_t bh = (int64_t)b * heads + h2;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + ty + 8 * i;
        L[i] = row < nq ? lse[bh * nq + row] : 0.f;
      }
      score_tile<T, DK>(q + bh * nq * dh, k + bh * nk * dh, q0, k0, nq, nk, dh,
                        qs, ks, s, tid, ty, tx);
      probs(s, L, q0, k0, nq, nk, b, h2, sd, thr, scale, ty, tx, p, mk);
      // score_tile's barriers also end the previous head's reads of at / gw
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) at[ty + 8 * i][tx + 16 * j] = p[i][j] * mk[i][j];
      for (int c = tid; c < DV; c += NT)
        wcol[c] = c0 + c < proj ? m_eff[((c0 + c) / dh) * heads + h2] : 0.f;
      __syncthreads();
      for (int e = tid; e < BQ * DV; e += NT) {
        const int r = e / DV, c = e % DV;
        float x = 0.f;
        if (q0 + r < nq && c0 + c < proj)
          x = to_f32(g[((int64_t)b * nq + q0 + r) * proj + c0 + c]) * wcol[c];
        gw[r][c] = x;
      }
      __syncthreads();
#pragma unroll 4
      for (int r = 0; r < BQ; ++r) {
        float a[8], gg[NJ];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = at[r][ty + 8 * i];
#pragma unroll
        for (int j = 0; j < NJ; ++j) gg[j] = gw[r][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(a[i], gg[j], acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int key = k0 + ty + 8 * i;
    if (key >= nk) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = c0 + tx + 16 * j;
      if (col < proj) dv[((int64_t)b * nk + key) * proj + col] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

int set_smem(const void* fn, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

template <typename T, int DK, int NJ>
int onorm(const void* q, const void* k, const void* v, const float* lse,
          const int64_t* seed, int thr, float scale, void* out, int batch,
          int heads, int nq, int nk, int dh, cudaStream_t stream) {
  const int proj = heads * dh;
  const int kc = proj <= 16 * NJ ? BK : nk > KC_MAX ? KC_MAX : (nk + BK - 1) / BK * BK;
  const size_t dyn = sizeof(float) * BQ * (kc + 1);
  int rc = set_smem(reinterpret_cast<const void*>(onorm_kernel<T, DK, NJ>), dyn);
  if (rc) return rc;
  onorm_kernel<T, DK, NJ><<<dim3((nq + BQ - 1) / BQ, heads, batch), NT, dyn, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lse, seed, thr, scale, static_cast<T*>(out),
      heads, nq, nk, dh, kc);
  return static_cast<int>(cudaGetLastError());
}

// Column chunk of onorm_kernel and dv_kernel: all of P when it is at most
// 192 wide (16 NJ >= P, NJ in {3, 12}), else chunks of 128.
#define VIT_BY_PROJ(FN, T, DK, ...)                               \
  (proj <= 48 ? FN<T, DK, 3>(__VA_ARGS__)                         \
   : proj <= 192 ? FN<T, DK, 12>(__VA_ARGS__) : FN<T, DK, 8>(__VA_ARGS__))

template <typename T, int DK>
int forward(const void* q, const void* k, const void* v, const int64_t* seed,
            int thr, float scale, float* lse, void* onorm_out, int batch,
            int heads, int nq, int nk, int dh, cudaStream_t stream) {
  lse_kernel<T, DK><<<dim3((nq + BQ - 1) / BQ, heads, batch), NT, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), lse, heads, nq, nk, dh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int proj = heads * dh;
  return VIT_BY_PROJ(onorm, T, DK, q, k, v, lse, seed, thr, scale, onorm_out,
                     batch, heads, nq, nk, dh, stream);
}

template <typename T, int DK>
int train_fwd(const void* q, const void* k, const void* v, const float* vsum,
              const float* m_eff, const float* c_eff, const int64_t* seed,
              int thr, float scale, float* lse, void* onorm, void* out,
              int batch, int heads, int nq, int nk, int dh, cudaStream_t stream) {
  int rc = forward<T, DK>(q, k, v, seed, thr, scale, lse, onorm, batch, heads,
                          nq, nk, dh, stream);
  if (rc) return rc;
  const int64_t total = (int64_t)batch * nq * heads * dh;
  const int blocks = static_cast<int>((total + 255) / 256 > 65536 ? 65536 : (total + 255) / 256);
  mix_kernel<T><<<blocks, 256, 0, stream>>>(
      static_cast<const T*>(onorm), vsum, m_eff, c_eff, static_cast<T*>(out),
      batch, heads, nq, dh);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DK>
int bn_fwd(const void* q, const void* k, const void* v, const int64_t* seed,
           int thr, float scale, float* lse, void* onorm, float* srow,
           float* crow, int batch, int heads, int nq, int nk, int dh,
           cudaStream_t stream) {
  int rc = forward<T, DK>(q, k, v, seed, thr, scale, lse, onorm, batch, heads,
                          nq, nk, dh, stream);
  if (rc) return rc;
  const int npairs = heads * (heads + 1) / 2;
  const size_t dyn = sizeof(float) * (heads * BQ * (BK + 1) + (heads + npairs) * BQ)
                     + sizeof(int) * npairs;
  rc = set_smem(reinterpret_cast<const void*>(sc_kernel<T, DK>), dyn);
  if (rc) return rc;
  sc_kernel<T, DK><<<dim3((nq + BQ - 1) / BQ, batch), NT, dyn, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), lse, seed, thr, scale,
      srow, crow, heads, nq, nk, dh);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DK, int NJ>
int dv_launch(const void* q, const void* k, const void* g, const float* lse,
              const float* m_eff, const int64_t* seed, int thr, float scale,
              float* dv, int batch, int heads, int nq, int nk, int dh,
              cudaStream_t stream) {
  const int proj = heads * dh;
  dv_kernel<T, DK, NJ><<<dim3((nk + BK - 1) / BK, (proj + 16 * NJ - 1) / (16 * NJ), batch),
                         NT, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(g), lse, m_eff, seed, thr, scale, dv, heads, nq,
      nk, dh);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int NJ>
int backward(const void* q, const void* k, const void* v, const void* g,
             const float* lse, const float* dvec, const float* m_eff,
             const float* gmat, const float* kappa, const int64_t* seed,
             int thr, float scale, float* dq, float* dk, float* dv, int batch,
             int heads, int nq, int nk, int dh, cudaStream_t stream) {
  constexpr int DK = NJ == 1 ? 16 : 32;
  const int proj = heads * dh;
  const size_t dyn = sizeof(float) * (BQ * dh + proj);
  int rc = set_smem(reinterpret_cast<const void*>(dqk_kernel<T, NJ>), dyn);
  if (rc) return rc;
  dqk_kernel<T, NJ><<<dim3((nq + BQ - 1) / BQ, heads, batch), NT, dyn, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g), lse, dvec, m_eff,
      gmat, kappa, seed, thr, scale, dq, dk, heads, nq, nk, dh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return VIT_BY_PROJ(dv_launch, T, DK, q, k, g, lse, m_eff, seed, thr, scale,
                     dv, batch, heads, nq, nk, dh, stream);
}

// dq's register width: the smallest 16 * NJ >= dh over the presets' head
// dims (12, 24, 48, 96, 192, 384)
template <typename T>
int backward_dispatch(const void* q, const void* k, const void* v, const void* g,
                      const float* lse, const float* dvec, const float* m_eff,
                      const float* gmat, const float* kappa, const int64_t* seed,
                      int thr, float scale, float* dq, float* dk, float* dv,
                      int batch, int heads, int nq, int nk, int dh,
                      cudaStream_t s) {
#define VIT_BWD(NJ) backward<T, NJ>(q, k, v, g, lse, dvec, m_eff, gmat, kappa, seed, \
                                    thr, scale, dq, dk, dv, batch, heads, nq, nk, dh, s)
  if (dh <= 16) return VIT_BWD(1);
  if (dh <= 32) return VIT_BWD(2);
  if (dh <= 48) return VIT_BWD(3);
  if (dh <= 96) return VIT_BWD(6);
  if (dh <= 192) return VIT_BWD(12);
  return VIT_BWD(24);
#undef VIT_BWD
}

bool bad_shape(int batch, int heads, int nq, int nk, int dh) {
  return batch <= 0 || batch > 65535 || nq <= 0 || nk <= 0 || heads <= 0 ||
         heads > MAX_HEADS || dh <= 0 || dh > 384;
}

__global__ void set_head_base(uint32_t head_base) { vit::g_head_base = head_base; }

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  seed: a device int64, or null when
// thr == 0 (no dropout).  Each returns cudaGetLastError() after its launches
// (0 on success), or cudaErrorInvalidValue for shapes it does not take.

// route: 0 the CUDA cores, 1 the tensor cores (bf16 at the classes of
// reattention_bnfwd_tc.cuh and, at 16 heads, reattention_bnfwd16_tc.cuh
// only), 2 and 3 the identity mix at (8, 192) and (4, 192) only, 2 in bf16,
// 3 in f32 (vsum, m_eff, c_eff and onorm are not touched and may be null,
// the mix is M = I, c = 0).
int vit_train_fwd(const void* q, const void* k, const void* v,
                  const float* vsum, const float* m_eff, const float* c_eff,
                  const int64_t* seed, int thr, float scale, float* lse,
                  void* onorm, void* out, int batch, int heads, int nq, int nk,
                  int dh, int dtype, int route, void* stream) {
  if (bad_shape(batch, heads, nq, nk, dh)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((route == 2 && dtype != 1) || (route == 3 && dtype != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (route == 2)
    return thr > 0 ? vit_id::launch<true>(q, k, v, seed, thr, scale, lse, out, batch, heads,
                                          nq, nk, dh, s)
                   : vit_id::launch<false>(q, k, v, seed, thr, scale, lse, out, batch, heads,
                                           nq, nk, dh, s);
  if (route == 3)
    return vit_idf::launch_train(q, k, v, seed, thr, scale, lse, out, batch, heads, nq, nk, dh, s);
  if (route == 1 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (route == 1 && heads == 16)
    return vit_bnfwd16::train_fwd16_tc(q, k, v, vsum, m_eff, c_eff, seed, thr, scale, lse, onorm,
                                       out, batch, heads, nq, nk, dh, s);
  if (route == 1)
    return vit_bnfwd::train_fwd_tc(q, k, v, vsum, m_eff, c_eff, seed, thr, scale, lse, onorm, out,
                                   batch, heads, nq, nk, dh, s);
  if (route != 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool thin = dh <= 16;
  if (dtype == 0)
    return thin ? train_fwd<float, 16>(q, k, v, vsum, m_eff, c_eff, seed, thr, scale, lse, onorm, out, batch, heads, nq, nk, dh, s)
                : train_fwd<float, 32>(q, k, v, vsum, m_eff, c_eff, seed, thr, scale, lse, onorm, out, batch, heads, nq, nk, dh, s);
  if (dtype == 1)
    return thin ? train_fwd<__nv_bfloat16, 16>(q, k, v, vsum, m_eff, c_eff, seed, thr, scale, lse, onorm, out, batch, heads, nq, nk, dh, s)
                : train_fwd<__nv_bfloat16, 32>(q, k, v, vsum, m_eff, c_eff, seed, thr, scale, lse, onorm, out, batch, heads, nq, nk, dh, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// route: 0 the CUDA cores, 1 the tensor cores (bf16 at the classes of
// reattention_bnfwd_tc.cuh and, at 16 heads, reattention_bnfwd16_tc.cuh).
int vit_bn_fwd(const void* q, const void* k, const void* v, const int64_t* seed,
               int thr, float scale, float* lse, void* onorm, float* srow,
               float* crow, int batch, int heads, int nq, int nk, int dh,
               int dtype, int route, void* stream) {
  if (bad_shape(batch, heads, nq, nk, dh)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (route == 1 && heads == 16)
    return vit_bnfwd16::bn_fwd16_tc(q, k, v, seed, thr, scale, lse, onorm, srow, crow, batch,
                                    heads, nq, nk, dh, s);
  if (route == 1)
    return vit_bnfwd::bn_fwd_tc(q, k, v, seed, thr, scale, lse, onorm, srow, crow, batch, heads,
                                nq, nk, dh, s);
  if (route != 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool thin = dh <= 16;
  if (dtype == 0)
    return thin ? bn_fwd<float, 16>(q, k, v, seed, thr, scale, lse, onorm, srow, crow, batch, heads, nq, nk, dh, s)
                : bn_fwd<float, 32>(q, k, v, seed, thr, scale, lse, onorm, srow, crow, batch, heads, nq, nk, dh, s);
  if (dtype == 1)
    return thin ? bn_fwd<__nv_bfloat16, 16>(q, k, v, seed, thr, scale, lse, onorm, srow, crow, batch, heads, nq, nk, dh, s)
                : bn_fwd<__nv_bfloat16, 32>(q, k, v, seed, thr, scale, lse, onorm, srow, crow, batch, heads, nq, nk, dh, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// gmat and kappa: both null (frozen BN) or both set (exact-BN correction).
// route: 0 the CUDA cores (dq written, dk zeroed), 1 the tensor cores (bf16
// at the classes of reattention_bwd_tc.cuh only; work: a device buffer of
// vit_train_bwd_workspace bytes, null where that is 0; where it is 0, dq must
// be zeroed, else every output is written once), 2 and 3 the identity mix at
// (8, 192) and (4, 192) only, 2 in bf16, 3 in f32 (attention_identity_bwd.cuh:
// m_eff is not read, gmat and kappa must be null, every output is written
// once), 4 the tensor cores in f32, split precision, at lite's classes (4,
// 12), (4, 48), (4, 192) only (reattention_bwd_tc.cuh's train_bwd_tc_f32;
// dq must be zeroed, dk and dv are written).
int vit_train_bwd(const void* q, const void* k, const void* v, const void* g,
                  const float* lse, const float* dvec, const float* m_eff,
                  const float* gmat, const float* kappa, const int64_t* seed,
                  int thr, float scale, float* dq, float* dk, float* dv,
                  int batch, int heads, int nq, int nk, int dh, int dtype,
                  int route, void* work, void* stream) {
  if (bad_shape(batch, heads, nq, nk, dh) || (gmat == nullptr) != (kappa == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 2 || route == 3)
    return gmat == nullptr && dtype == 3 - route
               ? vit_idb::train_bwd_identity(q, k, v, g, lse, dvec, seed, thr, scale, dq, dk, dv,
                                             batch, heads, nq, nk, dh, dtype, s)
               : static_cast<int>(cudaErrorInvalidValue);
  if (route == 1)
    return dtype == 1 ? vit_bwd::train_bwd_tc(q, k, v, g, lse, dvec, m_eff, gmat, kappa, seed,
                                              thr, scale, dq, dk, dv, work, batch, heads, nq,
                                              nk, dh, s)
                      : static_cast<int>(cudaErrorInvalidValue);
  if (route == 4)
    return dtype == 0 ? vit_bwd::train_bwd_tc_f32(q, k, v, g, lse, dvec, m_eff, gmat, kappa,
                                                  seed, thr, scale, dq, dk, dv, batch, heads,
                                                  nq, nk, dh, s)
                      : static_cast<int>(cudaErrorInvalidValue);
  if (route != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return backward_dispatch<float>(q, k, v, g, lse, dvec, m_eff, gmat, kappa, seed, thr, scale, dq, dk, dv, batch, heads, nq, nk, dh, s);
  if (dtype == 1)
    return backward_dispatch<__nv_bfloat16>(q, k, v, g, lse, dvec, m_eff, gmat, kappa, seed, thr, scale, dq, dk, dv, batch, heads, nq, nk, dh, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The dropout counter's head of every later launch's head 0 on the stream
// (vit::g_head_base): one thread writes it, in stream order.
int vit_train_set_head_base(int head_base, void* stream) {
  if (head_base < 0) return static_cast<int>(cudaErrorInvalidValue);
  set_head_base<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t>(head_base));
  return static_cast<int>(cudaGetLastError());
}

// Bytes of the workspace a vit_train_bwd call on the route needs.
int64_t vit_train_bwd_workspace(int batch, int heads, int nq, int nk, int dh, int route) {
  return route == 1 ? static_cast<int64_t>(vit_bwd::map_workspace(batch, heads, nq, nk, dh)) : 0;
}

const char* vit_train_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
