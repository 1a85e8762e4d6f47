// Eval flash re-attention on the tensor cores for small head dims: the
// register-resident output pass of the bfloat16 route (reattention_tc.cuh
// holds the log-sum-exp pass and the shared-memory output pass, and says
// which shape class runs where).
//
// Replaces the Pallas TPU kernel vit_unet_tpu/kernels/flash_reattention.py
// ::flash_reattention (body _kernel) where H * dh is small enough for one
// warp to keep the output of ALL heads for its 16 query rows in registers
// (H * ceil(dh / 8) * 4 accumulator registers a thread: 96 at H 8, dh 24).
//
// What bounds the function here: at dh = 24 the two products are a small
// share of the work; per map entry and head the exp and the H multiply-adds
// of the head mix dominate, and in reattention_tc.cuh every score and every
// probability also crosses shared memory twice, in phases split by block-wide
// barriers.  What this design does about it: nothing per map entry leaves the
// registers.
//
//   * A block of 8 warps takes 128 query rows of one image; warp w owns rows
//     16 w .. 16 w + 15 for all heads and never waits for another warp except
//     at the K/V ring.  q (all heads) is staged once; K and V of all heads come
//     in tiles of BK keys through a two-buffer cp.async ring, one barrier a
//     tile, zero-filled past Nk on every copy.
//   * Per 16 keys the warp computes S_h2 = Q_h2 K_h2^T for every head with
//     mma.sync m16n8k16 (bf16 in, f32 accumulate; A and B fragments by
//     ldmatrix), turns the accumulators into P_h2 = exp(s - lse_h2) in place,
//     and for each output head h mixes P'_h = sum_h2 M[h,h2] P_h2 + c[h] (on
//     valid keys) in f32, rounds it to bf16 once, and uses it directly as the
//     A operand of acc_h += P'_h V_h (V fragments by ldmatrix.trans): the
//     accumulator layout of two 8-key score tiles is the A layout of one
//     16-key step.
//
// What bounds it now: with 96 accumulator and 64 probability registers a
// thread the block has 8 warps on its SM, two a scheduler, so the chains
// ldmatrix -> mma -> exp -> mix -> mma of one warp are only partly hidden by
// the other.  A log-sum-exp pass in this form was tried and was slower than
// the shared-memory one, so that pass stays in reattention_tc.cuh.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16; g = lane / 4,
// t = lane % 4): A (16 x 16, row) a0 = (row g, cols 2t, 2t+1), a1 = rows g + 8,
// a2 = (row g, cols 2t + 8, 2t + 9), a3 = rows g + 8 of those; B (16 x 8, col)
// b0 = (k 2t, 2t+1; n g), b1 = (k 2t + 8, 2t + 9; n g); C (16 x 8) c0, c1 =
// (row g, cols 2t, 2t+1), c2, c3 = row g + 8.
//
// Shared memory at (H 8, dh 24), BK 32: q tile 81,920 + ring 2 x 40,960 +
// lse 4,096 + M, c 288 = 168,224 bytes, one block an SM.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "reattention_tiles.cuh"

namespace vit_mma {

using namespace vit_tile;

constexpr int BQ = 16 * NW;    // query rows per block: 16 a warp
constexpr int NSTAGE = 2;      // K/V tile buffers

template <int H_, int DH_, int BK_>
struct Cfg {
  static constexpr int H = H_, DH = DH_, BK = BK_;
  static constexpr int DP = (DH + 15) / 16 * 16;  // depth padded for the MMA
  static constexpr int KS = DP / 16;              // k16 steps of a score tile
  static constexpr int NV = (DH + 7) / 8;         // 8-column tiles of one head's output
  static constexpr int LD = DP + 8;               // bf16 row pitch of q/K/V tiles
  static constexpr int CH = DH % 8 == 0 ? 8 : 4;  // bf16 per cp.async
  static constexpr int CPR = DH / CH;             // copies per row
  static constexpr int Q_ELEMS = H * BQ * LD;
  static constexpr int KV_ELEMS = H * BK * LD;    // K of a tile; V follows it
  static constexpr int STAGE_ELEMS = 2 * KV_ELEMS;
  static constexpr size_t TILE_BYTES = sizeof(bf16) * (Q_ELEMS + NSTAGE * STAGE_ELEMS);
  static constexpr size_t OUT_SMEM = TILE_BYTES + sizeof(float) * (H * BQ + H * H + H);
  static_assert(DH % 4 == 0 && H % 4 == 0 && BK % 16 == 0, "shape");
  static_assert(8 * NV <= LD, "the output's column tiles stay inside a row");
  static_assert(OUT_SMEM <= 232448, "shared memory of a block");
};

// Four (two) 8 x 8 bf16 matrices; lane i gives the address of row i % 8 of
// matrix i / 8, and gets of matrix j (in r[j]) the elements
// (row lane / 4, cols 2 (lane % 4), + 1), or with .trans (rows 2 (lane % 4),
// + 1; col lane / 4).
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}
__device__ __forceinline__ void ldsm_x2(uint32_t* r, const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}
__device__ __forceinline__ void ldsm_x2_trans(uint32_t* r, const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(a));
}

// c (16 x 8, f32) += a (16 x 16, bf16, row) b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Key tile t into a stage: K of all heads, then V of all heads.
template <typename C>
__device__ __forceinline__ void load_stage(bf16* dst, const bf16* k, const bf16* v, int b,
                                           int t, int nk, int tid) {
  load_rows<C, C::BK, C::H>(dst, k + (int64_t)b * C::H * nk * C::DH, (int64_t)nk * C::DH, C::DH,
                            t * C::BK, nk, tid);
  load_rows<C, C::BK, C::H>(dst + C::KV_ELEMS, v + (int64_t)b * nk * (C::H * C::DH), C::DH,
                            C::H * C::DH, t * C::BK, nk, tid);
}

// Scores of this warp's 16 rows against keys [key0, key0 + 16) of the staged
// tile, for head h: s[nt][0..3] is the C fragment of 8-key tile nt.
template <typename C>
__device__ __forceinline__ void score_16(const bf16* qs, const bf16* ks, int h, int warp,
                                         int lane, int key0, float (&s)[2][4]) {
  uint32_t qa[C::KS][4];
  const bf16* qrow = qs + (h * BQ + 16 * warp + (lane % 8) + 8 * ((lane / 8) % 2)) * C::LD +
                     8 * (lane / 16);
#pragma unroll
  for (int ks = 0; ks < C::KS; ++ks) ldsm_x4(qa[ks], qrow + 16 * ks);
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
    // K fragments of this 8-key tile: matrix j holds depth 8 j .. 8 j + 7
    uint32_t kb[2 * C::KS];
    const bf16* krow = ks + (h * C::BK + key0 + 8 * nt + (lane % 8)) * C::LD;
#pragma unroll
    for (int j = 0; j + 4 <= 2 * C::KS; j += 4) ldsm_x4(kb + j, krow + 8 * j + 8 * (lane / 8));
    if constexpr (C::KS % 2 == 1)
      ldsm_x2(kb + 2 * C::KS - 2, krow + 8 * (2 * C::KS - 2) + 8 * ((lane / 8) % 2));
#pragma unroll
    for (int ks = 0; ks < C::KS; ++ks) mma_bf16(s[nt], qa[ks], kb[2 * ks], kb[2 * ks + 1]);
  }
}

// Pass 2: out[b, row, h*dh:(h+1)*dh] = (sum_h2 M[h,h2] softmax_h2 + c[h]) V_h.
// Grid (q tiles, B).
template <typename C>
__global__ void __launch_bounds__(NT, 1) out_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ w, const float* __restrict__ bvec,
    const float* __restrict__ lse, bf16* __restrict__ out, int nq, int nk) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ring = qs + C::Q_ELEMS;
  float* lse_s = reinterpret_cast<float*>(ring + NSTAGE * C::STAGE_ELEMS);  // [H][BQ], * log2(e)
  float* m_s = lse_s + C::H * BQ;     // [H][H]: M[h, h2]
  float* c_s = m_s + C::H * C::H;     // [H]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int q0 = blockIdx.x * BQ, b = blockIdx.y;
  constexpr int PROJ = C::H * C::DH;

  zero_bf16<C::Q_ELEMS + NSTAGE * C::STAGE_ELEMS>(qs, tid);
  for (int e = tid; e < C::H * C::H; e += NT) {
    const int h = e / C::H, h2 = e % C::H;
    m_s[e] = w[(int64_t)h2 * PROJ + h * C::DH];
  }
  if (tid < C::H) c_s[tid] = bvec[tid * C::DH];
  for (int e = tid; e < C::H * BQ; e += NT) {
    const int h = e / BQ, r = q0 + e % BQ;
    lse_s[e] = r < nq ? lse[((int64_t)b * C::H + h) * nq + r] * LOG2E : 0.f;
  }
  __syncthreads();
  load_rows<C, BQ, C::H>(qs, q + (int64_t)b * C::H * nq * C::DH, (int64_t)nq * C::DH, C::DH, q0,
                         nq, tid);
  const int n_tiles = (nk + C::BK - 1) / C::BK;
  if (n_tiles > 0) load_stage<C>(ring, k, v, b, 0, nk, tid);
  cp_async_commit();

  float acc[C::H][C::NV][4];
#pragma unroll
  for (int h = 0; h < C::H; ++h)
#pragma unroll
    for (int nv = 0; nv < C::NV; ++nv)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[h][nv][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<0>();
    __syncthreads();   // tile t has landed; everyone is done with tile t - 1
    if (t + 1 < n_tiles)
      load_stage<C>(ring + ((t + 1) % NSTAGE) * C::STAGE_ELEMS, k, v, b, t + 1, nk, tid);
    cp_async_commit();
    const bf16* ks = ring + (t % NSTAGE) * C::STAGE_ELEMS;
    const bf16* vs = ks + C::KV_ELEMS;
    if (q0 + 16 * warp >= nq) continue;   // a warp without rows only copies
    for (int kb16 = 0; kb16 < C::BK; kb16 += 16) {
      const int key = t * C::BK + kb16;
      if (key >= nk) break;
      const bool full = key + 16 <= nk;
      // P_h2 = exp(s - lse) of all heads for these 16 keys, zero past Nk
      float p[C::H][2][4];
#pragma unroll
      for (int h2 = 0; h2 < C::H; ++h2) {
        score_16<C>(qs, ks, h2, warp, lane, kb16, p[h2]);
        const float l0 = lse_s[h2 * BQ + 16 * warp + g], l1 = lse_s[h2 * BQ + 16 * warp + g + 8];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = fast_exp2(fmaf(p[h2][nt][e], LOG2E, e < 2 ? -l0 : -l1));
            p[h2][nt][e] = (full || key + 8 * nt + 2 * t4 + (e % 2) < nk) ? x : 0.f;
          }
      }
      // per output head: mix, round once to bf16, multiply with V_h
#pragma unroll
      for (int h = 0; h < C::H; ++h) {
        float o[2][4];
        const float ch = c_s[h];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            o[nt][e] = (full || key + 8 * nt + 2 * t4 + (e % 2) < nk) ? ch : 0.f;
#pragma unroll
        for (int h4 = 0; h4 < C::H / 4; ++h4) {
          const float4 m = *reinterpret_cast<const float4*>(m_s + h * C::H + 4 * h4);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              o[nt][e] = fmaf(m.x, p[4 * h4 + 0][nt][e], o[nt][e]);
              o[nt][e] = fmaf(m.y, p[4 * h4 + 1][nt][e], o[nt][e]);
              o[nt][e] = fmaf(m.z, p[4 * h4 + 2][nt][e], o[nt][e]);
              o[nt][e] = fmaf(m.w, p[4 * h4 + 3][nt][e], o[nt][e]);
            }
        }
        // the C fragments of the two 8-key tiles are the A fragment of 16 keys
        uint32_t pa[4];
        pa[0] = pack_bf16(o[0][0], o[0][1]);
        pa[1] = pack_bf16(o[0][2], o[0][3]);
        pa[2] = pack_bf16(o[1][0], o[1][1]);
        pa[3] = pack_bf16(o[1][2], o[1][3]);
        // V fragments (transposed on load): matrix 2 j is keys 0..7, 2 j + 1
        // keys 8..15 of column tile j
        uint32_t vb[2 * C::NV];
        const bf16* vrow = vs + (h * C::BK + kb16 + (lane % 8) + 8 * ((lane / 8) % 2)) * C::LD;
#pragma unroll
        for (int j = 0; j + 4 <= 2 * C::NV; j += 4)
          ldsm_x4_trans(vb + j, vrow + 8 * (j / 2) + 8 * (lane / 16));
        if constexpr (C::NV % 2 == 1) ldsm_x2_trans(vb + 2 * C::NV - 2, vrow + 8 * (C::NV - 1));
#pragma unroll
        for (int nv = 0; nv < C::NV; ++nv) mma_bf16(acc[h][nv], pa, vb[2 * nv], vb[2 * nv + 1]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < C::H; ++h)
#pragma unroll
    for (int nv = 0; nv < C::NV; ++nv) {
      const int col = 8 * nv + 2 * t4;
      if (col >= C::DH) continue;       // dh is even: a pair is in or out
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = q0 + 16 * warp + g + 8 * r;
        if (row < nq)
          *reinterpret_cast<__nv_bfloat162*>(out + ((int64_t)b * nq + row) * PROJ + h * C::DH + col) =
              __floats2bfloat162_rn(acc[h][nv][2 * r], acc[h][nv][2 * r + 1]);
      }
    }
}

// Launches the output pass; lse comes from the log-sum-exp pass of
// reattention_tc.cuh.
template <typename C>
int launch_out(const void* q, const void* k, const void* v, const float* w, const float* b,
               const float* lse, void* out, int batch, int nq, int nk, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      out_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(C::OUT_SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  out_kernel<C><<<dim3((nq + BQ - 1) / BQ, batch), NT, C::OUT_SMEM, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), w, b,
      lse, static_cast<bf16*>(out), nq, nk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace vit_mma
