// Flash re-attention with the identity head mix in float32, on Hopper's
// tensor cores in split precision, at the keras-attention classes (8, 192)
// and (4, 192): route 3 of vit_flash_reattention (flash_reattention.cu, eval)
// and route 3 of vit_train_fwd (flash_reattention_train.cu, the training
// forward, with the in-map dropout).
//
// Replaces the Pallas TPU kernels vit_unet_tpu/kernels/flash_reattention.py
// ::flash_reattention (body _kernel) and vit_unet_tpu/kernels/
// flash_reattention_train.py::_fwd (body _fwd_kernel) at the float32 calls
// of the keras attention (vit_unet_tpu/nn/mha.py; HViTUNetTFConfig's default
// dtype), whose head mix is M = I, c = 0.  The function is
// attention_identity_tc.cuh's,
//
//   out[b, n, h*dh:(h+1)*dh] = sum_m A_h[n, m] V_h[m]            (f32)
//   lse[b, h, n]             = log sum_m exp(q_h[n] . k_h[m])   (f32, before dropout)
//
// with A_h = softmax(q_h k_h^T) * mask (mask = 1 in eval; in training the
// dropout scale of vit::keep_scales' rule, drawn as attention_identity_tc.cuh
// draws it: a lane's Philox calls once a 64-key window, its keep bits in a
// register for both 32-key tiles), and w, b, m_eff, c_eff are not read.
//
// The precision of three bf16 passes, not f32's.  Every f32 operand x is
// carried as the pair hi = bf16(x), lo = bf16(x - hi): hi + lo is x to about
// 2^-17 of |x| (16 bits of mantissa against f32's 24).  Each product takes
// three bf16 MMAs with f32 accumulation, the two cross terms first,
// x y = lo_x hi_y + hi_x lo_y + hi_x hi_y (lo_x lo_y, about 2^-16 of the
// product, is left out): about 2^-16 (1.5e-5) of a product, inside the f32
// tolerance of 1e-4 of max|plain|.  No single TF32 or bf16 product is
// issued: the scores q K^T and the product P V both take the three terms,
// and P is split after the exp, in f32.
//
// What bounds it on this card.  Its bytes: q, k, v read once and out written
// once in f32, 4 B N H dh 4 (0.120 ms at (8, 192), N 256, b64, at 3.35
// TB/s).  Its operations as issued: three bf16 MMA products of each of the
// two, 3 x 4 B H Nq Nk dh (0.078 ms at the bf16 peak).  The bound is the
// larger, bytes.  Beside the MMAs: one exp a map entry, the split of each
// probability, and the split of every K and V element once a block.
//
// Design (attention_identity_tc.cuh's one pass, with the splits):
//   * grid (q tiles of BQ = 16 NW rows, H, B): a block of NW warps owns BQ
//     query rows of one (image, head), warp w rows 16 w .. 16 w + 15;
//   * the q tile is read once and split into hi and lo bf16 tiles in shared
//     memory (its fragments, 96 registers a thread at dh 192 for both halves,
//     would not fit beside the 96-register accumulator, so each warp takes
//     them by ldmatrix a 32-deep step at a time);
//   * K and V tiles of BK keys come in f32 by cp.async into one staging
//     buffer; the block splits the staged tile into hi and lo bf16 tiles and
//     the copy of the next tile starts, so it lands while this one's MMAs
//     run (two barriers a tile); rows past Nk are zero-filled by the copies;
//   * S = q K^T and acc += P V by mma.sync m16n8k16 (three a product),
//     online softmax in registers in base 2, as in the bf16 route; P is
//     split in registers into the A fragments of the P V product;
//   * with the dropout, P's dropped entries are 0 and its kept ones scaled
//     by 1/(1 - rate) after the row sum is taken, before the split;
//   * out = acc / l goes to device memory as 8-byte stores from the C
//     fragments (each row's 32 bytes a quad of lanes), lse = m + log l.
//     Without keys the output is 0 and lse +inf, as on the other routes.
//
// Shared memory at dh 192, BK 32, NW 8: q hi, lo 2 x 128 x 200 bf16 +
// K, V hi, lo 4 x 32 x 200 bf16 + the f32 stage 2 x 32 x 196 = 102,400 +
// 51,200 + 50,176 = 203,776 B, one block (8 warps) an SM.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_identity_tc.cuh"
#include "reattention_mma.cuh"
#include "reattention_tiles.cuh"

namespace vit_idf {

using vit_mma::ldsm_x4;
using vit_mma::ldsm_x4_trans;
using vit_mma::mma_bf16;
using vit_tile::bf16;
using vit_tile::cp_async;
using vit_tile::cp_async_commit;
using vit_tile::cp_async_wait;
using vit_tile::fast_exp2;
using vit_tile::LOG2E;

template <int DH_, int BK_, int NW_>
struct Cfg {
  static constexpr int DH = DH_, BK = BK_, NW = NW_;
  static constexpr int NT = 32 * NW;              // threads per block
  static constexpr int BQ = 16 * NW;              // query rows per block: 16 a warp
  static constexpr int KS = DH / 16;              // k16 steps of a score tile
  static constexpr int NV = DH / 8;               // 8-column tiles of the output
  static constexpr int NS = BK / 8;               // 8-key tiles of a score tile
  static constexpr int LD = DH + 8;               // bf16 row pitch of the split tiles
  static constexpr int LDF = DH + 4;              // f32 row pitch of the stage
  static constexpr int Q_ELEMS = BQ * LD;         // one half (hi or lo) of the q tile
  static constexpr int KV_ELEMS = BK * LD;        // one half of a K or V tile
  static constexpr int STAGE_FLOATS = 2 * BK * LDF;   // K rows, then V rows
  static constexpr size_t SMEM =
      sizeof(bf16) * (2 * Q_ELEMS + 4 * KV_ELEMS) + sizeof(float) * STAGE_FLOATS;
  static_assert(DH % 32 == 0 && NV % 2 == 0 && BK % 16 == 0, "shape");
  static_assert(SMEM <= 232448, "shared memory of a block");
};

// (hi, lo) bf16 pairs of (a, b): hi = bf16(x), lo = bf16(x - hi), each pair
// packed with a in the low half, as an MMA fragment register holds it.
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Four f32 values to the hi and lo tiles at the same offset, 8 bytes each.
__device__ __forceinline__ void split_store(float4 x, bf16* hi, bf16* lo) {
  uint2 h, l;
  split2(x.x, x.y, h.x, l.x);
  split2(x.z, x.w, h.y, l.y);
  *reinterpret_cast<uint2*>(hi) = h;
  *reinterpret_cast<uint2*>(lo) = l;
}

// c += a b in f32 from split operands: the two cross terms, then hi hi.
__device__ __forceinline__ void mma3(float* c, const uint32_t* a_hi, const uint32_t* a_lo,
                                     uint32_t bh0, uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  mma_bf16(c, a_lo, bh0, bh1);
  mma_bf16(c, a_hi, bl0, bl1);
  mma_bf16(c, a_hi, bh0, bh1);
}

// c += a b in f32 from operands split into triples hi, mid, lo (16 x 16 A
// fragments, the B fragment pairs of one 8-column tile): the 2^-16 terms
// lo hi, hi lo, mid mid first, then mid hi, hi mid, hi hi (lo mid, mid lo
// and lo lo, about 2^-24 of the product, are left out).
__device__ __forceinline__ void mma6(float* c, const uint32_t* a_hi, const uint32_t* a_mid,
                                     const uint32_t* a_lo, const uint32_t* b_hi,
                                     const uint32_t* b_mid, const uint32_t* b_lo) {
  mma_bf16(c, a_lo, b_hi[0], b_hi[1]);
  mma_bf16(c, a_hi, b_lo[0], b_lo[1]);
  mma_bf16(c, a_mid, b_mid[0], b_mid[1]);
  mma3(c, a_hi, a_mid, b_hi[0], b_hi[1], b_mid[0], b_mid[1]);
}

// Grid (q tiles, H, B).  q (B, H, Nq, dh) pre-scaled, k (B, H, Nk, dh),
// v (B, Nk, H dh), all f32; out (B, Nq, H dh) f32, lse (B, H, Nq) f32.
// DROP: the dropout of seed[0], keep iff bits >> 8 >= thr, kept entries
// times scale.
template <typename C, bool DROP>
__global__ void __launch_bounds__(C::NT, 1) attend_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ lse, float* __restrict__ out, int heads, int nq, int nk,
    const int64_t* __restrict__ seed, uint32_t thr, float scale) {
  extern __shared__ __align__(128) unsigned char idf_smem[];
  bf16* q_hi = reinterpret_cast<bf16*>(idf_smem);   // [BQ][LD]
  bf16* q_lo = q_hi + C::Q_ELEMS;
  bf16* k_hi = q_lo + C::Q_ELEMS;                   // [BK][LD] each
  bf16* k_lo = k_hi + C::KV_ELEMS;
  bf16* v_hi = k_lo + C::KV_ELEMS;
  bf16* v_lo = v_hi + C::KV_ELEMS;
  float* stage = reinterpret_cast<float*>(v_lo + C::KV_ELEMS);   // [K, V][BK][LDF]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int q0 = blockIdx.x * C::BQ, h = blockIdx.y, b = blockIdx.z;
  const int64_t proj = (int64_t)heads * C::DH;
  const int64_t bh = (int64_t)b * heads + h;
  const float* kh = k + bh * nk * C::DH;
  const float* vh = v + (int64_t)b * nk * proj + h * C::DH;
  constexpr int CPR = C::DH / 4;   // 16-byte copies (float4) a row

  // key tile t into the stage, K rows then V rows; rows at or past nk zero
  auto load_tile = [&](int t) {
    for (int c = tid; c < 2 * C::BK * CPR; c += C::NT) {
      const int j = c % CPR, r = (c / CPR) % C::BK, kv = c / (CPR * C::BK);
      const int key = t * C::BK + r;
      const bool valid = key < nk;
      const float* src = kv == 0 ? kh + (int64_t)key * C::DH : vh + (int64_t)key * proj;
      cp_async<16>(stage + (kv * C::BK + r) * C::LDF + 4 * j, valid ? src + 4 * j : kh, valid);
    }
  };
  const int n_tiles = (nk + C::BK - 1) / C::BK;
  if (n_tiles > 0) load_tile(0);
  cp_async_commit();
  // the q tile, split once; rows at or past nq zero
  const float* qh = q + bh * nq * C::DH;
  for (int c = tid; c < C::BQ * CPR; c += C::NT) {
    const int j = c % CPR, r = c / CPR, row = q0 + r;
    const float4 x = row < nq ? __ldg(reinterpret_cast<const float4*>(qh + (int64_t)row * C::DH) + j)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
    split_store(x, q_hi + r * C::LD + 4 * j, q_lo + r * C::LD + 4 * j);
  }

  float acc[C::NV][4];
#pragma unroll
  for (int nv = 0; nv < C::NV; ++nv)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nv][e] = 0.f;
  // rows g and g + 8 of the warp's 16: running max (of the scores times
  // log2 e) and this lane's part of the running sum
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  const int a_off = (16 * warp + (lane % 8) + 8 * ((lane / 8) % 2)) * C::LD + 8 * (lane / 16);
  uint64_t sd = 0;
  uint32_t keep = 0;   // this lane's keep bits of the current 64-key window
  if constexpr (DROP) sd = static_cast<uint64_t>(seed[0]);

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<0>();
    __syncthreads();   // tile t is staged; every warp is done with tile t - 1's halves
    for (int c = tid; c < 2 * C::BK * CPR; c += C::NT) {
      const int j = c % CPR, r = (c / CPR) % C::BK, kv = c / (CPR * C::BK);
      const float4 x = *reinterpret_cast<const float4*>(stage + (kv * C::BK + r) * C::LDF + 4 * j);
      bf16* hi = (kv == 0 ? k_hi : v_hi) + r * C::LD + 4 * j;
      split_store(x, hi, hi + C::KV_ELEMS);   // the lo tile follows its hi tile
    }
    __syncthreads();   // the halves are written; the stage is free
    if (t + 1 < n_tiles) load_tile(t + 1);
    cp_async_commit();

    // S = q K^T: s[nt] is the C fragment of keys 8 nt .. 8 nt + 7
    float s[C::NS][4];
#pragma unroll
    for (int nt = 0; nt < C::NS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < C::KS; ks += 2) {
      uint32_t qa_hi[2][4], qa_lo[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        ldsm_x4(qa_hi[i], q_hi + a_off + 16 * (ks + i));
        ldsm_x4(qa_lo[i], q_lo + a_off + 16 * (ks + i));
      }
#pragma unroll
      for (int nt = 0; nt < C::NS; ++nt) {
        // matrix j of a copy: depth 16 ks + 8 j .. + 7 of the 8 keys
        const int b_off = (8 * nt + (lane % 8)) * C::LD + 8 * (lane / 8) + 16 * ks;
        uint32_t kb_hi[4], kb_lo[4];
        ldsm_x4(kb_hi, k_hi + b_off);
        ldsm_x4(kb_lo, k_lo + b_off);
        mma3(s[nt], qa_hi[0], qa_lo[0], kb_hi[0], kb_hi[1], kb_lo[0], kb_lo[1]);
        mma3(s[nt], qa_hi[1], qa_lo[1], kb_hi[2], kb_hi[3], kb_lo[2], kb_lo[3]);
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
      static_assert(C::BK == 32, "a tile is half a 64-key dropout window");
      if ((k0 & 63) == 0)
        keep = vit_id::window_keep(sd, thr, b, h, q0 + 16 * warp + g, nq, k0 >> 6, t4);
      const int j0 = (k0 & 63) >> 3;   // 8-key tiles of the window before this one
#pragma unroll
      for (int nt = 0; nt < C::NS; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[nt][e] = (keep >> (16 * (e / 2) + 2 * (j0 + nt) + e % 2)) & 1u ? s[nt][e] * scale
                                                                           : 0.f;
    }

    // acc += P V, 16 keys a step, P split in registers
#pragma unroll
    for (int kk = 0; kk < C::BK / 16; ++kk) {
      uint32_t pa_hi[4], pa_lo[4];
      split2(s[2 * kk][0], s[2 * kk][1], pa_hi[0], pa_lo[0]);
      split2(s[2 * kk][2], s[2 * kk][3], pa_hi[1], pa_lo[1]);
      split2(s[2 * kk + 1][0], s[2 * kk + 1][1], pa_hi[2], pa_lo[2]);
      split2(s[2 * kk + 1][2], s[2 * kk + 1][3], pa_hi[3], pa_lo[3]);
      const int v_off =
          (16 * kk + (lane % 8) + 8 * ((lane / 8) % 2)) * C::LD + 8 * (lane / 16);
#pragma unroll
      for (int nv = 0; nv < C::NV; nv += 2) {
        uint32_t vb_hi[4], vb_lo[4];   // b0, b1 of column tile nv, then of nv + 1
        ldsm_x4_trans(vb_hi, v_hi + v_off + 8 * nv);
        ldsm_x4_trans(vb_lo, v_lo + v_off + 8 * nv);
        mma3(acc[nv], pa_hi, pa_lo, vb_hi[0], vb_hi[1], vb_lo[0], vb_lo[1]);
        mma3(acc[nv + 1], pa_hi, pa_lo, vb_hi[2], vb_hi[3], vb_lo[2], vb_lo[3]);
      }
    }
  }
  cp_async_wait<0>();   // no copy is left in flight at exit (none without keys)

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = l > 0.f ? 1.f / l : 0.f;
    const int row = q0 + 16 * warp + g + 8 * r;
    if (row >= nq) continue;
    float* orow = out + ((int64_t)b * nq + row) * proj + h * C::DH + 2 * t4;
#pragma unroll
    for (int nv = 0; nv < C::NV; ++nv)
      *reinterpret_cast<float2*>(orow + 8 * nv) =
          make_float2(acc[nv][2 * r] * inv, acc[nv][2 * r + 1] * inv);
    if (t4 == 0) lse[bh * nq + row] = l > 0.f ? m_run[r] / LOG2E + logf(l) : INFINITY;
  }
}

// The routes' classes: (8, 192) and (4, 192), float32; the kernel depends on
// dh alone.  cudaErrorInvalidValue for any other shape.  seed: a device
// int64, read only with DROP (thr > 0).
template <bool DROP>
int launch(const void* q, const void* k, const void* v, const int64_t* seed, int thr,
           float scale, float* lse, void* out, int batch, int heads, int nq, int nk, int dh,
           cudaStream_t stream) {
  if (dh != 192 || (heads != 8 && heads != 4)) return static_cast<int>(cudaErrorInvalidValue);
  using C = Cfg<192, 32, 8>;
  cudaError_t err = cudaFuncSetAttribute(attend_f32_kernel<C, DROP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(C::SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  attend_f32_kernel<C, DROP><<<dim3((nq + C::BQ - 1) / C::BQ, heads, batch), C::NT, C::SMEM,
                               stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      lse, static_cast<float*>(out), heads, nq, nk, seed, static_cast<uint32_t>(thr), scale);
  return static_cast<int>(cudaGetLastError());
}

// Kernel 1's route: no dropout.
inline int launch_eval(const void* q, const void* k, const void* v, float* lse, void* out,
                       int batch, int heads, int nq, int nk, int dh, cudaStream_t stream) {
  return launch<false>(q, k, v, nullptr, 0, 1.f, lse, out, batch, heads, nq, nk, dh, stream);
}

// Kernel 2's route: the training forward, with the dropout where thr > 0.
inline int launch_train(const void* q, const void* k, const void* v, const int64_t* seed, int thr,
                        float scale, float* lse, void* out, int batch, int heads, int nq, int nk,
                        int dh, cudaStream_t stream) {
  return thr > 0 ? launch<true>(q, k, v, seed, thr, scale, lse, out, batch, heads, nq, nk, dh,
                                stream)
                 : launch<false>(q, k, v, seed, thr, scale, lse, out, batch, heads, nq, nk, dh,
                                 stream);
}

}  // namespace vit_idf
