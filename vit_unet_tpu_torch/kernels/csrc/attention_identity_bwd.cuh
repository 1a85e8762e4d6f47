// Training backward of attention with the identity head mix, on Hopper's
// tensor cores, at the keras-attention classes (8, 192) and (4, 192): routes
// 2 (bfloat16) and 3 (float32, split precision) of vit_train_bwd
// (flash_reattention_train.cu).
//
// Replaces the Pallas TPU kernel vit_unet_tpu/kernels/flash_reattention_train.py
// ::_bwd (body _bwd_dkv_kernel) at the training calls of the keras attention
// (vit_unet_tpu/nn/mha.py), whose head mix is M = I, c = 0 and which has no
// BatchNorm term.  There the backward is the flash-attention backward of each
// head with the dropout regenerated in the map:
//
//   P_h  = exp(q_h k_h^T - lse_h) on valid keys,  A_h = P_h * mask_h
//   dV_h = A_h^T g_h
//   dS_h = P_h * (mask_h * (g_h V_h^T) - D_h)
//   dK_h = dS_h^T q_h,  dQ_h = dS_h K_h
//
// (mask: vit::keep_scales' rule, 0 or 1/(1 - rate), keyed on (seed, b,
// h + head_base, row, column group), bit for bit the forward's; D the
// softmax-dot term the caller forms, sum_d g * out).  No head-mix term, no
// BN term and no N x N workspace: m_eff, gmat and kappa are not read.
//
// Precision.  The map side of every product (P, A and dS, f32 in
// registers) is carried as bf16 pairs hi + lo, as reattention_bwd_tc.cuh
// carries dS and B: one bf16 rounding would put the gradients more than
// 1e-3 off the plain version.  bf16 inputs are exact in bf16, so a product
// with them takes two MMAs (lo, hi) and the score products S and g V^T one.
// f32 inputs are split into hi + lo too, and every product takes three MMAs
// (lo hi, hi lo, hi hi; attention_identity_f32.cuh's split products): the
// precision of three bf16 passes, about 2^-16 of a product, inside the f32
// tolerance of 1e-4 of max|plain|.  No TF32 product is issued.
//
// What bounds it on this card.  Its bytes: q, k, v, g read once, lse and D,
// dq, dk, dv written once in f32 (bf16 at (8, 192), N 256, b64: 503 MB,
// 0.150 ms at 3.35 TB/s; f32 705 MB, 0.210 ms).  Its operations: five
// products, 10 A dh with A = B H Nq Nk (0.065 ms at the bf16 peak); the f32
// route issues three bf16 MMAs a product (0.195 ms).  Per map entry one exp,
// and with the dropout a quarter of a Philox call.
//
// Design: two kernels, each writing its outputs once (no atomics, so two
// calls give the same bits), both 8 warps, one block an SM.
//   * dq_kernel, grid (q tiles of BQA = 64, H, B), the forward's shape: the
//     q and g tiles stay in shared memory; K and V tiles of BKA = 32 keys
//     come by cp.async (bf16: a two-slot ring, one barrier a tile; f32: one
//     f32 stage the block splits into hi and lo tiles, two barriers a tile).
//     Warp w owns query rows 16 (w % 4) .. and keys 16 (w / 4) .. of each
//     tile: S = q K^T, T = g V^T, dS, dq += dS K in registers (96
//     accumulators a thread at dh 192).  The dropout as in
//     attention_identity_tc.cuh: a lane draws its rows' four Philox calls
//     once a 64-key window and keeps the keep bits in a register.  At the
//     end the two warps of a row block add their dq through shared memory.
//   * dkv_kernel, grid (key tiles of BKB = 64, H, B), transposed: K and V of
//     its 64 keys stay in shared memory, q and g come in tiles of BQB = 32
//     queries as K and V do above, with two barriers a tile in both
//     precisions (the tile's lse, D and keep bytes are written between
//     them).  Warp w owns keys 16 (w % 4) ..; warps 0-3 form S^T = K q^T,
//     A^T and dv += A^T g, warps 4-7 S^T, T^T = V g^T, dS^T and
//     dk += dS^T q (the C fragments of two 8-query tiles are the A
//     fragment of one 16-query step), 96 accumulators a thread each; the
//     scores are formed twice, once in each warp, rather than 192
//     accumulators in one.  A 64-key tile is one dropout window: per q
//     tile the block draws each (query, column group) Philox call once and
//     keeps its four keep bits in a byte of shared memory, one bit for each
//     16-key warp.
// The f32 kernels read f32 rows by cp.async and split them once a tile
// (the one-time tiles straight from device memory).
//
// Shared memory (bytes): f32 dq 204,288, dkv 204,544; bf16 dq 102,912, dkv
// 103,168.  At (8, 192), N 256, b64: 2,048 blocks of each kernel.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "attention_identity_f32.cuh"
#include "attention_identity_tc.cuh"
#include "reattention_common.cuh"
#include "reattention_mma.cuh"
#include "reattention_tiles.cuh"

namespace vit_idb {

using vit_idf::mma3;
using vit_idf::split2;
using vit_idf::split_store;
using vit_mma::ldsm_x4;
using vit_mma::ldsm_x4_trans;
using vit_mma::mma_bf16;
using vit_tile::bf16;
using vit_tile::cp_async;
using vit_tile::cp_async_commit;
using vit_tile::cp_async_wait;
using vit_tile::fast_exp2;
using vit_tile::LOG2E;

constexpr int NW = 8;          // warps per block
constexpr int NT = 32 * NW;    // threads per block
constexpr int DH = 192;        // the classes' head dim
constexpr int KS = DH / 16;    // k16 steps over the head dim
constexpr int NV = DH / 8;     // 8-column tiles of a row of dh
constexpr int LD = DH + 8;     // bf16 row pitch of the operand tiles
constexpr int LDF = DH + 4;    // f32 row pitch of the stage and of dq's partial sums
constexpr int BQA = 64;        // dq_kernel: query rows a block, 16 a warp
constexpr int BKA = 32;        // dq_kernel: keys a tile, 16 a warp
constexpr int BKB = 64;        // dkv_kernel: keys a block (one dropout window), 16 a warp
constexpr int BQB = 32;        // dkv_kernel: queries a tile

template <bool F32_>
struct Cfg {
  static constexpr bool F32 = F32_;
  using T = typename std::conditional<F32, float, bf16>::type;
  static constexpr int HALVES = F32 ? 2 : 1;   // bf16 tiles of an operand: hi (and lo)
  // dq_kernel: q and g tiles, then the K/V tiles (f32: K hi, lo, V hi, lo
  // and the f32 stage; bf16: two ring slots of K, V), lse and D
  static constexpr int A_QG = BQA * LD;
  static constexpr int A_KV = BKA * LD;
  static constexpr int A_KV_ELEMS = 4 * A_KV;
  static constexpr size_t A_KV_BYTES =
      sizeof(bf16) * A_KV_ELEMS + (F32 ? sizeof(float) * 2 * BKA * LDF : 0);
  static constexpr size_t A_SMEM =
      sizeof(bf16) * 2 * HALVES * A_QG + A_KV_BYTES + sizeof(float) * 2 * BQA;
  // dkv_kernel: K and V tiles, then the q/g tiles as dq_kernel's K/V, lse,
  // D and the keep bytes
  static constexpr int B_KV = BKB * LD;
  static constexpr int B_QG = BQB * LD;
  static constexpr int B_QG_ELEMS = 4 * B_QG;
  static constexpr size_t B_QG_BYTES =
      sizeof(bf16) * B_QG_ELEMS + (F32 ? sizeof(float) * 2 * BQB * LDF : 0);
  static constexpr size_t B_SMEM =
      sizeof(bf16) * 2 * HALVES * B_KV + B_QG_BYTES + sizeof(float) * 2 * BQB + BQB * 16;
  static_assert(sizeof(float) * BQA * LDF <= A_KV_BYTES, "dq's partial sums reuse the K/V tiles");
  static_assert(A_SMEM <= 232448 && B_SMEM <= 232448, "shared memory of a block");
};

// Rows row0 + r (r < ROWS) of src, pitch `stride` elements, into a tile of
// pitch LD (bf16) or LDF (f32) by 16-byte copies; rows at or past n zero.
template <int ROWS>
__device__ __forceinline__ void copy_rows(bf16* dst, const bf16* src, int64_t stride, int row0,
                                          int n, int tid) {
  for (int c = tid; c < ROWS * (DH / 8); c += NT) {
    const int j = c % (DH / 8), r = c / (DH / 8);
    const bool valid = row0 + r < n;
    cp_async<16>(dst + r * LD + 8 * j, valid ? src + (row0 + r) * stride + 8 * j : src, valid);
  }
}
template <int ROWS>
__device__ __forceinline__ void copy_rows(float* dst, const float* src, int64_t stride, int row0,
                                          int n, int tid) {
  for (int c = tid; c < ROWS * (DH / 4); c += NT) {
    const int j = c % (DH / 4), r = c / (DH / 4);
    const bool valid = row0 + r < n;
    cp_async<16>(dst + r * LDF + 4 * j, valid ? src + (row0 + r) * stride + 4 * j : src, valid);
  }
}

// The stage's ROWS f32 rows into the hi tile and the lo tile lo_off after it.
template <int ROWS>
__device__ __forceinline__ void split_rows(const float* stage, bf16* hi, int lo_off, int tid) {
  for (int c = tid; c < ROWS * (DH / 4); c += NT) {
    const int j = c % (DH / 4), r = c / (DH / 4);
    const float4 x = *reinterpret_cast<const float4*>(stage + r * LDF + 4 * j);
    split_store(x, hi + r * LD + 4 * j, hi + lo_off + r * LD + 4 * j);
  }
}

// A block's one-time tile: f32 rows of device memory split straight into hi
// and lo; rows at or past n zero.
template <int ROWS>
__device__ __forceinline__ void split_rows_global(const float* src, int64_t stride, int row0, int n,
                                                  bf16* hi, int lo_off, int tid) {
  for (int c = tid; c < ROWS * (DH / 4); c += NT) {
    const int j = c % (DH / 4), r = c / (DH / 4);
    const float4 x = row0 + r < n
                         ? __ldg(reinterpret_cast<const float4*>(src + (row0 + r) * stride) + j)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    split_store(x, hi + r * LD + 4 * j, hi + lo_off + r * LD + 4 * j);
  }
}

// s[nt] (16 x 8, f32) = rows a_row.. of tile a times rows b_row + 8 nt.. of
// tile b, transposed, over the head dim, nt < NN: both operands from
// shared memory, their lo tiles a_lo and b_lo after the hi ones (f32: three
// MMAs a step; bf16: the hi tiles, one).
template <typename C, int NN>
__device__ __forceinline__ void score(float (&s)[NN][4], const bf16* a, int a_lo, int a_row,
                                      const bf16* b, int b_lo, int b_row, int lane) {
#pragma unroll
  for (int nt = 0; nt < NN; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
  const bf16* ap = a + (a_row + (lane % 8) + 8 * ((lane / 8) % 2)) * LD + 8 * (lane / 16);
  const bf16* bp = b + (b_row + (lane % 8)) * LD + 8 * (lane / 8);
#pragma unroll
  for (int ks = 0; ks < KS; ks += 2) {
    uint32_t ah[2][4];
    [[maybe_unused]] uint32_t al[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      ldsm_x4(ah[i], ap + 16 * (ks + i));
      if constexpr (C::F32) ldsm_x4(al[i], ap + a_lo + 16 * (ks + i));
    }
#pragma unroll
    for (int nt = 0; nt < NN; ++nt) {
      // matrix j of a copy: depth 16 ks + 8 j .. + 7 of the 8 rows
      uint32_t bh[4];
      ldsm_x4(bh, bp + 8 * nt * LD + 16 * ks);
      if constexpr (C::F32) {
        uint32_t bl[4];
        ldsm_x4(bl, bp + b_lo + 8 * nt * LD + 16 * ks);
        mma3(s[nt], ah[0], al[0], bh[0], bh[1], bl[0], bl[1]);
        mma3(s[nt], ah[1], al[1], bh[2], bh[3], bl[2], bl[3]);
      } else {
        mma_bf16(s[nt], ah[0], bh[0], bh[1]);
        mma_bf16(s[nt], ah[1], bh[2], bh[3]);
      }
    }
  }
}

// acc (16 x dh, f32) += X Y: X (16 x 16) the f32 C fragments c0 (k 0..7)
// and c1 (k 8..15) of two 8-wide score tiles, split into hi + lo in
// registers; Y rows b_row .. b_row + 15 of tile b (k x dh, transposed on
// load), its lo tile b_lo after it (f32: three MMAs; bf16: Y exact, two).
template <typename C>
__device__ __forceinline__ void accumulate(float (&acc)[NV][4], const float (&c0)[4],
                                           const float (&c1)[4], const bf16* b, int b_lo,
                                           int b_row, int lane) {
  uint32_t xh[4], xl[4];
  split2(c0[0], c0[1], xh[0], xl[0]);
  split2(c0[2], c0[3], xh[1], xl[1]);
  split2(c1[0], c1[1], xh[2], xl[2]);
  split2(c1[2], c1[3], xh[3], xl[3]);
  const bf16* bp = b + (b_row + (lane % 8) + 8 * ((lane / 8) % 2)) * LD + 8 * (lane / 16);
#pragma unroll
  for (int nv = 0; nv < NV; nv += 2) {
    uint32_t yh[4];   // b0, b1 of column tile nv, then of nv + 1
    ldsm_x4_trans(yh, bp + 8 * nv);
    if constexpr (C::F32) {
      uint32_t yl[4];
      ldsm_x4_trans(yl, bp + b_lo + 8 * nv);
      mma3(acc[nv], xh, xl, yh[0], yh[1], yl[0], yl[1]);
      mma3(acc[nv + 1], xh, xl, yh[2], yh[3], yl[2], yl[3]);
    } else {
      mma_bf16(acc[nv], xl, yh[0], yh[1]);
      mma_bf16(acc[nv], xh, yh[0], yh[1]);
      mma_bf16(acc[nv + 1], xl, yh[2], yh[3]);
      mma_bf16(acc[nv + 1], xh, yh[2], yh[3]);
    }
  }
}

// dq.  Grid (q tiles, H, B).  q (B, H, Nq, dh) pre-scaled, k (B, H, Nk, dh),
// v (B, Nk, H dh), g (B, Nq, H dh) in the input type; lse, D (B, H, Nq) f32;
// dq (B, H, Nq, dh) f32.  DROP: the dropout of seed[0], keep iff bits >> 8
// >= thr, kept entries times scale.
template <typename C, bool DROP>
__global__ void __launch_bounds__(NT, 1) dq_kernel(
    const typename C::T* __restrict__ q, const typename C::T* __restrict__ k,
    const typename C::T* __restrict__ v, const typename C::T* __restrict__ g,
    const float* __restrict__ lse, const float* __restrict__ dvec,
    const int64_t* __restrict__ seed, uint32_t thr, float scale, float* __restrict__ dq,
    int heads, int nq, int nk) {
  using T = typename C::T;
  extern __shared__ __align__(128) unsigned char idb_smem[];
  bf16* q_t = reinterpret_cast<bf16*>(idb_smem);   // [HALVES][BQA][LD], lo after hi
  bf16* g_t = q_t + C::HALVES * C::A_QG;
  bf16* kv = g_t + C::HALVES * C::A_QG;             // f32: K hi, lo, V hi, lo; bf16: [2][K, V]
  float* stage = reinterpret_cast<float*>(kv + C::A_KV_ELEMS);   // f32: [K, V][BKA][LDF]
  float* lse_s = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(kv) + C::A_KV_BYTES);
  float* d_s = lse_s + BQA;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g4 = lane / 4, t4 = lane % 4;
  const int row0 = 16 * (warp % 4), half = warp / 4;   // this warp's rows; its 16 keys of a tile
  const int q0 = blockIdx.x * BQA, h = blockIdx.y, b = blockIdx.z;
  const int64_t proj = (int64_t)heads * DH;
  const int64_t bh = (int64_t)b * heads + h;
  const T* kh = k + bh * nk * DH;
  const T* vh = v + (int64_t)b * nk * proj + h * DH;
  const T* qh = q + bh * nq * DH;
  const T* gh = g + (int64_t)b * nq * proj + h * DH;
  const int n_tiles = (nk + BKA - 1) / BKA;

  auto load_tile = [&](int t) {
    if constexpr (C::F32) {
      copy_rows<BKA>(stage, kh, DH, t * BKA, nk, tid);
      copy_rows<BKA>(stage + BKA * LDF, vh, proj, t * BKA, nk, tid);
    } else {
      bf16* dst = kv + (t & 1) * 2 * C::A_KV;
      copy_rows<BKA>(dst, kh, DH, t * BKA, nk, tid);
      copy_rows<BKA>(dst + C::A_KV, vh, proj, t * BKA, nk, tid);
    }
  };
  if constexpr (!C::F32) {
    copy_rows<BQA>(q_t, qh, DH, q0, nq, tid);
    copy_rows<BQA>(g_t, gh, proj, q0, nq, tid);
  }
  load_tile(0);
  cp_async_commit();   // bf16: the q and g tiles join tile 0's group
  if constexpr (C::F32) {
    split_rows_global<BQA>(qh, DH, q0, nq, q_t, C::A_QG, tid);
    split_rows_global<BQA>(gh, proj, q0, nq, g_t, C::A_QG, tid);
  }
  for (int r = tid; r < BQA; r += NT) {
    const bool valid = q0 + r < nq;
    lse_s[r] = valid ? lse[bh * nq + q0 + r] * LOG2E : 0.f;
    d_s[r] = valid ? dvec[bh * nq + q0 + r] : 0.f;
  }

  float acc[NV][4];
#pragma unroll
  for (int nv = 0; nv < NV; ++nv)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nv][e] = 0.f;
  uint64_t sd = 0;
  uint32_t keep = 0;   // this lane's keep bits of the current 64-key window
  if constexpr (DROP) sd = static_cast<uint64_t>(seed[0]);

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<0>();
    __syncthreads();   // tile t has landed; every warp is done with tile t - 1
    const bf16* k_t = kv + (C::F32 ? 0 : (t & 1) * 2 * C::A_KV);
    const bf16* v_t = k_t + (C::F32 ? 2 : 1) * C::A_KV;
    if constexpr (C::F32) {
      split_rows<BKA>(stage, kv, C::A_KV, tid);
      split_rows<BKA>(stage + BKA * LDF, kv + 2 * C::A_KV, C::A_KV, tid);
      __syncthreads();   // the halves are written; the stage is free
    }
    if (t + 1 < n_tiles) load_tile(t + 1);
    cp_async_commit();

    // S = q K^T and T = g V^T over this warp's 16 keys of the tile
    float s[2][4], dp[2][4];
    score<C, 2>(s, q_t, C::A_QG, row0, k_t, C::A_KV, 16 * half, lane);
    score<C, 2>(dp, g_t, C::A_QG, row0, v_t, C::A_KV, 16 * half, lane);
    const int k0 = t * BKA;
    if constexpr (DROP)
      if ((k0 & 63) == 0) keep = vit_id::window_keep(sd, thr, b, h, q0 + row0 + g4, nq, k0 >> 6, t4);
    const int j0 = ((k0 & 63) >> 3) + 2 * half;   // 8-key tiles of the window before this warp's
    const float lr[2] = {lse_s[row0 + g4], lse_s[row0 + g4 + 8]};
    const float dr[2] = {d_s[row0 + g4], d_s[row0 + g4 + 8]};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 16 * half + 8 * nt + 2 * t4 + (e % 2);
        const float p = key < nk ? fast_exp2(fmaf(s[nt][e], LOG2E, -lr[e / 2])) : 0.f;
        float m = 1.f;
        if constexpr (DROP) m = (keep >> (16 * (e / 2) + 2 * (j0 + nt) + e % 2)) & 1u ? scale : 0.f;
        s[nt][e] = p * (m * dp[nt][e] - dr[e / 2]);   // dS
      }
    accumulate<C>(acc, s[0], s[1], k_t, C::A_KV, 16 * half, lane);   // dq += dS K
  }
  cp_async_wait<0>();
  __syncthreads();   // every warp is done with the K/V tiles, which the sums reuse

  float* red = reinterpret_cast<float*>(kv);   // [BQA][LDF]: the key half 1 warps' dq
  if (half == 1) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int nv = 0; nv < NV; ++nv)
        *reinterpret_cast<float2*>(red + (row0 + g4 + 8 * r) * LDF + 8 * nv + 2 * t4) =
            make_float2(acc[nv][2 * r], acc[nv][2 * r + 1]);
  }
  __syncthreads();
  if (half == 1) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + row0 + g4 + 8 * r;
    if (row >= nq) continue;
    float* drow = dq + (bh * nq + row) * DH + 2 * t4;
    const float* prow = red + (row0 + g4 + 8 * r) * LDF + 2 * t4;
#pragma unroll
    for (int nv = 0; nv < NV; ++nv) {
      const float2 o = *reinterpret_cast<const float2*>(prow + 8 * nv);
      *reinterpret_cast<float2*>(drow + 8 * nv) =
          make_float2(acc[nv][2 * r] + o.x, acc[nv][2 * r + 1] + o.y);
    }
  }
}

// dk and dv.  Grid (key tiles, H, B), inputs as dq_kernel's; dk (B, H, Nk,
// dh) and dv (B, Nk, H dh) f32.
template <typename C, bool DROP>
__global__ void __launch_bounds__(NT, 1) dkv_kernel(
    const typename C::T* __restrict__ q, const typename C::T* __restrict__ k,
    const typename C::T* __restrict__ v, const typename C::T* __restrict__ g,
    const float* __restrict__ lse, const float* __restrict__ dvec,
    const int64_t* __restrict__ seed, uint32_t thr, float scale, float* __restrict__ dk,
    float* __restrict__ dv, int heads, int nq, int nk) {
  using T = typename C::T;
  extern __shared__ __align__(128) unsigned char idb_smem[];
  bf16* k_t = reinterpret_cast<bf16*>(idb_smem);   // [HALVES][BKB][LD], lo after hi
  bf16* v_t = k_t + C::HALVES * C::B_KV;
  bf16* qg = v_t + C::HALVES * C::B_KV;            // f32: q hi, lo, g hi, lo; bf16: [2][q, g]
  float* stage = reinterpret_cast<float*>(qg + C::B_QG_ELEMS);   // f32: [q, g][BQB][LDF]
  float* lse_s = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(qg) + C::B_QG_BYTES);
  float* d_s = lse_s + BQB;
  unsigned char* mb = reinterpret_cast<unsigned char*>(d_s + BQB);   // [BQB][16]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g4 = lane / 4, t4 = lane % 4;
  const int kg = warp % 4, dk_warp = warp / 4;   // keys 16 kg ..; dv (0) or dk (1)
  const int k0 = blockIdx.x * BKB, h = blockIdx.y, b = blockIdx.z;
  const int64_t proj = (int64_t)heads * DH;
  const int64_t bh = (int64_t)b * heads + h;
  const T* kh = k + bh * nk * DH;
  const T* vh = v + (int64_t)b * nk * proj + h * DH;
  const T* qh = q + bh * nq * DH;
  const T* gh = g + (int64_t)b * nq * proj + h * DH;
  const int n_tiles = (nq + BQB - 1) / BQB;

  auto load_tile = [&](int t) {
    if constexpr (C::F32) {
      copy_rows<BQB>(stage, qh, DH, t * BQB, nq, tid);
      copy_rows<BQB>(stage + BQB * LDF, gh, proj, t * BQB, nq, tid);
    } else {
      bf16* dst = qg + (t & 1) * 2 * C::B_QG;
      copy_rows<BQB>(dst, qh, DH, t * BQB, nq, tid);
      copy_rows<BQB>(dst + C::B_QG, gh, proj, t * BQB, nq, tid);
    }
  };
  if constexpr (!C::F32) {
    copy_rows<BKB>(k_t, kh, DH, k0, nk, tid);
    copy_rows<BKB>(v_t, vh, proj, k0, nk, tid);
  }
  load_tile(0);
  cp_async_commit();   // bf16: the K and V tiles join q tile 0's group
  if constexpr (C::F32) {
    split_rows_global<BKB>(kh, DH, k0, nk, k_t, C::B_KV, tid);
    split_rows_global<BKB>(vh, proj, k0, nk, v_t, C::B_KV, tid);
  }

  float acc[NV][4];
#pragma unroll
  for (int nv = 0; nv < NV; ++nv)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nv][e] = 0.f;
  uint64_t sd = 0;
  if constexpr (DROP) sd = static_cast<uint64_t>(seed[0]);

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<0>();
    __syncthreads();   // q tile t has landed; every warp is done with tile t - 1
    const bf16* q_c = qg + (C::F32 ? 0 : (t & 1) * 2 * C::B_QG);
    const bf16* g_c = q_c + (C::F32 ? 2 : 1) * C::B_QG;
    if constexpr (C::F32) {
      split_rows<BQB>(stage, qg, C::B_QG, tid);
      split_rows<BQB>(stage + BQB * LDF, qg + 2 * C::B_QG, C::B_QG, tid);
    }
    // lse (+inf past Nq, so P is 0 there), D, and the tile's keep bytes:
    // bit j of byte (query, c) keeps key k0 + 16 j + c, from one Philox call
    for (int r = tid; r < BQB; r += NT) {
      const int row = t * BQB + r;
      lse_s[r] = row < nq ? lse[bh * nq + row] * LOG2E : INFINITY;
      d_s[r] = row < nq ? dvec[bh * nq + row] : 0.f;
    }
    if constexpr (DROP) {
      for (int i = tid; i < BQB * 16; i += NT) {
        const int row = t * BQB + i / 16;
        unsigned bits = 0;
        if (row < nq) {
          const uint4 w = vit::philox4(sd, b, h, row, 16 * blockIdx.x + i % 16);
          bits = static_cast<unsigned>((w.x >> 8) >= thr) | static_cast<unsigned>((w.y >> 8) >= thr) << 1 |
                 static_cast<unsigned>((w.z >> 8) >= thr) << 2 | static_cast<unsigned>((w.w >> 8) >= thr) << 3;
        }
        mb[i] = static_cast<unsigned char>(bits);
      }
    }
    __syncthreads();   // the tile's halves, rows and bits are written
    if (t + 1 < n_tiles) load_tile(t + 1);
    cp_async_commit();

    // S^T = K q^T over this warp's 16 keys and the tile's 32 queries
    float s[4][4];
    score<C, 4>(s, k_t, C::B_KV, 16 * kg, q_c, C::B_QG, 0, lane);
    float dp[4][4] = {};
    if (dk_warp) score<C, 4>(dp, v_t, C::B_KV, 16 * kg, g_c, C::B_QG, 0, lane);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = 8 * nt + 2 * t4 + (e % 2);
        const float p = fast_exp2(fmaf(s[nt][e], LOG2E, -lse_s[ql]));
        float m = 1.f;
        if constexpr (DROP) m = (mb[16 * ql + g4 + 8 * (e / 2)] >> kg) & 1u ? scale : 0.f;
        s[nt][e] = dk_warp ? p * (m * dp[nt][e] - d_s[ql]) : p * m;   // dS^T or A^T
      }
    // dk += dS^T q, dv += A^T g, 16 queries a step
    const bf16* y = dk_warp ? q_c : g_c;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) accumulate<C>(acc, s[2 * kk], s[2 * kk + 1], y, C::B_QG, 16 * kk, lane);
  }
  cp_async_wait<0>();   // no copy is left in flight at exit

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + 16 * kg + g4 + 8 * r;
    if (key >= nk) continue;
    float* orow = dk_warp ? dk + (bh * nk + key) * DH + 2 * t4
                          : dv + ((int64_t)b * nk + key) * proj + h * DH + 2 * t4;
#pragma unroll
    for (int nv = 0; nv < NV; ++nv)
      *reinterpret_cast<float2*>(orow + 8 * nv) = make_float2(acc[nv][2 * r], acc[nv][2 * r + 1]);
  }
}

template <bool F32, bool DROP>
int launch(const void* q, const void* k, const void* v, const void* g, const float* lse,
           const float* dvec, const int64_t* seed, int thr, float scale, float* dq, float* dk,
           float* dv, int batch, int heads, int nq, int nk, cudaStream_t stream) {
  using C = Cfg<F32>;
  using T = typename C::T;
  cudaError_t err = cudaFuncSetAttribute(dq_kernel<C, DROP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(C::A_SMEM));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dkv_kernel<C, DROP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(C::B_SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(g);
  const uint32_t th = static_cast<uint32_t>(thr);
  dq_kernel<C, DROP><<<dim3((nq + BQA - 1) / BQA, heads, batch), NT, C::A_SMEM, stream>>>(
      qt, kt, vt, gt, lse, dvec, seed, th, scale, dq, heads, nq, nk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dkv_kernel<C, DROP><<<dim3((nk + BKB - 1) / BKB, heads, batch), NT, C::B_SMEM, stream>>>(
      qt, kt, vt, gt, lse, dvec, seed, th, scale, dk, dv, heads, nq, nk);
  return static_cast<int>(cudaGetLastError());
}

// The routes' classes: (8, 192) and (4, 192); dtype 0 float32 (route 3), 1
// bfloat16 (route 2).  cudaErrorInvalidValue for any other shape.  Every
// output is written once.  seed: a device int64, read only where thr > 0.
inline int train_bwd_identity(const void* q, const void* k, const void* v, const void* g,
                              const float* lse, const float* dvec, const int64_t* seed, int thr,
                              float scale, float* dq, float* dk, float* dv, int batch, int heads,
                              int nq, int nk, int dh, int dtype, cudaStream_t s) {
  if (dh != DH || (heads != 8 && heads != 4) || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
#define VIT_IDB(F, D) launch<F, D>(q, k, v, g, lse, dvec, seed, thr, scale, dq, dk, dv, batch, heads, nq, nk, s)
  if (dtype == 0) return thr > 0 ? VIT_IDB(true, true) : VIT_IDB(true, false);
  return thr > 0 ? VIT_IDB(false, true) : VIT_IDB(false, false);
#undef VIT_IDB
}

}  // namespace vit_idb
