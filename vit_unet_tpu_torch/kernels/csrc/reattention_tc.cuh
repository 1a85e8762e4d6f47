// Eval flash re-attention on Hopper's tensor cores: the bfloat16 route of
// flash_reattention.cu (which holds the interface and the float32 route).
//
// Replaces the Pallas TPU kernel vit_unet_tpu/kernels/flash_reattention.py
// ::flash_reattention (body _kernel) for bfloat16 q, k, v.
//
// What bounds the function on this card.  Its tensor-core work is tiny
// (2 * A * 2 * dh operations over A = B * H * Nq * Nk map entries) and so are
// its bytes; what costs time is everything per map entry between the two
// products: the exp, the H * H head mix, and the trips of scores and
// probabilities through shared memory, in phases a block's warps leave
// together (a barrier each) while the next tile's copy is in flight.  The
// CUDA-core route pays a scalar shared-memory load for every two FMAs, two
// barriers and a synchronous global load per 32-deep chunk, and recomputes
// every score H / G times.
//
// What this design does about it.  Two passes as before (the mix needs each
// head's normalised probabilities, so the per-row log-sum-exp comes first),
// both on one block shape: a block of 8 warps owns a tile of BQ query rows of
// one image and ALL heads, so every score tile is computed once per pass.
//
//   * Both products run as wmma m16n16k16 bf16 MMAs with f32 accumulators:
//     S_h2 = Q_h2 K_h2^T (K read as stored, [key][d], as a col_major B) and
//     acc_h += P'_h V_h (V as stored, [key][col], row_major B).  A warp's
//     tiles of a stage form a block of one head that shares its B fragments
//     and runs as independent MMA chains.
//   * q, K and V tiles are staged as bf16 over the whole head dim, depth and
//     width zero-padded to a multiple of 16, rows padded by 8 bf16 against
//     bank conflicts.  The q tile of all heads is staged once per block.  K
//     and V come in stages of HG heads x BK keys through a ring of NSTAGE
//     (2 or 3) buffers filled by cp.async (16 bytes a copy where
//     dh % 8 == 0, else 8): later stages load while stage s computes, with
//     one barrier a stage.  Rows past Nk (and Nq) are zero-filled by every
//     copy (src-size 0).
//   * Per key tile the stages are K groups 0..G-1, then V groups 0..G-1
//     (G = H / HG; G = 1 where all heads fit one stage).  A K stage writes
//     its f32 score tiles to the score region S[H][BQ][BK + 4].  Then one
//     thread per (row, 4 keys) reads all H scores of its entries, forms
//     P_h2 = exp(s - lse_h2) on valid keys, mixes
//     P'_h = sum_h2 M[h,h2] P_h2 + c[h] in f32 registers and writes P'_h back
//     IN PLACE as bf16 (rounded once, as the TPU kernel's p.astype(v.dtype)):
//     a row's threads sit in one warp and all read before any writes.
//     Invalid keys get P' = 0, and no c[h]; a full tile takes a path without
//     the validity tests.  A V stage multiplies P'_h with V_h; warp w owns
//     the same output tiles of every head group for the block's lifetime
//     (its accumulator fragments).
//   * The log-sum-exp pass runs the K stages alone; after the last one of a
//     key tile one thread per (head, row) folds the row's BK scores into its
//     running max and sum in shared memory.
//
// Shape classes (heads, dh) -> BQ, BK, HG, NSTAGE; dynamic shared memory of
// the output pass (score region + q tile + ring + lse, M, c), blocks per SM,
// accumulator registers per thread (H * BQ * dh_pad / 256).  Chosen among a
// few variants each, timed on an H100 at the presets' level shapes: few fat
// phases per key tile (all heads in a stage) and two blocks an SM where they
// fit beat deeper rings of smaller stages.
//
//   ( 8, 384)  16, 32, 1, 3   18,432 + 100,352 +  75,264 +   800 = 194,848   1   192
//   ( 8,  96)  32, 32, 8, 2   36,864 +  53,248 + 106,496 + 1,312 = 197,920   1    96
//   ( 8,  24)  32, 32, 8, 2   36,864 +  20,480 +  40,960 + 1,312 =  99,616   2    32 (*)
//   ( 4, 192)  16, 32, 2, 2    9,216 +  25,600 +  51,200 +   336 =  86,352   2    48
//   ( 4,  48)  32, 64, 4, 2   34,816 +  14,336 +  57,344 +   592 = 107,088   2    24
//   ( 4,  12)  32, 64, 4, 2   34,816 +   6,144 +  24,576 +   592 =  66,128   2     8
//   (16,  48)  16, 64, 8, 2   69,632 +  28,672 + 114,688 + 2,112 = 215,104   1    48
//   (16,  12)  32, 32, 8, 2   73,728 +  24,576 +  24,576 + 3,136 = 126,016   1    32
//
// (*) At (8, 24) this block shape runs the log-sum-exp pass only (100,352
// bytes with its running max and sum).  The output pass there is the
// register-resident one of reattention_mma.cuh (168,224 bytes, one block an
// SM, 96 accumulator registers a thread): 0.472 against 0.682 ms at N = 784,
// batch 64, on an H100 at 700 W, while a log-sum-exp pass in that form was
// the slower one.
//
// All under the 232,448 bytes a block may take.  At dh = 384 one head's K
// tile of 64 keys is 50 KB, so stages hold one head and 32 keys there.
// Other (heads, dh) stay on the CUDA-core route: the Python wrapper's
// kernel_route names the route from dtype and shape, nothing else does.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "reattention_mma.cuh"
#include "reattention_tiles.cuh"

namespace vit_tc {

namespace wmma = nvcuda::wmma;
using namespace vit_tile;

template <int H_, int DH_, int BQ_, int BK_, int HG_, int NSTAGE_, int MINB_>
struct Cfg {
  static constexpr int H = H_, DH = DH_, BQ = BQ_, BK = BK_, HG = HG_, MINB = MINB_;
  static constexpr int NSTAGE = NSTAGE_;          // K/V stage buffers of the ring
  static constexpr int DP = (DH + 15) / 16 * 16;  // head dim padded for the MMA
  static constexpr int LD = DP + 8;               // bf16 row pitch of q/K/V tiles
  static constexpr int CH = DH % 8 == 0 ? 8 : 4;  // bf16 per cp.async
  static constexpr int CPR = DH / CH;             // copies per row
  static constexpr int G = H / HG;                // stages per K (or V) tile
  static constexpr int LDS = BK + 4;              // f32 row pitch of score tiles
  static constexpr int RT = BQ / 16;              // row tiles of a q tile
  static constexpr int CT = BK / 16;              // column tiles of a score tile
  static constexpr int CTV = DP / 16;             // column tiles of one head's output
  // A warp's share of a K stage's score tiles, [HG][RT][CT] in all: SR row
  // tiles x SC column tiles of one head (one tile, on the first warps only,
  // where a stage has fewer tiles than the block has warps).
  static constexpr int S_TILES = HG * RT * CT;
  static constexpr int TS = S_TILES >= NW ? S_TILES / NW : 1;
  static constexpr int SC = TS < CT ? TS : CT, SR = TS / SC;
  // A warp's share of a V stage's output tiles, [HG][RT][CTV]: TR x TC tiles
  // of one head, the same share of every stage (its accumulators).
  static constexpr int TPW = HG * RT * CTV / NW;
  static constexpr int TC = TPW < CTV ? TPW : CTV, TR = TPW / TC;
  static constexpr int Q_ELEMS = H * BQ * LD;
  static constexpr int STAGE_ELEMS = HG * BK * LD;
  static constexpr int S_FLOATS = H * BQ * LDS;
  static constexpr int ROWS = H * BQ;             // (head, row) pairs of a block
  static constexpr int QUADS = BQ * BK / 4;       // (row, 4 keys) groups of a tile
  static constexpr size_t TILE_BYTES =
      sizeof(float) * S_FLOATS + sizeof(bf16) * (Q_ELEMS + NSTAGE * STAGE_ELEMS);
  static constexpr size_t OUT_SMEM = TILE_BYTES + sizeof(float) * (ROWS + H * H + H);
  static constexpr size_t LSE_SMEM = TILE_BYTES + sizeof(float) * 2 * ROWS;
  static_assert(DH % 4 == 0 && H % HG == 0 && H % 4 == 0 && BQ % 16 == 0 && BK % 16 == 0, "shape");
  static_assert(S_TILES % NW == 0 || S_TILES < NW, "score tiles of a stage over the warps");
  static_assert(TS % SC == 0 && CT % SC == 0 && RT % SR == 0, "a warp's score tiles form a block");
  static_assert(HG * RT * CTV % NW == 0, "output tiles of a stage split evenly over the warps");
  static_assert(TPW % TC == 0 && CTV % TC == 0 && RT % TR == 0, "a warp's output tiles form a block");
  static_assert(QUADS % 32 == 0 && 32 % (BK / 4) == 0, "a row's quads sit in one warp");
  static_assert(NSTAGE >= 2, "a ring");
  static_assert(OUT_SMEM <= 232448 && LSE_SMEM <= 232448, "shared memory of a block");
};

template <int I, int N, typename F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (I < N) {
    f(std::integral_constant<int, I>{});
    static_for<I + 1, N>(f);
  }
}

// Stage ph of key tile t: K of head group ph (ph < G), else V of group ph - G.
template <typename C>
__device__ __forceinline__ void load_stage(bf16* dst, const bf16* k, const bf16* v, int b,
                                           int t, int ph, int nk, int tid) {
  if (ph < C::G) {
    const bf16* src = k + ((int64_t)b * C::H + ph * C::HG) * nk * C::DH;
    load_rows<C, C::BK, C::HG>(dst, src, (int64_t)nk * C::DH, C::DH, t * C::BK, nk, tid);
  } else {
    const bf16* src = v + (int64_t)b * nk * (C::H * C::DH) + (ph - C::G) * C::HG * C::DH;
    load_rows<C, C::BK, C::HG>(dst, src, C::DH, C::H * C::DH, t * C::BK, nk, tid);
  }
}

// Score tiles of head group g: S[h] = Q_h K_h^T for the HG heads staged in ks.
// The warp's SR x SC tiles share their K fragments and run as independent MMA
// chains.
template <typename C>
__device__ __forceinline__ void score_stage(const bf16* qs, const bf16* ks, float* S, int g,
                                            int warp) {
  if (C::S_TILES < NW && warp >= C::S_TILES) return;
  constexpr int CG = C::CT / C::SC, RG = C::RT / C::SR;
  const int cg = warp % CG, rg = (warp / CG) % RG, hl = warp / (CG * RG);
  const int h = g * C::HG + hl;
  const bf16* a = qs + (h * C::BQ + 16 * C::SR * rg) * C::LD;
  const bf16* b = ks + (hl * C::BK + 16 * C::SC * cg) * C::LD;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[C::SR][C::SC];
#pragma unroll
  for (int i = 0; i < C::SR; ++i)
#pragma unroll
    for (int j = 0; j < C::SC; ++j) wmma::fill_fragment(acc[i][j], 0.f);
#pragma unroll 2
  for (int kk = 0; kk < C::DP / 16; ++kk) {
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb[C::SC];
#pragma unroll
    for (int j = 0; j < C::SC; ++j) wmma::load_matrix_sync(fb[j], b + 16 * j * C::LD + 16 * kk, C::LD);
#pragma unroll
    for (int i = 0; i < C::SR; ++i) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, a + 16 * i * C::LD + 16 * kk, C::LD);
#pragma unroll
      for (int j = 0; j < C::SC; ++j) wmma::mma_sync(acc[i][j], fa, fb[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < C::SR; ++i)
#pragma unroll
    for (int j = 0; j < C::SC; ++j)
      wmma::store_matrix_sync(
          S + (h * C::BQ + 16 * (C::SR * rg + i)) * C::LDS + 16 * (C::SC * cg + j), acc[i][j],
          C::LDS, wmma::mem_row_major);
}

// Blocks and shared memory common to both passes.
template <typename C>
struct Tiles {
  float* S;    // [H][BQ][LDS] f32 scores; after the mix, bf16 P' in each row's first half
  bf16* qs;    // [H][BQ][LD]
  bf16* ring;  // [NSTAGE][HG][BK][LD]
  float* tail; // per-pass small arrays
  __device__ explicit Tiles(unsigned char* smem) {
    S = reinterpret_cast<float*>(smem);
    qs = reinterpret_cast<bf16*>(S + C::S_FLOATS);
    ring = qs + C::Q_ELEMS;
    tail = reinterpret_cast<float*>(ring + C::NSTAGE * C::STAGE_ELEMS);
  }
};

// One thread per (head, row): fold the row's nvalid scores of this key tile
// into its running max m_s and sum l_s.  FULL: nvalid == BK.
template <typename C, bool FULL>
__device__ __forceinline__ void fold_rows(const float* S, float* m_s, float* l_s, int nvalid,
                                          int tid) {
  for (int row = tid; row < C::ROWS; row += NT) {
    const float4* srow = reinterpret_cast<const float4*>(S + row * C::LDS);
    float mt = -INFINITY;
#pragma unroll
    for (int c = 0; c < C::BK / 4; ++c) {
      const float4 x = srow[c];
      if (FULL || 4 * c + 0 < nvalid) mt = fmaxf(mt, x.x);
      if (FULL || 4 * c + 1 < nvalid) mt = fmaxf(mt, x.y);
      if (FULL || 4 * c + 2 < nvalid) mt = fmaxf(mt, x.z);
      if (FULL || 4 * c + 3 < nvalid) mt = fmaxf(mt, x.w);
    }
    const float m_old = m_s[row], mn = fmaxf(m_old, mt);   // finite: key 0 of the tile is valid
    const float mn2 = mn * LOG2E;
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < C::BK / 4; ++c) {
      const float4 x = srow[c];
      if (FULL || 4 * c + 0 < nvalid) sum += fast_exp2(fmaf(x.x, LOG2E, -mn2));
      if (FULL || 4 * c + 1 < nvalid) sum += fast_exp2(fmaf(x.y, LOG2E, -mn2));
      if (FULL || 4 * c + 2 < nvalid) sum += fast_exp2(fmaf(x.z, LOG2E, -mn2));
      if (FULL || 4 * c + 3 < nvalid) sum += fast_exp2(fmaf(x.w, LOG2E, -mn2));
    }
    l_s[row] = l_s[row] * fast_exp2((m_old - mn) * LOG2E) + sum;
    m_s[row] = mn;
  }
}

// Pass 1: lse[b, h, row] = log sum_k exp(q_h[row] . k_h[k]).  Grid (q tiles, B).
template <typename C>
__global__ void __launch_bounds__(NT, C::MINB) lse_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, float* __restrict__ lse,
    int nq, int nk) {
  extern __shared__ __align__(128) unsigned char smem[];
  Tiles<C> sm(smem);
  float* m_s = sm.tail;             // [H][BQ] running max
  float* l_s = m_s + C::ROWS;       // [H][BQ] running sum
  const int tid = threadIdx.x, warp = tid / 32;
  const int q0 = blockIdx.x * C::BQ, b = blockIdx.y;

  if constexpr (C::DP != C::DH) zero_bf16<C::Q_ELEMS + C::NSTAGE * C::STAGE_ELEMS>(sm.qs, tid);
  for (int e = tid; e < C::ROWS; e += NT) { m_s[e] = -INFINITY; l_s[e] = 0.f; }
  __syncthreads();
  load_rows<C, C::BQ, C::H>(sm.qs, q + (int64_t)b * C::H * nq * C::DH, (int64_t)nq * C::DH,
                            C::DH, q0, nq, tid);
  const int n_tiles = (nk + C::BK - 1) / C::BK;
  const int total = n_tiles * C::G;
  for (int st = 0; st < C::NSTAGE - 1; ++st) {   // the q tile joins stage 0's group
    if (st < total)
      load_stage<C>(sm.ring + st * C::STAGE_ELEMS, k, nullptr, b, st / C::G, st % C::G, nk, tid);
    cp_async_commit();
  }

  int s = 0;
  for (int t = 0; t < n_tiles; ++t) {
    for (int ph = 0; ph < C::G; ++ph, ++s) {
      cp_async_wait<C::NSTAGE - 2>();
      __syncthreads();   // stage s has landed; everyone is done with stage s - 1
      const int nxt = s + C::NSTAGE - 1;
      if (nxt < total)
        load_stage<C>(sm.ring + (nxt % C::NSTAGE) * C::STAGE_ELEMS, k, nullptr, b, nxt / C::G,
                      nxt % C::G, nk, tid);
      cp_async_commit();
      score_stage<C>(sm.qs, sm.ring + (s % C::NSTAGE) * C::STAGE_ELEMS, sm.S, ph, warp);
    }
    __syncthreads();     // all H score tiles of this key tile are stored
    if ((t + 1) * C::BK <= nk)
      fold_rows<C, true>(sm.S, m_s, l_s, C::BK, tid);
    else
      fold_rows<C, false>(sm.S, m_s, l_s, nk - t * C::BK, tid);
    // the next stage's barrier keeps the score region until every row is folded
  }
  cp_async_wait<0>();
  for (int row = tid; row < C::ROWS; row += NT) {
    const int h = row / C::BQ, r = q0 + row % C::BQ;
    // l == 0 only without keys: +inf then zeroes every probability
    if (r < nq)
      lse[((int64_t)b * C::H + h) * nq + r] = l_s[row] > 0.f ? m_s[row] + logf(l_s[row]) : INFINITY;
  }
}

// The mix of one key tile, in place in the score region: f32 scores of all
// heads in, bf16 P'_h (first half of each f32 row) out.
// lse_s holds lse * log2(e).  FULL: every key of the tile is valid.
template <typename C, bool FULL>
__device__ __forceinline__ void mix_tile(float* S, const float* lse_s, const float* m_s,
                                         const float* c_s, int k0, int nk, int tid) {
  constexpr int QPR = C::BK / 4;   // quads per row
  for (int e = tid; e < C::QUADS; e += NT) {
    const int r = e / QPR, c4 = (e % QPR) * 4;
    bool valid[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) valid[j] = FULL || k0 + c4 + j < nk;
    float p[C::H][4];
#pragma unroll
    for (int h2 = 0; h2 < C::H; ++h2) {
      const float4 x = *reinterpret_cast<const float4*>(S + (h2 * C::BQ + r) * C::LDS + c4);
      const float L = lse_s[h2 * C::BQ + r];
      p[h2][0] = valid[0] ? fast_exp2(fmaf(x.x, LOG2E, -L)) : 0.f;
      p[h2][1] = valid[1] ? fast_exp2(fmaf(x.y, LOG2E, -L)) : 0.f;
      p[h2][2] = valid[2] ? fast_exp2(fmaf(x.z, LOG2E, -L)) : 0.f;
      p[h2][3] = valid[3] ? fast_exp2(fmaf(x.w, LOG2E, -L)) : 0.f;
    }
    __syncwarp();   // the row's scores are all in registers before any is overwritten
#pragma unroll
    for (int h = 0; h < C::H; ++h) {
      float o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) o[j] = valid[j] ? c_s[h] : 0.f;
#pragma unroll
      for (int h4 = 0; h4 < C::H / 4; ++h4) {
        const float4 m = *reinterpret_cast<const float4*>(m_s + h * C::H + 4 * h4);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          o[j] = fmaf(m.x, p[4 * h4 + 0][j], o[j]);
          o[j] = fmaf(m.y, p[4 * h4 + 1][j], o[j]);
          o[j] = fmaf(m.z, p[4 * h4 + 2][j], o[j]);
          o[j] = fmaf(m.w, p[4 * h4 + 3][j], o[j]);
        }
      }
      const __nv_bfloat162 lo = __floats2bfloat162_rn(o[0], o[1]);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(o[2], o[3]);
      uint2 packed;
      packed.x = *reinterpret_cast<const unsigned*>(&lo);
      packed.y = *reinterpret_cast<const unsigned*>(&hi);
      bf16* prow = reinterpret_cast<bf16*>(S + (h * C::BQ + r) * C::LDS);
      *reinterpret_cast<uint2*>(prow + c4) = packed;
    }
  }
}

// Pass 2: out[b, row, h*dh:(h+1)*dh] = (sum_h2 M[h,h2] softmax_h2 + c[h]) V_h.
// Grid (q tiles, B).
template <typename C>
__global__ void __launch_bounds__(NT, C::MINB) out_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ w, const float* __restrict__ bvec,
    const float* __restrict__ lse, bf16* __restrict__ out, int nq, int nk) {
  using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
  extern __shared__ __align__(128) unsigned char smem[];
  Tiles<C> sm(smem);
  float* lse_s = sm.tail;            // [H][BQ]: lse * log2(e)
  float* m_s = lse_s + C::ROWS;      // [H][H]: M[h, h2]
  float* c_s = m_s + C::H * C::H;    // [H]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * C::BQ, b = blockIdx.y;
  constexpr int PROJ = C::H * C::DH;

  if constexpr (C::DP != C::DH) zero_bf16<C::Q_ELEMS + C::NSTAGE * C::STAGE_ELEMS>(sm.qs, tid);
  for (int e = tid; e < C::H * C::H; e += NT) {
    const int h = e / C::H, h2 = e % C::H;
    m_s[e] = w[(int64_t)h2 * PROJ + h * C::DH];
  }
  if (tid < C::H) c_s[tid] = bvec[tid * C::DH];
  for (int e = tid; e < C::ROWS; e += NT) {
    const int h = e / C::BQ, r = q0 + e % C::BQ;
    lse_s[e] = r < nq ? lse[((int64_t)b * C::H + h) * nq + r] * LOG2E : 0.f;
  }
  __syncthreads();
  load_rows<C, C::BQ, C::H>(sm.qs, q + (int64_t)b * C::H * nq * C::DH, (int64_t)nq * C::DH,
                            C::DH, q0, nq, tid);
  const int n_tiles = (nk + C::BK - 1) / C::BK;
  const int total = n_tiles * 2 * C::G;
  for (int st = 0; st < C::NSTAGE - 1; ++st) {   // the q tile joins stage 0's group
    if (st < total)
      load_stage<C>(sm.ring + st * C::STAGE_ELEMS, k, v, b, st / (2 * C::G), st % (2 * C::G),
                    nk, tid);
    cp_async_commit();
  }

  // this warp's output tiles: TR row tiles x TC column tiles of the hl-th head
  // of every head group
  constexpr int CGV = C::CTV / C::TC, RGV = C::RT / C::TR;
  const int ct0 = C::TC * (warp % CGV), rt0 = C::TR * ((warp / CGV) % RGV);
  const int hl = warp / (CGV * RGV);
  Acc acc[C::G][C::TR][C::TC];
#pragma unroll
  for (int g = 0; g < C::G; ++g)
#pragma unroll
    for (int i = 0; i < C::TR; ++i)
#pragma unroll
      for (int j = 0; j < C::TC; ++j) wmma::fill_fragment(acc[g][i][j], 0.f);

  int s = 0;
  for (int t = 0; t < n_tiles; ++t) {
    static_for<0, 2 * C::G>([&](auto ph_c) {
      constexpr int ph = decltype(ph_c)::value;
      cp_async_wait<C::NSTAGE - 2>();
      __syncthreads();   // stage s has landed; everyone is done with stage s - 1
      const int nxt = s + C::NSTAGE - 1;
      if (nxt < total)
        load_stage<C>(sm.ring + (nxt % C::NSTAGE) * C::STAGE_ELEMS, k, v, b, nxt / (2 * C::G),
                      (ph + C::NSTAGE - 1) % (2 * C::G), nk, tid);
      cp_async_commit();
      const bf16* stage = sm.ring + (s % C::NSTAGE) * C::STAGE_ELEMS;
      if constexpr (ph < C::G) {
        score_stage<C>(sm.qs, stage, sm.S, ph, warp);
      } else {
        if constexpr (ph == C::G) {
          // the barrier above: all H score tiles of this key tile are stored
          if ((t + 1) * C::BK <= nk)
            mix_tile<C, true>(sm.S, lse_s, m_s, c_s, t * C::BK, nk, tid);
          else
            mix_tile<C, false>(sm.S, lse_s, m_s, c_s, t * C::BK, nk, tid);
          __syncthreads();
        }
        constexpr int g = ph - C::G;
        const int h = g * C::HG + hl;
        const bf16* pa = reinterpret_cast<const bf16*>(sm.S + (h * C::BQ + 16 * rt0) * C::LDS);
        const bf16* vb = stage + hl * C::BK * C::LD + 16 * ct0;
#pragma unroll
        for (int kk = 0; kk < C::BK / 16; ++kk) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[C::TC];
#pragma unroll
          for (int j = 0; j < C::TC; ++j)
            wmma::load_matrix_sync(fb[j], vb + 16 * kk * C::LD + 16 * j, C::LD);
#pragma unroll
          for (int i = 0; i < C::TR; ++i) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
            wmma::load_matrix_sync(fa, pa + 16 * i * 2 * C::LDS + 16 * kk, 2 * C::LDS);
#pragma unroll
            for (int j = 0; j < C::TC; ++j) wmma::mma_sync(acc[g][i][j], fa, fb[j], acc[g][i][j]);
          }
        }
      }
      ++s;
    });
  }
  cp_async_wait<0>();
  __syncthreads();   // the score region is free: a 16 x 16 f32 scratch tile per warp

  float* scratch = sm.S + warp * 256;
  const int er = lane / 2, ec = (lane % 2) * 8;   // this lane's row and 8 columns of a tile
  static_for<0, C::G>([&](auto g_c) {
    constexpr int g = decltype(g_c)::value;
#pragma unroll
    for (int i = 0; i < C::TR; ++i)
#pragma unroll
      for (int j = 0; j < C::TC; ++j) {
        wmma::store_matrix_sync(scratch, acc[g][i][j], 16, wmma::mem_row_major);
        __syncwarp();
        const int row = q0 + 16 * (rt0 + i) + er, col = 16 * (ct0 + j) + ec;
        if (row < nq && col < C::DH) {
          const float* src = scratch + er * 16 + ec;
          bf16* dst = out + ((int64_t)b * nq + row) * PROJ + (g * C::HG + hl) * C::DH + col;
          if constexpr (C::DH % 8 == 0) {   // the 8 columns are all inside the head, 16-byte aligned
            __align__(16) __nv_bfloat162 o2[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) o2[e] = __floats2bfloat162_rn(src[2 * e], src[2 * e + 1]);
            *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(o2);
          } else {
#pragma unroll
            for (int e = 0; e < 8; ++e)
              if (col + e < C::DH) dst[e] = __float2bfloat16(src[e]);
          }
        }
        __syncwarp();
      }
  });
}

template <typename C>
int launch_lse(const void* q, const void* k, float* lse, int batch, int nq, int nk,
               cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      lse_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(C::LSE_SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  lse_kernel<C><<<dim3((nq + C::BQ - 1) / C::BQ, batch), NT, C::LSE_SMEM, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), lse, nq, nk);
  return static_cast<int>(cudaGetLastError());
}

template <typename C>
int launch_out(const void* q, const void* k, const void* v, const float* w, const float* b,
               const float* lse, void* out, int batch, int nq, int nk, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      out_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(C::OUT_SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  out_kernel<C><<<dim3((nq + C::BQ - 1) / C::BQ, batch), NT, C::OUT_SMEM, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), w, b,
      lse, static_cast<bf16*>(out), nq, nk);
  return static_cast<int>(cudaGetLastError());
}

// passes: bit 0 the log-sum-exp pass, bit 1 the output pass (which reads lse).
// MMA_OUT: the output pass is reattention_mma.cuh's register-resident one.
template <typename C, bool MMA_OUT>
int launch(const void* q, const void* k, const void* v, const float* w, const float* b,
           float* lse, void* out, int batch, int nq, int nk, int passes,
           cudaStream_t stream) {
  int rc = 0;
  if (passes & 1) rc = launch_lse<C>(q, k, lse, batch, nq, nk, stream);
  if (rc || !(passes & 2)) return rc;
  if constexpr (MMA_OUT)
    return vit_mma::launch_out<vit_mma::Cfg<C::H, C::DH, C::BK>>(q, k, v, w, b, lse, out, batch,
                                                                 nq, nk, stream);
  else
    return launch_out<C>(q, k, v, w, b, lse, out, batch, nq, nk, stream);
}

}  // namespace vit_tc
