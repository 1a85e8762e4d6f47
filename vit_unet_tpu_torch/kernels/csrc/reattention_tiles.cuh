// Pieces shared by the tensor-core re-attention kernels (reattention_tc.cuh,
// reattention_mma.cuh): the block size, asynchronous copies of bf16 rows into
// padded shared-memory tiles, and the fast base-2 exponential.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vit_tile {

using bf16 = __nv_bfloat16;

constexpr int NW = 8;         // warps per block
constexpr int NT = NW * 32;   // threads per block
constexpr float LOG2E = 1.4426950408889634f;

// One asynchronous copy of BYTES (8 or 16) to shared memory; the whole
// destination is zero-filled when !valid (src-size 0).
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? BYTES : 0;
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src), "r"(n) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
// Waits until at most N of this thread's newest copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// dst[hl][r][0..DH) <- src[hl * head_stride + (row0 + r) * row_stride + 0..DH)
// for hl < NHEADS, r < ROWS, in copies of C::CH bf16 (16 bytes where
// dh % 8 == 0, else 8) into rows of pitch C::LD; rows at or past n are
// zero-filled.
template <typename C, int ROWS, int NHEADS>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int64_t head_stride,
                                          int64_t row_stride, int row0, int n, int tid) {
  constexpr int TOTAL = NHEADS * ROWS * C::CPR;
  for (int c = tid; c < TOTAL; c += NT) {
    const int j = c % C::CPR, r = (c / C::CPR) % ROWS, hl = c / (C::CPR * ROWS);
    const bool valid = row0 + r < n;
    const bf16* s = valid ? src + hl * head_stride + (row0 + r) * row_stride + j * C::CH : src;
    cp_async<C::CH * 2>(dst + (hl * ROWS + r) * C::LD + j * C::CH, s, valid);
  }
}

// Zero ELEMS (a multiple of 8) bf16 of shared memory with plain stores: the
// copies never write a tile's padding columns [dh, LD), part of which the
// MMAs read.  A barrier must follow before the first copy into the region.
template <int ELEMS>
__device__ __forceinline__ void zero_bf16(bf16* p, int tid) {
  static_assert(ELEMS % 8 == 0, "16-byte stores");
  uint4* p16 = reinterpret_cast<uint4*>(p);
  for (int e = tid; e < ELEMS / 8; e += NT) p16[e] = make_uint4(0u, 0u, 0u, 0u);
}

}  // namespace vit_tile
