// Coalesced staging of a block's rows between device memory (int32
// 12-bit limbs, row-major, the layout of drand_tpu_torch/ops/field.py)
// and shared memory (64-bit words in flat_load's layout: element e of
// block row r, word v at [(e * 6 + v) * R + r]), for the kernels that keep
// their rows on chip across phases: K9-K12, K18 and K19 (curve_kernels.cu,
// miller_kernels.cu), K5, K6, K13, K14, K16, K17 and K20
// (tower_kernels.cu), and K1 and K2 (field_kernels.cu); and kernel_attrs,
// the occupancy report of every kernel file's *_attrs entry points.  CUDA
// code only.
//
// A row of `width` elements is width * 128 contiguous bytes.  An element
// is eight 16-byte chunks of four limbs, 48 bits each.  Eight
// neighbouring lanes take the eight chunks of one element and a warp one
// element of four neighbouring rows, so a load or store instruction
// touches four whole 128-byte lines.  The conversion between limbs and
// words happens in the lanes: word v is bits 64v..64v+63, which lie in
// chunks 4v/3 and 4v/3 + 1, so lane v of an element builds it from two
// shuffles (and chunk p from words 48p/64 and the next on the way out).
#pragma once

#include <cuda_runtime.h>

#include "field_arith.cuh"

namespace dt {

__device__ __forceinline__ uint64_t shfl64(uint64_t x, int lane) {
  return (uint64_t)__shfl_sync(0xffffffffu, (unsigned long long)x, lane);
}

// Rows [row0, row0 + R) of src [rows, width, 32] into dst; rows past
// `rows` stage as zero.  Called by every thread of the block, blockDim.x
// a multiple of 32.
template <int R>
__device__ __forceinline__ void stage_in(const int32_t *__restrict__ src,
                                         int width, long long row0,
                                         long long rows, uint64_t *dst) {
  const int lane = threadIdx.x & 31, p = lane & 7, base = lane & ~7;
  const int pa = (4 * p) / 3;             // word p's first chunk (p < 6)
  for (int s = threadIdx.x; s < R * width * 8; s += blockDim.x) {
    const int g = s >> 3, r = g % R, e = g / R;
    uint64_t x = 0;                       // chunk p: limbs 4p..4p+3
    if (row0 + r < rows) {
      const int4 v = reinterpret_cast<const int4 *>(
          src + ((row0 + r) * width + e) * N_LIMBS)[p];
      x = (uint64_t)(uint32_t)v.x | (uint64_t)(uint32_t)v.y << 12 |
          (uint64_t)(uint32_t)v.z << 24 | (uint64_t)(uint32_t)v.w << 36;
    }
    const uint64_t xa = shfl64(x, base + (pa & 7));
    const uint64_t xb = shfl64(x, base + ((pa + 1) & 7));
    if (p < N_WORDS) {
      const int sh = 64 * p - 48 * pa;    // 0, 16 or 32
      dst[(e * N_WORDS + p) * R + r] = (xa >> sh) | (xb << (48 - sh));
    }
  }
}

// stage_in for a width W and T threads a block known at compile time
// (R * W * 8 a multiple of T): a thread's chunks are all loaded before any
// is converted, so their loads are in flight together, not one loop trip
// after another (K5, K13: a short kernel or a single wave of blocks pays
// its staging latency in full).
template <int R, int T, int W>
__device__ __forceinline__ void stage_in_all(const int32_t *__restrict__ src,
                                             long long row0, long long rows,
                                             uint64_t *dst) {
  constexpr int N = R * W * 8 / T;
  static_assert(N * T == R * W * 8, "a thread's share of the chunks");
  const int lane = threadIdx.x & 31, p = lane & 7, base = lane & ~7;
  const int pa = (4 * p) / 3;
  uint64_t x[N];
#pragma unroll
  for (int i = 0; i < N; i++) {
    const int g = (threadIdx.x + i * T) >> 3, r = g % R, e = g / R;
    x[i] = 0;
    if (row0 + r < rows) {
      const int4 v = reinterpret_cast<const int4 *>(
          src + ((row0 + r) * W + e) * N_LIMBS)[p];
      x[i] = (uint64_t)(uint32_t)v.x | (uint64_t)(uint32_t)v.y << 12 |
             (uint64_t)(uint32_t)v.z << 24 | (uint64_t)(uint32_t)v.w << 36;
    }
  }
#pragma unroll
  for (int i = 0; i < N; i++) {
    const int g = (threadIdx.x + i * T) >> 3, r = g % R, e = g / R;
    const uint64_t xa = shfl64(x[i], base + (pa & 7));
    const uint64_t xb = shfl64(x[i], base + ((pa + 1) & 7));
    if (p < N_WORDS) {
      const int sh = 64 * p - 48 * pa;
      dst[(e * N_WORDS + p) * R + r] = (xa >> sh) | (xb << (48 - sh));
    }
  }
}

// The inverse of stage_in for n elements: src's rows [row0, row0 + R)
// into elements [at, at + n) of dst [rows, width, 32], rows past `rows`
// skipped.  Called by every thread of the block.
template <int R>
__device__ __forceinline__ void stage_out_at(const uint64_t *src, int n,
                                             int width, int at,
                                             long long row0, long long rows,
                                             int32_t *__restrict__ dst) {
  const int lane = threadIdx.x & 31, p = lane & 7, base = lane & ~7;
  const int wa = (48 * p) >> 6, off = (48 * p) & 63;
  for (int s = threadIdx.x; s < R * n * 8; s += blockDim.x) {
    const int g = s >> 3, r = g % R, e = g / R;
    const uint64_t w = p < N_WORDS ? src[(e * N_WORDS + p) * R + r] : 0;
    const uint64_t lo = shfl64(w, base + wa), hi = shfl64(w, base + wa + 1);
    const uint64_t x = off > 16 ? (lo >> off) | (hi << (64 - off))
                                : lo >> off;
    if (row0 + r < rows)
      reinterpret_cast<int4 *>(
          dst + ((row0 + r) * width + at + e) * N_LIMBS)[p] =
          make_int4((int)(x & 0xFFF), (int)((x >> 12) & 0xFFF),
                    (int)((x >> 24) & 0xFFF), (int)((x >> 36) & 0xFFF));
  }
}

// All `width` elements: src's rows to dst [rows, width, 32].
template <int R>
__device__ __forceinline__ void stage_out(const uint64_t *src, int width,
                                          long long row0, long long rows,
                                          int32_t *__restrict__ dst) {
  stage_out_at<R>(src, width, width, 0, row0, rows, dst);
}

// A kernel's registers, local memory and shared memory (static plus the
// `smem` dynamic bytes it launches with) a thread or block, threads a block
// and resident blocks per SM on the current device: out[0..4].  Returns
// 0 or the CUDA error.
template <typename Kern>
int kernel_attrs(Kern kernel, int threads, int smem, int *out) {
  cudaError_t e = cudaSuccess;
  if (smem > 0)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  cudaFuncAttributes fa;
  int per_sm = 0;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kernel);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (e != cudaSuccess) return (int)e;
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = (int)fa.sharedSizeBytes + smem;
  out[3] = threads;
  out[4] = per_sm;
  return 0;
}

}  // namespace dt
