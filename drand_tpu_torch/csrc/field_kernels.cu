// The Montgomery and Fp add/sub kernels, for sm_90a, behind a
// plain C interface (loaded with ctypes by drand_tpu_torch/ops/kernels.py).
//
// Common design: one thread per field element.  A thread loads its 128
// (or 256) contiguous bytes with 16-byte vector loads, repacks the 12-bit
// limbs into 64-bit words, runs the arithmetic of field_arith.cuh in
// registers and stores 128 bytes.  Inputs must be int32, contiguous and
// 16-byte aligned; the Python wrappers check that.  Each entry point
// launches on the given stream, does not synchronise, and returns the
// cudaGetLastError() of its launch.
//
// What bounds them on the H100.  The roofline takes each input read once
// and each output written once at 3.35 TB/s, against the 32-bit integer
// multiply-adds of the 64-bit word products (each 64x64 product is four
// 32x32 products, each with a low and a high half: 8 multiply-adds) at
// the card's integer rate, 64 per clock per SM x 132 SMs x 1.98 GHz =
// 16.7 T multiply-adds/s (half the float32 FMA rate).  A product (K1) is
// 600 multiply-adds on 384 bytes, a square (K2) 480 on 256 bytes, a
// reduction (K3) 312 on 384 bytes: all three are bound by bytes.  K4's
// k squarings and a product on 256-384 bytes are bound by operations from
// k = 3 on.  At the verify path's 16384 rows, though, one thread per
// element is only 128 blocks of 128 threads, one block on each of the 132
// SMs, so each SM runs four warps of long dependent multiply chains with
// nothing to hide their latency: the kernels run well above either bound
// (times in PERF.md).  More elements per launch (stacking the path's
// products) or several threads per element is later work.
//
// K1 dt_mont_mul -- replaces PallasField.mont_mul
//   (drand_tpu/ops/pallas_field.py:723, body _mont_mul_kernel :462).
//   A 6x6-word CIOS product (72 64-bit multiplies, lo and hi halves) on
//   256 bytes in and 128 out.  The design keeps all state in registers
//   and never touches shared memory.
// K2 dt_mont_sqr -- replaces PallasField.mont_sqr (:737, body :471).
//   A triangular square (21 word products instead of 36) and a 6-word
//   REDC on 128 bytes in and 128 out, in registers like K1.
// K3 dt_mont_reduce -- replaces PallasField.mont_reduce (:746, body
//   :479).  384 bytes per element against a 13-word carry pass and a 6x6
//   REDC.  The design sums the cheap-carried limbs exactly into words
//   first, so the reduction itself is branch-free word arithmetic.
// K4 dt_sqr_chain_mul -- replaces PallasField.sqr_chain_mul (:1253, body
//   _sqr_chain_mul_kernel :1223) and, as its k = 4 call,
//   PallasField.sqr4_mul (:1201, body :1184).  k of K2's squares and one
//   of K1's products per 256-384 bytes.  The design keeps the value in
//   registers across all k squarings (k is a runtime argument), so the
//   chain costs one read and one write per element however long it is.
// K21 dt_add -- replaces PallasField.add (:759, body _add_kernel :442).
// K22 dt_sub -- replaces PallasField.sub (:762, body _sub_kernel :449).
//   Canonical a + b and a - b mod m, one thread an element: 6-word add (or
//   subtract) and one conditional correction on 256 bytes in and 128 out,
//   no multiply: bound by bytes.  Like drand_tpu, whose Field.add/sub stay
//   in XLA and never call their kernels, the port's Field.add/sub keep
//   their torch path: these two have no caller on the verify path.

#include <cuda_runtime.h>

#include "field_arith.cuh"

namespace {

constexpr int THREADS = 128;

__device__ __forceinline__ void load_limbs(const int32_t *src, int32_t *dst,
                                           int n_limbs) {
  const int4 *s = reinterpret_cast<const int4 *>(src);
#pragma unroll
  for (int i = 0; i < 16; i++) {
    if (4 * i < n_limbs) {
      const int4 v = s[i];
      dst[4 * i] = v.x;
      dst[4 * i + 1] = v.y;
      dst[4 * i + 2] = v.z;
      dst[4 * i + 3] = v.w;
    }
  }
}

__device__ __forceinline__ void store_limbs(const int32_t *src, int32_t *dst) {
  int4 *d = reinterpret_cast<int4 *>(dst);
#pragma unroll
  for (int i = 0; i < 8; i++)
    d[i] = make_int4(src[4 * i], src[4 * i + 1], src[4 * i + 2],
                     src[4 * i + 3]);
}

__global__ void k_mont_mul(const int32_t *__restrict__ a,
                           const int32_t *__restrict__ b,
                           int32_t *__restrict__ o, long long n, dt::Mod M) {
  const long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (e >= n) return;
  int32_t la[dt::N_LIMBS], lb[dt::N_LIMBS], lo[dt::N_LIMBS];
  load_limbs(a + e * dt::N_LIMBS, la, dt::N_LIMBS);
  load_limbs(b + e * dt::N_LIMBS, lb, dt::N_LIMBS);
  dt::mont_mul_limbs(la, lb, lo, M);
  store_limbs(lo, o + e * dt::N_LIMBS);
}

__global__ void k_mont_sqr(const int32_t *__restrict__ a,
                           int32_t *__restrict__ o, long long n, dt::Mod M) {
  const long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (e >= n) return;
  int32_t la[dt::N_LIMBS], lo[dt::N_LIMBS];
  load_limbs(a + e * dt::N_LIMBS, la, dt::N_LIMBS);
  dt::mont_sqr_limbs(la, lo, M);
  store_limbs(lo, o + e * dt::N_LIMBS);
}

__global__ void k_mont_reduce(const int32_t *__restrict__ t,
                              int32_t *__restrict__ o, long long n,
                              dt::Mod M) {
  const long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (e >= n) return;
  int32_t lt[dt::W_LIMBS], lo[dt::N_LIMBS];
  load_limbs(t + e * dt::W_LIMBS, lt, dt::W_LIMBS);
  dt::mont_reduce_limbs(lt, lo, M);
  store_limbs(lo, o + e * dt::N_LIMBS);
}

__global__ void k_sqr_chain_mul(const int32_t *__restrict__ a,
                                const int32_t *__restrict__ t,
                                int32_t *__restrict__ o, long long n, int k,
                                dt::Mod M) {
  const long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (e >= n) return;
  int32_t la[dt::N_LIMBS], lt[dt::N_LIMBS], lo[dt::N_LIMBS];
  load_limbs(a + e * dt::N_LIMBS, la, dt::N_LIMBS);
  if (t != nullptr) load_limbs(t + e * dt::N_LIMBS, lt, dt::N_LIMBS);
  dt::sqr_chain_mul_limbs(la, t != nullptr ? lt : nullptr, lo, k, M);
  store_limbs(lo, o + e * dt::N_LIMBS);
}

template <bool SUB>
__global__ void k_add_sub(const int32_t *__restrict__ a,
                          const int32_t *__restrict__ b,
                          int32_t *__restrict__ o, long long n, dt::Mod M) {
  const long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (e >= n) return;
  int32_t la[dt::N_LIMBS], lb[dt::N_LIMBS], lo[dt::N_LIMBS];
  load_limbs(a + e * dt::N_LIMBS, la, dt::N_LIMBS);
  load_limbs(b + e * dt::N_LIMBS, lb, dt::N_LIMBS);
  dt::add_sub_limbs(la, lb, lo, SUB, M);
  store_limbs(lo, o + e * dt::N_LIMBS);
}

unsigned blocks(long long n) { return (unsigned)((n + THREADS - 1) / THREADS); }

}  // namespace

extern "C" {

int dt_mont_mul(const int32_t *a, const int32_t *b, int32_t *o, long long n,
                const uint64_t *mod7, void *stream) {
  if (n <= 0) return 0;
  k_mont_mul<<<blocks(n), THREADS, 0, (cudaStream_t)stream>>>(
      a, b, o, n, dt::mod_from_words(mod7));
  return (int)cudaGetLastError();
}

int dt_mont_sqr(const int32_t *a, int32_t *o, long long n,
                const uint64_t *mod7, void *stream) {
  if (n <= 0) return 0;
  k_mont_sqr<<<blocks(n), THREADS, 0, (cudaStream_t)stream>>>(
      a, o, n, dt::mod_from_words(mod7));
  return (int)cudaGetLastError();
}

int dt_mont_reduce(const int32_t *t, int32_t *o, long long n,
                   const uint64_t *mod7, void *stream) {
  if (n <= 0) return 0;
  k_mont_reduce<<<blocks(n), THREADS, 0, (cudaStream_t)stream>>>(
      t, o, n, dt::mod_from_words(mod7));
  return (int)cudaGetLastError();
}

int dt_sqr_chain_mul(const int32_t *a, const int32_t *t, int32_t *o,
                     long long n, int k, const uint64_t *mod7, void *stream) {
  if (n <= 0) return 0;
  k_sqr_chain_mul<<<blocks(n), THREADS, 0, (cudaStream_t)stream>>>(
      a, t, o, n, k, dt::mod_from_words(mod7));
  return (int)cudaGetLastError();
}

int dt_add(const int32_t *a, const int32_t *b, int32_t *o, long long n,
           const uint64_t *mod7, void *stream) {
  if (n <= 0) return 0;
  k_add_sub<false><<<blocks(n), THREADS, 0, (cudaStream_t)stream>>>(
      a, b, o, n, dt::mod_from_words(mod7));
  return (int)cudaGetLastError();
}

int dt_sub(const int32_t *a, const int32_t *b, int32_t *o, long long n,
           const uint64_t *mod7, void *stream) {
  if (n <= 0) return 0;
  k_add_sub<true><<<blocks(n), THREADS, 0, (cudaStream_t)stream>>>(
      a, b, o, n, dt::mod_from_words(mod7));
  return (int)cudaGetLastError();
}

const char *dt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
