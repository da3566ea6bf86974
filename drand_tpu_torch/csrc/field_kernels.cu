// The Montgomery and Fp add/sub kernels, for sm_90a, behind a
// plain C interface (loaded with ctypes by drand_tpu_torch/ops/kernels.py).
//
// Common design: one thread per field element.  A thread loads its 128
// (or 256) contiguous bytes with 16-byte vector loads, repacks the 12-bit
// limbs into 64-bit words, runs the arithmetic of field_arith.cuh in
// registers and stores 128 bytes (K3, K21, K22).  K1, K2 and K4 run the
// 32-bit carry-chain arithmetic of field_arith32.cuh instead.  Inputs must
// be int32, contiguous and 16-byte aligned; the Python wrappers check
// that.  Each entry point launches on the given stream, does not
// synchronise, and returns the cudaGetLastError() of its launch.
//
// What bounds them on the H100.  The roofline takes each input read once
// and each output written once at 3.35 TB/s, against the fewest 32-bit
// multiply-adds the function needs on twelve 32-bit words (a word product
// has a low and a high half, two multiply-adds; a REDC quotient word is a
// low half only, one) at the card's integer rate, 64 per clock per SM x
// 132 SMs x 1.98 GHz = 16.7 T multiply-adds/s (half the float32 FMA
// rate).  A product (K1: 144 word products, 144 for the REDC and 12
// quotients) is 588 multiply-adds on 384 bytes, a square (K2: the
// triangle's 66 products and 12 diagonal ones) 456 on 256 bytes, a
// reduction (K3) 300 on 384 bytes: all three are bound by bytes.  K4's
// chains are bound by operations.  At the verify path's 16384 rows one
// thread per element is 512 warps, about one on each of the card's 528
// schedulers, so nothing but a thread's own instruction-level parallelism
// hides the latency of its multiply chains.
//
// K1 dt_mont_mul -- replaces PallasField.mont_mul
//   (drand_tpu/ops/pallas_field.py:723, body _mont_mul_kernel :462).
//   The CIOS product of field_arith32.cuh (mont_mul32: two carry chains a
//   step, one on the even and one on the odd words of the multiplicand)
//   on 256 bytes in and 128 out; as the kernel before it, it takes a first
//   operand of any 384 bits against a canonical second one.  A block of
//   K1_THREADS rows stages both operands into shared memory and writes
//   the result back through it, coalesced (stage.cuh stage_in_all,
//   stage_out: eight lanes an element, whole 128-byte lines), where one
//   thread's own 16-byte loads 128 bytes apart touched a line a lane.
//   32-row blocks spread 16384 rows over all 132 SMs (faster than 64 by
//   events on the H100: PERF.md).
// K2 dt_mont_sqr -- replaces PallasField.mont_sqr (:737, body :471).
//   The triangular square of field_arith32.cuh (mont_sqr32: 78 word
//   products instead of 144, then REDC) on 128 bytes in and 128 out,
//   staged as K1's rows are.  Off the verify path: its only calls there
//   were the inversions' a^2, now inside K4.
// K3 dt_mont_reduce -- replaces PallasField.mont_reduce (:746, body
//   :479).  384 bytes per element against a 13-word carry pass and a 6x6
//   REDC.  The design sums the cheap-carried limbs exactly into words
//   first, so the reduction itself is branch-free word arithmetic.
// K4 dt_fp_pow_chain -- replaces PallasField.sqr_chain_mul (:1253, body
//   _sqr_chain_mul_kernel :1223) and, as its k = 4 step,
//   PallasField.sqr4_mul (:1201, body :1184).  drand_tpu launches one
//   step res^(2^k) * t at a time; here one launch runs a whole program
//   (field_arith32.cuh chain_row), so a Fermat inversion a^(p-2) (the odd
//   table a^3..a^31, then 67 windows: 378 squares and 82 products a row,
//   0.22 ms of multiply-adds at 16384 rows) is one launch where it was 83.
//   One thread a row keeps the running value in registers from the first
//   square to the last (field_arith32.cuh: the triangular square and the
//   CIOS product); the odd table lives in a scratch buffer laid out so
//   that a warp's accesses coalesce (13.4 MB at 16384 rows, resident in
//   the 50 MB L2).  The single step res^(2^k) * t is a one-step program.
// K21 dt_add -- replaces PallasField.add (:759, body _add_kernel :442).
// K22 dt_sub -- replaces PallasField.sub (:762, body _sub_kernel :449).
//   Canonical a + b and a - b mod m, one thread an element: 6-word add (or
//   subtract) and one conditional correction on 256 bytes in and 128 out,
//   no multiply: bound by bytes.  Like drand_tpu, whose Field.add/sub stay
//   in XLA and never call their kernels, the port's Field.add/sub keep
//   their torch path: these two have no caller on the verify path.

#include <cuda_runtime.h>

#include "field_arith32.cuh"
#include "stage.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int K1_THREADS = 32;

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

// Element `el` of row threadIdx.x of a staged block (stage.cuh's layout,
// R rows) as twelve 32-bit words, and back.
template <int R>
__device__ __forceinline__ void staged_to_words32(const uint64_t *s, int el,
                                                  uint32_t *x) {
  uint64_t w[dt::N_WORDS];
#pragma unroll
  for (int v = 0; v < dt::N_WORDS; v++)
    w[v] = s[(el * dt::N_WORDS + v) * R + threadIdx.x];
  dt::words_to_words32(w, x);
}

template <int R>
__device__ __forceinline__ void words32_to_staged(const uint32_t *x, int el,
                                                  uint64_t *s) {
  uint64_t w[dt::N_WORDS];
  dt::words32_to_words(x, w);
#pragma unroll
  for (int v = 0; v < dt::N_WORDS; v++)
    s[(el * dt::N_WORDS + v) * R + threadIdx.x] = w[v];
}

// K1: a block stages K1_THREADS rows of a and b (elements 0 and 1 of
// stage.cuh's layout), each thread multiplies its row, and the block
// writes the rows back from element 0.
__global__ void __launch_bounds__(K1_THREADS)
    k_mont_mul(const int32_t *__restrict__ a, const int32_t *__restrict__ b,
               int32_t *__restrict__ o, long long n, dt::Mod32 M) {
  constexpr int R = K1_THREADS;
  __shared__ uint64_t s[2 * dt::N_WORDS * R];
  const long long row0 = (long long)blockIdx.x * R;
  dt::stage_in_all<R, R, 1>(a, row0, n, s);
  dt::stage_in_all<R, R, 1>(b, row0, n, s + dt::N_WORDS * R);
  __syncthreads();
  uint32_t x[dt::N_WORDS32], y[dt::N_WORDS32];
  staged_to_words32<R>(s, 0, x);
  staged_to_words32<R>(s, 1, y);
  // b is canonical; a may be any 384-bit value (the halves of a wide value
  // in Field.reduce_wide), so a goes in as the multiplier
  dt::mont_mul32(y, x, x, M);
  words32_to_staged<R>(x, 0, s);
  __syncthreads();
  dt::stage_out<R>(s, 1, row0, n, o);
}

// K2: K1's staging on one operand, through the triangular square.
__global__ void __launch_bounds__(K1_THREADS)
    k_mont_sqr(const int32_t *__restrict__ a, int32_t *__restrict__ o,
               long long n, dt::Mod32 M) {
  constexpr int R = K1_THREADS;
  __shared__ uint64_t s[dt::N_WORDS * R];
  const long long row0 = (long long)blockIdx.x * R;
  dt::stage_in_all<R, R, 1>(a, row0, n, s);
  __syncthreads();
  uint32_t x[dt::N_WORDS32];
  staged_to_words32<R>(s, 0, x);
  dt::mont_sqr32(x, x, M);
  words32_to_staged<R>(x, 0, s);
  __syncthreads();
  dt::stage_out<R>(s, 1, row0, n, o);
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

// K4: thread e runs the program on row e (field_arith32.cuh chain_row).
__global__ void __launch_bounds__(THREADS)
    k_fp_pow_chain(const int32_t *__restrict__ a,
                   const int32_t *__restrict__ t, int32_t *__restrict__ o,
                   long long n, const int32_t *__restrict__ steps,
                   int n_steps, uint32_t *__restrict__ scratch,
                   dt::Mod32 M) {
  const long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (e >= n) return;
  dt::chain_row(a, t, o, steps, n_steps, scratch, n, e, M);
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

unsigned blocks(long long n, int threads = THREADS) {
  return (unsigned)((n + threads - 1) / threads);
}

}  // namespace

extern "C" {

int dt_mont_mul(const int32_t *a, const int32_t *b, int32_t *o, long long n,
                const uint64_t *mod7, void *stream) {
  if (n <= 0) return 0;
  k_mont_mul<<<blocks(n, K1_THREADS), K1_THREADS, 0, (cudaStream_t)stream>>>(
      a, b, o, n, dt::mod32_from_words(mod7));
  return (int)cudaGetLastError();
}

int dt_mont_mul_attrs(int *out) {
  return dt::kernel_attrs(k_mont_mul, K1_THREADS, 0, out);
}

int dt_mont_sqr(const int32_t *a, int32_t *o, long long n,
                const uint64_t *mod7, void *stream) {
  if (n <= 0) return 0;
  k_mont_sqr<<<blocks(n, K1_THREADS), K1_THREADS, 0, (cudaStream_t)stream>>>(
      a, o, n, dt::mod32_from_words(mod7));
  return (int)cudaGetLastError();
}

int dt_mont_reduce(const int32_t *t, int32_t *o, long long n,
                   const uint64_t *mod7, void *stream) {
  if (n <= 0) return 0;
  k_mont_reduce<<<blocks(n), THREADS, 0, (cudaStream_t)stream>>>(
      t, o, n, dt::mod_from_words(mod7));
  return (int)cudaGetLastError();
}

// n rows of a (and of t, which may be null when no step names CHAIN_T)
// through the n_steps codes at steps (device memory); scratch (device
// memory) holds 48 bytes a row for each slot the program uses, null when
// it uses none.
int dt_fp_pow_chain(const int32_t *a, const int32_t *t, int32_t *o,
                    long long n, const int32_t *steps, int n_steps,
                    uint32_t *scratch, const uint64_t *mod7, void *stream) {
  if (n <= 0) return 0;
  k_fp_pow_chain<<<blocks(n), THREADS, 0, (cudaStream_t)stream>>>(
      a, t, o, n, steps, n_steps, scratch, dt::mod32_from_words(mod7));
  return (int)cudaGetLastError();
}

int dt_fp_pow_chain_attrs(int *out) {
  return dt::kernel_attrs(k_fp_pow_chain, THREADS, 0, out);
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
