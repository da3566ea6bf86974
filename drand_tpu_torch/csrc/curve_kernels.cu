// The G2 point kernels of the verify path (the subgroup check's and the
// cofactor clearing's ladders) and the trio Miller loop's line steps, for
// sm_90a, behind a plain C interface
// (loaded with ctypes by drand_tpu_torch/ops/kernels.py).  The arithmetic
// is in curve_arith.cuh.  K9's and K10's points are coordinate-major
// stacks [6, rows, 32] of int32 limbs (X0 X1 Y0 Y1 Z0 Z1); K18's and
// K19's operands are row-major (below).  All are canonical, contiguous
// and 16-byte aligned; the Python wrappers check that.  Each entry point
// launches on the given stream, does not synchronise, and returns the
// cudaGetLastError() of its launch.
//
// K9 dt_g2_point_dbl -- replaces PallasField.g2_point_dbl
//   (drand_tpu/ops/pallas_field.py:1705, body _g2_point_dbl_kernel :1587).
//   dbl-2009-l, one thread a row: 2 Fp2 products and 5 squares,
//   ~9.9k multiply-adds on 1.5 KB, bound by operations.
// K10 dt_g2_point_add -- replaces PallasField.g2_point_add (:1720, body
//   :1617).  The general addition with every case branchless (and the
//   doubling of P where with_double), one thread a row: 11 Fp2 products
//   and 5 squares (+ K9's work with the doubling), ~26k multiply-adds on
//   2.3 KB, bound by operations.
// K18 dt_g2_dbl_line -- replaces PallasField.g2_dbl_line (:1538, body
//   _g2_dbl_line_kernel :1392, rows _g2_dbl_line_rows :1401).  The Miller
//   doubling step of the trio loop over the K pairs stacked on the rows,
//   one thread a row: in [rows, 8, 32] (X0 X1 Y0 Y1 Z0 Z1 xp yp), out T'
//   and the line triple (a0 a1 b0 b1 c0 c1), [rows, 6, 32] each.  6 Fp2
//   squares, 5 products and 4 Fp products, ~18.8k multiply-adds on 2.5 KB,
//   bound by operations.
// K19 dt_g2_add_line -- replaces PallasField.g2_add_line (:1551, body
//   :1450, rows :1460).  The mixed addition step, in [rows, 12, 32] (T,
//   xq0 xq1 yq0 yq1, xp yp): 4 squares, 10 products and 4 Fp products,
//   ~25.2k multiply-adds on 3 KB, bound by operations.  Both run the step
//   functions K11 and K12 run (curve_arith.cuh miller_dbl_step,
//   miller_add_step), so the merged and trio loops share one formula.
//
// The file is compiled twice, in parallel (ops/kernels.py SOURCES):
// -DDT_CURVE_PART=0 gives K9 and K10, =1 K18 and K19.  Each pair takes
// nvcc minutes (255 registers of straight-line Fp2 arithmetic), so the
// build waits for the slower one instead of both.

#include <cuda_runtime.h>

#include "curve_arith.cuh"

#if !defined(DT_CURVE_PART)
#error "compile with -DDT_CURVE_PART=0 (K9, K10) or -DDT_CURVE_PART=1 (K18, K19)"
#endif

namespace {

constexpr int THREADS = 128;

unsigned blocks(long long n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

#if DT_CURVE_PART == 0
__global__ void k_g2_point_dbl(const int32_t *__restrict__ p,
                               int32_t *__restrict__ o, long long rows,
                               dt::Mod M) {
  const long long r = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const long long cs = rows * dt::N_LIMBS, at = r * dt::N_LIMBS;
  dt::g2_store6(dt::g2_dbl(dt::g2_load6(p + at, cs), M), o + at, cs);
}

__global__ void k_g2_point_add(const int32_t *__restrict__ p1,
                               const int32_t *__restrict__ p2,
                               int32_t *__restrict__ o, long long rows,
                               int with_double, dt::One one, dt::Mod M) {
  const long long r = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const long long cs = rows * dt::N_LIMBS, at = r * dt::N_LIMBS;
  dt::g2_store6(dt::g2_add(dt::g2_load6(p1 + at, cs),
                           dt::g2_load6(p2 + at, cs), with_double != 0, one,
                           M),
                o + at, cs);
}
#else
template <bool ADD>
__global__ void k_g2_line_step(const int32_t *__restrict__ in,
                               int32_t *__restrict__ to,
                               int32_t *__restrict__ lo, long long rows,
                               dt::Mod M) {
  const long long r = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const long long at = r * 6 * dt::N_LIMBS;
  dt::miller_line_step(in + r * (ADD ? 12 : 8) * dt::N_LIMBS, ADD, to + at,
                       lo + at, M);
}
#endif

}  // namespace

extern "C" {

#if DT_CURVE_PART == 0
int dt_g2_point_dbl(const int32_t *p, int32_t *o, long long rows,
                    const uint64_t *mod7, void *stream) {
  if (rows <= 0) return 0;
  k_g2_point_dbl<<<blocks(rows, THREADS), THREADS, 0,
                   (cudaStream_t)stream>>>(p, o, rows,
                                           dt::mod_from_words(mod7));
  return (int)cudaGetLastError();
}

// one6: Montgomery one, 6 words, host memory.
int dt_g2_point_add(const int32_t *p1, const int32_t *p2, int32_t *o,
                    long long rows, int with_double, const uint64_t *one6,
                    const uint64_t *mod7, void *stream) {
  if (rows <= 0) return 0;
  k_g2_point_add<<<blocks(rows, THREADS), THREADS, 0,
                   (cudaStream_t)stream>>>(p1, p2, o, rows, with_double,
                                           dt::one_from_words(one6),
                                           dt::mod_from_words(mod7));
  return (int)cudaGetLastError();
}
#else
int dt_g2_dbl_line(const int32_t *in, int32_t *to, int32_t *lo,
                   long long rows, const uint64_t *mod7, void *stream) {
  if (rows <= 0) return 0;
  k_g2_line_step<false><<<blocks(rows, THREADS), THREADS, 0,
                          (cudaStream_t)stream>>>(in, to, lo, rows,
                                                  dt::mod_from_words(mod7));
  return (int)cudaGetLastError();
}

int dt_g2_add_line(const int32_t *in, int32_t *to, int32_t *lo,
                   long long rows, const uint64_t *mod7, void *stream) {
  if (rows <= 0) return 0;
  k_g2_line_step<true><<<blocks(rows, THREADS), THREADS, 0,
                         (cudaStream_t)stream>>>(in, to, lo, rows,
                                                 dt::mod_from_words(mod7));
  return (int)cudaGetLastError();
}
#endif

}  // extern "C"
