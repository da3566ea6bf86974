// The G2 point kernels of the verify path (the subgroup check's and the
// cofactor clearing's ladders), for sm_90a, behind a plain C interface
// (loaded with ctypes by drand_tpu_torch/ops/kernels.py).  The arithmetic
// is in curve_arith.cuh.  Points are coordinate-major stacks
// [6, rows, 32] of int32 limbs (X0 X1 Y0 Y1 Z0 Z1), canonical, contiguous
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

#include <cuda_runtime.h>

#include "curve_arith.cuh"

namespace {

constexpr int THREADS = 128;

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

unsigned blocks(long long n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

}  // namespace

extern "C" {

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

}  // extern "C"
