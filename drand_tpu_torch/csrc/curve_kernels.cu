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
//   (drand_tpu/ops/pallas_field.py:1705, body _g2_point_dbl_kernel :1587),
//   in chain form: n dbl-2009-l doublings in one launch ([2^n]P; drand_tpu
//   launches one a doubling, the port's ladders pass each run of
//   doublings to one call).  A doubling is 2 Fp2 products and 5 squares,
//   ~9.8k multiply-adds a row, so a chain is bound by operations at
//   every n (at n = 1 the 1.5 KB a row it reads and writes take 0.8 of
//   the time of its operations).  A block takes 32 rows with three
//   threads a row, one warp a share: the point is staged once, coalesced
//   (stage.cuh: each coordinate of the stack [6, rows, 32] is one
//   contiguous [rows, 32] block), into shared memory as words, doubled n
//   times there by the level shares of curve_arith.cuh g2_dbl_share with
//   a barrier after each level, and written once.  Shared memory: the
//   point and the level values, 30,720 bytes a block; four blocks (12
//   warps) a SM, so 16384 rows (512 blocks) are resident at once on 132
//   SMs.
// K10 dt_g2_point_add -- replaces PallasField.g2_point_add (:1720, body
//   :1617).  The general addition with every case branchless (and the
//   doubling of P1 where with_double): 11 Fp2 products and 5 squares
//   (+ K9's doubling), ~25.8k multiply-adds (35.6k) on 2.3 KB a row,
//   bound by operations.  K9's launch shape: 32 rows a block, three
//   threads a row, one warp a share; both points are staged once,
//   coalesced, into shared memory as words, the five dependency levels
//   of curve_arith.cuh g2_add_share run with a barrier after each (the
//   doubling's three levels of g2_dbl_share beside levels 1, 2 and 4),
//   and the sum, written over P1, is staged out once.  The levels run in
//   a loop (not unrolled) and each share's half-products through one
//   product body, which keeps the kernel's code small enough for the
//   instruction cache.  A row's level values take 36 elements with or
//   without the doubling (each slot taken again once read for the last
//   time; P2 is read again from device memory at the last level), 55,296
//   bytes of dynamic shared memory a block: four blocks (12 warps) a SM,
//   so 16384 rows (512 blocks) are resident at once on 132 SMs in both
//   forms.
// K18 dt_g2_dbl_line -- replaces PallasField.g2_dbl_line (:1538, body
//   _g2_dbl_line_kernel :1392, rows _g2_dbl_line_rows :1401).  The Miller
//   doubling step of the trio loop over the K pairs stacked on the rows:
//   in [rows, 8, 32] (X0 X1 Y0 Y1 Z0 Z1 xp yp), out T' and the line
//   triple (a0 a1 b0 b1 c0 c1), [rows, 6, 32] each.  6 Fp2 squares, 5
//   products and 4 Fp products, ~18.8k multiply-adds on 2.5 KB, bound by
//   operations.  K11's launch shape on K11's shares: a block takes 32
//   rows with three threads a row, one warp a share; the rows are staged
//   once, coalesced (stage.cuh), into shared memory as words, the three
//   dependency levels of curve_arith.cuh miller_dbl_share run with a
//   barrier after each (its TrioDblIo instance: P from the staged row,
//   the unmasked line triple and T' into shared memory, a __syncwarp
//   between a share's products), and T' and the line are staged out.  A
//   row's buffer is 34 elements (curve_arith.cuh DL_*), 52,224 bytes of
//   dynamic shared memory a block: four blocks (12 warps) a SM at 168
//   registers, no local memory.  Its time is the shares' word arithmetic,
//   as in K11.
// K19 dt_g2_add_line -- replaces PallasField.g2_add_line (:1551, body
//   :1450, rows :1460).  The mixed addition step, in [rows, 12, 32] (T,
//   xq0 xq1 yq0 yq1, xp yp), out T' and the line triple: 4 squares, 10
//   products and 4 Fp products, ~25.2k multiply-adds on 3 KB, bound by
//   operations.  K18's launch shape on K12's shares: the 12 input
//   coordinates staged once, the five dependency levels of curve_arith.cuh
//   miller_add_share with a barrier after each (its TrioAddIo instance: P
//   from the staged row, T' into the buffer where no later share reads --
//   X' and Z' over T's, Y' over yq -- and the unmasked line triple over the
//   first six level values), then T' and the line staged out, coalesced.
//   A row's buffer is 36 elements (curve_arith.cuh AL_*), 55,296 bytes a
//   block: four blocks (12 warps) a SM at 168 registers, no local memory;
//   two stacked pairs of 16384 rows are 1,024 blocks, 1.94 waves on 132
//   SMs.
//
// The file is compiled twice, in parallel (ops/kernels.py SOURCES):
// -DDT_CURVE_PART=0 gives K9 and K10, =1 K18 and K19, so the build waits
// for the slower half instead of both.

#include <cuda_runtime.h>

#include "curve_arith.cuh"
#include "stage.cuh"

#if !defined(DT_CURVE_PART)
#error "compile with -DDT_CURVE_PART=0 (K9, K10) or -DDT_CURVE_PART=1 (K18, K19)"
#endif

namespace {

unsigned blocks(long long n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

#if DT_CURVE_PART == 0
constexpr int DBL_ROWS = 32;               // rows of a K9 block
constexpr int DBL_THREADS = 3 * DBL_ROWS;  // three threads a row

__global__ void __launch_bounds__(DBL_THREADS, 4)
    k_g2_point_dbl(const int32_t *__restrict__ p, int32_t *__restrict__ o,
                   long long rows, int n, dt::Mod M) {
  // element e of block row r, word v at [(e * 6 + v) * DBL_ROWS + r]:
  // the point (6), then the level values
  constexpr int SLOT = dt::N_WORDS * DBL_ROWS;   // words of one element
  __shared__ uint64_t sm[dt::G2_DBL_BUF * SLOT];
  const long long row0 = (long long)blockIdx.x * DBL_ROWS;
  const long long cs = rows * dt::N_LIMBS;
  for (int c = 0; c < 6; c++)
    dt::stage_in<DBL_ROWS>(p + c * cs, 1, row0, rows, sm + c * SLOT);
  __syncthreads();
  const int j = threadIdx.x / DBL_ROWS, r = threadIdx.x % DBL_ROWS;
  for (int i = 0; i < n; i++) {
#pragma unroll
    for (int level = 0; level < 3; level++) {
      dt::g2_dbl_share(level, j, i, n, sm + r, sm + 6 * SLOT + r, DBL_ROWS,
                       M);
      __syncthreads();
    }
  }
  for (int c = 0; c < 6; c++)
    dt::stage_out<DBL_ROWS>(sm + c * SLOT, 1, row0, rows, o + c * cs);
}

constexpr int ADD_ROWS = 32;               // rows of a K10 block
constexpr int ADD_THREADS = 3 * ADD_ROWS;  // three threads a row

// the level values of a block: 55,296 bytes, dynamic (over 48 KB)
constexpr int ADD_SMEM =
    dt::GA_BUF * dt::N_WORDS * ADD_ROWS * sizeof(uint64_t);

__global__ void __launch_bounds__(ADD_THREADS, 4)
    k_g2_point_add(const int32_t *__restrict__ p1,
                   const int32_t *__restrict__ p2, int32_t *__restrict__ o,
                   long long rows, int with_double, dt::One one, dt::Mod M) {
  // element e of block row r, word v at [(e * 6 + v) * ADD_ROWS + r]
  // (curve_arith.cuh GA_*)
  extern __shared__ uint64_t sm[];
  constexpr int SLOT = dt::N_WORDS * ADD_ROWS;
  const long long row0 = (long long)blockIdx.x * ADD_ROWS;
  const long long cs = rows * dt::N_LIMBS;
  for (int c = 0; c < 6; c++) {
    dt::stage_in<ADD_ROWS>(p1 + c * cs, 1, row0, rows,
                           sm + (dt::GA_P1 + c) * SLOT);
    dt::stage_in<ADD_ROWS>(p2 + c * cs, 1, row0, rows,
                           sm + dt::ga_p2_at(c) * SLOT);
  }
  __syncthreads();
  const int j = threadIdx.x / ADD_ROWS, r = threadIdx.x % ADD_ROWS;
  const int32_t *p2_row =
      row0 + r < rows ? p2 + (row0 + r) * dt::N_LIMBS : nullptr;
  dt::G2AddCase cases;
#pragma unroll 1
  for (int level = 0; level < 5; level++) {
    dt::g2_add_share(level, j, with_double != 0, sm + r, cases, p2_row, cs,
                     one, ADD_ROWS, M);
    __syncthreads();
  }
  for (int c = 0; c < 6; c++)
    dt::stage_out<ADD_ROWS>(sm + (dt::GA_P1 + c) * SLOT, 1, row0, rows,
                            o + c * cs);
}
#else
constexpr int DL_ROWS = 32;               // rows of a K18 or K19 block
constexpr int DL_THREADS = 3 * DL_ROWS;   // three threads a row
constexpr int DL_SLOT = dt::N_WORDS * DL_ROWS;   // words of one element

// a block's row buffers, dynamic (over 48 KB): K18 52,224 bytes, K19
// 55,296
constexpr int DL_SMEM = dt::DL_BUF * DL_SLOT * sizeof(uint64_t);
constexpr int AL_SMEM = dt::AL_BUF * DL_SLOT * sizeof(uint64_t);

// One level of K18's (ADD false) or K19's (ADD true) shares on a block's
// row buffers in sm, then a barrier.  The kernels call it once a level
// with the level written out: a loop over the levels stays a loop even
// under #pragma unroll, and ptxas keeps its counter in local memory.
template <bool ADD>
__device__ __forceinline__ void line_level(int level, uint64_t *sm,
                                           const dt::Mod &M) {
  const int t = threadIdx.x, j = t / DL_ROWS;
  uint64_t *b = sm + t % DL_ROWS;
  if constexpr (ADD)
    dt::miller_add_share(level, j, b + dt::AL_T * DL_SLOT,
                         b + dt::AL_Q * DL_SLOT, b + dt::AL_S * DL_SLOT,
                         dt::TrioAddIo{b, DL_ROWS}, DL_ROWS, M);
  else
    dt::miller_dbl_share(level, j, b + dt::DL_T * DL_SLOT,
                         b + dt::DL_S1 * DL_SLOT, b + dt::DL_S2 * DL_SLOT,
                         dt::TrioDblIo{b + dt::DL_T * DL_SLOT,
                                       b + dt::DL_L * DL_SLOT, DL_ROWS},
                         DL_ROWS, M);
  __syncthreads();
}

__global__ void __launch_bounds__(DL_THREADS, 4)
    k_g2_dbl_line(const int32_t *__restrict__ in, int32_t *__restrict__ to,
                  int32_t *__restrict__ lo, long long rows, dt::Mod M) {
  // element e of block row r, word v at [(e * 6 + v) * DL_ROWS + r]
  // (curve_arith.cuh DL_*)
  extern __shared__ uint64_t sm[];
  dt::stage_in<DL_ROWS>(in, 8, (long long)blockIdx.x * DL_ROWS, rows,
                        sm + dt::DL_T * DL_SLOT);
  __syncthreads();
  line_level<false>(0, sm, M);
  line_level<false>(1, sm, M);
  line_level<false>(2, sm, M);
  const long long row0 = (long long)blockIdx.x * DL_ROWS;
  dt::stage_out<DL_ROWS>(sm + dt::DL_T * DL_SLOT, 6, row0, rows, to);
  dt::stage_out<DL_ROWS>(sm + dt::DL_L * DL_SLOT, 6, row0, rows, lo);
}

__global__ void __launch_bounds__(DL_THREADS, 4)
    k_g2_add_line(const int32_t *__restrict__ in, int32_t *__restrict__ to,
                  int32_t *__restrict__ lo, long long rows, dt::Mod M) {
  // element e of block row r, word v at [(e * 6 + v) * DL_ROWS + r]
  // (curve_arith.cuh AL_*)
  extern __shared__ uint64_t sm[];
  dt::stage_in<DL_ROWS>(in, 12, (long long)blockIdx.x * DL_ROWS, rows,
                        sm + dt::AL_T * DL_SLOT);
  __syncthreads();
  line_level<true>(0, sm, M);
  line_level<true>(1, sm, M);
  line_level<true>(2, sm, M);
  line_level<true>(3, sm, M);
  line_level<true>(4, sm, M);
  const long long row0 = (long long)blockIdx.x * DL_ROWS;
  for (int c = 0; c < 6; c += 2)          // X', Y', Z' (dt::al_t_out)
    dt::stage_out_at<DL_ROWS>(sm + dt::al_t_out(c) * DL_SLOT, 2, 6, c, row0,
                              rows, to);
  dt::stage_out<DL_ROWS>(sm + dt::AL_S * DL_SLOT, 6, row0, rows, lo);
}
#endif

}  // namespace

extern "C" {

#if DT_CURVE_PART == 0
// n >= 1 doublings in one launch.
int dt_g2_point_dbl(const int32_t *p, int32_t *o, long long rows, int n,
                    const uint64_t *mod7, void *stream) {
  if (rows <= 0 || n <= 0) return 0;
  k_g2_point_dbl<<<blocks(rows, DBL_ROWS), DBL_THREADS, 0,
                   (cudaStream_t)stream>>>(p, o, rows, n,
                                           dt::mod_from_words(mod7));
  return (int)cudaGetLastError();
}

// K9's occupancy (stage.cuh kernel_attrs).
int dt_g2_point_dbl_attrs(int *out) {
  return dt::kernel_attrs(k_g2_point_dbl, DBL_THREADS, 0, out);
}

// one6: Montgomery one, 6 words, host memory.
int dt_g2_point_add(const int32_t *p1, const int32_t *p2, int32_t *o,
                    long long rows, int with_double, const uint64_t *one6,
                    const uint64_t *mod7, void *stream) {
  if (rows <= 0) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      k_g2_point_add, cudaFuncAttributeMaxDynamicSharedMemorySize, ADD_SMEM);
  if (e != cudaSuccess) return (int)e;
  k_g2_point_add<<<blocks(rows, ADD_ROWS), ADD_THREADS, ADD_SMEM,
                   (cudaStream_t)stream>>>(p1, p2, o, rows, with_double,
                                           dt::one_from_words(one6),
                                           dt::mod_from_words(mod7));
  return (int)cudaGetLastError();
}

// K10's, with its dynamic shared memory.
int dt_g2_point_add_attrs(int *out) {
  return dt::kernel_attrs(k_g2_point_add, ADD_THREADS, ADD_SMEM, out);
}
#else
int dt_g2_dbl_line(const int32_t *in, int32_t *to, int32_t *lo,
                   long long rows, const uint64_t *mod7, void *stream) {
  if (rows <= 0) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      k_g2_dbl_line, cudaFuncAttributeMaxDynamicSharedMemorySize, DL_SMEM);
  if (e != cudaSuccess) return (int)e;
  k_g2_dbl_line<<<blocks(rows, DL_ROWS), DL_THREADS, DL_SMEM,
                  (cudaStream_t)stream>>>(in, to, lo, rows,
                                          dt::mod_from_words(mod7));
  return (int)cudaGetLastError();
}

// K18's, with its dynamic shared memory.
int dt_g2_dbl_line_attrs(int *out) {
  return dt::kernel_attrs(k_g2_dbl_line, DL_THREADS, DL_SMEM, out);
}

int dt_g2_add_line(const int32_t *in, int32_t *to, int32_t *lo,
                   long long rows, const uint64_t *mod7, void *stream) {
  if (rows <= 0) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      k_g2_add_line, cudaFuncAttributeMaxDynamicSharedMemorySize, AL_SMEM);
  if (e != cudaSuccess) return (int)e;
  k_g2_add_line<<<blocks(rows, DL_ROWS), DL_THREADS, AL_SMEM,
                  (cudaStream_t)stream>>>(in, to, lo, rows,
                                          dt::mod_from_words(mod7));
  return (int)cudaGetLastError();
}

// K19's, with its dynamic shared memory.
int dt_g2_add_line_attrs(int *out) {
  return dt::kernel_attrs(k_g2_add_line, DL_THREADS, AL_SMEM, out);
}
#endif

}  // extern "C"
