// The merged Miller-loop iterations of the two-pair pairing check, for
// sm_90a, behind a plain C interface (loaded with ctypes by
// drand_tpu_torch/ops/kernels.py).  The arithmetic is in curve_arith.cuh
// and tower_arith.cuh.  Per row: f [12, 32], T [2, 6, 32] (pair; X0 X1 Y0
// Y1 Z0 Z1), P [2, 2, 32] (xp yp), Q [2, 4, 32] (xq0 xq1 yq0 yq1) int32
// limbs, canonical, contiguous and 16-byte aligned, and masks [2] int32
// (0: the pair is inactive); the Python wrappers check that.  Each entry
// point launches on the given stream, does not synchronise, and returns
// the cudaGetLastError() of its launch.
//
// K11 dt_miller_dbl_iter -- replaces PallasField.miller_dbl_iter
//   (drand_tpu/ops/pallas_field.py:2088, body _miller_dbl_iter_kernel
//   :2017).  One doubling iteration: f' = f^2 * l1 * l2 and both pairs'
//   doubling steps, each pair's line masked to one where it is inactive.
// K12 dt_miller_add_iter -- replaces PallasField.miller_add_iter (:2121,
//   body :2040).  One addition step: f' = f * l1 * l2 and both pairs'
//   mixed additions, an inactive pair keeping its T.
//
// A block takes 16 rows with six threads a row.  It stages the rows' f in
// shared memory as words; one warp runs the 32 pair steps (one thread per
// pair and row) and stages their sparse lines beside f; then the six
// threads of a row compute the flat products, each owning the convolution
// classes k = j (mod 6) as K13 does: for K11 the square f^2 with K17's
// slot-symmetric flat_sqr_class (drand_tpu's _sqr_phase, shared by B11
// and B17); then L = l1 * l2 with K20's line_merge_class (drand_tpu's
// _line_merge_phase, its default line_merge=True form), written over the
// two line buffers, and one dense product of f^2 (K11) or f (K12) by L.
// Shared memory: f, f^2 and the two lines (then L), 27,648 bytes a block.
//
// Per row, K11 does 66 + 12 triangular word products with 23 REDCs for
// the square, 36 products with 16 REDCs for L and 144 with 23 for the
// dense product, and 2 x (~19k) multiply-adds for the steps: ~130k
// multiply-adds on 6.7 KB, bound by operations.  K12 does L, the dense
// product and 2 x (~25k) for the additions.
//
// The file is compiled twice, in parallel (ops/kernels.py SOURCES), one
// kernel each: -DDT_MILLER_ADD=0 for K11 (dt_miller_dbl_iter) and =1 for
// K12 (dt_miller_add_iter).  Each takes nvcc minutes, most of it the
// inlined pair step.

#include <cuda_runtime.h>

#include "curve_arith.cuh"

#if !defined(DT_MILLER_ADD)
#error "compile with -DDT_MILLER_ADD=0 (K11) or 1 (K12)"
#endif

namespace {

constexpr int MR = 16;                 // rows of a block
constexpr int MT = 6 * MR;             // threads of a block
constexpr int SLOT = dt::N_WORDS * MR; // words of one coefficient of a block

template <bool ADD>
__global__ void __launch_bounds__(MT)
    k_miller_iter(const int32_t *__restrict__ f,
                  const int32_t *__restrict__ T,
                  const int32_t *__restrict__ Q,
                  const int32_t *__restrict__ P,
                  const int32_t *__restrict__ mask, int32_t *__restrict__ fo,
                  int32_t *__restrict__ To, long long rows,
                  dt::FlatIdx dense, dt::One one, dt::Mod M) {
  // word v of coefficient i of block row r at [(i * 6 + v) * MR + r]; sl
  // holds l1 (coefficients 0-5) and l2 (6-11), then L
  __shared__ uint64_t sf[dt::FLAT * SLOT];
  __shared__ uint64_t sg[dt::FLAT * SLOT];
  __shared__ uint64_t sl[2 * 6 * SLOT];
  const long long row0 = (long long)blockIdx.x * MR;
  const int t = threadIdx.x;
  for (int s = t; s < MR * dt::FLAT; s += MT) {
    const int r = s % MR, i = s / MR;
    uint64_t *dst = sf + i * SLOT + r;
    if (row0 + r < rows) {
      dt::flat_stage_coeff(f + ((row0 + r) * dt::FLAT + i) * dt::N_LIMBS,
                           dst, MR);
    } else {
#pragma unroll
      for (int v = 0; v < dt::N_WORDS; v++) dst[v * MR] = 0;
    }
  }
  if (t < 2 * MR) {                    // warp 0: pair k = t / MR
    const int k = t / MR, r = t % MR;
    const long long row = row0 + r, pk = row * 2 + k;
    dt::Line l = dt::line_one(one);
    if (row < rows)
      l = dt::miller_pair_step(T + pk * 6 * dt::N_LIMBS,
                               P + pk * 2 * dt::N_LIMBS,
                               ADD ? Q + pk * 4 * dt::N_LIMBS : nullptr,
                               mask[pk], To + pk * 6 * dt::N_LIMBS, one, M);
    dt::line_stage(l, sl + k * 6 * SLOT + r, MR);
  }
  __syncthreads();
  const int j = t / MR, r = t % MR;
  uint64_t lo[dt::N_WORDS], hi[dt::N_WORDS];
  uint64_t *cur = sf;                  // f, or f^2 for K11
  if (!ADD) {
    dt::flat_sqr_class(j, sf + r, MR, lo, hi, M);
    dt::flat_unstage(lo, hi, j, sg + r, MR);
    cur = sg;
  }
  dt::line_merge_class(j, sl + r, sl + 6 * SLOT + r, MR, lo, hi, M);
  __syncthreads();                     // the lines are read; f^2 is written
  dt::flat_unstage(lo, hi, j, sl + r, MR);
  __syncthreads();
  dt::flat_mul_class(j, cur + r, sl + r, MR, dense, lo, hi, M);
  if (row0 + r < rows) {
    int32_t *out = fo + (row0 + r) * dt::FLAT * dt::N_LIMBS;
    dt::store_words(lo, out + j * dt::N_LIMBS);
    dt::store_words(hi, out + (j + 6) * dt::N_LIMBS);
  }
}

template <bool ADD>
int launch(const int32_t *f, const int32_t *T, const int32_t *Q,
           const int32_t *P, const int32_t *mask, int32_t *fo, int32_t *To,
           long long rows, const uint64_t *one6, const uint64_t *mod7,
           void *stream) {
  if (rows <= 0) return 0;
  int all[dt::FLAT];
  for (int p = 0; p < dt::FLAT; p++) all[p] = p;
  k_miller_iter<ADD><<<(unsigned)((rows + MR - 1) / MR), MT, 0,
                       (cudaStream_t)stream>>>(
      f, T, Q, P, mask, fo, To, rows, dt::flat_idx(all, dt::FLAT),
      dt::one_from_words(one6), dt::mod_from_words(mod7));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// one6: Montgomery one, 6 words, host memory.
#if DT_MILLER_ADD == 0
int dt_miller_dbl_iter(const int32_t *f, const int32_t *T, const int32_t *P,
                       const int32_t *mask, int32_t *fo, int32_t *To,
                       long long rows, const uint64_t *one6,
                       const uint64_t *mod7, void *stream) {
  return launch<false>(f, T, nullptr, P, mask, fo, To, rows, one6, mod7,
                       stream);
}
#else
int dt_miller_add_iter(const int32_t *f, const int32_t *T, const int32_t *Q,
                       const int32_t *P, const int32_t *mask, int32_t *fo,
                       int32_t *To, long long rows, const uint64_t *one6,
                       const uint64_t *mod7, void *stream) {
  return launch<true>(f, T, Q, P, mask, fo, To, rows, one6, mod7, stream);
}
#endif

}  // extern "C"
