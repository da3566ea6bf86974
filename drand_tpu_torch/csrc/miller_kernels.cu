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
// Both are bound by operations.  Per row, K11 does the square f^2 (66 +
// 12 triangular word products, 23 REDCs), two sparse products by a line
// (72 products and 21 REDCs each) and two doubling steps (~19k
// multiply-adds each): ~120k multiply-adds on 6.7 KB.  K12 does the two
// sparse products and two mixed additions (~25k each).
//
// A block takes 32 rows with six threads a row, and keeps its rows on
// chip from one phase to the next: the operands are staged once,
// coalesced (stage.cuh), into dynamic shared memory as words; f' goes out
// the same way.  The lines are multiplied in one after the other, f^2 *
// l1 then * l2 (K12: f * l1 * l2), each a sparse product on LINE_IDX
// (flat_mul_line_class): on this card that does fewer word products than
// merging the lines first (drand_tpu's default form, K20's body), and its
// canonical output is the same element bit for bit.  In the product
// phases thread j of a row owns the convolution classes k = j (mod 6) as
// K13 does, each warp on one j.
//
// The steps run on all six threads of a row, three a pair, each warp on
// one (share, pair), so no thread holds a whole point and its
// temporaries: K11 the shares of curve_arith.cuh miller_dbl_share (three
// dependency levels, MergedDblIo), K12 those of miller_add_share (five,
// MergedAddIo), a barrier
// after each level, the values between levels in shared memory (the
// buffer map MB_*, MA_* of curve_arith.cuh).  K11 stages f and T, K12 T
// and Q and, once its steps are done, f over T.  Shared memory, in
// elements of 32 rows x 6 words: K11 64 (98,304 bytes a block), K12 68
// (104,448 bytes); two blocks (12 warps) a SM each.
//
// The file is compiled twice, in parallel (ops/kernels.py SOURCES), one
// kernel each: -DDT_MILLER_ADD=0 for K11 (dt_miller_dbl_iter) and =1 for
// K12 (dt_miller_add_iter).

#include <cuda_runtime.h>

#include "curve_arith.cuh"
#include "stage.cuh"

#if !defined(DT_MILLER_ADD)
#error "compile with -DDT_MILLER_ADD=0 (K11) or 1 (K12)"
#endif

namespace {

constexpr bool IS_ADD = DT_MILLER_ADD != 0;  // this compile's kernel
constexpr int MR = 32;                 // rows of a block
constexpr int MT = 6 * MR;             // threads of a block
constexpr int SLOT = dt::N_WORDS * MR; // words of one element of a block
constexpr int SMEM = (IS_ADD ? dt::MB_ADD : dt::MB_DBL) * SLOT *
                     (int)sizeof(uint64_t);

// 12 warps a SM (two blocks), so at most 168 registers a thread.  A
// template, so the two kernels keep apart names in a profile.
template <bool ADD>
__global__ void __launch_bounds__(MT, 2)
    k_miller_iter(const int32_t *__restrict__ f,
                  const int32_t *__restrict__ T,
                  const int32_t *__restrict__ Q,
                  const int32_t *__restrict__ P,
                  const int32_t *__restrict__ mask, int32_t *__restrict__ fo,
                  int32_t *__restrict__ To, long long rows, dt::One one,
                  dt::Mod M) {
  extern __shared__ uint64_t sm[];
  const long long row0 = (long long)blockIdx.x * MR;
  const int t = threadIdx.x, r = t % MR;
  if constexpr (ADD) {
    dt::stage_in<MR>(T, 12, row0, rows, sm + dt::MA_T * SLOT);
    dt::stage_in<MR>(Q, 8, row0, rows, sm + dt::MA_Q * SLOT);
  } else {
    dt::stage_in<MR>(f, dt::FLAT, row0, rows, sm + dt::MB_F * SLOT);
    dt::stage_in<MR>(T, 12, row0, rows, sm + dt::MB_L * SLOT);
  }
  __syncthreads();

  // steps: share j of pair k
  const long long row = row0 + r;
  const int j = t / (2 * MR), k = (t / MR) % 2;
  const long long pk = row * 2 + k;
#pragma unroll
  for (int level = 0; level < (ADD ? 5 : 3); level++) {
    if (row < rows) {
      if constexpr (ADD)
        dt::miller_add_share(
            level, j, sm + (dt::MA_T + 6 * k) * SLOT + r,
            sm + (dt::MA_Q + 4 * k) * SLOT + r,
            sm + (dt::MA_S + dt::MA_SW * k) * SLOT + r,
            dt::MergedAddIo{P + pk * 2 * dt::N_LIMBS, mask[pk] != 0,
                            To + pk * 6 * dt::N_LIMBS, one},
            MR, M);
      else
        dt::miller_dbl_share(
            level, j, sm + (dt::MB_L + 6 * k) * SLOT + r,
            sm + (dt::MB_S1 + 8 * k) * SLOT + r,
            sm + (dt::MB_S2 + 12 * k) * SLOT + r,
            dt::MergedDblIo{sm + (dt::MB_L + 6 * k) * SLOT + r,
                            P + pk * 2 * dt::N_LIMBS, mask[pk] != 0,
                            To + pk * 6 * dt::N_LIMBS, one, MR},
            MR, M);
    }
    __syncthreads();
  }

  const int c = t / MR;                // product phases: class c
  uint64_t lo[dt::N_WORDS], hi[dt::N_WORDS];
  // f^2 * l1 * l2 (K11) or f * l1 * l2 (K12): where f (or f^2), the
  // lines, f * l1 and f' are (curve_arith.cuh MB_*, MA_*)
  constexpr int CUR = ADD ? dt::MA_F : dt::MB_S1;
  constexpr int L1 = ADD ? dt::MA_S : dt::MB_L;
  constexpr int L2 = ADD ? dt::MA_S + dt::MA_SW : dt::MB_L + 6;
  constexpr int MID = ADD ? dt::MA_MID : dt::MB_F;
  constexpr int OUT = ADD ? dt::MA_F : dt::MB_S2;
  if constexpr (ADD) {
    dt::stage_in<MR>(f, dt::FLAT, row0, rows, sm + dt::MA_F * SLOT);
  } else {
    dt::flat_sqr_class(c, sm + dt::MB_F * SLOT + r, MR, lo, hi, M);
    dt::flat_unstage(lo, hi, c, sm + dt::MB_S1 * SLOT + r, MR);
  }
  __syncthreads();
  dt::flat_mul_line_class(c, sm + CUR * SLOT + r, sm + L1 * SLOT + r, MR, lo,
                          hi, M);
  dt::flat_unstage(lo, hi, c, sm + MID * SLOT + r, MR);
  __syncthreads();
  dt::flat_mul_line_class(c, sm + MID * SLOT + r, sm + L2 * SLOT + r, MR, lo,
                          hi, M);
  dt::flat_unstage(lo, hi, c, sm + OUT * SLOT + r, MR);
  __syncthreads();
  dt::stage_out<MR>(sm + OUT * SLOT, dt::FLAT, row0, rows, fo);
}

}  // namespace

// The launch and the kernel's attributes, under the entry point's name.
static int launch(const int32_t *f, const int32_t *T, const int32_t *Q,
                  const int32_t *P, const int32_t *mask, int32_t *fo,
                  int32_t *To, long long rows, const uint64_t *one6,
                  const uint64_t *mod7, void *stream) {
  if (rows <= 0) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      k_miller_iter<IS_ADD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM);
  if (e != cudaSuccess) return (int)e;
  k_miller_iter<IS_ADD><<<(unsigned)((rows + MR - 1) / MR), MT, SMEM,
                  (cudaStream_t)stream>>>(f, T, Q, P, mask, fo, To, rows,
                                          dt::one_from_words(one6),
                                          dt::mod_from_words(mod7));
  return (int)cudaGetLastError();
}

extern "C" {

// one6: Montgomery one, 6 words, host memory.
#if DT_MILLER_ADD == 0
int dt_miller_dbl_iter(const int32_t *f, const int32_t *T, const int32_t *P,
                       const int32_t *mask, int32_t *fo, int32_t *To,
                       long long rows, const uint64_t *one6,
                       const uint64_t *mod7, void *stream) {
  return launch(f, T, nullptr, P, mask, fo, To, rows, one6, mod7, stream);
}

int dt_miller_dbl_iter_attrs(int *out) {
  return dt::kernel_attrs(k_miller_iter<IS_ADD>, MT, SMEM, out);
}
#else
int dt_miller_add_iter(const int32_t *f, const int32_t *T, const int32_t *Q,
                       const int32_t *P, const int32_t *mask, int32_t *fo,
                       int32_t *To, long long rows, const uint64_t *one6,
                       const uint64_t *mod7, void *stream) {
  return launch(f, T, Q, P, mask, fo, To, rows, one6, mod7, stream);
}

int dt_miller_add_iter_attrs(int *out) {
  return dt::kernel_attrs(k_miller_iter<IS_ADD>, MT, SMEM, out);
}
#endif

}  // extern "C"
