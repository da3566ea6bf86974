// The Fp2 and flat-Fp12 kernels of the verify path, for sm_90a,
// behind a plain C interface (loaded with ctypes by
// drand_tpu_torch/ops/kernels.py together with field_kernels.cu).  The
// arithmetic is in tower_arith.cuh.  Inputs are int32 limbs (the layout of
// drand_tpu_torch/ops/field.py), canonical, contiguous and 16-byte
// aligned; the Python wrappers check that.  Each entry point launches on
// the given stream, does not synchronise, and returns the
// cudaGetLastError() of its launch.
//
// What bounds them on the H100 (the convention of field_kernels.cu: each
// input read once and each output written once at 3.35 TB/s, against
// 32-bit multiply-adds at 16.7 T/s, 8 for a 64x64-bit word product and 4
// for a REDC quotient word, 312 for a REDC):
//
// K5 dt_fp2_products -- replaces PallasField.fp2_products
//   (drand_tpu/ops/pallas_field.py:1062, body _fp2_products_kernel :984).
//   n stacked Fp2 products: four 6x6-word products and two REDCs, 1776
//   multiply-adds on 768 bytes a pair-row: bound by bytes.  Two threads a
//   pair-row on neighbouring lanes, lane h computing half h with fp2_half
//   (one REDC of a wide sum each: x0 y0 - x1 y1 lifted by m * 2^384 when
//   negative, x0 y1 + x1 y0), so twice the warps of one thread a pair-row
//   hide the latency of a half as long a chain.  A block of 32 pair-rows
//   stages the pair's four coordinate planes and writes its two output
//   planes coalesced (stage.cuh, 16-byte chunks through shared memory).
// K6 dt_fp2_sqrs -- replaces PallasField.fp2_sqrs (:1029, body :1008).
//   n stacked Fp2 squares: two triangular squares, one cross product
//   doubled and two REDCs, 1,200 multiply-adds on 512 bytes a row: bound
//   by bytes.  K5's launch shape: two threads a row on neighbouring
//   lanes, a block of 32 rows staging the item's two coordinate planes
//   and writing them back coalesced (stage.cuh).  Lane h computes half h
//   of the square as one Montgomery product of operands it picks
//   (tower_arith.cuh fp2_sqr_lane32: (a + b)(a - b) or a (2b), K7's
//   split) on the 32-bit carry chains of field_arith32.cuh (mont_mul32,
//   K1's and K4's product), so a lane waits out one 12-word CIOS where
//   one thread a row waited out two squares, a cross product and two
//   64-bit REDCs.
// K13 dt_flat_mul -- replaces PallasField.flat_mul (:1125, body
//   _flat_mul_kernel :971).  A flat Fp12 product, b dense or sparse on
//   b_idx: 144 word products and 23 REDCs a row when dense as schoolbook,
//   ~48.6k multiply-adds on 4.6 KB, bound by operations.  One kernel, an
//   instance a pattern of b's powers (tower_arith.cuh FlatB, chosen here
//   from b_idx): dense (the final exponentiation) through one Karatsuba
//   level on the w^6 split, 108 word products and 33 REDCs
//   (flat_kara_phase); LINE_IDX (the trio Miller loop) and any other set
//   through flat_mul_slots, each coefficient's products only.  A row is 72
//   words of a and as many of b, too many for one thread's registers, so a
//   block stages 32 rows of a and b (b at its own J coefficients, so a
//   sparse b stays sparse) into shared memory as words, coalesced, every
//   load of a thread in flight at once (stage.cuh stage_in_all; a b of
//   another width than 12 or 6 through stage_in), in
//   structure of arrays (neighbouring threads read neighbouring words, no
//   bank conflicts).  Six threads share a row, thread j owning output
//   slots j and j + 6, each warp on one j so the loops do not diverge; the
//   slots go back through shared memory, coalesced.  Its time follows its
//   code size: every loop over coefficients and products is kept rolled,
//   one product body and one REDC in each instance (~4.7k SASS
//   instructions dense where the unrolled loops took 8.7k).  At most 80
//   registers a thread, four 192-thread blocks a SM: 16384 rows in one
//   wave.
// K14 dt_cyclo_sqr -- replaces PallasField.cyclo_sqr (:647, body
//   _cyclo_sqr_kernel :581), in chain form: k Granger-Scott squares in one
//   launch (drand_tpu launches one a square; the port's final
//   exponentiation passes each run of squares of its ladder to one call).
//   A square is nine Fp2 squares and the Fp4 folds, 11,232 multiply-adds
//   a row, so a chain of k is bound by operations at k >= 2 and by the
//   3 KB a row it reads and writes at k = 1.  A block stages its 32 rows
//   once, coalesced (stage.cuh), into shared memory as words in tower-cell
//   form, squares k times there and writes once.  Each square is two
//   phases with a barrier after each: nine threads a row, one per Fp2
//   square (cyclo_sqr_square, each warp one square of 32 rows), then six,
//   one per output cell (cyclo_sqr_fold, in place).  Shared memory: the
//   cells and the nine squares, 46,080 bytes a block.

// K7 dt_fp2_sqr_chain_mul -- replaces PallasField.fp2_sqr_chain_mul
//   (:1326, body _fp2_sqr_chain_mul_kernel :1298).  The Fp2 addition-chain
//   step x^(2^k) * t (or x^(2^k)), every square and the product canonical
//   in words (no lazy band, so no _WIDE_NEG_OFF_LAZY): k * 1248 + 1776
//   multiply-adds on 384 bytes a row, bound by operations.  Two threads
//   a row, neighbouring lanes of one warp: lane h owns half h of the
//   running value, each square is one Montgomery product a lane on
//   operands the lane picks (tower_arith.cuh fp2_sqr_lane: (a+b)(a-b) or
//   a(2b)), and the two halves are swapped with __shfl_xor_sync after
//   each square (six 64-bit words); the product with t is one REDC of a
//   wide sum a lane (fp2_half), and lane h writes half h.  A square is
//   then 600 multiply-adds on a lane's path where one thread took
//   1,248.  32 rows (64 threads) a block: 16384 rows are 512 blocks, all
//   resident at once on 132 SMs.
// K8 dt_fp2_sqr5_mul -- replaces PallasField.fp2_sqr5_mul (:1348, body
//   :1286).  The window step x^32 * t: K7's kernel at k = 5.
// K15 dt_flat_conj -- replaces PallasField.flat_conj (:1812, body :1804).
//   f^(p^6), the odd w-powers negated: 3 KB a row and no multiply, bound
//   by bytes.  A streaming pass over 16-byte chunks in limbs, no shared
//   memory and no words: eight lanes a coefficient, lane j its chunk j,
//   so a warp's load touches four whole 128-byte lines.  An odd
//   coefficient's lanes subtract their limbs from p's, the borrow across
//   them from a lookahead over the warp's masks of the chunks that
//   generate and pass on a borrow (tower_arith.cuh conj_chunk; three
//   __ballot_sync a chunk, the third the zero chunks, as 0 stays 0); an
//   even one is stored as it came.  A grid-stride loop of
//   CONJ_CHUNKS chunks a thread a trip, every load of a trip issued
//   before any is used, over as many blocks as the card holds at once.
// K16 dt_flat_frob -- replaces PallasField.flat_frob (:1834, body :1817).
//   f^(p^n), n = 1..3: per slot pair (s, s + 6) a 2x2 matrix of Montgomery
//   constants, at most 24 Montgomery products and 12 adds on 3 KB a row,
//   bound by bytes at every n.  Many constants are 0, one or minus one
//   (n = 2: every matrix diagonal, slot 0 the identity and slot 3 its
//   negation, 8 products a row; n = 1: 17; n = 3: 12), so the entry point
//   sorts each constant into its class from the words it is given
//   (tower_arith.cuh frob_from_words) and a term by a zero constant costs
//   nothing, by one a copy, by minus one a subtraction from 0, and only
//   the others a product (mont_mul32, the 32-bit carry chains of K1).  A
//   block stages 32 rows in and out coalesced (stage.cuh, every load of a
//   thread in flight at once); each of its twelve warps computes one
//   output coefficient (slot s, half h) of the 32 rows, so the constants
//   and their classes are read at warp-uniform indices of a
//   __grid_constant__ argument (no copy to a local frame) and a warp's
//   branch on the class never diverges.

// K17 dt_flat_sqr -- replaces PallasField.flat_sqr (:1758, body
//   _flat_sqr_kernel :1749, phase _sqr_phase :929).  The slot-symmetric
//   flat Fp12 square: 66 general and 12 triangular word products and 23
//   REDCs a row where K13 takes 144 and 23, ~28.2k multiply-adds on 3 KB,
//   bound by operations.  K13's launch shape on one operand: a block
//   stages 32 rows coalesced, every load of a thread in flight at once
//   (stage.cuh stage_in_all), six threads a row, thread j owning the
//   powers k = j mod 6 (tower_arith.cuh flat_sqr_slots: rolled loops, one
//   product body, each coefficient folded into the output rows in shared
//   memory as it is reduced, so no thread keeps lo and hi in registers
//   through its products), and the square is staged out coalesced.  Four
//   blocks a SM: 16384 rows in one wave.  K11's square is flat_sqr_class,
//   the same coefficients recombined in registers.
// K20 dt_line_merge -- replaces PallasField.line_merge (:1898, body
//   _line_merge_kernel :1887, phase _line_merge_phase :1864).  The dense
//   product of two sparse lines on LINE_IDX, the same launch shape with
//   line_merge_class: 36 word products and 16 REDCs a row, ~15.4k
//   multiply-adds on 3 KB, bound by operations and bytes alike (0.92 ns
//   a row each); staged in and out through stage.cuh.  Like drand_tpu's,
//   it has no caller on the verify path: K11 and K12 multiply f by their
//   two lines one after the other.

#include <cuda_runtime.h>

#include "stage.cuh"
#include "tower_arith.cuh"

namespace {

constexpr int FLAT_ROWS = 32;                 // rows of a K13 block
constexpr int FLAT_THREADS = 6 * FLAT_ROWS;   // six threads a row

constexpr int FROB_ROWS = 32;                 // rows of a K16 block
constexpr int FROB_THREADS = 12 * FROB_ROWS;  // a warp an output coefficient

constexpr int F2P_ROWS = 32;                  // pair-rows of a K5, K6 block
constexpr int F2P_THREADS = 2 * F2P_ROWS;     // two threads a pair-row

// K5: block b serves rows [row0, row0 + F2P_ROWS) of pair b / per_pair.
// Coordinate c of pair p is the plane (2p + c) * rows * 32 of x, y and o.
// The block stages the pair's four planes (x0, x1, y0, y1: elements 0-3
// of flat_load's layout), lane h of a row computes half h of its product
// (fp2_half: h = 0 the real part, 1 the imaginary one) and puts it in
// element h, and the block writes elements 0 and 1 back as planes o0, o1.
__global__ void __launch_bounds__(F2P_THREADS)
    k_fp2_products(const int32_t *__restrict__ x,
                   const int32_t *__restrict__ y, int32_t *__restrict__ o,
                   long long rows, int per_pair, dt::Mod M) {
  constexpr int R = F2P_ROWS;
  __shared__ uint64_t s[4 * dt::N_WORDS * R];
  const long long plane = rows * dt::N_LIMBS;
  const long long at = 2 * (blockIdx.x / per_pair) * plane;
  const long long row0 = (long long)(blockIdx.x % per_pair) * R;
  for (int c = 0; c < 2; c++) {
    dt::stage_in_all<R, F2P_THREADS, 1>(x + at + c * plane, row0, rows,
                                        s + c * dt::N_WORDS * R);
    dt::stage_in_all<R, F2P_THREADS, 1>(y + at + c * plane, row0, rows,
                                        s + (2 + c) * dt::N_WORDS * R);
  }
  __syncthreads();
  const int r = threadIdx.x / 2, h = threadIdx.x & 1;
  dt::F2 a, b;
  dt::flat_load(s + r, 0, R, a.x);
  dt::flat_load(s + r, 1, R, a.y);
  dt::flat_load(s + r, 2, R, b.x);
  dt::flat_load(s + r, 3, R, b.y);
  uint64_t half[dt::N_WORDS];
  dt::fp2_half(h, a, b, half, M);
  __syncthreads();                             // every lane has its operands
  dt::flat_store(half, s + r, h, R);
  __syncthreads();
  for (int c = 0; c < 2; c++)
    dt::stage_out<R>(s + c * dt::N_WORDS * R, 1, row0, rows,
                     o + at + c * plane);
}

// K6: K5's blocks on one operand.  Block b serves rows [row0, row0 +
// F2P_ROWS) of item b / per_item, whose coordinate c is the plane (2p +
// c) * rows * 32 of x and o; lane h of a row puts half h of its square
// (fp2_sqr_lane32) in element h, and the block writes both planes back.
__global__ void __launch_bounds__(F2P_THREADS)
    k_fp2_sqrs(const int32_t *__restrict__ x, int32_t *__restrict__ o,
               long long rows, int per_item, dt::Mod M, dt::Mod32 M32) {
  constexpr int R = F2P_ROWS;
  __shared__ uint64_t s[2 * dt::N_WORDS * R];
  const long long plane = rows * dt::N_LIMBS;
  const long long at = 2 * (blockIdx.x / per_item) * plane;
  const long long row0 = (long long)(blockIdx.x % per_item) * R;
  for (int c = 0; c < 2; c++)
    dt::stage_in_all<R, F2P_THREADS, 1>(x + at + c * plane, row0, rows,
                                        s + c * dt::N_WORDS * R);
  __syncthreads();
  const int r = threadIdx.x / 2, h = threadIdx.x & 1;
  uint64_t a[dt::N_WORDS], b[dt::N_WORDS], half[dt::N_WORDS];
  dt::flat_load(s + r, 0, R, a);
  dt::flat_load(s + r, 1, R, b);
  dt::fp2_sqr_lane32(h, a, b, half, M, M32);
  __syncthreads();                             // every lane has its operands
  dt::flat_store(half, s + r, h, R);
  __syncthreads();
  for (int c = 0; c < 2; c++)
    dt::stage_out<R>(s + c * dt::N_WORDS * R, 1, row0, rows,
                     o + at + c * plane);
}

// K13, one instance a pattern of b's powers (tower_arith.cuh FlatB).
// Four blocks a SM (so at most 80 registers a thread): 16384 rows, 512
// blocks, in one wave on 132 SMs.  Rows past the end compute on zeros and
// store nothing.  The dense instance's Karatsuba phases are one loop, so
// its phase body is in the code once.
template <dt::FlatB B>
__global__ void __launch_bounds__(FLAT_THREADS, 4)
    k_flat_mul(const int32_t *__restrict__ a, const int32_t *__restrict__ b,
               int32_t *__restrict__ o, long long rows, int J,
               dt::FlatIdx idx, dt::Mod M) {
  // word v of coefficient i of block row r at [(i * 6 + v) * FLAT_ROWS + r]
  __shared__ uint64_t sa[dt::FLAT * dt::N_WORDS * FLAT_ROWS];
  __shared__ uint64_t sb[dt::FLAT * dt::N_WORDS * FLAT_ROWS];
  const long long row0 = (long long)blockIdx.x * FLAT_ROWS;
  dt::stage_in_all<FLAT_ROWS, FLAT_THREADS, dt::FLAT>(a, row0, rows, sa);
  if constexpr (B == dt::FlatB::DENSE)
    dt::stage_in_all<FLAT_ROWS, FLAT_THREADS, dt::FLAT>(b, row0, rows, sb);
  else if (J == 6)                             // the trio's lines
    dt::stage_in_all<FLAT_ROWS, FLAT_THREADS, 6>(b, row0, rows, sb);
  else
    dt::stage_in<FLAT_ROWS>(b, J, row0, rows, sb);
  __syncthreads();
  const int j = threadIdx.x / FLAT_ROWS, r = threadIdx.x % FLAT_ROWS;
  uint64_t lo[dt::N_WORDS] = {0, 0, 0, 0, 0, 0};
  uint64_t hi[dt::N_WORDS] = {0, 0, 0, 0, 0, 0};
  if constexpr (B == dt::FlatB::DENSE) {       // Karatsuba on the w^6 split
#pragma unroll 1
    for (int phase = 0; phase < 2; phase++) {  // one copy of the phase
      dt::flat_kara_phase(phase, j, sa + r, sb + r, FLAT_ROWS, lo, hi, M);
      if (phase == 0) {
        __syncthreads();
        dt::flat_kara_sums(j, sa + r, sb + r, FLAT_ROWS, M);
        __syncthreads();
      }
    }
  } else {
    dt::flat_mul_slots(j, sa + r, sb + r, FLAT_ROWS, idx, lo, hi, M);
  }
  __syncthreads();                             // every thread done with sa
  dt::flat_store(lo, sa + r, j, FLAT_ROWS);
  dt::flat_store(hi, sa + r, j + 6, FLAT_ROWS);
  __syncthreads();
  dt::stage_out<FLAT_ROWS>(sa, dt::FLAT, row0, rows, o);
}

// K17: K13's launch shape on one operand.  Four blocks a SM (at most 80
// registers a thread): 16384 rows, 512 blocks, in one wave on 132 SMs.
// Thread j's coefficients fold into elements j and j + 6 of so as they
// are reduced (tower_arith.cuh flat_sqr_slots), so no thread holds lo and
// hi in registers through its products; rows past the end compute on
// zeros and store nothing.
__global__ void __launch_bounds__(FLAT_THREADS, 4)
    k_flat_sqr(const int32_t *__restrict__ a, int32_t *__restrict__ o,
               long long rows, dt::Mod M) {
  // word v of coefficient i of block row r at [(i * 6 + v) * FLAT_ROWS + r]
  __shared__ uint64_t sa[dt::FLAT * dt::N_WORDS * FLAT_ROWS];
  __shared__ uint64_t so[dt::FLAT * dt::N_WORDS * FLAT_ROWS];
  const long long row0 = (long long)blockIdx.x * FLAT_ROWS;
  dt::stage_in_all<FLAT_ROWS, FLAT_THREADS, dt::FLAT>(a, row0, rows, sa);
  __syncthreads();
  const int j = threadIdx.x / FLAT_ROWS, r = threadIdx.x % FLAT_ROWS;
  dt::flat_sqr_slots(j, sa + r, so + r, FLAT_ROWS, M);
  __syncthreads();
  dt::stage_out<FLAT_ROWS>(so, dt::FLAT, row0, rows, o);
}

// K20, off every path: the two lines staged side by side (l1 at elements
// 0-5, l2 at 6-11), the product written over them once every thread has
// read its operands, and staged out; rows past the end compute on zeros
// and store nothing.
__global__ void __launch_bounds__(FLAT_THREADS)
    k_line_merge(const int32_t *__restrict__ l1,
                 const int32_t *__restrict__ l2, int32_t *__restrict__ o,
                 long long rows, dt::Mod M) {
  constexpr int SLOT = dt::N_WORDS * FLAT_ROWS;
  __shared__ uint64_t s[dt::FLAT * SLOT];
  const long long row0 = (long long)blockIdx.x * FLAT_ROWS;
  dt::stage_in_all<FLAT_ROWS, FLAT_THREADS, 6>(l1, row0, rows, s);
  dt::stage_in_all<FLAT_ROWS, FLAT_THREADS, 6>(l2, row0, rows, s + 6 * SLOT);
  __syncthreads();
  const int j = threadIdx.x / FLAT_ROWS, r = threadIdx.x % FLAT_ROWS;
  uint64_t lo[dt::N_WORDS], hi[dt::N_WORDS];
  dt::line_merge_class(j, s + r, s + 6 * SLOT + r, FLAT_ROWS, lo, hi, M);
  __syncthreads();                             // every thread done with s
  dt::flat_store(lo, s + r, j, FLAT_ROWS);
  dt::flat_store(hi, s + r, j + 6, FLAT_ROWS);
  __syncthreads();
  dt::stage_out<FLAT_ROWS>(s, dt::FLAT, row0, rows, o);
}

constexpr int CY_ROWS = 32;                    // rows of a K14 block
constexpr int CY_THREADS = 9 * CY_ROWS;       // nine threads a row

__global__ void __launch_bounds__(CY_THREADS, 2)
    k_cyclo_sqr(const int32_t *__restrict__ a, int32_t *__restrict__ o,
                long long rows, int k, dt::Mod M) {
  // cell s of block row r: x at element s, y at element s + 6; square q
  // at elements 2q, 2q + 1 (flat_load's layout, stride CY_ROWS)
  __shared__ uint64_t cells[dt::FLAT * dt::N_WORDS * CY_ROWS];
  __shared__ uint64_t sq[18 * dt::N_WORDS * CY_ROWS];
  const long long row0 = (long long)blockIdx.x * CY_ROWS;
  dt::stage_in<CY_ROWS>(a, dt::FLAT, row0, rows, cells);
  __syncthreads();
  const int j = threadIdx.x / CY_ROWS, r = threadIdx.x % CY_ROWS;
  if (j < 6) dt::cyclo_to_cell(j, cells + r, CY_ROWS, M);
  __syncthreads();
  for (int i = 0; i < k; i++) {
    dt::cyclo_sqr_square(j, cells + r, sq + r, CY_ROWS, M);
    __syncthreads();
    if (j < 6) dt::cyclo_sqr_fold(j, cells + r, sq + r, CY_ROWS, M);
    __syncthreads();
  }
  if (j < 6) dt::cyclo_to_flat(j, cells + r, CY_ROWS, M);
  __syncthreads();
  dt::stage_out<CY_ROWS>(cells, dt::FLAT, row0, rows, o);
}

constexpr int F2C_ROWS = 32;                  // rows of a K7 block
constexpr int F2C_THREADS = 2 * F2C_ROWS;     // two threads a row

// The Fp2 value whose half h this lane holds in `mine`, the other half
// from the neighbouring lane.
__device__ __forceinline__ void swap_halves(const uint64_t *mine, int h,
                                            dt::F2 &a) {
#pragma unroll
  for (int v = 0; v < dt::N_WORDS; v++) {
    const uint64_t other = (uint64_t)__shfl_xor_sync(
        0xffffffffu, (unsigned long long)mine[v], 1);
    a.x[v] = h ? other : mine[v];
    a.y[v] = h ? mine[v] : other;
  }
}

// K7, K8: coordinate c of row r at (c * rows + r) * 32.  Lanes of rows
// past the end compute on zeros (every lane of a warp takes part in the
// shuffles) and store nothing.
__global__ void __launch_bounds__(F2C_THREADS)
    k_fp2_sqr_chain_mul(const int32_t *__restrict__ x,
                        const int32_t *__restrict__ t,
                        int32_t *__restrict__ o, long long rows, int k,
                        dt::Mod M) {
  const long long r = (long long)blockIdx.x * F2C_ROWS + threadIdx.x / 2;
  const int h = threadIdx.x & 1;
  const bool in = r < rows;
  const long long at = (h * rows + r) * dt::N_LIMBS;   // half h of row r
  uint64_t mine[dt::N_WORDS] = {0, 0, 0, 0, 0, 0};
  dt::F2 a;
  if (in) dt::load_words(x + at, mine);
  swap_halves(mine, h, a);
  for (int s = 0; s < k; s++) {
    dt::fp2_sqr_lane(h, a.x, a.y, mine, M);
    swap_halves(mine, h, a);
  }
  if (t != nullptr) {
    uint64_t tt[dt::N_WORDS] = {0, 0, 0, 0, 0, 0};
    dt::F2 c;
    if (in) dt::load_words(t + at, tt);
    swap_halves(tt, h, c);
    dt::fp2_half(h, a, c, mine, M);
  }
  if (in) dt::store_words(mine, o + at);
}

constexpr int CONJ_THREADS = 256;
constexpr int CONJ_CHUNKS = 4;                // a thread's chunks a trip

// K15 on n 16-byte chunks: chunk q is chunk q % 8 of coefficient q / 8,
// on lane q % 32 (blocks and trips are whole warps apart), and the
// coefficient is odd where q / 8 is (a row has 12).  n is a multiple of
// 96, so a warp's 32 chunks are all in or all out, and all its lanes take
// part in the ballots.
__global__ void __launch_bounds__(CONJ_THREADS)
    k_flat_conj(const int4 *__restrict__ a, int4 *__restrict__ o,
                long long n, dt::Mod M) {
  const int lane = threadIdx.x & 31;
  int32_t pl[4];
  dt::conj_p_chunk(lane & 7, M, pl);
  constexpr int BLOCK = CONJ_THREADS * CONJ_CHUNKS;
  for (long long q0 = (long long)blockIdx.x * BLOCK + threadIdx.x; q0 < n;
       q0 += (long long)gridDim.x * BLOCK) {
    int4 v[CONJ_CHUNKS];
#pragma unroll
    for (int i = 0; i < CONJ_CHUNKS; i++)
      if (q0 + i * CONJ_THREADS < n) v[i] = a[q0 + i * CONJ_THREADS];
#pragma unroll
    for (int i = 0; i < CONJ_CHUNKS; i++) {
      const long long q = q0 + i * CONJ_THREADS;
      if (q >= n) break;
      const int32_t x[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
      bool gen, pass, zero;
      dt::conj_flags(x, pl, gen, pass, zero);
      const uint32_t G = __ballot_sync(0xffffffffu, gen);
      const uint32_t T = __ballot_sync(0xffffffffu, pass);
      const uint32_t Z = __ballot_sync(0xffffffffu, zero);
      int32_t y[4];
      dt::conj_chunk(lane, (q >> 3) & 1, x, pl, G, T, Z, y);
      o[q] = make_int4(y[0], y[1], y[2], y[3]);
    }
  }
}

// K16: warp w of the block computes output coefficient s + 6 h, s = w %
// 6, h = w / 6, of the block's 32 rows (lane = row); every warp has read
// its two inputs before any writes its output over its slot.
__global__ void __launch_bounds__(FROB_THREADS, 2)
    k_flat_frob(const int32_t *__restrict__ a, int32_t *__restrict__ o,
                long long rows, const __grid_constant__ dt::FrobConsts F,
                dt::Mod M, dt::Mod32 M32) {
  constexpr int R = FROB_ROWS;
  __shared__ uint64_t sm[dt::FLAT * dt::N_WORDS * R];
  const long long row0 = (long long)blockIdx.x * R;
  dt::stage_in_all<R, FROB_THREADS, dt::FLAT>(a, row0, rows, sm);
  __syncthreads();
  const int w = threadIdx.x / 32, r = threadIdx.x % 32;
  const int s = w % 6, h = w / 6;
  uint64_t out[dt::N_WORDS];
  dt::flat_frob_out(s, h, sm + r, R, F, out, M, M32);
  __syncthreads();
  dt::flat_store(out, sm + r, s + 6 * h, R);
  __syncthreads();
  dt::stage_out<R>(sm, dt::FLAT, row0, rows, o);
}

unsigned blocks(long long n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

// Blocks of k_flat_conj the current device holds at once (SMs times
// resident blocks a SM), asked once a device.
unsigned conj_resident_blocks() {
  static int cached[64];
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  if (cached[dev] == 0) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k_flat_conj,
                                                  CONJ_THREADS, 0);
    cached[dev] = sms * per_sm > 0 ? sms * per_sm : 1;
  }
  return (unsigned)cached[dev];
}

}  // namespace

extern "C" {

int dt_fp2_products(const int32_t *x, const int32_t *y, int32_t *o,
                    long long rows, int n, const uint64_t *mod7,
                    void *stream) {
  if (rows <= 0 || n <= 0) return 0;
  const unsigned per_pair = blocks(rows, F2P_ROWS);
  k_fp2_products<<<n * per_pair, F2P_THREADS, 0, (cudaStream_t)stream>>>(
      x, y, o, rows, (int)per_pair, dt::mod_from_words(mod7));
  return (int)cudaGetLastError();
}

int dt_fp2_sqrs(const int32_t *x, int32_t *o, long long rows, int n,
                const uint64_t *mod7, void *stream) {
  if (rows <= 0 || n <= 0) return 0;
  const unsigned per_item = blocks(rows, F2P_ROWS);
  k_fp2_sqrs<<<n * per_item, F2P_THREADS, 0, (cudaStream_t)stream>>>(
      x, o, rows, (int)per_item, dt::mod_from_words(mod7),
      dt::mod32_from_words(mod7));
  return (int)cudaGetLastError();
}

int dt_fp2_sqrs_attrs(int *out) {
  return dt::kernel_attrs(k_fp2_sqrs, F2P_THREADS, 0, out);
}

// b_idx: the J distinct w-powers (0..11) that b's rows hold, host memory;
// they choose the kernel's instance (dt::flat_pattern).
int dt_flat_mul(const int32_t *a, const int32_t *b, int32_t *o,
                long long rows, const int *b_idx, int J,
                const uint64_t *mod7, void *stream) {
  if (rows <= 0) return 0;
  const dt::FlatIdx idx = dt::flat_idx(b_idx, J);
  const dt::Mod M = dt::mod_from_words(mod7);
  const unsigned g = blocks(rows, FLAT_ROWS);
  cudaStream_t s = (cudaStream_t)stream;
  if (dt::flat_pattern(b_idx, J) == dt::FlatB::DENSE)
    k_flat_mul<dt::FlatB::DENSE><<<g, FLAT_THREADS, 0, s>>>(a, b, o, rows, J,
                                                            idx, M);
  else
    k_flat_mul<dt::FlatB::ANY><<<g, FLAT_THREADS, 0, s>>>(a, b, o, rows, J,
                                                          idx, M);
  return (int)cudaGetLastError();
}

int dt_flat_sqr(const int32_t *a, int32_t *o, long long rows,
                const uint64_t *mod7, void *stream) {
  if (rows <= 0) return 0;
  k_flat_sqr<<<blocks(rows, FLAT_ROWS), FLAT_THREADS, 0,
               (cudaStream_t)stream>>>(a, o, rows, dt::mod_from_words(mod7));
  return (int)cudaGetLastError();
}

int dt_flat_sqr_attrs(int *out) {
  return dt::kernel_attrs(k_flat_sqr, FLAT_THREADS, 0, out);
}

// l1, l2 [rows, 6, 32] on LINE_IDX; o [rows, 12, 32] dense.
int dt_line_merge(const int32_t *l1, const int32_t *l2, int32_t *o,
                  long long rows, const uint64_t *mod7, void *stream) {
  if (rows <= 0) return 0;
  k_line_merge<<<blocks(rows, FLAT_ROWS), FLAT_THREADS, 0,
                 (cudaStream_t)stream>>>(l1, l2, o, rows,
                                         dt::mod_from_words(mod7));
  return (int)cudaGetLastError();
}

int dt_line_merge_attrs(int *out) {
  return dt::kernel_attrs(k_line_merge, FLAT_THREADS, 0, out);
}

// k >= 1 squares in one launch.
int dt_cyclo_sqr(const int32_t *a, int32_t *o, long long rows, int k,
                 const uint64_t *mod7, void *stream) {
  if (rows <= 0 || k <= 0) return 0;
  k_cyclo_sqr<<<blocks(rows, CY_ROWS), CY_THREADS, 0,
                (cudaStream_t)stream>>>(a, o, rows, k,
                                        dt::mod_from_words(mod7));
  return (int)cudaGetLastError();
}

int dt_cyclo_sqr_attrs(int *out) {
  return dt::kernel_attrs(k_cyclo_sqr, CY_THREADS, 0, out);
}

// K13's dense instance, the final exponentiation's.
int dt_flat_mul_attrs(int *out) {
  return dt::kernel_attrs(k_flat_mul<dt::FlatB::DENSE>, FLAT_THREADS, 0, out);
}

int dt_fp2_products_attrs(int *out) {
  return dt::kernel_attrs(k_fp2_products, F2P_THREADS, 0, out);
}

// t may be null: then x^(2^k).
int dt_fp2_sqr_chain_mul(const int32_t *x, const int32_t *t, int32_t *o,
                         long long rows, int k, const uint64_t *mod7,
                         void *stream) {
  if (rows <= 0) return 0;
  k_fp2_sqr_chain_mul<<<blocks(rows, F2C_ROWS), F2C_THREADS, 0,
                        (cudaStream_t)stream>>>(x, t, o, rows, k,
                                                dt::mod_from_words(mod7));
  return (int)cudaGetLastError();
}

int dt_fp2_sqr5_mul(const int32_t *x, const int32_t *t, int32_t *o,
                    long long rows, const uint64_t *mod7, void *stream) {
  return dt_fp2_sqr_chain_mul(x, t, o, rows, 5, mod7, stream);
}

// K7's (and K8's).
int dt_fp2_sqr_chain_mul_attrs(int *out) {
  return dt::kernel_attrs(k_fp2_sqr_chain_mul, F2C_THREADS, 0, out);
}

int dt_flat_conj(const int32_t *a, int32_t *o, long long rows,
                 const uint64_t *mod7, void *stream) {
  if (rows <= 0) return 0;
  const long long n = rows * dt::FLAT * 8;      // 16-byte chunks
  const unsigned need = blocks(n, CONJ_THREADS * CONJ_CHUNKS);
  const unsigned most = conj_resident_blocks();
  k_flat_conj<<<need < most ? need : most, CONJ_THREADS, 0,
                (cudaStream_t)stream>>>(
      reinterpret_cast<const int4 *>(a), reinterpret_cast<int4 *>(o), n,
      dt::mod_from_words(mod7));
  return (int)cudaGetLastError();
}

int dt_flat_conj_attrs(int *out) {
  return dt::kernel_attrs(k_flat_conj, CONJ_THREADS, 0, out);
}

// consts: the 6 x 4 x 6 words of the matrices A B C D of each slot, host
// memory; their classes are found here (dt::frob_from_words).
int dt_flat_frob(const int32_t *a, int32_t *o, long long rows,
                 const uint64_t *consts, const uint64_t *mod7,
                 void *stream) {
  if (rows <= 0) return 0;
  const dt::Mod M = dt::mod_from_words(mod7);
  k_flat_frob<<<blocks(rows, FROB_ROWS), FROB_THREADS, 0,
                (cudaStream_t)stream>>>(a, o, rows,
                                        dt::frob_from_words(consts, M), M,
                                        dt::mod32_from_words(mod7));
  return (int)cudaGetLastError();
}

int dt_flat_frob_attrs(int *out) {
  return dt::kernel_attrs(k_flat_frob, FROB_THREADS, 0, out);
}

}  // extern "C"
