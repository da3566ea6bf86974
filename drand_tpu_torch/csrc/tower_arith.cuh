// Fp2 and flat Fp12 arithmetic over the Montgomery words of
// field_arith.cuh (K6's product on field_arith32.cuh's 32-bit words, K15
// on the limbs themselves), shared by the CUDA kernels (tower_kernels.cu)
// and the host harness (field_host.cpp, built with g++ by
// tests/test_torch_kernel_harness.py).
//
// Every value is canonical (in [0, p)) on entry and on exit, so each
// function's output equals the plain PyTorch version's bit for bit: both
// return the unique canonical residue of the same quantity.
//
//   Fp2        : c0 + c1*u, u^2 = -1
//   flat Fp12  : 12 coefficients over 1, w, ..., w^11, w^12 = 2w^6 - 2;
//                the tower cell x + y*u at slot s is (x - y)*w^s +
//                y*w^(s+6) (drand_tpu_torch/ops/flat12.py)
#pragma once

#include "field_arith.cuh"
#include "field_arith32.cuh"

// A loop kept rolled on the card: one copy of its body in the code.
#if defined(__CUDACC__)
#define DT_NO_UNROLL _Pragma("unroll 1")
#else
#define DT_NO_UNROLL
#endif

namespace dt {

constexpr int FLAT = 12;      // coefficients of a flat Fp12 element

// w += a * b over 13 words (the caller keeps the sum below 2^832).
DT_HD void mul_acc(const uint64_t *a, const uint64_t *b, uint64_t *w) {
  DT_UNROLL
  for (int i = 0; i < N_WORDS; i++) {
    uint64_t c = 0;
    DT_UNROLL
    for (int j = 0; j < N_WORDS; j++) w[i + j] = mac(a[j], b[i], w[i + j], c);
    DT_UNROLL
    for (int j = i + N_WORDS; j < W_WORDS; j++) {
      const uint64_t s = w[j] + c;
      c = s < c;
      w[j] = s;
    }
  }
}

DT_HD void zero_wide(uint64_t *w) {
  DT_UNROLL
  for (int i = 0; i < W_WORDS; i++) w[i] = 0;
}

// t <- t - u over 12 words for t, u < m^2, plus m * 2^384 where the
// difference is negative: the value stays congruent mod m and lands in
// [0, m * 2^384), which REDC maps below 2m.
DT_HD void wide_sub(uint64_t *t, const uint64_t *u, const Mod &M) {
  uint64_t borrow = 0;
  DT_UNROLL
  for (int j = 0; j < 2 * N_WORDS; j++) {
    const uint64_t x = t[j] - u[j];
    const uint64_t b1 = t[j] < u[j];
    t[j] = x - borrow;
    borrow = b1 | (x < borrow);
  }
  const uint64_t mask = 0 - borrow;
  uint64_t c = 0;
  DT_UNROLL
  for (int j = 0; j < N_WORDS; j++) {
    const uint64_t mj = M.m[j] & mask;
    const uint64_t s = t[N_WORDS + j] + mj;
    const uint64_t c1 = s < mj;
    t[N_WORDS + j] = s + c;
    c = c1 | (t[N_WORDS + j] < s);
  }
  t[W_WORDS - 1] = 0;                     // the carry cancels the borrow
}

// r = w * 2^-384 mod m, canonical, for a 13-word w < subs * 2^384 * m:
// REDC returns (w + q m) / 2^384 < w / 2^384 + m < (subs + 1) m, and each
// of the `subs` conditional subtracts removes one m.
DT_HD void redc_to(uint64_t *w, uint64_t *r, int subs, const Mod &M) {
  redc_wide(w, M);
  DT_UNROLL
  for (int j = 0; j < N_WORDS; j++) r[j] = w[N_WORDS + j];
  cond_sub(r, w[W_WORDS - 1], M);
  for (int s = 1; s < subs; s++) cond_sub(r, 0, M);
}

// The two halves of B5, each one REDC of a wide sum: r0 = (x0 y0 - x1 y1)
// * 2^-384 mod m, r1 = (x0 y1 + x1 y0) * 2^-384 mod m.
DT_HD void fp2_mul_re(const uint64_t *x0, const uint64_t *x1,
                      const uint64_t *y0, const uint64_t *y1, uint64_t *r0,
                      const Mod &M) {
  uint64_t t[W_WORDS], u[W_WORDS];
  zero_wide(t);
  mul_acc(x0, y0, t);
  zero_wide(u);
  mul_acc(x1, y1, u);
  wide_sub(t, u, M);                      // [0, m 2^384)
  redc_to(t, r0, 1, M);
}

DT_HD void fp2_mul_im(const uint64_t *x0, const uint64_t *x1,
                      const uint64_t *y0, const uint64_t *y1, uint64_t *r1,
                      const Mod &M) {
  uint64_t t[W_WORDS];
  zero_wide(t);
  mul_acc(x0, y1, t);
  mul_acc(x1, y0, t);                     // < 2 m^2
  redc_to(t, r1, 1, M);
}

// B5: (r0, r1) = (x0 y0 - x1 y1, x0 y1 + x1 y0) * 2^-384 mod m.  The
// outputs must not alias the inputs.
DT_HD void fp2_mul_words(const uint64_t *x0, const uint64_t *x1,
                         const uint64_t *y0, const uint64_t *y1,
                         uint64_t *r0, uint64_t *r1, const Mod &M) {
  fp2_mul_re(x0, x1, y0, y1, r0, M);
  fp2_mul_im(x0, x1, y0, y1, r1, M);
}

// The two halves of B6, each one REDC: r0 = (x0^2 - x1^2) * 2^-384 mod m
// from two triangular squares, r1 = 2 x0 x1 * 2^-384 mod m from one
// doubled cross product.
DT_HD void fp2_sqr_re(const uint64_t *x0, const uint64_t *x1, uint64_t *r0,
                      const Mod &M) {
  uint64_t t[W_WORDS], u[W_WORDS];
  sqr_wide(x0, t);
  sqr_wide(x1, u);
  wide_sub(t, u, M);
  redc_to(t, r0, 1, M);
}

DT_HD void fp2_sqr_im(const uint64_t *x0, const uint64_t *x1, uint64_t *r1,
                      const Mod &M) {
  uint64_t t[W_WORDS];
  zero_wide(t);
  mul_acc(x0, x1, t);                     // < m^2 < 2^762: doubling fits
  DT_UNROLL
  for (int i = 2 * N_WORDS - 1; i > 0; i--)
    t[i] = (t[i] << 1) | (t[i - 1] >> 63);
  t[0] <<= 1;
  redc_to(t, r1, 1, M);
}

// B6: (r0, r1) = (x0^2 - x1^2, 2 x0 x1) * 2^-384 mod m.  The outputs must
// not alias the inputs.
DT_HD void fp2_sqr_words(const uint64_t *x0, const uint64_t *x1,
                         uint64_t *r0, uint64_t *r1, const Mod &M) {
  fp2_sqr_re(x0, x1, r0, M);
  fp2_sqr_im(x0, x1, r1, M);
}

// The w-powers that K13's operand b holds, one kernel instance each: all
// twelve (the final exponentiation), or any other set given at run time
// as a FlatIdx (the trio Miller loop's sparse lines on LINE_IDX among them).
enum class FlatB { DENSE, ANY };

// The sparse layout of a flat_mul operand b: pos[p] is the row of b that
// holds the coefficient of w^p (-1 where b has none), K = 12 + the highest
// power of b, the number of convolution coefficients.
struct FlatIdx {
  int pos[FLAT];
  int K;
};

// The FlatIdx of an operand holding the J distinct w-powers b_idx[0..J).
inline FlatIdx flat_idx(const int *b_idx, int J) {
  FlatIdx idx;
  for (int p = 0; p < FLAT; p++) idx.pos[p] = -1;
  int top = 0;
  for (int jj = 0; jj < J; jj++) {
    idx.pos[b_idx[jj]] = jj;
    top = b_idx[jj] > top ? b_idx[jj] : top;
  }
  idx.K = FLAT + top;
  return idx;
}

// The instance for the powers b_idx[0..J): DENSE for 0..11 in order, else
// ANY.
inline FlatB flat_pattern(const int *b_idx, int J) {
  bool dense = J == FLAT;
  for (int jj = 0; jj < J; jj++) dense = dense && b_idx[jj] == jj;
  return dense ? FlatB::DENSE : FlatB::ANY;
}

// Output slots j and j+6 of a flat Fp12 element from its four reduced
// convolution coefficients r[q] = c_(j + 6q), 0 <= j < 6, through
// w^12 = 2w^6 - 2 iterated:
//
//   slot j   = c_j      - 2 c_(j+12) - 4 c_(j+18)
//   slot j+6 = c_(j+6)  + 2 c_(j+12) + 2 c_(j+18)
//
// (the rows of _reduce_matrix in ops/flat12.py).  Recombining reduced
// words with modular adds and subtracts keeps every intermediate in
// [0, m): no wide offset has to cover a subtraction.
DT_HD void flat_recombine(uint64_t (*r)[N_WORDS], uint64_t *lo,
                          uint64_t *hi, const Mod &M) {
  uint64_t u[N_WORDS], v[N_WORDS];
  add_mod(r[2], r[2], u, M);              // 2 c_(j+12)
  add_mod(r[3], r[3], v, M);              // 2 c_(j+18)
  add_mod(r[1], u, hi, M);
  add_mod(hi, v, hi, M);
  sub_mod(r[0], u, lo, M);
  sub_mod(lo, v, lo, M);
  sub_mod(lo, v, lo, M);
}

// Words of element e of an operand: base[(e * 6 + v) * stride], v = 0..5,
// the kernels' shared-memory layout (stride = rows of a block) and the
// harness's plain one (stride = 1) alike.
DT_HD void flat_load(const uint64_t *base, int e, int stride, uint64_t *x) {
  DT_UNROLL
  for (int v = 0; v < N_WORDS; v++) x[v] = base[(e * N_WORDS + v) * stride];
}

// Words of element e of an operand from x: the inverse of flat_load.
DT_HD void flat_store(const uint64_t *x, uint64_t *base, int e, int stride) {
  DT_UNROLL
  for (int v = 0; v < N_WORDS; v++) base[(e * N_WORDS + v) * stride] = x[v];
}

// The w-power of coefficient i of a sparse line, LINE_IDX = (0, 2, 3, 6,
// 8, 9): the slots s = 0, 2, 3 of its three Fp2 cells and s + 6.
DT_HD int line_pow(int i) { return (i % 3 == 0 ? 0 : i % 3 + 1) + 6 * (i / 3); }

// K13 on a sparse b, one thread's share of a flat Fp12 product a*b for the
// powers of b in idx (the dense product is flat_kara_phase's):
// output slots j and j+6 (0 <= j < 6) from the four convolution
// coefficients c_k = sum_{i + p = k} a_i b_p, k = j + 6q (q = 0..3), the
// k = j (mod 6) of the recombination in flat_recombine.  The six classes
// j cover every k once and take 12 products each on LINE_IDX.  Each
// coefficient sums the products of its pairs (i, p) -- a loop with one
// product body over i from max(0, k - 11) to min(k, 11), with b's row of
// w^(k - i) from the run-time table -- is reduced on its own and folded
// into lo and hi at once: one wide sum live, not four reduced
// coefficients, and the loop over q kept rolled, so one product body and
// one REDC in the code.
// A coefficient sums at most 12 products of canonical operands, < 12 m^2
// < 1.22 * 2^384 m, so its REDC value is below 2.22 m and two conditional
// subtracts make it canonical; the folds are modular adds and subtracts of
// canonical values, so lo and hi equal flat_recombine's bit for bit.
DT_HD void flat_mul_slots(int j, const uint64_t *a, const uint64_t *b,
                          int stride, const FlatIdx &idx, uint64_t *lo,
                          uint64_t *hi, const Mod &M) {
  const int top = idx.K - 1;
  DT_NO_UNROLL
  for (int q = 0; q < 4; q++) {
    const int k = j + 6 * q;
    uint64_t r[N_WORDS] = {0, 0, 0, 0, 0, 0};
    if (k <= top) {
      uint64_t w[W_WORDS];
      zero_wide(w);
      const int n = (k < FLAT ? k : FLAT - 1) + 1;
      DT_NO_UNROLL
      for (int i = k < FLAT ? 0 : k - (FLAT - 1); i < n; i++) {
        const int p = idx.pos[k - i];
        if (p < 0) continue;
        uint64_t x[N_WORDS], y[N_WORDS];
        flat_load(a, i, stride, x);
        flat_load(b, p, stride, y);
        mul_acc(x, y, w);
      }
      redc_to(w, r, 2, M);
    }
    if (q == 0) {
      DT_UNROLL
      for (int v = 0; v < N_WORDS; v++) lo[v] = r[v];
    } else if (q == 1) {
      DT_UNROLL
      for (int v = 0; v < N_WORDS; v++) hi[v] = r[v];
    } else {                              // 2 c_k: + in slot j+6, - in j
      add_mod(r, r, r, M);
      add_mod(hi, r, hi, M);
      sub_mod(lo, r, lo, M);
      if (q == 3) sub_mod(lo, r, lo, M);  // c_(j+18): -4 in slot j
    }
  }
}

// x <- x + w r mod m for a weight w in -2..2; x, r canonical.
DT_HD void add_times(uint64_t *x, const uint64_t *r, int w, const Mod &M) {
  if (w == 0) return;
  uint64_t v[N_WORDS];
  if (w == 2 || w == -2) {
    add_mod(r, r, v, M);
  } else {
    DT_UNROLL
    for (int i = 0; i < N_WORDS; i++) v[i] = r[i];
  }
  if (w > 0)
    add_mod(x, v, x, M);
  else
    sub_mod(x, v, x, M);
}

// B13 dense through one Karatsuba level on the w^6 split: a = a0 + a1 v,
// b = b0 + b1 v (v = w^6, v^2 = 2v - 2, a0 = a_0..a_5, a1 = a_6..a_11),
// P0 = a0 b0, P1 = a1 b1, Mid = (a0 + a1)(b0 + b1), each a product of two
// 6-coefficient halves with coefficients t = 0..10 (index 11 and above
// zero).  Then a b = (P0 - 2 P1) + (Mid - P0 + P1) v, and w^12 = 2w^6 - 2
// once more gives output slots j and j + 6 (0 <= j < 6):
//
//   slot j     = P0_j - 2 P1_j + 2 P0_(j+6) - 2 P1_(j+6) - 2 Mid_(j+6)
//   slot j + 6 = -P0_j + P1_j + Mid_j - P0_(j+6) + 2 Mid_(j+6)
//
// 108 word products a row where the schoolbook product takes 144, and 33
// REDCs where it takes 23: 41,400 multiply-adds against 48,648, 15% fewer
// (13.5% on a thread's path).  Thread j takes the
// six coefficients t = j, j + 6 of P0, P1 and Mid, 18 products (j + 1
// for t = j, 5 - j for t = j + 6), in three phases with a barrier between
// them: flat_kara_phase(0) the four of P0 and P1 from a and b,
// flat_kara_sums the half sums a_j + a_(j+6), b_j + b_(j+6) into
// elements j of a and b (add_mod: canonical, so every half-coefficient
// stays below 6 m^2), flat_kara_phase(1) the two of Mid from them.  Each
// coefficient is reduced on its own (below 6 m^2, so below 2m after REDC,
// made canonical) and folded into lo and hi (0 before phase 0) with its
// weights; every value is canonical, so lo and hi equal the schoolbook
// product's bit for bit.
DT_HD void flat_kara_phase(int phase, int j, const uint64_t *a,
                           const uint64_t *b, int stride, uint64_t *lo,
                           uint64_t *hi, const Mod &M) {
  DT_NO_UNROLL
  for (int task = 0; task < (phase ? 2 : 4); task++) {
    // (the half of a and b, t, the weights in slot j and in slot j + 6)
    const int half = phase ? 0 : task & 1;
    const int t = j + (phase ? 6 * task : 6 * (task >> 1));
    if (t > 10) continue;                 // no such coefficient
    const int w_lo = phase ? (task ? -2 : 0) : task & 1 ? -2 : task ? 2 : 1;
    const int w_hi = phase ? (task ? 2 : 1)
                     : task == 3 ? 0 : task == 1 ? 1 : -1;
    uint64_t w[W_WORDS], r[N_WORDS];
    zero_wide(w);
    DT_NO_UNROLL
    for (int i = t < 6 ? 0 : t - 5; i <= (t < 6 ? t : 5); i++) {
      uint64_t x[N_WORDS], y[N_WORDS];
      flat_load(a, 6 * half + i, stride, x);
      flat_load(b, 6 * half + t - i, stride, y);
      mul_acc(x, y, w);
    }
    redc_to(w, r, 2, M);
    add_times(lo, r, w_lo, M);
    add_times(hi, r, w_hi, M);
  }
}

// Between the phases: element j of a and b becomes the half sum.
DT_HD void flat_kara_sums(int j, uint64_t *a, uint64_t *b, int stride,
                          const Mod &M) {
  uint64_t x[N_WORDS], y[N_WORDS];
  flat_load(a, j, stride, x);
  flat_load(a, j + 6, stride, y);
  add_mod(x, y, x, M);
  flat_store(x, a, j, stride);
  flat_load(b, j, stride, x);
  flat_load(b, j + 6, stride, y);
  add_mod(x, y, x, M);
  flat_store(x, b, j, stride);
}

// B17, one thread's share of the flat Fp12 square a^2, slot-symmetric:
// c_k = 2 sum_{i < k-i} a_i a_(k-i) + a_(k/2)^2 (the last for even k),
// the off-diagonal products summed once and doubled, the diagonal one a
// triangular square -- 66 general and 12 triangular products over the
// six classes where the product takes 144 general ones.  c_k is the
// product's coefficient, below 12 m^2, reduced and recombined as in
// flat_mul_slots, so the square equals the product a * a bit for bit.
DT_HD void flat_sqr_class(int j, const uint64_t *a, int stride, uint64_t *lo,
                          uint64_t *hi, const Mod &M) {
  uint64_t r[4][N_WORDS];
  DT_UNROLL
  for (int q = 0; q < 4; q++) {
    const int k = j + 6 * q;
    if (k > 2 * (FLAT - 1)) {             // no such coefficient
      DT_UNROLL
      for (int v = 0; v < N_WORDS; v++) r[q][v] = 0;
      continue;
    }
    uint64_t w[W_WORDS];
    zero_wide(w);
    for (int i = k > FLAT - 1 ? k - (FLAT - 1) : 0; 2 * i < k; i++) {
      uint64_t x[N_WORDS], y[N_WORDS];
      flat_load(a, i, stride, x);
      flat_load(a, k - i, stride, y);
      mul_acc(x, y, w);
    }
    // at most 6 products, < 6 m^2 < 2^766: the doubling stays in 13 words
    DT_UNROLL
    for (int i = W_WORDS - 1; i > 0; i--)
      w[i] = (w[i] << 1) | (w[i - 1] >> 63);
    w[0] <<= 1;
    if (k % 2 == 0) {
      uint64_t x[N_WORDS], d[W_WORDS];
      flat_load(a, k / 2, stride, x);
      sqr_wide(x, d);
      uint64_t c = 0;
      DT_UNROLL
      for (int i = 0; i < W_WORDS; i++) {
        const uint64_t s = w[i] + d[i];
        const uint64_t c1 = s < d[i];
        w[i] = s + c;
        c = c1 | (w[i] < s);
      }
    }
    redc_to(w, r[q], 2, M);
  }
  flat_recombine(r, lo, hi, M);
}

// K17's class loop: flat_sqr_class's coefficients c_k, k = j + 6q, each
// reduced on its own and folded straight into output elements j and j + 6
// of o (flat_load's layout, the same stride as a) with flat_mul_slots's
// weights, so lo and hi live in shared memory, not in registers, while
// the products run.  Both loops are kept rolled: one product body, one
// triangular square and one REDC in the code.  c_k is below 12 m^2 and
// every fold a modular add or subtract of canonical values, so o gets
// flat_sqr_class's lo and hi bit for bit.  o must not alias a.
DT_HD void flat_sqr_slots(int j, const uint64_t *a, uint64_t *o, int stride,
                          const Mod &M) {
  DT_NO_UNROLL
  for (int q = 0; q < 4; q++) {
    const int k = j + 6 * q;
    uint64_t r[N_WORDS] = {0, 0, 0, 0, 0, 0};
    if (k <= 2 * (FLAT - 1)) {
      uint64_t w[W_WORDS];
      zero_wide(w);
      DT_NO_UNROLL
      for (int i = k > FLAT - 1 ? k - (FLAT - 1) : 0; 2 * i < k; i++) {
        uint64_t x[N_WORDS], y[N_WORDS];
        flat_load(a, i, stride, x);
        flat_load(a, k - i, stride, y);
        mul_acc(x, y, w);
      }
      // at most 6 products, < 6 m^2 < 2^766: the doubling stays in 13 words
      DT_UNROLL
      for (int i = W_WORDS - 1; i > 0; i--)
        w[i] = (w[i] << 1) | (w[i - 1] >> 63);
      w[0] <<= 1;
      if (k % 2 == 0) {
        uint64_t x[N_WORDS], d[W_WORDS];
        flat_load(a, k / 2, stride, x);
        sqr_wide(x, d);
        uint64_t c = 0;
        DT_UNROLL
        for (int i = 0; i < W_WORDS; i++) {
          const uint64_t s = w[i] + d[i];
          const uint64_t c1 = s < d[i];
          w[i] = s + c;
          c = c1 | (w[i] < s);
        }
      }
      redc_to(w, r, 2, M);
    }
    if (q < 2) {                          // c_j to slot j, c_(j+6) to j + 6
      flat_store(r, o, j + 6 * q, stride);
    } else {                              // 2 c_k: + in slot j+6, - in j
      uint64_t lo[N_WORDS], hi[N_WORDS];
      flat_load(o, j, stride, lo);
      flat_load(o, j + 6, stride, hi);
      add_mod(r, r, r, M);
      add_mod(hi, r, hi, M);
      sub_mod(lo, r, lo, M);
      if (q == 3) sub_mod(lo, r, lo, M);  // c_(j+18): -4 in slot j
      flat_store(lo, o, j, stride);
      flat_store(hi, o, j + 6, stride);
    }
  }
}

// B20, one thread's share of the product L = l1 l2 of two sparse lines,
// each six coefficients on LINE_IDX: the 36 products grouped by their
// power k = p_i + p_j in 0..18 (at most four a power, so below 4 m^2),
// each power reduced on its own, then output slots j and j + 6 of the
// dense element through flat_recombine -- the scatter of drand_tpu's
// _line_merge_tables: k < 12 -> (k, +1); 12 <= k < 18 -> (k - 6, +2),
// (k - 12, -2); k = 18 -> (6, +2), (0, -4).
DT_HD void line_merge_class(int j, const uint64_t *l1, const uint64_t *l2,
                            int stride, uint64_t *lo, uint64_t *hi,
                            const Mod &M) {
  uint64_t r[4][N_WORDS];
  DT_UNROLL
  for (int q = 0; q < 4; q++) {
    const int k = j + 6 * q;
    uint64_t w[W_WORDS];
    zero_wide(w);
    bool any = false;
    DT_UNROLL
    for (int i = 0; i < 6; i++) {
      DT_UNROLL
      for (int jj = 0; jj < 6; jj++) {
        if (line_pow(i) + line_pow(jj) != k) continue;
        uint64_t x[N_WORDS], y[N_WORDS];
        flat_load(l1, i, stride, x);
        flat_load(l2, jj, stride, y);
        mul_acc(x, y, w);
        any = true;
      }
    }
    if (any) {
      redc_to(w, r[q], 2, M);
    } else {                              // powers 1, 7, 13 and above 18
      DT_UNROLL
      for (int v = 0; v < N_WORDS; v++) r[q][v] = 0;
    }
  }
  flat_recombine(r, lo, hi, M);
}

// B14 in chain form: k Granger-Scott cyclotomic squares of a flat Fp12
// row (the function of ops/flat12.py _flat_cyclo_sqr_plain applied k
// times, for any canonical input; it equals the square only on unitary
// ones), split into shares that the threads of a row run between
// barriers (K14).  Between squares the row stays in its six tower cells,
// cell s (the cell at flat slot s) with x at element s and y at element
// s + 6 of a buffer in flat_load's layout: cell s is x = lo + hi, y = hi
// of the flat coefficients lo at s and hi at s + 6, and lo = x - y gives
// them back.  Every value is canonical, so x - y + y = x: k squares in
// cell form equal k flat squares bit for bit.

// Flat coefficients -> cell s, in place (one share per slot s < 6).
DT_HD void cyclo_to_cell(int s, uint64_t *a, int stride, const Mod &M) {
  uint64_t lo[N_WORDS], hi[N_WORDS];
  flat_load(a, s, stride, lo);
  flat_load(a, s + 6, stride, hi);
  add_mod(lo, hi, lo, M);
  flat_store(lo, a, s, stride);
}

// Cell s -> flat coefficients, in place.
DT_HD void cyclo_to_flat(int s, uint64_t *a, int stride, const Mod &M) {
  uint64_t x[N_WORDS], y[N_WORDS];
  flat_load(a, s, stride, x);
  flat_load(a, s + 6, stride, y);
  sub_mod(x, y, x, M);
  flat_store(x, a, s, stride);
}

// The Fp4 groups A, B, C (g = 0, 1, 2) square the cells at slots g and
// g + 3.  Share q (0..8) of the squaring phase: of group g = q / 3, the
// Fp2 square a^2 (q % 3 == 0, a = cell g), b^2 (1, b = cell g + 3) or
// (a + b)^2 (2), into elements 2q (x) and 2q + 1 (y) of sq.
DT_HD void cyclo_sqr_square(int q, const uint64_t *cells, uint64_t *sq,
                            int stride, const Mod &M) {
  const int g = q / 3, kind = q % 3, s = kind == 1 ? g + 3 : g;
  uint64_t x0[N_WORDS], x1[N_WORDS], r0[N_WORDS], r1[N_WORDS];
  flat_load(cells, s, stride, x0);
  flat_load(cells, s + 6, stride, x1);
  if (kind == 2) {
    uint64_t y0[N_WORDS], y1[N_WORDS];
    flat_load(cells, g + 3, stride, y0);
    flat_load(cells, g + 9, stride, y1);
    add_mod(x0, y0, x0, M);
    add_mod(x1, y1, x1, M);
  }
  fp2_sqr_words(x0, x1, r0, r1, M);
  flat_store(r0, sq, 2 * q, stride);
  flat_store(r1, sq, 2 * q + 1, stride);
}

// Share o (0..5) of the folding phase, in place: group g = o / 2, with
//
//   re = a^2 + xi b^2, im = (a + b)^2 - a^2 - b^2      (xi = 1 + u)
//
// writes slot 2g as 3 re - 2 (cell there) when o is even, and slot
// (2g + 3) mod 6 as 3 t + 2 (cell there) when o is odd, t = im, or xi im
// for group C.  The six shares write six distinct slots and each reads
// only the cell it writes.
DT_HD void cyclo_sqr_fold(int o, uint64_t *cells, const uint64_t *sq,
                          int stride, const Mod &M) {
  const int g = o / 2;
  uint64_t ax[N_WORDS], ay[N_WORDS], bx[N_WORDS], by[N_WORDS];
  uint64_t tx[N_WORDS], ty[N_WORDS], cx[N_WORDS], cy[N_WORDS];
  flat_load(sq, 6 * g, stride, ax);
  flat_load(sq, 6 * g + 1, stride, ay);
  flat_load(sq, 6 * g + 2, stride, bx);
  flat_load(sq, 6 * g + 3, stride, by);
  const bool even = o % 2 == 0;
  const int s = even ? 2 * g : (2 * g + 3) % 6;
  if (even) {                             // t = re, xi b^2 = (bx - by, bx + by)
    sub_mod(bx, by, tx, M);
    add_mod(bx, by, ty, M);
    add_mod(ax, tx, tx, M);
    add_mod(ay, ty, ty, M);
  } else {                                // t = im (xi im for C)
    flat_load(sq, 6 * g + 4, stride, tx);
    flat_load(sq, 6 * g + 5, stride, ty);
    sub_mod(tx, ax, tx, M);
    sub_mod(ty, ay, ty, M);
    sub_mod(tx, bx, tx, M);
    sub_mod(ty, by, ty, M);
    if (g == 2) {
      sub_mod(tx, ty, ax, M);
      add_mod(tx, ty, ty, M);
      DT_UNROLL
      for (int v = 0; v < N_WORDS; v++) tx[v] = ax[v];
    }
  }
  flat_load(cells, s, stride, cx);
  flat_load(cells, s + 6, stride, cy);
  // even: 3t - 2c = 2(t - c) + t; odd: 3t + 2c = 2(t + c) + t
  if (even) {
    sub_mod(tx, cx, cx, M);
    sub_mod(ty, cy, cy, M);
  } else {
    add_mod(tx, cx, cx, M);
    add_mod(ty, cy, cy, M);
  }
  add_mod(cx, cx, cx, M);
  add_mod(cy, cy, cy, M);
  add_mod(cx, tx, cx, M);
  add_mod(cy, ty, cy, M);
  flat_store(cx, cells, s, stride);
  flat_store(cy, cells, s + 6, stride);
}

// One share of a flat product a * l by a sparse line l on LINE_IDX (its
// six coefficients at the powers line_pow(0..5)): the function of
// flat_mul_slots on flat_idx(LINE_IDX, 6), every product inlined (K11,
// K12).  A power
// k sums at most six products (below 6 m^2) and k > 20 has none; each is
// reduced and recombined as in flat_mul_slots, so the two agree bit for
// bit.
DT_HD void flat_mul_line_class(int j, const uint64_t *a, const uint64_t *l,
                               int stride, uint64_t *lo, uint64_t *hi,
                               const Mod &M) {
  uint64_t r[4][N_WORDS];
  DT_UNROLL
  for (int q = 0; q < 4; q++) {
    const int k = j + 6 * q;
    if (k > FLAT - 1 + 9) {               // above the top power 11 + 9
      DT_UNROLL
      for (int v = 0; v < N_WORDS; v++) r[q][v] = 0;
      continue;
    }
    uint64_t w[W_WORDS];
    zero_wide(w);
    DT_UNROLL
    for (int m = 0; m < 6; m++) {
      const int i = k - line_pow(m);
      if (i < 0 || i >= FLAT) continue;
      uint64_t x[N_WORDS], y[N_WORDS];
      flat_load(a, i, stride, x);
      flat_load(l, m, stride, y);
      mul_acc(x, y, w);
    }
    redc_to(w, r[q], 2, M);
  }
  flat_recombine(r, lo, hi, M);
}


// ---------------------------------------------------------------------------
// Fp2 as a value type: the Fp2 chain steps (B7, B8), the G2 point kernels
// and the Miller iterations (curve_arith.cuh) are written over it.
// ---------------------------------------------------------------------------

struct F2 {
  uint64_t x[N_WORDS], y[N_WORDS];        // x + y*u
};

DT_HD F2 f2_mul(const F2 &a, const F2 &b, const Mod &M) {
  F2 r;
  fp2_mul_words(a.x, a.y, b.x, b.y, r.x, r.y, M);
  return r;
}

DT_HD F2 f2_sqr(const F2 &a, const Mod &M) {
  F2 r;
  fp2_sqr_words(a.x, a.y, r.x, r.y, M);
  return r;
}

DT_HD F2 f2_add(const F2 &a, const F2 &b, const Mod &M) {
  F2 r;
  add_mod(a.x, b.x, r.x, M);
  add_mod(a.y, b.y, r.y, M);
  return r;
}

DT_HD F2 f2_sub(const F2 &a, const F2 &b, const Mod &M) {
  F2 r;
  sub_mod(a.x, b.x, r.x, M);
  sub_mod(a.y, b.y, r.y, M);
  return r;
}

DT_HD F2 f2_dbl(const F2 &a, const Mod &M) { return f2_add(a, a, M); }

DT_HD F2 f2_zero() {
  F2 r;
  DT_UNROLL
  for (int v = 0; v < N_WORDS; v++) r.x[v] = r.y[v] = 0;
  return r;
}

// -a mod m, with -0 = 0 (the function of Field.neg).
DT_HD F2 f2_neg(const F2 &a, const Mod &M) { return f2_sub(f2_zero(), a, M); }

// (a.x s, a.y s) * 2^-384: an Fp2 element times an Fp scalar.
DT_HD F2 f2_mul_fp(const F2 &a, const uint64_t *s, const Mod &M) {
  F2 r;
  mont_mul_words(a.x, s, r.x, M);
  mont_mul_words(a.y, s, r.y, M);
  return r;
}

DT_HD bool fp_eq(const uint64_t *a, const uint64_t *b) {
  bool e = true;
  DT_UNROLL
  for (int v = 0; v < N_WORDS; v++) e = e && (a[v] == b[v]);
  return e;
}

DT_HD bool f2_eq(const F2 &a, const F2 &b) {
  return fp_eq(a.x, b.x) && fp_eq(a.y, b.y);
}

DT_HD bool f2_is_zero(const F2 &a) { return f2_eq(a, f2_zero()); }

DT_HD F2 f2_select(bool c, const F2 &a, const F2 &b) {
  F2 r;
  DT_UNROLL
  for (int v = 0; v < N_WORDS; v++) {
    r.x[v] = c ? a.x[v] : b.x[v];
    r.y[v] = c ? a.y[v] : b.y[v];
  }
  return r;
}

DT_HD F2 f2_load(const int32_t *c0, const int32_t *c1) {
  F2 r;
  load_words(c0, r.x);
  load_words(c1, r.y);
  return r;
}

DT_HD void f2_store(const F2 &a, int32_t *c0, int32_t *c1) {
  store_words(a.x, c0);
  store_words(a.y, c1);
}

// B7 (B8 at k = 5), x^(2^k) * t or x^(2^k) in Fp2, over the two threads
// (lanes) of a row: lane h owns half h of the running value (x for
// h = 0, y for h = 1).  Half h of the square of a + b u is one Montgomery
// product whose operands h picks,
//
//   h = 0: (a + b)(a - b) = a^2 - b^2,   h = 1: a (2b) = 2ab,
//
// so both lanes of a row run the same mont_mul_words and do not diverge;
// half h of the product with t is fp2_half (below).  Each half is the
// unique canonical residue of its quantity, so k squares and the product
// give f2_sqr k times and f2_mul bit for bit.  r must not alias the
// operands.  fp2_sqr_operands picks the two operands (canonical).
DT_HD void fp2_sqr_operands(int h, const uint64_t *a, const uint64_t *b,
                            uint64_t *s, uint64_t *d, const Mod &M) {
  uint64_t b2[N_WORDS];
  add_mod(a, b, s, M);
  sub_mod(a, b, d, M);
  add_mod(b, b, b2, M);
  DT_UNROLL
  for (int v = 0; v < N_WORDS; v++) {
    s[v] = h ? a[v] : s[v];
    d[v] = h ? b2[v] : d[v];
  }
}

DT_HD void fp2_sqr_lane(int h, const uint64_t *a, const uint64_t *b,
                        uint64_t *r, const Mod &M) {
  uint64_t s[N_WORDS], d[N_WORDS];
  fp2_sqr_operands(h, a, b, s, d, M);
  mont_mul_words(s, d, r, M);
}

// B6's half h (K6) as fp2_sqr_lane's, its product the 32-bit carry-chain
// CIOS of field_arith32.cuh (mont_mul32).  Both operands come out of
// add_mod / sub_mod canonical, which mont_mul32 needs of its
// multiplicand; the result is the same canonical residue.
DT_HD void fp2_sqr_lane32(int h, const uint64_t *a, const uint64_t *b,
                          uint64_t *r, const Mod &M, const Mod32 &M32) {
  uint64_t s[N_WORDS], d[N_WORDS];
  uint32_t x[N_WORDS32], y[N_WORDS32];
  fp2_sqr_operands(h, a, b, s, d, M);
  words_to_words32(s, x);
  words_to_words32(d, y);
  mont_mul32(x, y, x, M32);
  words32_to_words(x, r);
}

// Half h of the Fp2 product a b: h = 0: a.x b.x - a.y b.y, h = 1: a.x b.y
// + a.y b.x, each one REDC of a wide sum: fp2_mul_re and fp2_mul_im in
// one body, the operands picked by h, so the threads that call it with
// either h share its code (K7's two lanes, every half-product of K10).
DT_HD void fp2_half(int h, const F2 &a, const F2 &b, uint64_t *r,
                    const Mod &M) {
  uint64_t c0[N_WORDS], c1[N_WORDS], t[W_WORDS], u[W_WORDS];
  DT_UNROLL
  for (int v = 0; v < N_WORDS; v++) {
    c0[v] = h ? b.y[v] : b.x[v];
    c1[v] = h ? b.x[v] : b.y[v];
  }
  zero_wide(t);
  mul_acc(a.x, c0, t);
  zero_wide(u);
  mul_acc(a.y, c1, u);
  if (h) {                                // t + u < 2 m^2
    uint64_t carry = 0;
    DT_UNROLL
    for (int i = 0; i < W_WORDS; i++) {
      const uint64_t s = t[i] + u[i];
      const uint64_t over = s < t[i];
      t[i] = s + carry;
      carry = over | (t[i] < s);
    }
  } else {
    wide_sub(t, u, M);                    // [0, m 2^384)
  }
  redc_to(t, r, 1, M);
}

// ---------------------------------------------------------------------------
// Flat Fp12 conjugation (B15) in limbs, a 16-byte chunk a lane
// ---------------------------------------------------------------------------
//
// f^(p^6) negates the odd w-powers.  Eight lanes hold a coefficient, lane
// j = lane % 8 its chunk j (limbs 4j..4j+3), and p - a is taken limb by
// limb: lane j subtracts its limbs from p's with the borrow from the
// chunks below it.  Chunk k generates a borrow when its limbs are above
// p's (g_k: a borrow out with none in) and passes one on when they equal
// p's (t_k), so the borrow into chunk j is set when some g_k t_(k+1) ...
// t_(j-1) is, for k < j: a carry lookahead, read off the warp's masks of
// g and t (one bit a lane, __ballot_sync on the card, built lane by lane
// in field_host.cpp).  a = 0 gives 0, not p, as sub_mod(0, a) and
// drand_tpu's _neg_rows do.

// Limbs 4j..4j+3 of m.
DT_HD void conj_p_chunk(int j, const Mod &M, int32_t *pl) {
  DT_UNROLL
  for (int k = 0; k < 8; k++) {
    DT_UNROLL
    for (int i = 0; i < 4; i++) {
      const int bit = 12 * (4 * k + i), w = bit / 64, off = bit % 64;
      uint64_t v = M.m[w] >> off;
      if (off > 52) v |= M.m[w + 1] << (64 - off);
      if (k == j) pl[i] = (int32_t)(v & 0xFFF);
    }
  }
}

// A chunk's flags against p's chunk pl: it generates a borrow, passes one
// on, is zero.
DT_HD void conj_flags(const int32_t *x, const int32_t *pl, bool &gen,
                      bool &pass, bool &zero) {
  int b = 0;
  bool eq = true, z = true;
  DT_UNROLL
  for (int i = 0; i < 4; i++) {
    b = pl[i] - x[i] - b < 0;
    eq = eq && x[i] == pl[i];
    z = z && x[i] == 0;
  }
  gen = b;
  pass = eq;
  zero = z;
}

// The borrow into `lane`'s chunk, from the warp's masks of generated and
// passed-on borrows (bit L for lane L): the carry into bit `lane` of
// (gen | pass) + gen, with the top lane of every 8-lane group masked off
// so that no borrow crosses into the next coefficient.
DT_HD int conj_borrow_in(int lane, uint32_t gen, uint32_t pass) {
  const uint32_t keep = 0x7F7F7F7Fu;
  const uint32_t x = (gen | pass) & keep, y = gen & keep;
  return (int)(((x + y) ^ x ^ y) >> lane) & 1;
}

// `lane`'s chunk o of f^(p^6) from its chunk x: for an odd coefficient,
// p - a with the borrow in, or 0 where all eight chunks of the
// coefficient are zero (`zero`: the warp's mask of zero chunks); an even
// one unchanged.  Limbs in [0, 4096).
DT_HD void conj_chunk(int lane, bool odd, const int32_t *x,
                      const int32_t *pl, uint32_t gen, uint32_t pass,
                      uint32_t zero, int32_t *o) {
  int b = conj_borrow_in(lane, gen, pass);
  const bool nonzero = ((zero >> (lane & 24)) & 0xFFu) != 0xFFu;
  DT_UNROLL
  for (int i = 0; i < 4; i++) {
    const int d = pl[i] - x[i] - b;
    b = d < 0;
    o[i] = odd ? (nonzero ? d + (b << 12) : 0) : x[i];
  }
}

// ---------------------------------------------------------------------------
// Flat Fp12 Frobenius (B16), one output coefficient of a slot pair
// ---------------------------------------------------------------------------
//
// f^(p^n) maps each slot pair (c_s, c_(s+6)) by a 2x2 matrix of Montgomery
// constants (ops/flat12.py _frob_consts): A c_s + B c_(s+6) to slot s, C
// c_s + D c_(s+6) to slot s + 6.  Many of the 24 constants are 0, one
// (R mod m) or minus one (m - (R mod m)); a term by such a constant needs
// no product (Montgomery multiplication by one returns a canonical value
// unchanged, by minus one its negation).  The class of each constant is
// found once a launch from its words (frob_from_words), so no table of
// classes is written down for any n.

enum FrobClass : int32_t { FROB_ZERO = 0, FROB_ONE = 1, FROB_NEG = 2,
                           FROB_MUL = 3 };

// c[s] = {A, B, C, D} of slot s as 32-bit words (mont_mul32's
// multiplicand), and cls[s] their classes.
struct FrobConsts {
  uint32_t c[6][4][N_WORDS32];
  int32_t cls[6][4];
};

// From the C entry point's 6 x 4 x 6 words: the constants, and each one's
// class against 0, one = 2^384 mod m (384 doublings of 1) and m - one.
inline FrobConsts frob_from_words(const uint64_t *w, const Mod &M) {
  uint64_t zero[N_WORDS] = {0, 0, 0, 0, 0, 0};
  uint64_t one[N_WORDS] = {1, 0, 0, 0, 0, 0}, neg[N_WORDS];
  for (int i = 0; i < 384; i++) add_mod(one, one, one, M);
  sub_mod(zero, one, neg, M);
  FrobConsts F;
  for (int s = 0; s < 6; s++)
    for (int q = 0; q < 4; q++) {
      const uint64_t *c = w + (s * 4 + q) * N_WORDS;
      F.cls[s][q] = fp_eq(c, zero)  ? FROB_ZERO
                    : fp_eq(c, one) ? FROB_ONE
                    : fp_eq(c, neg) ? FROB_NEG
                                    : FROB_MUL;
      words_to_words32(c, F.c[s][q]);
    }
  return F;
}

// r = x times the constant c of class cls, canonical: 0, x, 0 - x
// (sub_mod, so 0 stays 0), or the 32-bit carry-chain Montgomery product
// with c as the canonical multiplicand.  Each is the canonical residue the
// plain version's Montgomery product gives.
DT_HD void frob_term(int cls, const uint32_t *c, const uint64_t *x,
                     uint64_t *r, const Mod &M, const Mod32 &M32) {
  if (cls == FROB_MUL) {
    uint32_t y[N_WORDS32];
    words_to_words32(x, y);
    mont_mul32(c, y, y, M32);
    words32_to_words(y, r);
  } else if (cls == FROB_NEG) {
    const uint64_t zero[N_WORDS] = {0, 0, 0, 0, 0, 0};
    sub_mod(zero, x, r, M);
  } else {
    DT_UNROLL
    for (int v = 0; v < N_WORDS; v++) r[v] = cls == FROB_ONE ? x[v] : 0;
  }
}

// Coefficient s + 6 o of f^(p^n) (o = 0: A c_s + B c_(s+6); o = 1: C c_s
// + D c_(s+6)) from a's slots s and s + 6 in flat_load's layout: the two
// terms in one rolled loop (one product body), summed from 0 by add_mod
// as the plain version sums its two products.
DT_HD void flat_frob_out(int s, int o, const uint64_t *a, int stride,
                         const FrobConsts &F, uint64_t *r, const Mod &M,
                         const Mod32 &M32) {
  DT_UNROLL
  for (int v = 0; v < N_WORDS; v++) r[v] = 0;
  DT_NO_UNROLL
  for (int t = 0; t < 2; t++) {
    uint64_t x[N_WORDS], y[N_WORDS];
    flat_load(a, s + 6 * t, stride, x);
    frob_term(F.cls[s][2 * o + t], F.c[s][2 * o + t], x, y, M, M32);
    add_mod(r, y, r, M);
  }
}

}  // namespace dt
