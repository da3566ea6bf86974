// Montgomery arithmetic on twelve 32-bit words with the carry flag, for
// the Fp kernels K1, K2 and K4 (field_kernels.cu), K6's product
// (tower_kernels.cu through tower_arith.cuh) and their host harness
// (field_host.cpp).  The other kernels keep field_arith.cuh's 64-bit words.
//
// A value is 12 little-endian 32-bit words, the Montgomery radix 2^384 as
// in field_arith.cuh, so Montgomery form is the same number in both and
// every output is canonical.
//
// The product is CIOS (one REDC step per word of b) with the running sum
// kept as two 12-word arrays: P (words at columns 0..11) and S (words at
// columns 1..12).  a * b_i splits into the products of a's even words,
// whose low and high halves land on disjoint column pairs of P, and those
// of a's odd words on S, so each array takes its share as one carry chain
// (mad.lo.cc / madc.hi.cc), and the two chains of a step are independent:
// instruction-level parallelism for a thread that has its scheduler
// mostly to itself.  The REDC quotient's multiple of m splits the same
// way.  Dividing by 2^32 after a step swaps the arrays' roles: the new P
// is the old S plus P's word 1, the new S the old P two words down
// (add_shift_pairs does both while it adds the next step's odd products).
//
// Bounds: with a < m < 2^381 the running sum stays below 2m after each
// step (standard CIOS: it grows by at most (a + m) (2^32 - 1) before each
// division by 2^32, whatever b's words), so it stays below 2^32 * 2m <
// 2^414 before the division, and S (at most that over 2^32) below 2^383:
// no chain on S ever carries out of its 12 words, and the chains on P
// carry into S's top word.  b may be any 384-bit value: the result,
// below a b / 2^384 + m < 2m, takes one conditional subtract to be
// canonical.  So the multiplicand a must be canonical and the multiplier
// b need not be (K1's first operand, reduce_wide's halves of a wide
// value, goes in as b).
//
// The square (K4's) is triangular: the 66 off-diagonal products in rows
// of decreasing length (one chain template a length), doubled, plus the
// 12 squares, into 24 words, then REDC by the same P/S steps with no
// products of b.
//
// On the card each carry chain is one asm statement: nvcc does not promise
// to keep the carry flag between statements.  The host build runs the
// same instructions one by one on an emulated carry flag, so the harness
// checks this word schedule bit for bit.
#pragma once

#include <stdint.h>

#include "field_arith.cuh"

namespace dt {

constexpr int N_WORDS32 = 12;

// The modulus as 32-bit words, its even and odd words apart (the REDC
// chains' operands), and -m^-1 mod 2^32.
struct Mod32 {
  uint32_t m[N_WORDS32];
  uint32_t me[N_WORDS32 / 2], mo[N_WORDS32 / 2];
  uint32_t n0;
};

inline Mod32 mod32_from_words(const uint64_t *mod7) {
  Mod32 M;
  for (int i = 0; i < N_WORDS; i++) {
    M.m[2 * i] = (uint32_t)mod7[i];
    M.m[2 * i + 1] = (uint32_t)(mod7[i] >> 32);
  }
  for (int j = 0; j < N_WORDS32 / 2; j++) {
    M.me[j] = M.m[2 * j];
    M.mo[j] = M.m[2 * j + 1];
  }
  M.n0 = (uint32_t)mod7[N_WORDS];     // -m^-1 mod 2^64, reduced mod 2^32
  return M;
}

DT_HD uint32_t mulhi32(uint32_t a, uint32_t b) {
#if defined(__CUDA_ARCH__)
  return __umulhi(a, b);
#else
  return (uint32_t)(((uint64_t)a * b) >> 32);
#endif
}

DT_HD void words_to_words32(const uint64_t *w, uint32_t *x) {
  DT_UNROLL
  for (int i = 0; i < N_WORDS; i++) {
    x[2 * i] = (uint32_t)w[i];
    x[2 * i + 1] = (uint32_t)(w[i] >> 32);
  }
}

DT_HD void words32_to_words(const uint32_t *x, uint64_t *w) {
  DT_UNROLL
  for (int i = 0; i < N_WORDS; i++)
    w[i] = (uint64_t)x[2 * i] | (uint64_t)x[2 * i + 1] << 32;
}

// One element's 32 limbs <-> 12 words (load_words/store_words of
// field_arith.cuh: 16-byte accesses on the card).
DT_HD void load_words32(const int32_t *src, uint32_t *x) {
  uint64_t w[N_WORDS];
  load_words(src, w);
  words_to_words32(w, x);
}

DT_HD void store_words32(const uint32_t *x, int32_t *dst) {
  uint64_t w[N_WORDS];
  words32_to_words(x, w);
  store_words(w, dst);
}

#if !defined(__CUDA_ARCH__)
// The host's carry flag and the PTX instructions the chains use.
struct Carry {
  uint32_t cf = 0;
  uint32_t add(uint32_t a, uint32_t b, bool in, bool out) {
    const uint64_t v = (uint64_t)a + b + (in ? cf : 0);
    if (out) cf = (uint32_t)(v >> 32);
    return (uint32_t)v;
  }
  uint32_t sub(uint32_t a, uint32_t b, bool in, bool out) {
    const uint64_t v = (uint64_t)a - b - (in ? cf : 0);
    if (out) cf = (uint32_t)(v >> 63);
    return (uint32_t)v;
  }
  // mad{c}.{lo,hi}{.cc}.u32 d, a, b, c
  uint32_t mad(uint32_t a, uint32_t b, uint32_t c, bool hi, bool in,
               bool out) {
    const uint64_t p = (uint64_t)a * b;
    return add(hi ? (uint32_t)(p >> 32) : (uint32_t)p, c, in, out);
  }
};
#endif

// r[2j], r[2j+1] = lo, hi of x[j] * b: the products of one half of a's
// words as a 12-word number, no carries.
DT_HD void mul_pairs(uint32_t *r, const uint32_t *x, uint32_t b) {
  DT_UNROLL
  for (int j = 0; j < N_WORDS32 / 2; j++) {
    r[2 * j] = x[j] * b;
    r[2 * j + 1] = mulhi32(x[j], b);
  }
}

// r += sum_j x[j] * b * 2^(64j); the carry out of r's 12 words goes into
// top.
DT_HD void add_pairs_cc(uint32_t *r, const uint32_t *x, uint32_t b,
                        uint32_t &top) {
#if defined(__CUDA_ARCH__)
  asm("mad.lo.cc.u32 %0, %14, %13, %0;\n\t"
      "madc.hi.cc.u32 %1, %14, %13, %1;\n\t"
      "madc.lo.cc.u32 %2, %15, %13, %2;\n\t"
      "madc.hi.cc.u32 %3, %15, %13, %3;\n\t"
      "madc.lo.cc.u32 %4, %16, %13, %4;\n\t"
      "madc.hi.cc.u32 %5, %16, %13, %5;\n\t"
      "madc.lo.cc.u32 %6, %17, %13, %6;\n\t"
      "madc.hi.cc.u32 %7, %17, %13, %7;\n\t"
      "madc.lo.cc.u32 %8, %18, %13, %8;\n\t"
      "madc.hi.cc.u32 %9, %18, %13, %9;\n\t"
      "madc.lo.cc.u32 %10, %19, %13, %10;\n\t"
      "madc.hi.cc.u32 %11, %19, %13, %11;\n\t"
      "addc.u32 %12, %12, 0;"
      : "+r"(r[0]), "+r"(r[1]), "+r"(r[2]), "+r"(r[3]), "+r"(r[4]),
        "+r"(r[5]), "+r"(r[6]), "+r"(r[7]), "+r"(r[8]), "+r"(r[9]),
        "+r"(r[10]), "+r"(r[11]), "+r"(top)
      : "r"(b), "r"(x[0]), "r"(x[1]), "r"(x[2]), "r"(x[3]), "r"(x[4]),
        "r"(x[5]));
#else
  Carry c;
  for (int j = 0; j < N_WORDS32 / 2; j++) {
    r[2 * j] = c.mad(x[j], b, r[2 * j], false, j > 0, true);
    r[2 * j + 1] = c.mad(x[j], b, r[2 * j + 1], true, true, true);
  }
  top = c.add(top, 0, true, false);
#endif
}

// The same with no carry out of r (the caller's bound says there is none).
DT_HD void add_pairs(uint32_t *r, const uint32_t *x, uint32_t b) {
#if defined(__CUDA_ARCH__)
  asm("mad.lo.cc.u32 %0, %13, %12, %0;\n\t"
      "madc.hi.cc.u32 %1, %13, %12, %1;\n\t"
      "madc.lo.cc.u32 %2, %14, %12, %2;\n\t"
      "madc.hi.cc.u32 %3, %14, %12, %3;\n\t"
      "madc.lo.cc.u32 %4, %15, %12, %4;\n\t"
      "madc.hi.cc.u32 %5, %15, %12, %5;\n\t"
      "madc.lo.cc.u32 %6, %16, %12, %6;\n\t"
      "madc.hi.cc.u32 %7, %16, %12, %7;\n\t"
      "madc.lo.cc.u32 %8, %17, %12, %8;\n\t"
      "madc.hi.cc.u32 %9, %17, %12, %9;\n\t"
      "madc.lo.cc.u32 %10, %18, %12, %10;\n\t"
      "madc.hi.u32 %11, %18, %12, %11;"
      : "+r"(r[0]), "+r"(r[1]), "+r"(r[2]), "+r"(r[3]), "+r"(r[4]),
        "+r"(r[5]), "+r"(r[6]), "+r"(r[7]), "+r"(r[8]), "+r"(r[9]),
        "+r"(r[10]), "+r"(r[11])
      : "r"(b), "r"(x[0]), "r"(x[1]), "r"(x[2]), "r"(x[3]), "r"(x[4]),
        "r"(x[5]));
#else
  Carry c;
  for (int j = 0; j < N_WORDS32 / 2; j++) {
    r[2 * j] = c.mad(x[j], b, r[2 * j], false, j > 0, true);
    r[2 * j + 1] = c.mad(x[j], b, r[2 * j + 1], true, true, j < 5);
  }
#endif
}

// The division by 2^32 between two steps, with the next step's odd
// products: s0 += p[1] (the new P's word 0), and p becomes the new S,
// p[k] = p[k+2] + (x[j] * b halves) with the carry of s0 rippling in.
// No carry out (S's bound).
DT_HD void add_shift_pairs(uint32_t *p, uint32_t &s0, const uint32_t *x,
                           uint32_t b) {
#if defined(__CUDA_ARCH__)
  const uint32_t zero = 0;
  asm("add.cc.u32 %12, %12, %1;\n\t"
      "madc.lo.cc.u32 %0, %14, %13, %2;\n\t"
      "madc.hi.cc.u32 %1, %14, %13, %3;\n\t"
      "madc.lo.cc.u32 %2, %15, %13, %4;\n\t"
      "madc.hi.cc.u32 %3, %15, %13, %5;\n\t"
      "madc.lo.cc.u32 %4, %16, %13, %6;\n\t"
      "madc.hi.cc.u32 %5, %16, %13, %7;\n\t"
      "madc.lo.cc.u32 %6, %17, %13, %8;\n\t"
      "madc.hi.cc.u32 %7, %17, %13, %9;\n\t"
      "madc.lo.cc.u32 %8, %18, %13, %10;\n\t"
      "madc.hi.cc.u32 %9, %18, %13, %11;\n\t"
      "madc.lo.cc.u32 %10, %19, %13, %20;\n\t"
      "madc.hi.u32 %11, %19, %13, %20;"
      : "+r"(p[0]), "+r"(p[1]), "+r"(p[2]), "+r"(p[3]), "+r"(p[4]),
        "+r"(p[5]), "+r"(p[6]), "+r"(p[7]), "+r"(p[8]), "+r"(p[9]),
        "+r"(p[10]), "+r"(p[11]), "+r"(s0)
      : "r"(b), "r"(x[0]), "r"(x[1]), "r"(x[2]), "r"(x[3]), "r"(x[4]),
        "r"(x[5]), "r"(zero));
#else
  Carry c;
  s0 = c.add(s0, p[1], false, true);
  for (int j = 0; j < N_WORDS32 / 2; j++) {
    const uint32_t lo = j < 5 ? p[2 * j + 2] : 0;
    const uint32_t hi = j < 5 ? p[2 * j + 3] : 0;
    p[2 * j] = c.mad(x[j], b, lo, false, true, true);
    p[2 * j + 1] = c.mad(x[j], b, hi, true, true, j < 5);
  }
#endif
}

// s += p >> 32 (p[0] is 0): the final division.  No carry out.
DT_HD void add_shifted(uint32_t *s, const uint32_t *p) {
#if defined(__CUDA_ARCH__)
  asm("add.cc.u32 %0, %0, %12;\n\t"
      "addc.cc.u32 %1, %1, %13;\n\t"
      "addc.cc.u32 %2, %2, %14;\n\t"
      "addc.cc.u32 %3, %3, %15;\n\t"
      "addc.cc.u32 %4, %4, %16;\n\t"
      "addc.cc.u32 %5, %5, %17;\n\t"
      "addc.cc.u32 %6, %6, %18;\n\t"
      "addc.cc.u32 %7, %7, %19;\n\t"
      "addc.cc.u32 %8, %8, %20;\n\t"
      "addc.cc.u32 %9, %9, %21;\n\t"
      "addc.cc.u32 %10, %10, %22;\n\t"
      "addc.u32 %11, %11, 0;"
      : "+r"(s[0]), "+r"(s[1]), "+r"(s[2]), "+r"(s[3]), "+r"(s[4]),
        "+r"(s[5]), "+r"(s[6]), "+r"(s[7]), "+r"(s[8]), "+r"(s[9]),
        "+r"(s[10]), "+r"(s[11])
      : "r"(p[1]), "r"(p[2]), "r"(p[3]), "r"(p[4]), "r"(p[5]), "r"(p[6]),
        "r"(p[7]), "r"(p[8]), "r"(p[9]), "r"(p[10]), "r"(p[11]));
#else
  Carry c;
  for (int k = 0; k < N_WORDS32; k++)
    s[k] = c.add(s[k], k < 11 ? p[k + 1] : 0, k > 0, k < 11);
#endif
}

// x in [0, 2m) -> x mod m: x - m where that does not borrow.
DT_HD void cond_sub32(uint32_t *x, const Mod32 &M) {
  uint32_t d[N_WORDS32], borrow;
  DT_UNROLL
  for (int k = 0; k < N_WORDS32; k++) d[k] = x[k];
#if defined(__CUDA_ARCH__)
  const uint32_t zero = 0;
  asm("sub.cc.u32 %0, %0, %13;\n\t"
      "subc.cc.u32 %1, %1, %14;\n\t"
      "subc.cc.u32 %2, %2, %15;\n\t"
      "subc.cc.u32 %3, %3, %16;\n\t"
      "subc.cc.u32 %4, %4, %17;\n\t"
      "subc.cc.u32 %5, %5, %18;\n\t"
      "subc.cc.u32 %6, %6, %19;\n\t"
      "subc.cc.u32 %7, %7, %20;\n\t"
      "subc.cc.u32 %8, %8, %21;\n\t"
      "subc.cc.u32 %9, %9, %22;\n\t"
      "subc.cc.u32 %10, %10, %23;\n\t"
      "subc.cc.u32 %11, %11, %24;\n\t"
      "subc.u32 %12, %25, %25;"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "=r"(borrow)
      : "r"(M.m[0]), "r"(M.m[1]), "r"(M.m[2]), "r"(M.m[3]), "r"(M.m[4]),
        "r"(M.m[5]), "r"(M.m[6]), "r"(M.m[7]), "r"(M.m[8]), "r"(M.m[9]),
        "r"(M.m[10]), "r"(M.m[11]), "r"(zero));
#else
  Carry c;
  for (int k = 0; k < N_WORDS32; k++) d[k] = c.sub(d[k], M.m[k], k > 0, true);
  borrow = c.sub(0, 0, true, false);
#endif
  DT_UNROLL
  for (int k = 0; k < N_WORDS32; k++) x[k] = borrow ? x[k] : d[k];
}

// The REDC half of a step: q = P[0] * n0, then P + S * 2^32 += q * m
// (P[0] becomes 0; P's carry goes into S's top word).
DT_HD void redc_step32(uint32_t *P, uint32_t *S, const Mod32 &M) {
  const uint32_t q = P[0] * M.n0;
  add_pairs(S, M.mo, q);
  add_pairs_cc(P, M.me, q, S[N_WORDS32 - 1]);
}

// One step of b_i after the first, on P and S, the roles of the step
// before: afterwards S holds the P role and P the S role.
DT_HD void mul_step32(uint32_t *P, uint32_t *S, const uint32_t *ae,
                      const uint32_t *ao, uint32_t bi, const Mod32 &M) {
  add_shift_pairs(P, S[0], ao, bi);
  add_pairs_cc(S, ae, bi, P[N_WORDS32 - 1]);
  redc_step32(S, P, M);
}

// r = a * b * 2^-384 mod m for a in [0, m), b in [0, 2^384); r may alias
// a or b.
DT_HD void mont_mul32(const uint32_t *a, const uint32_t *b, uint32_t *r,
                      const Mod32 &M) {
  uint32_t ae[N_WORDS32 / 2], ao[N_WORDS32 / 2], bw[N_WORDS32];
  DT_UNROLL
  for (int j = 0; j < N_WORDS32 / 2; j++) {
    ae[j] = a[2 * j];
    ao[j] = a[2 * j + 1];
  }
  DT_UNROLL
  for (int k = 0; k < N_WORDS32; k++) bw[k] = b[k];
  uint32_t P[N_WORDS32], S[N_WORDS32];
  mul_pairs(P, ae, bw[0]);
  mul_pairs(S, ao, bw[0]);
  redc_step32(P, S, M);
  DT_UNROLL
  for (int i = 1; i < N_WORDS32; i += 2) {
    mul_step32(P, S, ae, ao, bw[i], M);
    if (i + 1 < N_WORDS32) mul_step32(S, P, ae, ao, bw[i + 1], M);
  }
  // after b_11 S holds the P role: the sum is S + P * 2^32 with S[0] = 0,
  // and its quotient by 2^32 is P + S / 2^32
  add_shifted(P, S);
  cond_sub32(P, M);
  DT_UNROLL
  for (int k = 0; k < N_WORDS32; k++) r[k] = P[k];
}

// ---------------------------------------------------------------------------
// The square: the triangular product into 24 words, then REDC
// ---------------------------------------------------------------------------

// acc[2k], acc[2k+1] += lo, hi of x[k] * b for k < L, the carry out into
// acc[2L]: one row's share of the off-diagonal products.
template <int L>
DT_HD void add_row(uint32_t *acc, const uint32_t *x, uint32_t b) {
#if defined(__CUDA_ARCH__)
  static_assert(1 <= L && L <= 6, "a row holds one to six pairs");
  if constexpr (L == 1) {
    asm("mad.lo.cc.u32 %0, %4, %3, %0;\n\t"
        "madc.hi.cc.u32 %1, %4, %3, %1;\n\t"
        "addc.u32 %2, %2, 0;"
        : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2])
        : "r"(b), "r"(x[0]));
  } else if constexpr (L == 2) {
    asm("mad.lo.cc.u32 %0, %6, %5, %0;\n\t"
        "madc.hi.cc.u32 %1, %6, %5, %1;\n\t"
        "madc.lo.cc.u32 %2, %7, %5, %2;\n\t"
        "madc.hi.cc.u32 %3, %7, %5, %3;\n\t"
        "addc.u32 %4, %4, 0;"
        : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3]), "+r"(acc[4])
        : "r"(b), "r"(x[0]), "r"(x[1]));
  } else if constexpr (L == 3) {
    asm("mad.lo.cc.u32 %0, %8, %7, %0;\n\t"
        "madc.hi.cc.u32 %1, %8, %7, %1;\n\t"
        "madc.lo.cc.u32 %2, %9, %7, %2;\n\t"
        "madc.hi.cc.u32 %3, %9, %7, %3;\n\t"
        "madc.lo.cc.u32 %4, %10, %7, %4;\n\t"
        "madc.hi.cc.u32 %5, %10, %7, %5;\n\t"
        "addc.u32 %6, %6, 0;"
        : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3]),
          "+r"(acc[4]), "+r"(acc[5]), "+r"(acc[6])
        : "r"(b), "r"(x[0]), "r"(x[1]), "r"(x[2]));
  } else if constexpr (L == 4) {
    asm("mad.lo.cc.u32 %0, %10, %9, %0;\n\t"
        "madc.hi.cc.u32 %1, %10, %9, %1;\n\t"
        "madc.lo.cc.u32 %2, %11, %9, %2;\n\t"
        "madc.hi.cc.u32 %3, %11, %9, %3;\n\t"
        "madc.lo.cc.u32 %4, %12, %9, %4;\n\t"
        "madc.hi.cc.u32 %5, %12, %9, %5;\n\t"
        "madc.lo.cc.u32 %6, %13, %9, %6;\n\t"
        "madc.hi.cc.u32 %7, %13, %9, %7;\n\t"
        "addc.u32 %8, %8, 0;"
        : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3]),
          "+r"(acc[4]), "+r"(acc[5]), "+r"(acc[6]), "+r"(acc[7]), "+r"(acc[8])
        : "r"(b), "r"(x[0]), "r"(x[1]), "r"(x[2]), "r"(x[3]));
  } else if constexpr (L == 5) {
    asm("mad.lo.cc.u32 %0, %12, %11, %0;\n\t"
        "madc.hi.cc.u32 %1, %12, %11, %1;\n\t"
        "madc.lo.cc.u32 %2, %13, %11, %2;\n\t"
        "madc.hi.cc.u32 %3, %13, %11, %3;\n\t"
        "madc.lo.cc.u32 %4, %14, %11, %4;\n\t"
        "madc.hi.cc.u32 %5, %14, %11, %5;\n\t"
        "madc.lo.cc.u32 %6, %15, %11, %6;\n\t"
        "madc.hi.cc.u32 %7, %15, %11, %7;\n\t"
        "madc.lo.cc.u32 %8, %16, %11, %8;\n\t"
        "madc.hi.cc.u32 %9, %16, %11, %9;\n\t"
        "addc.u32 %10, %10, 0;"
        : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3]),
          "+r"(acc[4]), "+r"(acc[5]), "+r"(acc[6]), "+r"(acc[7]),
          "+r"(acc[8]), "+r"(acc[9]), "+r"(acc[10])
        : "r"(b), "r"(x[0]), "r"(x[1]), "r"(x[2]), "r"(x[3]), "r"(x[4]));
  } else if constexpr (L == 6) {
    asm("mad.lo.cc.u32 %0, %14, %13, %0;\n\t"
        "madc.hi.cc.u32 %1, %14, %13, %1;\n\t"
        "madc.lo.cc.u32 %2, %15, %13, %2;\n\t"
        "madc.hi.cc.u32 %3, %15, %13, %3;\n\t"
        "madc.lo.cc.u32 %4, %16, %13, %4;\n\t"
        "madc.hi.cc.u32 %5, %16, %13, %5;\n\t"
        "madc.lo.cc.u32 %6, %17, %13, %6;\n\t"
        "madc.hi.cc.u32 %7, %17, %13, %7;\n\t"
        "madc.lo.cc.u32 %8, %18, %13, %8;\n\t"
        "madc.hi.cc.u32 %9, %18, %13, %9;\n\t"
        "madc.lo.cc.u32 %10, %19, %13, %10;\n\t"
        "madc.hi.cc.u32 %11, %19, %13, %11;\n\t"
        "addc.u32 %12, %12, 0;"
        : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3]),
          "+r"(acc[4]), "+r"(acc[5]), "+r"(acc[6]), "+r"(acc[7]),
          "+r"(acc[8]), "+r"(acc[9]), "+r"(acc[10]), "+r"(acc[11]),
          "+r"(acc[12])
        : "r"(b), "r"(x[0]), "r"(x[1]), "r"(x[2]), "r"(x[3]), "r"(x[4]),
          "r"(x[5]));
  }
#else
  Carry c;
  for (int k = 0; k < L; k++) {
    acc[2 * k] = c.mad(x[k], b, acc[2 * k], false, k > 0, true);
    acc[2 * k + 1] = c.mad(x[k], b, acc[2 * k + 1], true, true, true);
  }
  acc[2 * L] = c.add(acc[2 * L], 0, true, false);
#endif
}

// Rows I.. of the off-diagonal products a_I a_j (j > I): those with j of
// the other parity than I land on odd columns and go into od (od[k] is
// column k + 1), the others into ev, so each is one chain of disjoint
// column pairs.  A row's carry goes into a word no earlier row wrote a
// product into (rows end at columns I + 12), so it holds only earlier
// carries and cannot overflow.
template <int I>
DT_HD void sqr_rows(uint32_t *ev, uint32_t *od, const uint32_t *ae,
                    const uint32_t *ao, const uint32_t *a) {
  if constexpr (I < N_WORDS32 - 1) {
    add_row<(10 - I) / 2 + 1>(od + 2 * I,
                              I % 2 == 0 ? ao + I / 2 : ae + (I + 1) / 2,
                              a[I]);
    if constexpr (I < 10)
      add_row<(9 - I) / 2 + 1>(ev + 2 * I + 2,
                               I % 2 == 0 ? ae + I / 2 + 1 : ao + (I + 1) / 2,
                               a[I]);
    sqr_rows<I + 1>(ev, od, ae, ao, a);
  }
}

// ev += od * 2^32 over 24 words (ev[0] stays 0): the off-diagonal sum.
DT_HD void add_cross(uint32_t *ev, const uint32_t *od) {
#if defined(__CUDA_ARCH__)
  asm("add.cc.u32 %0, %0, %23;\n\t"
      "addc.cc.u32 %1, %1, %24;\n\t"
      "addc.cc.u32 %2, %2, %25;\n\t"
      "addc.cc.u32 %3, %3, %26;\n\t"
      "addc.cc.u32 %4, %4, %27;\n\t"
      "addc.cc.u32 %5, %5, %28;\n\t"
      "addc.cc.u32 %6, %6, %29;\n\t"
      "addc.cc.u32 %7, %7, %30;\n\t"
      "addc.cc.u32 %8, %8, %31;\n\t"
      "addc.cc.u32 %9, %9, %32;\n\t"
      "addc.cc.u32 %10, %10, %33;\n\t"
      "addc.cc.u32 %11, %11, %34;\n\t"
      "addc.cc.u32 %12, %12, %35;\n\t"
      "addc.cc.u32 %13, %13, %36;\n\t"
      "addc.cc.u32 %14, %14, %37;\n\t"
      "addc.cc.u32 %15, %15, %38;\n\t"
      "addc.cc.u32 %16, %16, %39;\n\t"
      "addc.cc.u32 %17, %17, %40;\n\t"
      "addc.cc.u32 %18, %18, %41;\n\t"
      "addc.cc.u32 %19, %19, %42;\n\t"
      "addc.cc.u32 %20, %20, %43;\n\t"
      "addc.cc.u32 %21, %21, %44;\n\t"
      "addc.u32 %22, %22, %45;"
      : "+r"(ev[1]), "+r"(ev[2]), "+r"(ev[3]), "+r"(ev[4]), "+r"(ev[5]),
        "+r"(ev[6]), "+r"(ev[7]), "+r"(ev[8]), "+r"(ev[9]), "+r"(ev[10]),
        "+r"(ev[11]), "+r"(ev[12]), "+r"(ev[13]), "+r"(ev[14]), "+r"(ev[15]),
        "+r"(ev[16]), "+r"(ev[17]), "+r"(ev[18]), "+r"(ev[19]), "+r"(ev[20]),
        "+r"(ev[21]), "+r"(ev[22]), "+r"(ev[23])
      : "r"(od[0]), "r"(od[1]), "r"(od[2]), "r"(od[3]), "r"(od[4]),
        "r"(od[5]), "r"(od[6]), "r"(od[7]), "r"(od[8]), "r"(od[9]),
        "r"(od[10]), "r"(od[11]), "r"(od[12]), "r"(od[13]), "r"(od[14]),
        "r"(od[15]), "r"(od[16]), "r"(od[17]), "r"(od[18]), "r"(od[19]),
        "r"(od[20]), "r"(od[21]), "r"(od[22]));
#else
  Carry c;
  for (int k = 1; k < 2 * N_WORDS32; k++)
    ev[k] = c.add(ev[k], od[k - 1], k > 1, k < 2 * N_WORDS32 - 1);
#endif
}

// w[2i], w[2i+1] += lo, hi of a_i^2.  No carry out (w ends below a^2).
DT_HD void add_diag(uint32_t *w, const uint32_t *a) {
#if defined(__CUDA_ARCH__)
  asm("mad.lo.cc.u32 %0, %24, %24, %0;\n\t"
      "madc.hi.cc.u32 %1, %24, %24, %1;\n\t"
      "madc.lo.cc.u32 %2, %25, %25, %2;\n\t"
      "madc.hi.cc.u32 %3, %25, %25, %3;\n\t"
      "madc.lo.cc.u32 %4, %26, %26, %4;\n\t"
      "madc.hi.cc.u32 %5, %26, %26, %5;\n\t"
      "madc.lo.cc.u32 %6, %27, %27, %6;\n\t"
      "madc.hi.cc.u32 %7, %27, %27, %7;\n\t"
      "madc.lo.cc.u32 %8, %28, %28, %8;\n\t"
      "madc.hi.cc.u32 %9, %28, %28, %9;\n\t"
      "madc.lo.cc.u32 %10, %29, %29, %10;\n\t"
      "madc.hi.cc.u32 %11, %29, %29, %11;\n\t"
      "madc.lo.cc.u32 %12, %30, %30, %12;\n\t"
      "madc.hi.cc.u32 %13, %30, %30, %13;\n\t"
      "madc.lo.cc.u32 %14, %31, %31, %14;\n\t"
      "madc.hi.cc.u32 %15, %31, %31, %15;\n\t"
      "madc.lo.cc.u32 %16, %32, %32, %16;\n\t"
      "madc.hi.cc.u32 %17, %32, %32, %17;\n\t"
      "madc.lo.cc.u32 %18, %33, %33, %18;\n\t"
      "madc.hi.cc.u32 %19, %33, %33, %19;\n\t"
      "madc.lo.cc.u32 %20, %34, %34, %20;\n\t"
      "madc.hi.cc.u32 %21, %34, %34, %21;\n\t"
      "madc.lo.cc.u32 %22, %35, %35, %22;\n\t"
      "madc.hi.u32 %23, %35, %35, %23;"
      : "+r"(w[0]), "+r"(w[1]), "+r"(w[2]), "+r"(w[3]), "+r"(w[4]),
        "+r"(w[5]), "+r"(w[6]), "+r"(w[7]), "+r"(w[8]), "+r"(w[9]),
        "+r"(w[10]), "+r"(w[11]), "+r"(w[12]), "+r"(w[13]), "+r"(w[14]),
        "+r"(w[15]), "+r"(w[16]), "+r"(w[17]), "+r"(w[18]), "+r"(w[19]),
        "+r"(w[20]), "+r"(w[21]), "+r"(w[22]), "+r"(w[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]),
        "r"(a[6]), "r"(a[7]), "r"(a[8]), "r"(a[9]), "r"(a[10]), "r"(a[11]));
#else
  Carry c;
  for (int i = 0; i < N_WORDS32; i++) {
    w[2 * i] = c.mad(a[i], a[i], w[2 * i], false, i > 0, true);
    w[2 * i + 1] = c.mad(a[i], a[i], w[2 * i + 1], true, true, i < 11);
  }
#endif
}

// r += h over 12 words, no carry out (the caller's bound).
DT_HD void add12(uint32_t *r, const uint32_t *h) {
#if defined(__CUDA_ARCH__)
  asm("add.cc.u32 %0, %0, %12;\n\t"
      "addc.cc.u32 %1, %1, %13;\n\t"
      "addc.cc.u32 %2, %2, %14;\n\t"
      "addc.cc.u32 %3, %3, %15;\n\t"
      "addc.cc.u32 %4, %4, %16;\n\t"
      "addc.cc.u32 %5, %5, %17;\n\t"
      "addc.cc.u32 %6, %6, %18;\n\t"
      "addc.cc.u32 %7, %7, %19;\n\t"
      "addc.cc.u32 %8, %8, %20;\n\t"
      "addc.cc.u32 %9, %9, %21;\n\t"
      "addc.cc.u32 %10, %10, %22;\n\t"
      "addc.u32 %11, %11, %23;"
      : "+r"(r[0]), "+r"(r[1]), "+r"(r[2]), "+r"(r[3]), "+r"(r[4]),
        "+r"(r[5]), "+r"(r[6]), "+r"(r[7]), "+r"(r[8]), "+r"(r[9]),
        "+r"(r[10]), "+r"(r[11])
      : "r"(h[0]), "r"(h[1]), "r"(h[2]), "r"(h[3]), "r"(h[4]), "r"(h[5]),
        "r"(h[6]), "r"(h[7]), "r"(h[8]), "r"(h[9]), "r"(h[10]), "r"(h[11]));
#else
  Carry c;
  for (int k = 0; k < N_WORDS32; k++)
    r[k] = c.add(r[k], h[k], k > 0, k < 11);
#endif
}

// w = a^2 over 24 words: 66 off-diagonal products (sqr_rows), their sum
// doubled by a shift, then the 12 squares a_i^2 -- 78 products where the
// CIOS product takes 144.
DT_HD void sqr_wide32(const uint32_t *a, uint32_t *w) {
  uint32_t ae[N_WORDS32 / 2], ao[N_WORDS32 / 2];
  uint32_t ev[2 * N_WORDS32], od[2 * N_WORDS32];
  DT_UNROLL
  for (int j = 0; j < N_WORDS32 / 2; j++) {
    ae[j] = a[2 * j];
    ao[j] = a[2 * j + 1];
  }
  DT_UNROLL
  for (int k = 0; k < 2 * N_WORDS32; k++) ev[k] = od[k] = 0;
  sqr_rows<0>(ev, od, ae, ao, a);
  add_cross(ev, od);
  // the off-diagonal sum is below a^2 / 2 < 2^767: doubling stays in 24
  // words
  w[0] = 0;
  DT_UNROLL
  for (int k = 1; k < 2 * N_WORDS32; k++) w[k] = ev[k] << 1 | ev[k - 1] >> 31;
  add_diag(w, a);
}

// One REDC step after the first on the low half of a wide value: the
// division by 2^32 of mont_mul32's steps, with the quotient's odd
// products fused into the shift and its even ones on the new P (there is
// no b).  Afterwards S holds the P role and P the S role.
DT_HD void redc_shift_step32(uint32_t *P, uint32_t *S, const Mod32 &M) {
  const uint32_t q = (S[0] + P[1]) * M.n0;
  add_shift_pairs(P, S[0], M.mo, q);
  add_pairs_cc(S, M.me, q, P[N_WORDS32 - 1]);
}

// r = a^2 * 2^-384 mod m for a in [0, m); r may alias a.  REDC(w) is
// (w_lo + Q m) / 2^384 + w_hi with Q from w_lo alone: the first term is at
// most m (w_lo < 2^384) and w_hi < m, so the sum is below 2m and one
// conditional subtract makes it canonical.  The running sum of the REDC
// steps stays below 2^384 + 2^33 m before each division, so S's chains
// never carry out, as in mont_mul32.
DT_HD void mont_sqr32(const uint32_t *a, uint32_t *r, const Mod32 &M) {
  uint32_t w[2 * N_WORDS32], P[N_WORDS32], S[N_WORDS32];
  sqr_wide32(a, w);
  DT_UNROLL
  for (int k = 0; k < N_WORDS32; k++) P[k] = w[k];
  const uint32_t q0 = P[0] * M.n0;
  mul_pairs(S, M.mo, q0);
  add_pairs_cc(P, M.me, q0, S[N_WORDS32 - 1]);
  DT_UNROLL
  for (int i = 1; i < N_WORDS32; i += 2) {
    redc_shift_step32(P, S, M);
    if (i + 1 < N_WORDS32) redc_shift_step32(S, P, M);
  }
  add_shifted(P, S);
  add12(P, w + N_WORDS32);
  cond_sub32(P, M);
  DT_UNROLL
  for (int k = 0; k < N_WORDS32; k++) r[k] = P[k];
}

// ---------------------------------------------------------------------------
// K4: an addition-chain program a thread runs on its row
// ---------------------------------------------------------------------------
//
// A program is a list of int32 steps, code = k << 8 | op << 6 | slot, run
// on a running value x that starts as the row of a:
//   CHAIN_SQRMUL: x = x^(2^k), then x = x * y for slot != CHAIN_NONE, y
//                 the row of t for slot CHAIN_T, else scratch slot `slot`;
//   CHAIN_LOAD:   x = scratch slot `slot`;
//   CHAIN_STORE:  scratch slot `slot` = x.
// drand_tpu_torch/ops/kernels.py chain_program compiles an addchain_plan
// into one (the odd table, the repunit builds, then the plan's steps) and
// a single step res^(2^k) * t into [SQRMUL k, CHAIN_T].  The scratch holds
// slot s of row e of n as three 16-byte units at [(s * 3 + j) * n + e]:
// neighbouring rows' units are neighbours, so a warp's accesses coalesce.

constexpr int CHAIN_SQRMUL = 0, CHAIN_LOAD = 1, CHAIN_STORE = 2;
constexpr int CHAIN_NONE = 63, CHAIN_T = 62;
constexpr int CHAIN_SLOTS = 62;         // scratch slots 0..61

DT_HD void chain_slot_load(const uint32_t *scratch, int slot, long long n,
                           long long e, uint32_t *x) {
  DT_UNROLL
  for (int j = 0; j < 3; j++) {
    const uint32_t *u = scratch + 4 * ((slot * 3 + j) * n + e);
#if defined(__CUDA_ARCH__)
    const uint4 v = *reinterpret_cast<const uint4 *>(u);
    x[4 * j] = v.x;
    x[4 * j + 1] = v.y;
    x[4 * j + 2] = v.z;
    x[4 * j + 3] = v.w;
#else
    for (int i = 0; i < 4; i++) x[4 * j + i] = u[i];
#endif
  }
}

DT_HD void chain_slot_store(uint32_t *scratch, int slot, long long n,
                            long long e, const uint32_t *x) {
  DT_UNROLL
  for (int j = 0; j < 3; j++) {
    uint32_t *u = scratch + 4 * ((slot * 3 + j) * n + e);
#if defined(__CUDA_ARCH__)
    *reinterpret_cast<uint4 *>(u) =
        make_uint4(x[4 * j], x[4 * j + 1], x[4 * j + 2], x[4 * j + 3]);
#else
    for (int i = 0; i < 4; i++) u[i] = x[4 * j + i];
#endif
  }
}

// Row e of n: o = the program run on a (t: the rows of CHAIN_T, or null).
DT_HD void chain_row(const int32_t *a, const int32_t *t, int32_t *o,
                     const int32_t *steps, int n_steps, uint32_t *scratch,
                     long long n, long long e, const Mod32 &M) {
  uint32_t x[N_WORDS32], y[N_WORDS32];
  load_words32(a + e * N_LIMBS, x);
  for (int s = 0; s < n_steps; s++) {
#if defined(__CUDA_ARCH__)
    const int code = __ldg(steps + s);
#else
    const int code = steps[s];
#endif
    const int op = (code >> 6) & 3, slot = code & 63, k = code >> 8;
    if (op == CHAIN_LOAD) {
      chain_slot_load(scratch, slot, n, e, x);
    } else if (op == CHAIN_STORE) {
      chain_slot_store(scratch, slot, n, e, x);
    } else {
      for (int i = 0; i < k; i++) mont_sqr32(x, x, M);
      if (slot != CHAIN_NONE) {
        if (slot == CHAIN_T)
          load_words32(t + e * N_LIMBS, y);
        else
          chain_slot_load(scratch, slot, n, e, y);
        mont_mul32(x, y, x, M);
      }
    }
  }
  store_words32(x, o + e * N_LIMBS);
}

}  // namespace dt
