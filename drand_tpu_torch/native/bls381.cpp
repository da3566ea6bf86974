// BLS12-381 verification, native host tier of drand_tpu_torch.
//
// The port's own copy of drand_tpu/native/bls381.cpp: the same code and
// the same exported C ABI (the `extern "C"` block at the end).  The
// reference's hot CPU path is kilic/bls12-381 x86-64 assembly behind
// kyber (`key/curve.go:24`); this library answers the LATENCY side of the
// port: single-beacon verification, batches of at most 32 rows, per-partial
// checks and the threshold-recovery combine on the host (the THROUGHPUT
// side is the batched CUDA path on the card).  It is a port of the
// pure-Python golden model of drand_tpu/crypto/bls12381/ -- same tower
// layout, same SSWU+Velu-isogeny hash-to-curve, same e(P,Q)^3 pairing
// convention -- and tests/test_torch_native.py holds it
// against drand_tpu's library and the pinned RFC 9380 vectors.  Every
// constant comes from constants.h, GENERATED from the golden model by
// tools/gen_native_constants.py.
//
// Build: g++ -O3 -march=native -shared -fPIC bls381.cpp -o _libdrandbls.so
// (driven by drand_tpu_torch/native/__init__.py at first use, into
// build/native/: it probes -O3 -march=native and then portable -O2; the
// chosen flag set is recorded in the sidecar build-meta file --
// native.build_info()).

#include <stdint.h>
#include <string.h>

#include "constants.h"

typedef unsigned __int128 u128;

// ---------------------------------------------------------------------------
// Fp: 6x64-bit limbs, Montgomery form (R = 2^384)
// ---------------------------------------------------------------------------

static inline int fp_is_zero(const fp *a) {
  uint64_t o = 0;
  for (int i = 0; i < 6; i++) o |= a->l[i];
  return o == 0;
}

static inline int fp_eq(const fp *a, const fp *b) {
  uint64_t o = 0;
  for (int i = 0; i < 6; i++) o |= a->l[i] ^ b->l[i];
  return o == 0;
}

static inline int fp_cmp(const fp *a, const fp *b) {  // -1,0,1
  for (int i = 5; i >= 0; i--) {
    if (a->l[i] < b->l[i]) return -1;
    if (a->l[i] > b->l[i]) return 1;
  }
  return 0;
}

static inline void fp_sub_raw(fp *r, const fp *a, const fp *b) {
  u128 borrow = 0;
  for (int i = 0; i < 6; i++) {
    u128 d = (u128)a->l[i] - b->l[i] - borrow;
    r->l[i] = (uint64_t)d;
    borrow = (d >> 64) ? 1 : 0;
  }
}

static inline void fp_add(fp *r, const fp *a, const fp *b) {
  u128 carry = 0;
  for (int i = 0; i < 6; i++) {
    u128 s = (u128)a->l[i] + b->l[i] + carry;
    r->l[i] = (uint64_t)s;
    carry = s >> 64;
  }
  if (carry || fp_cmp(r, &BLS_MOD) >= 0) fp_sub_raw(r, r, &BLS_MOD);
}

static inline void fp_sub(fp *r, const fp *a, const fp *b) {
  if (fp_cmp(a, b) >= 0) {
    fp_sub_raw(r, a, b);
  } else {
    fp t;
    fp_sub_raw(&t, b, a);
    fp_sub_raw(r, &BLS_MOD, &t);
  }
}

static inline void fp_neg(fp *r, const fp *a) {
  if (fp_is_zero(a)) { *r = *a; return; }
  fp_sub_raw(r, &BLS_MOD, a);
}

// Non-reducing add/sub for LAZY-REDUCTION operand prep only: results are
// < 2p (p < 2^382, so 2p fits 384 bits) and feed mul_wide, never fp_mul
// (whose no-carry CIOS bound below needs canonical < p inputs).
static inline void fp_add_nored(fp *r, const fp *a, const fp *b) {
  u128 carry = 0;
  for (int i = 0; i < 6; i++) {
    u128 s = (u128)a->l[i] + b->l[i] + carry;
    r->l[i] = (uint64_t)s;
    carry = s >> 64;
  }
}
// a - b + p, in [1, 2p): congruent to a-b without a canonicalizing branch
static inline void fp_sub_nored(fp *r, const fp *a, const fp *b) {
  fp pb;
  fp_sub_raw(&pb, &BLS_MOD, b);  // b < p, so no borrow
  fp_add_nored(r, a, &pb);
}

// Unrolled 6x6 CIOS Montgomery multiplication (Acar et al., the
// "no-carry" variant: BLS12-381's top modulus word 0x1a01... < 2^61
// leaves enough headroom that the running value stays < 2p and the
// seventh accumulator limb never materializes).  One interleaved
// reduction per operand limb; all carries live in registers.
static void fp_mul(fp *r, const fp *a, const fp *b) {
  uint64_t t0 = 0, t1 = 0, t2 = 0, t3 = 0, t4 = 0, t5 = 0;
  u128 z;
#define FP_CIOS_ROUND(AI)                                                     \
  {                                                                           \
    const uint64_t ai = (AI);                                                 \
    uint64_t c1, c2, m;                                                       \
    z = (u128)ai * b->l[0] + t0; t0 = (uint64_t)z; c1 = (uint64_t)(z >> 64);  \
    m = t0 * BLS_INV;                                                         \
    z = (u128)m * BLS_MOD.l[0] + t0; c2 = (uint64_t)(z >> 64);                \
    z = (u128)ai * b->l[1] + t1 + c1; t1 = (uint64_t)z; c1 = (uint64_t)(z >> 64); \
    z = (u128)m * BLS_MOD.l[1] + t1 + c2; t0 = (uint64_t)z; c2 = (uint64_t)(z >> 64); \
    z = (u128)ai * b->l[2] + t2 + c1; t2 = (uint64_t)z; c1 = (uint64_t)(z >> 64); \
    z = (u128)m * BLS_MOD.l[2] + t2 + c2; t1 = (uint64_t)z; c2 = (uint64_t)(z >> 64); \
    z = (u128)ai * b->l[3] + t3 + c1; t3 = (uint64_t)z; c1 = (uint64_t)(z >> 64); \
    z = (u128)m * BLS_MOD.l[3] + t3 + c2; t2 = (uint64_t)z; c2 = (uint64_t)(z >> 64); \
    z = (u128)ai * b->l[4] + t4 + c1; t4 = (uint64_t)z; c1 = (uint64_t)(z >> 64); \
    z = (u128)m * BLS_MOD.l[4] + t4 + c2; t3 = (uint64_t)z; c2 = (uint64_t)(z >> 64); \
    z = (u128)ai * b->l[5] + t5 + c1; t5 = (uint64_t)z; c1 = (uint64_t)(z >> 64); \
    z = (u128)m * BLS_MOD.l[5] + t5 + c2; t4 = (uint64_t)z; c2 = (uint64_t)(z >> 64); \
    t5 = c1 + c2;                                                             \
  }
  FP_CIOS_ROUND(a->l[0])
  FP_CIOS_ROUND(a->l[1])
  FP_CIOS_ROUND(a->l[2])
  FP_CIOS_ROUND(a->l[3])
  FP_CIOS_ROUND(a->l[4])
  FP_CIOS_ROUND(a->l[5])
#undef FP_CIOS_ROUND
  fp out = {{t0, t1, t2, t3, t4, t5}};
  if (fp_cmp(&out, &BLS_MOD) >= 0) fp_sub_raw(&out, &out, &BLS_MOD);
  *r = out;
}

// ---------------------------------------------------------------------------
// Double-width (768-bit) lane for lazy reduction: full products are
// accumulated unreduced and pay ONE Montgomery reduction per output
// coefficient (Aranha et al.).  Contract: every value handed to
// redc_wide is < p*2^384, so the reduction output is < 2p and one
// conditional subtraction canonicalizes — results stay bit-identical to
// the reduce-per-fp_mul path (same residue, same canonical form).
// ---------------------------------------------------------------------------

typedef struct { uint64_t l[12]; } fpw;

// 768-bit schoolbook product, rows unrolled (operands may be the
// non-reduced <2p sums from fp_add_nored/fp_sub_nored: 2p*2p < p*2^384).
static void mul_wide(fpw *w, const fp *a, const fp *b) {
  memset(w->l, 0, sizeof(w->l));
  u128 z;
#define MW_ROW(I)                                                             \
  {                                                                           \
    const uint64_t ai = a->l[I];                                              \
    uint64_t cc = 0;                                                          \
    z = (u128)ai * b->l[0] + w->l[I + 0] + cc; w->l[I + 0] = (uint64_t)z; cc = (uint64_t)(z >> 64); \
    z = (u128)ai * b->l[1] + w->l[I + 1] + cc; w->l[I + 1] = (uint64_t)z; cc = (uint64_t)(z >> 64); \
    z = (u128)ai * b->l[2] + w->l[I + 2] + cc; w->l[I + 2] = (uint64_t)z; cc = (uint64_t)(z >> 64); \
    z = (u128)ai * b->l[3] + w->l[I + 3] + cc; w->l[I + 3] = (uint64_t)z; cc = (uint64_t)(z >> 64); \
    z = (u128)ai * b->l[4] + w->l[I + 4] + cc; w->l[I + 4] = (uint64_t)z; cc = (uint64_t)(z >> 64); \
    z = (u128)ai * b->l[5] + w->l[I + 5] + cc; w->l[I + 5] = (uint64_t)z; cc = (uint64_t)(z >> 64); \
    w->l[I + 6] = cc;                                                         \
  }
  MW_ROW(0) MW_ROW(1) MW_ROW(2) MW_ROW(3) MW_ROW(4) MW_ROW(5)
#undef MW_ROW
}

// 768-bit square exploiting partial-product symmetry: 15 distinct cross
// products doubled by one shift, plus 6 diagonal squares — 21 64x64
// multiplies instead of mul_wide's 36.
static void sqr_wide(fpw *w, const fp *a) {
  memset(w->l, 0, sizeof(w->l));
  u128 z;
#define SW_ROW(I, J0)                                                         \
  {                                                                           \
    const uint64_t ai = a->l[I];                                              \
    uint64_t cc = 0;                                                          \
    for (int j = (J0); j < 6; j++) {                                          \
      z = (u128)ai * a->l[j] + w->l[I + j] + cc;                              \
      w->l[I + j] = (uint64_t)z;                                              \
      cc = (uint64_t)(z >> 64);                                               \
    }                                                                         \
    w->l[I + 6] = cc;                                                         \
  }
  SW_ROW(0, 1) SW_ROW(1, 2) SW_ROW(2, 3) SW_ROW(3, 4) SW_ROW(4, 5)
#undef SW_ROW
  // double the cross half (top cross limb is l[10]; carry stays in-range)
  uint64_t hi = 0;
  for (int i = 0; i < 12; i++) {
    uint64_t v = w->l[i];
    w->l[i] = (v << 1) | hi;
    hi = v >> 63;
  }
  // add the diagonal a_i^2 at limb 2i
  uint64_t cc = 0;
  for (int i = 0; i < 6; i++) {
    z = (u128)a->l[i] * a->l[i];
    u128 s = (u128)w->l[2 * i] + (uint64_t)z + cc;
    w->l[2 * i] = (uint64_t)s;
    s = (u128)w->l[2 * i + 1] + (uint64_t)(z >> 64) + (uint64_t)(s >> 64);
    w->l[2 * i + 1] = (uint64_t)s;
    cc = (uint64_t)(s >> 64);
  }
}

// Montgomery reduction of a 768-bit value < p*2^384: six unrolled m*p
// elimination rounds sliding the window up, output canonical.
static void redc_wide(fp *r, const fpw *w) {
  uint64_t t0 = w->l[0], t1 = w->l[1], t2 = w->l[2], t3 = w->l[3],
           t4 = w->l[4], t5 = w->l[5];
  uint64_t hicarry = 0;
  u128 z;
#define RW_ROUND(I)                                                           \
  {                                                                           \
    const uint64_t m = t0 * BLS_INV;                                          \
    uint64_t cc;                                                              \
    z = (u128)m * BLS_MOD.l[0] + t0; cc = (uint64_t)(z >> 64);                \
    z = (u128)m * BLS_MOD.l[1] + t1 + cc; t0 = (uint64_t)z; cc = (uint64_t)(z >> 64); \
    z = (u128)m * BLS_MOD.l[2] + t2 + cc; t1 = (uint64_t)z; cc = (uint64_t)(z >> 64); \
    z = (u128)m * BLS_MOD.l[3] + t3 + cc; t2 = (uint64_t)z; cc = (uint64_t)(z >> 64); \
    z = (u128)m * BLS_MOD.l[4] + t4 + cc; t3 = (uint64_t)z; cc = (uint64_t)(z >> 64); \
    z = (u128)m * BLS_MOD.l[5] + t5 + cc; t4 = (uint64_t)z; cc = (uint64_t)(z >> 64); \
    z = (u128)w->l[6 + (I)] + cc + hicarry;                                   \
    t5 = (uint64_t)z; hicarry = (uint64_t)(z >> 64);                          \
  }
  RW_ROUND(0) RW_ROUND(1) RW_ROUND(2) RW_ROUND(3) RW_ROUND(4) RW_ROUND(5)
#undef RW_ROUND
  // input < p*2^384 => result < 2p: hicarry is 0 here, one cond-sub
  fp out = {{t0, t1, t2, t3, t4, t5}};
  if (fp_cmp(&out, &BLS_MOD) >= 0) fp_sub_raw(&out, &out, &BLS_MOD);
  *r = out;
}

static inline void fpw_add(fpw *r, const fpw *a, const fpw *b) {
  u128 carry = 0;
  for (int i = 0; i < 12; i++) {
    u128 s = (u128)a->l[i] + b->l[i] + carry;
    r->l[i] = (uint64_t)s;
    carry = s >> 64;
  }
}

static inline void fpw_sub(fpw *r, const fpw *a, const fpw *b) {  // a >= b
  u128 borrow = 0;
  for (int i = 0; i < 12; i++) {
    u128 d = (u128)a->l[i] - b->l[i] - borrow;
    r->l[i] = (uint64_t)d;
    borrow = (d >> 64) ? 1 : 0;
  }
}

static inline void fpw_dbl(fpw *r, const fpw *a) {
  uint64_t hi = 0;
  for (int i = 0; i < 12; i++) {
    uint64_t v = a->l[i];
    r->l[i] = (v << 1) | hi;
    hi = v >> 63;
  }
}

// p^2 as a 768-bit integer (exps_init): the offset that keeps wide
// Karatsuba differences non-negative (x + p^2 - y with y < p^2; p^2 is
// 0 mod p, so the residue — hence the canonical result — is unchanged).
static fpw WIDE_PP2;

static inline void fpw_sub_pp2(fpw *r, const fpw *a, const fpw *b) {
  fpw t;
  fpw_add(&t, a, &WIDE_PP2);
  fpw_sub(r, &t, b);
}

static inline void fp_sqr(fp *r, const fp *a) {
  fpw w;
  sqr_wide(&w, a);
  redc_wide(r, &w);
}

// a^e where e is a plain exponent given as 6 limbs (le).
// 4-bit fixed-window MSB-first: ~381 squarings + <=95 table multiplies
// (the same windowing the device engine's pow_const scan uses).
static void fp_pow_limbs(fp *r, const fp *a, const uint64_t e[6]) {
  int top = 5;
  while (top >= 0 && e[top] == 0) top--;
  if (top < 0) { *r = BLS_ONE_M; return; }
  fp tab[16];
  tab[0] = BLS_ONE_M;
  tab[1] = *a;
  for (int i = 2; i < 16; i++) fp_mul(&tab[i], &tab[i - 1], a);
  int nbits = 64 * top + 64 - __builtin_clzll(e[top]);
  int ndig = (nbits + 3) / 4;
  fp acc = BLS_ONE_M;
  int started = 0;
  for (int d = ndig - 1; d >= 0; d--) {
    if (started)
      for (int s = 0; s < 4; s++) fp_sqr(&acc, &acc);
    unsigned dig = (unsigned)((e[(4 * d) / 64] >> ((4 * d) % 64)) & 0xF);
    if (dig) {
      if (started)
        fp_mul(&acc, &acc, &tab[dig]);
      else
        acc = tab[dig];
      started = 1;
    } else if (!started) {
      continue;
    }
  }
  *r = acc;
}

static uint64_t EXP_PM2[6];     // p - 2
static uint64_t EXP_P14[6];     // (p + 1) / 4
static uint64_t EXP_P12[6];     // (p - 1) / 2

static void exps_init(void) {
  uint64_t borrow = 0;
  for (int i = 0; i < 6; i++) {
    u128 d = (u128)BLS_MOD.l[i] - ((i == 0) ? 2 : 0) - borrow;
    EXP_PM2[i] = (uint64_t)d;
    borrow = (d >> 64) ? 1 : 0;
  }
  // (p+1)/4: p+1 then >>2 (p+1 doesn't overflow 384 bits)
  uint64_t p1[6];
  u128 carry = 1;
  for (int i = 0; i < 6; i++) {
    u128 s = (u128)BLS_MOD.l[i] + carry;
    p1[i] = (uint64_t)s;
    carry = s >> 64;
  }
  for (int i = 0; i < 6; i++) {
    uint64_t hi = (i < 5) ? p1[i + 1] : 0;
    EXP_P14[i] = (p1[i] >> 2) | (hi << 62);
  }
  // (p-1)/2
  uint64_t pm1[6];
  borrow = 0;
  for (int i = 0; i < 6; i++) {
    u128 d = (u128)BLS_MOD.l[i] - ((i == 0) ? 1 : 0) - borrow;
    pm1[i] = (uint64_t)d;
    borrow = (d >> 64) ? 1 : 0;
  }
  for (int i = 0; i < 6; i++) {
    uint64_t hi = (i < 5) ? pm1[i + 1] : 0;
    EXP_P12[i] = (pm1[i] >> 1) | (hi << 63);
  }
  // p^2 (plain integer arithmetic; mul_wide is form-agnostic)
  mul_wide(&WIDE_PP2, &BLS_MOD, &BLS_MOD);
}

static inline void fp_inv(fp *r, const fp *a) { fp_pow_limbs(r, a, EXP_PM2); }

static int fp_sqrt(fp *r, const fp *a) {  // 1 = ok
  if (fp_is_zero(a)) { *r = BLS_ZERO; return 1; }
  fp c, c2;
  fp_pow_limbs(&c, a, EXP_P14);
  fp_sqr(&c2, &c);
  if (!fp_eq(&c2, a)) return 0;
  *r = c;
  return 1;
}

static int fp_is_square(const fp *a) {
  if (fp_is_zero(a)) return 1;
  fp ls;
  fp_pow_limbs(&ls, a, EXP_P12);
  return fp_eq(&ls, &BLS_ONE_M);
}

// Montgomery <-> plain/bytes
static void fp_from_mont(fp *r, const fp *a) {
  fp one = {{1, 0, 0, 0, 0, 0}};
  fp_mul(r, a, &one);
}

static void fp_to_mont(fp *r, const fp *a) { fp_mul(r, a, &BLS_R2); }

static int fp_from_be48(fp *r, const uint8_t b[48]) {  // 1 = canonical
  fp v;
  for (int i = 0; i < 6; i++) {
    uint64_t w = 0;
    for (int j = 0; j < 8; j++) w = (w << 8) | b[(5 - i) * 8 + j];
    v.l[i] = w;
  }
  if (fp_cmp(&v, &BLS_MOD) >= 0) return 0;
  fp_to_mont(r, &v);
  return 1;
}

static void fp_to_be48(uint8_t b[48], const fp *a) {
  fp v;
  fp_from_mont(&v, a);
  for (int i = 0; i < 6; i++)
    for (int j = 0; j < 8; j++)
      b[(5 - i) * 8 + j] = (uint8_t)(v.l[i] >> (56 - 8 * j));
}

static int fp_sgn0(const fp *a) {
  fp v;
  fp_from_mont(&v, a);
  return (int)(v.l[0] & 1);
}

static int fp_gt_half(const fp *a) {  // a > (p-1)/2, plain compare
  fp v;
  fp_from_mont(&v, a);
  return fp_cmp(&v, &BLS_HALF_P) > 0;
}

// ---------------------------------------------------------------------------
// Fp2 = Fp[u]/(u^2+1)  (mirrors golden fp.py)
// ---------------------------------------------------------------------------

static const fp2 FP2_ZERO_C = {{{0}}, {{0}}};

static inline void fp2_add(fp2 *r, const fp2 *a, const fp2 *b) {
  fp_add(&r->c0, &a->c0, &b->c0);
  fp_add(&r->c1, &a->c1, &b->c1);
}
static inline void fp2_sub(fp2 *r, const fp2 *a, const fp2 *b) {
  fp_sub(&r->c0, &a->c0, &b->c0);
  fp_sub(&r->c1, &a->c1, &b->c1);
}
static inline void fp2_neg(fp2 *r, const fp2 *a) {
  fp_neg(&r->c0, &a->c0);
  fp_neg(&r->c1, &a->c1);
}
static inline void fp2_conj(fp2 *r, const fp2 *a) {
  r->c0 = a->c0;
  fp_neg(&r->c1, &a->c1);
}
// Lazy Karatsuba: three double-width products, ONE reduction per output
// coefficient (vs three in the reduce-every-fp_mul form).  c0 rides the
// p^2 offset (t1 < p^2, so t0 + p^2 - t1 stays in [0, 2p^2)); c1 uses
// the exact integer identity (sa*sb = t0 + t1 + cross), both < p*2^384.
static void fp2_mul(fp2 *r, const fp2 *a, const fp2 *b) {
  fp sa, sb;
  fp_add_nored(&sa, &a->c0, &a->c1);
  fp_add_nored(&sb, &b->c0, &b->c1);
  fpw t0, t1, m, w;
  mul_wide(&t0, &a->c0, &b->c0);
  mul_wide(&t1, &a->c1, &b->c1);
  mul_wide(&m, &sa, &sb);
  fp2 out;
  fpw_sub_pp2(&w, &t0, &t1);
  redc_wide(&out.c0, &w);
  fpw_sub(&w, &m, &t0);
  fpw_sub(&w, &w, &t1);
  redc_wide(&out.c1, &w);
  *r = out;
}
// (a0+a1)(a0-a1+p) = a0^2 - a1^2 + p(a0+a1): same residue, < 4p^2, and
// one wide product per coefficient.
static void fp2_sqr(fp2 *r, const fp2 *a) {
  fp s, d;
  fp_add_nored(&s, &a->c0, &a->c1);
  fp_sub_nored(&d, &a->c0, &a->c1);
  fpw w, m;
  fp2 out;
  mul_wide(&w, &s, &d);
  redc_wide(&out.c0, &w);
  mul_wide(&m, &a->c0, &a->c1);
  fpw_dbl(&m, &m);
  redc_wide(&out.c1, &m);
  *r = out;
}
static void fp2_mul_fp(fp2 *r, const fp2 *a, const fp *s) {
  fp_mul(&r->c0, &a->c0, s);
  fp_mul(&r->c1, &a->c1, s);
}
static void fp2_mul_small(fp2 *r, const fp2 *a, int k) {  // k in 1..13
  fp2 acc = *a;
  for (int i = 1; i < k; i++) fp2_add(&acc, &acc, a);
  *r = acc;
}
static void fp2_mul_xi(fp2 *r, const fp2 *a) {  // * (1+u)
  fp2 out;
  fp_sub(&out.c0, &a->c0, &a->c1);
  fp_add(&out.c1, &a->c0, &a->c1);
  *r = out;
}
static inline int fp2_is_zero(const fp2 *a) {
  return fp_is_zero(&a->c0) && fp_is_zero(&a->c1);
}
static inline int fp2_eq(const fp2 *a, const fp2 *b) {
  return fp_eq(&a->c0, &b->c0) && fp_eq(&a->c1, &b->c1);
}
static void fp2_inv(fp2 *r, const fp2 *a) {
  fp n, t, ninv;
  fp_sqr(&n, &a->c0);
  fp_sqr(&t, &a->c1);
  fp_add(&n, &n, &t);
  fp_inv(&ninv, &n);
  fp2 out;
  fp_mul(&out.c0, &a->c0, &ninv);
  fp nc1;
  fp_neg(&nc1, &a->c1);
  fp_mul(&out.c1, &nc1, &ninv);
  *r = out;
}
static void fp2_norm(fp *r, const fp2 *a) {
  fp t0, t1;
  fp_sqr(&t0, &a->c0);
  fp_sqr(&t1, &a->c1);
  fp_add(r, &t0, &t1);
}
static int fp2_is_square(const fp2 *a) {
  fp n;
  fp2_norm(&n, a);
  return fp_is_square(&n);
}
// golden fp.py fp2_sqrt (complex method, p = 3 mod 4)
static int fp2_sqrt(fp2 *r, const fp2 *a) {
  if (fp2_is_zero(a)) { *r = FP2_ZERO_C; return 1; }
  if (fp_is_zero(&a->c1)) {
    fp s;
    if (fp_sqrt(&s, &a->c0)) {
      r->c0 = s;
      r->c1 = BLS_ZERO;
      return 1;
    }
    fp na;
    fp_neg(&na, &a->c0);
    if (!fp_sqrt(&s, &na)) return 0;
    r->c0 = BLS_ZERO;
    r->c1 = s;
    return 1;
  }
  fp alpha, n;
  fp2_norm(&n, a);
  if (!fp_sqrt(&alpha, &n)) return 0;
  // inv2 = (p+1)/2 as field element: (1/2) mod p
  fp two = BLS_ONE_M, inv2;
  fp_add(&two, &two, &BLS_ONE_M);
  fp_inv(&inv2, &two);
  fp delta, x0;
  fp_add(&delta, &a->c0, &alpha);
  fp_mul(&delta, &delta, &inv2);
  if (!fp_sqrt(&x0, &delta)) {
    fp_sub(&delta, &a->c0, &alpha);
    fp_mul(&delta, &delta, &inv2);
    if (!fp_sqrt(&x0, &delta)) return 0;
  }
  fp x0i, x1;
  fp_inv(&x0i, &x0);
  fp_mul(&x1, &a->c1, &inv2);
  fp_mul(&x1, &x1, &x0i);
  fp2 cand = {x0, x1}, chk;
  fp2_sqr(&chk, &cand);
  if (!fp2_eq(&chk, a)) return 0;
  *r = cand;
  return 1;
}
static int fp2_sgn0(const fp2 *a) {  // RFC 9380 sgn0, m=2
  int s0 = fp_sgn0(&a->c0);
  int z0 = fp_is_zero(&a->c0);
  int s1 = fp_sgn0(&a->c1);
  return s0 | (z0 & s1);
}
static int fp2_gt_half(const fp2 *a) {  // ZCash lexicographic sign rule
  if (!fp_is_zero(&a->c1)) return fp_gt_half(&a->c1);
  return fp_gt_half(&a->c0);
}

// Double-width Fp2: a pair of unreduced 768-bit accumulators.  Tower
// formulas sum several of these and reduce ONCE per output coefficient.
// Bounds (units of p^2, budget p*2^384 ~ 9.8 p^2): fp2_mulw (2,2),
// fp2_mulw_fp (1,1), fp2_mulw_fp_xi (2,2) — so a three-term sum tops out
// at 6p^2, comfortably inside the redc_wide contract.
typedef struct { fpw c0, c1; } fp2w;

static void fp2_mulw(fp2w *w, const fp2 *a, const fp2 *b) {
  fp sa, sb;
  fp_add_nored(&sa, &a->c0, &a->c1);
  fp_add_nored(&sb, &b->c0, &b->c1);
  fpw t0, t1, m;
  mul_wide(&t0, &a->c0, &b->c0);
  mul_wide(&t1, &a->c1, &b->c1);
  mul_wide(&m, &sa, &sb);
  fpw_sub_pp2(&w->c0, &t0, &t1);
  fpw_sub(&m, &m, &t0);
  fpw_sub(&w->c1, &m, &t1);
}

static void fp2_mulw_fp(fp2w *w, const fp2 *a, const fp *s) {  // a * (s, 0)
  mul_wide(&w->c0, &a->c0, s);
  mul_wide(&w->c1, &a->c1, s);
}

// a * xi*(s, 0) = a * (s, s) = (s*(a0 - a1), s*(a0 + a1))
static void fp2_mulw_fp_xi(fp2w *w, const fp2 *a, const fp *s) {
  fp d, su;
  fp_sub_nored(&d, &a->c0, &a->c1);
  fp_add_nored(&su, &a->c0, &a->c1);
  mul_wide(&w->c0, &d, s);
  mul_wide(&w->c1, &su, s);
}

static inline void fp2w_add(fp2w *r, const fp2w *a) {
  fpw_add(&r->c0, &r->c0, &a->c0);
  fpw_add(&r->c1, &r->c1, &a->c1);
}

static inline void fp2w_redc(fp2 *r, const fp2w *w) {
  redc_wide(&r->c0, &w->c0);
  redc_wide(&r->c1, &w->c1);
}

// ---------------------------------------------------------------------------
// Fp6 = Fp2[v]/(v^3 - xi),  Fp12 = Fp6[w]/(w^2 - v)   (mirrors fp.py)
// ---------------------------------------------------------------------------

typedef struct { fp2 a0, a1, a2; } fp6;
typedef struct { fp6 b0, b1; } fp12;

static void fp6_add(fp6 *r, const fp6 *a, const fp6 *b) {
  fp2_add(&r->a0, &a->a0, &b->a0);
  fp2_add(&r->a1, &a->a1, &b->a1);
  fp2_add(&r->a2, &a->a2, &b->a2);
}
static void fp6_sub(fp6 *r, const fp6 *a, const fp6 *b) {
  fp2_sub(&r->a0, &a->a0, &b->a0);
  fp2_sub(&r->a1, &a->a1, &b->a1);
  fp2_sub(&r->a2, &a->a2, &b->a2);
}
static void fp6_neg(fp6 *r, const fp6 *a) {
  fp2_neg(&r->a0, &a->a0);
  fp2_neg(&r->a1, &a->a1);
  fp2_neg(&r->a2, &a->a2);
}
static void fp6_mul(fp6 *r, const fp6 *a, const fp6 *b) {
  fp2 s1, s2, m, x;
  // c0 = a0 b0 + xi((a1+a2)(b1+b2) - t1 - t2)
  fp2 p0, p1, p2;
  fp2_mul(&p0, &a->a0, &b->a0);
  fp2_mul(&p1, &a->a1, &b->a1);
  fp2_mul(&p2, &a->a2, &b->a2);
  fp6 out;
  fp2_add(&s1, &a->a1, &a->a2);
  fp2_add(&s2, &b->a1, &b->a2);
  fp2_mul(&m, &s1, &s2);
  fp2_sub(&m, &m, &p1);
  fp2_sub(&m, &m, &p2);
  fp2_mul_xi(&x, &m);
  fp2_add(&out.a0, &p0, &x);
  // c1 = (a0+a1)(b0+b1) - p0 - p1 + xi p2
  fp2_add(&s1, &a->a0, &a->a1);
  fp2_add(&s2, &b->a0, &b->a1);
  fp2_mul(&m, &s1, &s2);
  fp2_sub(&m, &m, &p0);
  fp2_sub(&m, &m, &p1);
  fp2_mul_xi(&x, &p2);
  fp2_add(&out.a1, &m, &x);
  // c2 = (a0+a2)(b0+b2) - p0 - p2 + p1
  fp2_add(&s1, &a->a0, &a->a2);
  fp2_add(&s2, &b->a0, &b->a2);
  fp2_mul(&m, &s1, &s2);
  fp2_sub(&m, &m, &p0);
  fp2_sub(&m, &m, &p2);
  fp2_add(&out.a2, &m, &p1);
  *r = out;
}
static void fp6_sqr(fp6 *r, const fp6 *a) { fp6_mul(r, a, a); }
static void fp6_mul_by_v(fp6 *r, const fp6 *a) {
  fp6 out;
  fp2_mul_xi(&out.a0, &a->a2);
  out.a1 = a->a0;
  out.a2 = a->a1;
  *r = out;
}
static void fp6_mul_fp2(fp6 *r, const fp6 *a, const fp2 *s) {
  fp2_mul(&r->a0, &a->a0, s);
  fp2_mul(&r->a1, &a->a1, s);
  fp2_mul(&r->a2, &a->a2, s);
}
static void fp6_inv(fp6 *r, const fp6 *a) {
  fp2 t0, t1, t2, t3, t4, t5, c0, c1, c2, det, di, x;
  fp2_sqr(&t0, &a->a0);
  fp2_sqr(&t1, &a->a1);
  fp2_sqr(&t2, &a->a2);
  fp2_mul(&t3, &a->a0, &a->a1);
  fp2_mul(&t4, &a->a0, &a->a2);
  fp2_mul(&t5, &a->a1, &a->a2);
  fp2_mul_xi(&x, &t5);
  fp2_sub(&c0, &t0, &x);
  fp2_mul_xi(&x, &t2);
  fp2_sub(&c1, &x, &t3);
  fp2_sub(&c2, &t1, &t4);
  fp2 m1, m2, s;
  fp2_mul(&m1, &a->a2, &c1);
  fp2_mul(&m2, &a->a1, &c2);
  fp2_add(&s, &m1, &m2);
  fp2_mul_xi(&x, &s);
  fp2_mul(&m1, &a->a0, &c0);
  fp2_add(&det, &m1, &x);
  fp2_inv(&di, &det);
  fp2_mul(&r->a0, &c0, &di);
  fp2_mul(&r->a1, &c1, &di);
  fp2_mul(&r->a2, &c2, &di);
}

static void fp12_mul(fp12 *r, const fp12 *a, const fp12 *b) {
  fp6 t0, t1, s1, s2, m, v;
  fp6_mul(&t0, &a->b0, &b->b0);
  fp6_mul(&t1, &a->b1, &b->b1);
  fp12 out;
  fp6_mul_by_v(&v, &t1);
  fp6_add(&out.b0, &t0, &v);
  fp6_add(&s1, &a->b0, &a->b1);
  fp6_add(&s2, &b->b0, &b->b1);
  fp6_mul(&m, &s1, &s2);
  fp6_sub(&m, &m, &t0);
  fp6_sub(&out.b1, &m, &t1);
  *r = out;
}
static void fp12_sqr(fp12 *r, const fp12 *a) {
  fp6 t, s1, s2, m, v;
  fp6_mul(&t, &a->b0, &a->b1);
  fp6_add(&s1, &a->b0, &a->b1);
  fp6_mul_by_v(&v, &a->b1);
  fp6_add(&s2, &a->b0, &v);
  fp6_mul(&m, &s1, &s2);
  fp6_sub(&m, &m, &t);
  fp6_mul_by_v(&v, &t);
  fp12 out;
  fp6_sub(&out.b0, &m, &v);
  fp6_add(&out.b1, &t, &t);
  *r = out;
}
static void fp12_conj(fp12 *r, const fp12 *a) {
  r->b0 = a->b0;
  fp6_neg(&r->b1, &a->b1);
}
static void fp12_inv(fp12 *r, const fp12 *a) {
  fp6 s0, s1, det, di, v;
  fp6_sqr(&s0, &a->b0);
  fp6_sqr(&s1, &a->b1);
  fp6_mul_by_v(&v, &s1);
  fp6_sub(&det, &s0, &v);
  fp6_inv(&di, &det);
  fp6_mul(&r->b0, &a->b0, &di);
  fp6 m;
  fp6_mul(&m, &a->b1, &di);
  fp6_neg(&r->b1, &m);
}
static void fp6_frob(fp6 *r, const fp6 *a) {
  fp6 out;
  fp2_conj(&out.a0, &a->a0);
  fp2 c;
  fp2_conj(&c, &a->a1);
  fp2_mul(&out.a1, &c, &BLS_FROB_G2);
  fp2_conj(&c, &a->a2);
  fp2_mul(&out.a2, &c, &BLS_FROB_G4);
  *r = out;
}
static void fp12_frob(fp12 *r, const fp12 *a) {
  fp12 out;
  fp6_frob(&out.b0, &a->b0);
  fp6 f;
  fp6_frob(&f, &a->b1);
  fp6_mul_fp2(&out.b1, &f, &BLS_FROB_G1);
  *r = out;
}
static void fp12_frob_n(fp12 *r, const fp12 *a, int n) {
  fp12 t = *a;
  for (int i = 0; i < n; i++) fp12_frob(&t, &t);
  *r = t;
}

static void fp12_one(fp12 *r) {
  memset(r, 0, sizeof(*r));
  r->b0.a0.c0 = BLS_ONE_M;
}
static int fp12_is_one(const fp12 *a) {
  fp12 one;
  fp12_one(&one);
  return memcmp(a, &one, sizeof(one)) == 0;
}

// ---------------------------------------------------------------------------
// Curve points (Jacobian, a = 0), G1 over Fp and G2 over Fp2
// (mirrors golden curve.py; generic via macros over the field type)
// ---------------------------------------------------------------------------

typedef struct { fp x, y, z; } g1p;
typedef struct { fp2 x, y, z; } g2p;

#define DEF_POINT_OPS(NAME, PT, FE, F_ADD, F_SUB, F_NEG, F_MUL, F_SQR,        \
                      F_ISZ, F_EQ)                                            \
  static int NAME##_is_inf(const PT *p) { return F_ISZ(&p->z); }              \
  static void NAME##_dbl(PT *r, const PT *p) {                                \
    if (F_ISZ(&p->z)) { *r = *p; return; }                                    \
    FE a, b, c, d, e, f, t, x3, y3, z3, c8;                                   \
    F_SQR(&a, &p->x);                                                         \
    F_SQR(&b, &p->y);                                                         \
    F_SQR(&c, &b);                                                            \
    F_ADD(&t, &p->x, &b);                                                     \
    F_SQR(&d, &t);                                                            \
    F_SUB(&d, &d, &a);                                                        \
    F_SUB(&d, &d, &c);                                                        \
    F_ADD(&d, &d, &d);                                                        \
    F_ADD(&e, &a, &a);                                                        \
    F_ADD(&e, &e, &a);                                                        \
    F_SQR(&f, &e);                                                            \
    F_ADD(&t, &d, &d);                                                        \
    F_SUB(&x3, &f, &t);                                                       \
    F_ADD(&c8, &c, &c);                                                       \
    F_ADD(&c8, &c8, &c8);                                                     \
    F_ADD(&c8, &c8, &c8);                                                     \
    F_SUB(&t, &d, &x3);                                                       \
    F_MUL(&y3, &e, &t);                                                       \
    F_SUB(&y3, &y3, &c8);                                                     \
    F_MUL(&t, &p->y, &p->z);                                                  \
    F_ADD(&z3, &t, &t);                                                       \
    r->x = x3; r->y = y3; r->z = z3;                                          \
  }                                                                           \
  static void NAME##_add(PT *r, const PT *p1, const PT *p2) {                 \
    if (F_ISZ(&p1->z)) { *r = *p2; return; }                                  \
    if (F_ISZ(&p2->z)) { *r = *p1; return; }                                  \
    FE z1z1, z2z2, u1, u2, s1, s2, t, h, i, j, rr, v, x3, y3, z3;             \
    F_SQR(&z1z1, &p1->z);                                                     \
    F_SQR(&z2z2, &p2->z);                                                     \
    F_MUL(&u1, &p1->x, &z2z2);                                                \
    F_MUL(&u2, &p2->x, &z1z1);                                                \
    F_MUL(&t, &p1->y, &p2->z);                                                \
    F_MUL(&s1, &t, &z2z2);                                                    \
    F_MUL(&t, &p2->y, &p1->z);                                                \
    F_MUL(&s2, &t, &z1z1);                                                    \
    if (F_EQ(&u1, &u2)) {                                                     \
      if (F_EQ(&s1, &s2)) { NAME##_dbl(r, p1); return; }                      \
      memset(r, 0, sizeof(*r));                                               \
      return;                                                                 \
    }                                                                         \
    F_SUB(&h, &u2, &u1);                                                      \
    F_ADD(&t, &h, &h);                                                        \
    F_SQR(&i, &t);                                                            \
    F_MUL(&j, &h, &i);                                                        \
    F_SUB(&rr, &s2, &s1);                                                     \
    F_ADD(&rr, &rr, &rr);                                                     \
    F_MUL(&v, &u1, &i);                                                       \
    F_SQR(&x3, &rr);                                                          \
    F_SUB(&x3, &x3, &j);                                                      \
    F_ADD(&t, &v, &v);                                                        \
    F_SUB(&x3, &x3, &t);                                                      \
    F_SUB(&t, &v, &x3);                                                       \
    F_MUL(&y3, &rr, &t);                                                      \
    F_MUL(&t, &s1, &j);                                                       \
    F_ADD(&t, &t, &t);                                                        \
    F_SUB(&y3, &y3, &t);                                                      \
    F_ADD(&t, &p1->z, &p2->z);                                                \
    F_SQR(&t, &t);                                                            \
    F_SUB(&t, &t, &z1z1);                                                     \
    F_SUB(&t, &t, &z2z2);                                                     \
    F_MUL(&z3, &t, &h);                                                       \
    r->x = x3; r->y = y3; r->z = z3;                                          \
  }                                                                           \
  static void NAME##_mul_u64(PT *r, const PT *p, uint64_t k) {                \
    PT acc; memset(&acc, 0, sizeof(acc));                                     \
    PT base = *p;                                                             \
    while (k) {                                                               \
      if (k & 1) NAME##_add(&acc, &acc, &base);                               \
      NAME##_dbl(&base, &base);                                               \
      k >>= 1;                                                                \
    }                                                                         \
    *r = acc;                                                                 \
  }

DEF_POINT_OPS(g1, g1p, fp, fp_add, fp_sub, fp_neg, fp_mul, fp_sqr,
              fp_is_zero, fp_eq)
DEF_POINT_OPS(g2, g2p, fp2, fp2_add, fp2_sub, fp2_neg, fp2_mul, fp2_sqr,
              fp2_is_zero, fp2_eq)

static void g1_neg(g1p *r, const g1p *p) {
  r->x = p->x;
  fp_neg(&r->y, &p->y);
  r->z = p->z;
}
static void g2_neg(g2p *r, const g2p *p) {
  r->x = p->x;
  fp2_neg(&r->y, &p->y);
  r->z = p->z;
}

static int g1_to_affine(fp *x, fp *y, const g1p *p) {
  if (g1_is_inf(p)) return 0;
  fp zi, zi2, zi3;
  fp_inv(&zi, &p->z);
  fp_sqr(&zi2, &zi);
  fp_mul(&zi3, &zi2, &zi);
  fp_mul(x, &p->x, &zi2);
  fp_mul(y, &p->y, &zi3);
  return 1;
}
static int g2_to_affine(fp2 *x, fp2 *y, const g2p *p) {
  if (g2_is_inf(p)) return 0;
  fp2 zi, zi2, zi3;
  fp2_inv(&zi, &p->z);
  fp2_sqr(&zi2, &zi);
  fp2_mul(&zi3, &zi2, &zi);
  fp2_mul(x, &p->x, &zi2);
  fp2_mul(y, &p->y, &zi3);
  return 1;
}

// mul by 256-bit scalar (be bytes), variable base
static void g2_mul_be(g2p *r, const g2p *p, const uint8_t *be, int len) {
  g2p acc;
  memset(&acc, 0, sizeof(acc));
  for (int i = 0; i < len; i++) {
    for (int b = 7; b >= 0; b--) {
      g2_dbl(&acc, &acc);
      if ((be[i] >> b) & 1) g2_add(&acc, &acc, p);
    }
  }
  *r = acc;
}

// psi endomorphism (golden curve.py g2_psi)
static void g2_psi(g2p *r, const g2p *p) {
  fp2 cx, cy, cz;
  fp2_conj(&cx, &p->x);
  fp2_conj(&cy, &p->y);
  fp2_conj(&cz, &p->z);
  fp2_mul(&r->x, &cx, &BLS_PSI_X);
  fp2_mul(&r->y, &cy, &BLS_PSI_Y);
  r->z = cz;
}

static int g2_eq_points(const g2p *a, const g2p *b) {
  int ia = g2_is_inf(a), ib = g2_is_inf(b);
  if (ia || ib) return ia && ib;
  fp2 za2, zb2, t1, t2, za3, zb3;
  fp2_sqr(&za2, &a->z);
  fp2_sqr(&zb2, &b->z);
  fp2_mul(&t1, &a->x, &zb2);
  fp2_mul(&t2, &b->x, &za2);
  if (!fp2_eq(&t1, &t2)) return 0;
  fp2_mul(&za3, &za2, &a->z);
  fp2_mul(&zb3, &zb2, &b->z);
  fp2_mul(&t1, &a->y, &zb3);
  fp2_mul(&t2, &b->y, &za3);
  return fp2_eq(&t1, &t2);
}

// [k]P for 64-bit k with sign handling for the negative BLS parameter:
// returns [x]P where x = -|x|.
static void g2_mul_x(g2p *r, const g2p *p) {
  g2p t;
  g2_mul_u64(&t, p, BLS_X_ABS);
  g2_neg(r, &t);
}

static int g2_in_subgroup(const g2p *p) {  // psi(Q) == [x]Q
  if (g2_is_inf(p)) return 1;
  g2p lhs, rhs;
  g2_psi(&lhs, p);
  g2_mul_x(&rhs, p);
  return g2_eq_points(&lhs, &rhs);
}

// BP cofactor clearing (golden curve.py g2_clear_cofactor):
// [x^2-x-1]Q + [x-1]psi(Q) + psi^2(2Q)
static void g2_clear_cofactor(g2p *r, const g2p *q) {
  g2p xq, x2q, t, p1, p2, nq, nxq;
  g2_mul_x(&xq, q);
  g2_mul_x(&x2q, &xq);
  g2_neg(&nxq, &xq);
  g2_add(&t, &x2q, &nxq);      // [x^2 - x]Q
  g2_neg(&nq, q);
  g2_add(&t, &t, &nq);         // [x^2 - x - 1]Q
  g2_add(&p1, &xq, &nq);       // [x - 1]Q
  g2_psi(&p1, &p1);
  g2p dq;
  g2_dbl(&dq, q);
  g2_psi(&p2, &dq);
  g2_psi(&p2, &p2);
  g2_add(&t, &t, &p1);
  g2_add(r, &t, &p2);
}

// G1 effective cofactor (1 - x) = 1 + |x|
static void g1_clear_cofactor(g1p *r, const g1p *p) {
  g1p t;
  g1_mul_u64(&t, p, BLS_X_ABS);
  g1_add(r, &t, p);
}

// G1 subgroup check via GLV endomorphism phi(x,y) = (beta x, y):
// in-subgroup iff phi(P) == [lambda]P with lambda = x^2 - 1 (derived and
// convention-checked at init against [r]P == inf on the generator side).
static fp G1_BETA;        // cube root of unity (mont)
static int g1_endo_ready = 0;

static void g1_endo_init(void) {
  // beta = xi_fp^((p-1)/3)? Derive instead from x: beta is a nontrivial
  // cube root of 1: find via 2^((p-1)/3) style search on small bases.
  fp base = BLS_ONE_M;  // start from 2
  fp two;
  fp_add(&two, &BLS_ONE_M, &BLS_ONE_M);
  base = two;
  // exponent (p-1)/3
  uint64_t e[6];
  uint64_t pm1[6];
  u128 borrow = 0;
  for (int i = 0; i < 6; i++) {
    u128 d = (u128)BLS_MOD.l[i] - ((i == 0) ? 1 : 0) - borrow;
    pm1[i] = (uint64_t)d;
    borrow = (d >> 64) ? 1 : 0;
  }
  // divide pm1 by 3 (exact)
  u128 rem = 0;
  for (int i = 5; i >= 0; i--) {
    u128 cur = (rem << 64) | pm1[i];
    e[i] = (uint64_t)(cur / 3);
    rem = cur % 3;
  }
  for (int tries = 0; tries < 40; tries++) {
    fp cand;
    fp_pow_limbs(&cand, &base, e);
    if (!fp_eq(&cand, &BLS_ONE_M)) {
      G1_BETA = cand;
      g1_endo_ready = 1;
      return;
    }
    fp_add(&base, &base, &BLS_ONE_M);
  }
}

static int g1_in_subgroup(const g1p *p) {
  if (g1_is_inf(p)) return 1;
  // phi(P) = (beta x, y); check phi(P) == [x^2-1]P  (lambda = x^2 - 1)
  // [x^2]P = [|x|]([|x|]P) since (-x)(-x) = x^2
  g1p xp, x2p, lam, phi;
  g1_mul_u64(&xp, p, BLS_X_ABS);
  g1_mul_u64(&x2p, &xp, BLS_X_ABS);
  g1p np;
  g1_neg(&np, p);
  g1_add(&lam, &x2p, &np);  // [x^2 - 1]P
  phi = *p;
  fp_mul(&phi.x, &phi.x, &G1_BETA);
  // compare
  int ia = g1_is_inf(&phi), ib = g1_is_inf(&lam);
  if (ia || ib) return ia && ib;
  fp za2, zb2, t1, t2, za3, zb3;
  fp_sqr(&za2, &phi.z);
  fp_sqr(&zb2, &lam.z);
  fp_mul(&t1, &phi.x, &zb2);
  fp_mul(&t2, &lam.x, &za2);
  if (!fp_eq(&t1, &t2)) {
    // beta has two nontrivial cube roots; the other one pairs with
    // lambda' = -x^2: check phi'(P) = (beta^2 x, y)
    g1p phi2 = *p;
    fp b2;
    fp_sqr(&b2, &G1_BETA);
    fp_mul(&phi2.x, &phi2.x, &b2);
    fp_sqr(&za2, &phi2.z);
    fp_mul(&t1, &phi2.x, &zb2);
    if (!fp_eq(&t1, &t2)) return 0;
    fp_mul(&za3, &za2, &phi2.z);
    fp_mul(&zb3, &zb2, &lam.z);
    fp_mul(&t1, &phi2.y, &zb3);
    fp_mul(&t2, &lam.y, &za3);
    return fp_eq(&t1, &t2);
  }
  fp_mul(&za3, &za2, &phi.z);
  fp_mul(&zb3, &zb2, &lam.z);
  fp_mul(&t1, &phi.y, &zb3);
  fp_mul(&t2, &lam.y, &za3);
  return fp_eq(&t1, &t2);
}

// ---------------------------------------------------------------------------
// Compressed deserialization (ZCash flags; golden curve.py:345-429)
// ---------------------------------------------------------------------------

static int g1_from_bytes(g1p *r, const uint8_t b[48]) {
  uint8_t flags = b[0];
  if (!(flags & 0x80)) return 0;
  if (flags & 0x40) { memset(r, 0, sizeof(*r)); return 1; }
  uint8_t xb[48];
  memcpy(xb, b, 48);
  xb[0] &= 0x1F;
  fp x;
  if (!fp_from_be48(&x, xb)) return 0;
  fp y2, t;
  fp_sqr(&t, &x);
  fp_mul(&y2, &t, &x);
  fp_add(&y2, &y2, &BLS_B_G1);
  fp y;
  if (!fp_sqrt(&y, &y2)) return 0;
  int big = fp_gt_half(&y);
  if (((flags >> 5) & 1) != big) fp_neg(&y, &y);
  r->x = x;
  r->y = y;
  r->z = BLS_ONE_M;
  return 1;
}

static int g2_from_bytes(g2p *r, const uint8_t b[96]) {
  uint8_t flags = b[0];
  if (!(flags & 0x80)) return 0;
  if (flags & 0x40) { memset(r, 0, sizeof(*r)); return 1; }
  uint8_t x1b[48];
  memcpy(x1b, b, 48);
  x1b[0] &= 0x1F;
  fp x1, x0;
  if (!fp_from_be48(&x1, x1b)) return 0;
  if (!fp_from_be48(&x0, b + 48)) return 0;
  fp2 x = {x0, x1};
  fp2 y2, t;
  fp2_sqr(&t, &x);
  fp2_mul(&y2, &t, &x);
  fp2_add(&y2, &y2, &BLS_B_G2);
  fp2 y;
  if (!fp2_sqrt(&y, &y2)) return 0;
  int big = fp2_gt_half(&y);
  if (((flags >> 5) & 1) != big) fp2_neg(&y, &y);
  r->x = x;
  r->y = y;
  r->z.c0 = BLS_ONE_M;
  r->z.c1 = BLS_ZERO;
  return 1;
}

static void g1_to_bytes(uint8_t out[48], const g1p *p) {
  if (g1_is_inf(p)) {
    memset(out, 0, 48);
    out[0] = 0xC0;
    return;
  }
  fp x, y;
  g1_to_affine(&x, &y, p);
  fp_to_be48(out, &x);
  out[0] |= 0x80;
  if (fp_gt_half(&y)) out[0] |= 0x20;
}

static void g2_to_bytes(uint8_t out[96], const g2p *p) {
  if (g2_is_inf(p)) {
    memset(out, 0, 96);
    out[0] = 0xC0;
    return;
  }
  fp2 x, y;
  g2_to_affine(&x, &y, p);
  fp_to_be48(out, &x.c1);
  fp_to_be48(out + 48, &x.c0);
  out[0] |= 0x80;
  if (fp2_gt_half(&y)) out[0] |= 0x20;
}

// ---------------------------------------------------------------------------
// SHA-256 (for expand_message_xmd + digesting)
// ---------------------------------------------------------------------------

typedef struct {
  uint32_t h[8];
  uint64_t len;
  uint8_t buf[64];
  int fill;
} sha256_ctx;

static const uint32_t SHA_K[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};

static inline uint32_t ror(uint32_t x, int n) { return (x >> n) | (x << (32 - n)); }

static void sha_block(sha256_ctx *c, const uint8_t *p) {
  uint32_t w[64];
  for (int i = 0; i < 16; i++)
    w[i] = ((uint32_t)p[4 * i] << 24) | ((uint32_t)p[4 * i + 1] << 16) |
           ((uint32_t)p[4 * i + 2] << 8) | p[4 * i + 3];
  for (int i = 16; i < 64; i++) {
    uint32_t s0 = ror(w[i - 15], 7) ^ ror(w[i - 15], 18) ^ (w[i - 15] >> 3);
    uint32_t s1 = ror(w[i - 2], 17) ^ ror(w[i - 2], 19) ^ (w[i - 2] >> 10);
    w[i] = w[i - 16] + s0 + w[i - 7] + s1;
  }
  uint32_t a = c->h[0], b = c->h[1], cc = c->h[2], d = c->h[3], e = c->h[4],
           f = c->h[5], g = c->h[6], h = c->h[7];
  for (int i = 0; i < 64; i++) {
    uint32_t S1 = ror(e, 6) ^ ror(e, 11) ^ ror(e, 25);
    uint32_t ch = (e & f) ^ (~e & g);
    uint32_t t1 = h + S1 + ch + SHA_K[i] + w[i];
    uint32_t S0 = ror(a, 2) ^ ror(a, 13) ^ ror(a, 22);
    uint32_t mj = (a & b) ^ (a & cc) ^ (b & cc);
    uint32_t t2 = S0 + mj;
    h = g; g = f; f = e; e = d + t1;
    d = cc; cc = b; b = a; a = t1 + t2;
  }
  c->h[0] += a; c->h[1] += b; c->h[2] += cc; c->h[3] += d;
  c->h[4] += e; c->h[5] += f; c->h[6] += g; c->h[7] += h;
}

static void sha_init(sha256_ctx *c) {
  static const uint32_t iv[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372,
                                 0xa54ff53a, 0x510e527f, 0x9b05688c,
                                 0x1f83d9ab, 0x5be0cd19};
  memcpy(c->h, iv, sizeof(iv));
  c->len = 0;
  c->fill = 0;
}
static void sha_update(sha256_ctx *c, const uint8_t *p, size_t n) {
  c->len += n;
  while (n) {
    size_t take = 64 - c->fill;
    if (take > n) take = n;
    memcpy(c->buf + c->fill, p, take);
    c->fill += (int)take;
    p += take;
    n -= take;
    if (c->fill == 64) {
      sha_block(c, c->buf);
      c->fill = 0;
    }
  }
}
static void sha_final(sha256_ctx *c, uint8_t out[32]) {
  uint64_t bits = c->len * 8;
  uint8_t pad = 0x80;
  sha_update(c, &pad, 1);
  uint8_t z = 0;
  while (c->fill != 56) sha_update(c, &z, 1);
  uint8_t lb[8];
  for (int i = 0; i < 8; i++) lb[i] = (uint8_t)(bits >> (56 - 8 * i));
  sha_update(c, lb, 8);
  for (int i = 0; i < 8; i++)
    for (int j = 0; j < 4; j++)
      out[4 * i + j] = (uint8_t)(c->h[i] >> (24 - 8 * j));
}

// ---------------------------------------------------------------------------
// expand_message_xmd + hash_to_field (RFC 9380; golden h2c.py)
// ---------------------------------------------------------------------------

static void expand_xmd(uint8_t *out, size_t len_out, const uint8_t *msg,
                       size_t msg_len, const uint8_t *dst, size_t dst_len) {
  uint8_t dstp[256];
  size_t dplen = dst_len;
  memcpy(dstp, dst, dst_len);
  dstp[dplen++] = (uint8_t)dst_len;
  int ell = (int)((len_out + 31) / 32);
  uint8_t b0[32], bi[32];
  sha256_ctx c;
  sha_init(&c);
  uint8_t zpad[64] = {0};
  sha_update(&c, zpad, 64);
  sha_update(&c, msg, msg_len);
  uint8_t lib[3] = {(uint8_t)(len_out >> 8), (uint8_t)len_out, 0};
  sha_update(&c, lib, 3);
  sha_update(&c, dstp, dplen);
  sha_final(&c, b0);
  sha_init(&c);
  sha_update(&c, b0, 32);
  uint8_t one = 1;
  sha_update(&c, &one, 1);
  sha_update(&c, dstp, dplen);
  sha_final(&c, bi);
  size_t off = 0;
  for (int i = 1;; i++) {
    size_t take = len_out - off;
    if (take > 32) take = 32;
    memcpy(out + off, bi, take);
    off += take;
    if (off >= len_out) break;
    uint8_t x[32];
    for (int j = 0; j < 32; j++) x[j] = b0[j] ^ bi[j];
    sha_init(&c);
    sha_update(&c, x, 32);
    uint8_t idx = (uint8_t)(i + 1);
    sha_update(&c, &idx, 1);
    sha_update(&c, dstp, dplen);
    sha_final(&c, bi);
  }
}

// 64-byte big-endian draw -> fp (Montgomery): value mod p
static void fp_from_be64_draw(fp *r, const uint8_t b[64]) {
  // split: hi = first 16 bytes, lo = last 48; value = hi*2^384 + lo
  // mont(value) = mont_mul(hi_plain, R3) + mont_mul(lo_plain, R2)
  // simpler: iterate bytes with r = r*256 + b (Horner) in plain domain via
  // Montgomery: keep acc in Montgomery, mul by 256_mont each step.
  fp acc = BLS_ZERO;
  fp mont256;
  fp v256 = {{256, 0, 0, 0, 0, 0}};
  fp_to_mont(&mont256, &v256);
  for (int i = 0; i < 64; i++) {
    fp_mul(&acc, &acc, &mont256);
    fp add = {{b[i], 0, 0, 0, 0, 0}};
    fp addm;
    fp_to_mont(&addm, &add);
    fp_add(&acc, &acc, &addm);
  }
  *r = acc;
}

// ---------------------------------------------------------------------------
// SSWU + isogenies (golden h2c.py)
// ---------------------------------------------------------------------------

static void sswu_fp2(fp2 *xo, fp2 *yo, const fp2 *u) {
  fp2 u2, zu2, tv1, tv2, x1, gx1, t, ai, bi;
  fp2_sqr(&u2, u);
  fp2_mul(&zu2, &SSWU2_Z, &u2);
  fp2_sqr(&tv1, &zu2);
  fp2_add(&tv2, &tv1, &zu2);
  if (fp2_is_zero(&tv2)) {
    fp2 za;
    fp2_mul(&za, &SSWU2_Z, &SSWU2_A);
    fp2_inv(&t, &za);
    fp2_mul(&x1, &SSWU2_B, &t);
  } else {
    fp2_inv(&ai, &SSWU2_A);
    fp2_mul(&bi, &SSWU2_B, &ai);
    fp2_neg(&bi, &bi);  // -B/A
    fp2 one = {BLS_ONE_M, BLS_ZERO};
    fp2_inv(&t, &tv2);
    fp2_add(&t, &t, &one);
    fp2_mul(&x1, &bi, &t);
  }
  fp2 x = x1;
  fp2_sqr(&t, &x);
  fp2_mul(&gx1, &t, &x);
  fp2_mul(&t, &SSWU2_A, &x);
  fp2_add(&gx1, &gx1, &t);
  fp2_add(&gx1, &gx1, &SSWU2_B);
  fp2 y;
  if (!fp2_sqrt(&y, &gx1)) {
    fp2_mul(&x, &zu2, &x1);
    fp2 gx2;
    fp2_sqr(&t, &x);
    fp2_mul(&gx2, &t, &x);
    fp2_mul(&t, &SSWU2_A, &x);
    fp2_add(&gx2, &gx2, &t);
    fp2_add(&gx2, &gx2, &SSWU2_B);
    fp2_sqrt(&y, &gx2);
  }
  if (fp2_sgn0(u) != fp2_sgn0(&y)) fp2_neg(&y, &y);
  *xo = x;
  *yo = y;
}

static void sswu_fp(fp *xo, fp *yo, const fp *u) {
  fp u2, zu2, tv1, tv2, x1, gx1, t, ai, bi;
  fp_sqr(&u2, u);
  fp_mul(&zu2, &SSWU1_Z, &u2);
  fp_sqr(&tv1, &zu2);
  fp_add(&tv2, &tv1, &zu2);
  if (fp_is_zero(&tv2)) {
    fp za;
    fp_mul(&za, &SSWU1_Z, &SSWU1_A);
    fp_inv(&t, &za);
    fp_mul(&x1, &SSWU1_B, &t);
  } else {
    fp_inv(&ai, &SSWU1_A);
    fp_mul(&bi, &SSWU1_B, &ai);
    fp_neg(&bi, &bi);
    fp_inv(&t, &tv2);
    fp_add(&t, &t, &BLS_ONE_M);
    fp_mul(&x1, &bi, &t);
  }
  fp x = x1;
  fp_sqr(&t, &x);
  fp_mul(&gx1, &t, &x);
  fp_mul(&t, &SSWU1_A, &x);
  fp_add(&gx1, &gx1, &t);
  fp_add(&gx1, &gx1, &SSWU1_B);
  fp y;
  if (!fp_sqrt(&y, &gx1)) {
    fp_mul(&x, &zu2, &x1);
    fp gx2;
    fp_sqr(&t, &x);
    fp_mul(&gx2, &t, &x);
    fp_mul(&t, &SSWU1_A, &x);
    fp_add(&gx2, &gx2, &t);
    fp_add(&gx2, &gx2, &SSWU1_B);
    fp_sqrt(&y, &gx2);
  }
  if (fp_sgn0(u) != fp_sgn0(&y)) fp_neg(&y, &y);
  *xo = x;
  *yo = y;
}

// affine addition on E': y^2 = x^3 + A x + B (general a)
static int aff_add_fp2(fp2 *xo, fp2 *yo, const fp2 *x1, const fp2 *y1,
                       const fp2 *x2, const fp2 *y2, const fp2 *a) {
  fp2 lam, t, d;
  if (fp2_eq(x1, x2)) {
    fp2 ys;
    fp2_add(&ys, y1, y2);
    if (fp2_is_zero(&ys)) return 0;  // infinity
    fp2_sqr(&t, x1);
    fp2_mul_small(&t, &t, 3);
    fp2_add(&t, &t, a);
    fp2_add(&d, y1, y1);
    fp2_inv(&d, &d);
    fp2_mul(&lam, &t, &d);
  } else {
    fp2_sub(&t, y2, y1);
    fp2_sub(&d, x2, x1);
    fp2_inv(&d, &d);
    fp2_mul(&lam, &t, &d);
  }
  fp2 x3, y3;
  fp2_sqr(&x3, &lam);
  fp2_sub(&x3, &x3, x1);
  fp2_sub(&x3, &x3, x2);
  fp2_sub(&t, x1, &x3);
  fp2_mul(&y3, &lam, &t);
  fp2_sub(&y3, &y3, y1);
  *xo = x3;
  *yo = y3;
  return 1;
}

static int aff_add_fp(fp *xo, fp *yo, const fp *x1, const fp *y1, const fp *x2,
                      const fp *y2, const fp *a) {
  fp lam, t, d;
  if (fp_eq(x1, x2)) {
    fp ys;
    fp_add(&ys, y1, y2);
    if (fp_is_zero(&ys)) return 0;
    fp_sqr(&t, x1);
    fp three;
    fp_add(&three, &t, &t);
    fp_add(&t, &three, &t);
    fp_add(&t, &t, a);
    fp_add(&d, y1, y1);
    fp_inv(&d, &d);
    fp_mul(&lam, &t, &d);
  } else {
    fp_sub(&t, y2, y1);
    fp_sub(&d, x2, x1);
    fp_inv(&d, &d);
    fp_mul(&lam, &t, &d);
  }
  fp x3, y3;
  fp_sqr(&x3, &lam);
  fp_sub(&x3, &x3, x1);
  fp_sub(&x3, &x3, x2);
  fp_sub(&t, x1, &x3);
  fp_mul(&y3, &lam, &t);
  fp_sub(&y3, &y3, y1);
  *xo = x3;
  *yo = y3;
  return 1;
}

static void iso3_map(g2p *r, const fp2 *x, const fp2 *y, int inf) {
  if (inf) { memset(r, 0, sizeof(*r)); return; }
  fp2 d, di, di2, di3, X, Yf, t;
  fp2_sub(&d, x, &ISO3_X0);
  if (fp2_is_zero(&d)) { memset(r, 0, sizeof(*r)); return; }
  fp2_inv(&di, &d);
  fp2_sqr(&di2, &di);
  fp2_mul(&di3, &di2, &di);
  fp2_mul(&t, &ISO3_V, &di);
  fp2_add(&X, x, &t);
  fp2_mul(&t, &ISO3_W, &di2);
  fp2_add(&X, &X, &t);
  fp2 one = {BLS_ONE_M, BLS_ZERO};
  fp2_mul(&t, &ISO3_V, &di2);
  fp2_sub(&Yf, &one, &t);
  fp2 w2;
  fp2_add(&w2, &ISO3_W, &ISO3_W);
  fp2_mul(&t, &w2, &di3);
  fp2_sub(&Yf, &Yf, &t);
  fp2 Y;
  fp2_mul(&Y, y, &Yf);
  fp2_mul(&r->x, &ISO3_S2, &X);
  fp2_mul(&r->y, &ISO3_S3, &Y);
  r->z.c0 = BLS_ONE_M;
  r->z.c1 = BLS_ZERO;
}

static void horner_fp(fp *r, const fp *tab, int n, const fp *x) {
  fp acc = tab[n - 1];
  for (int i = n - 2; i >= 0; i--) {
    fp_mul(&acc, &acc, x);
    fp_add(&acc, &acc, &tab[i]);
  }
  *r = acc;
}

static void iso1_map(g1p *r, const fp *x, const fp *y, int inf) {
  if (inf) { memset(r, 0, sizeof(*r)); return; }
  fp xn, xd, yn, yd, t;
  horner_fp(&xn, ISO1_XN, ISO1_XN_LEN, x);
  horner_fp(&xd, ISO1_XD, ISO1_XD_LEN, x);
  horner_fp(&yn, ISO1_YN, ISO1_YN_LEN, x);
  horner_fp(&yd, ISO1_YD, ISO1_YD_LEN, x);
  if (fp_is_zero(&xd) || fp_is_zero(&yd)) { memset(r, 0, sizeof(*r)); return; }
  fp xdi, ydi;
  fp_inv(&xdi, &xd);
  fp_inv(&ydi, &yd);
  fp_mul(&r->x, &xn, &xdi);
  fp_mul(&t, y, &yn);
  fp_mul(&r->y, &t, &ydi);
  r->z = BLS_ONE_M;
}

static void hash_to_g2(g2p *r, const uint8_t *msg, size_t msg_len,
                       const uint8_t *dst, size_t dst_len) {
  uint8_t buf[256];
  expand_xmd(buf, 256, msg, msg_len, dst, dst_len);
  fp2 u0, u1;
  fp_from_be64_draw(&u0.c0, buf);
  fp_from_be64_draw(&u0.c1, buf + 64);
  fp_from_be64_draw(&u1.c0, buf + 128);
  fp_from_be64_draw(&u1.c1, buf + 192);
  fp2 x0, y0, x1, y1, xs, ys;
  sswu_fp2(&x0, &y0, &u0);
  sswu_fp2(&x1, &y1, &u1);
  g2p e;
  int ok = aff_add_fp2(&xs, &ys, &x0, &y0, &x1, &y1, &SSWU2_A);
  iso3_map(&e, &xs, &ys, !ok);
  g2_clear_cofactor(r, &e);
}

static void hash_to_g1(g1p *r, const uint8_t *msg, size_t msg_len,
                       const uint8_t *dst, size_t dst_len) {
  uint8_t buf[128];
  expand_xmd(buf, 128, msg, msg_len, dst, dst_len);
  fp u0, u1;
  fp_from_be64_draw(&u0, buf);
  fp_from_be64_draw(&u1, buf + 64);
  fp x0, y0, x1, y1, xs, ys;
  sswu_fp(&x0, &y0, &u0);
  sswu_fp(&x1, &y1, &u1);
  g1p e;
  int ok = aff_add_fp(&xs, &ys, &x0, &y0, &x1, &y1, &SSWU1_A);
  iso1_map(&e, &xs, &ys, !ok);
  g1_clear_cofactor(r, &e);
}

// ---------------------------------------------------------------------------
// Pairing (golden pairing.py: e(P,Q)^3, affine Miller, x-chain hard part)
// ---------------------------------------------------------------------------

typedef struct { fp2 x, y; } g2aff;
typedef struct { fp x, y; } g1aff;

// f *= L for the SPARSE Miller line L = (A + B v) + (C v) w with
// A = lam*xt - yt, B = -lam*xp, C = (yp, 0) — the only nonzero slots the
// affine line evaluation produces (b0.a0, b0.a1, b1.a1).  Expanding
// (a + b w)(l + m w) = (a l + b m v) + (a m + b l) w over fp6 = fp2[v]
// with v^3 = xi gives each output coefficient as a THREE-TERM sum of
// fp2 products; the lazy double-width lane accumulates all three and
// reduces once per coefficient (xi twists folded into canonical
// operands: Bx = xi*B, and the (s,s) form of xi*C):
//   F0 = f0 A + f2 Bx + xi f4 C     F3 = f3 A + f5 Bx + xi f2 C
//   F1 = f1 A + f0 B  + xi f5 C     F4 = f4 A + f3 B  + f0 C
//   F2 = f2 A + f1 B  + f3 C        F5 = f5 A + f4 B  + f1 C
// Exactly fp12_mul(f, dense(L)) mod p, canonicalized — bit-identical —
// at ~57% of the dense multiply's 64x64-product count.
static void fp12_mul_line(fp12 *f, const fp2 *A, const fp2 *B,
                          const fp *yp) {
  fp2 Bx;
  fp2_mul_xi(&Bx, B);
  const fp2 *f0 = &f->b0.a0, *f1 = &f->b0.a1, *f2 = &f->b0.a2;
  const fp2 *f3 = &f->b1.a0, *f4 = &f->b1.a1, *f5 = &f->b1.a2;
  fp2w acc, t;
  fp12 out;
  fp2_mulw(&acc, f0, A);
  fp2_mulw(&t, f2, &Bx);
  fp2w_add(&acc, &t);
  fp2_mulw_fp_xi(&t, f4, yp);
  fp2w_add(&acc, &t);
  fp2w_redc(&out.b0.a0, &acc);
  fp2_mulw(&acc, f1, A);
  fp2_mulw(&t, f0, B);
  fp2w_add(&acc, &t);
  fp2_mulw_fp_xi(&t, f5, yp);
  fp2w_add(&acc, &t);
  fp2w_redc(&out.b0.a1, &acc);
  fp2_mulw(&acc, f2, A);
  fp2_mulw(&t, f1, B);
  fp2w_add(&acc, &t);
  fp2_mulw_fp(&t, f3, yp);
  fp2w_add(&acc, &t);
  fp2w_redc(&out.b0.a2, &acc);
  fp2_mulw(&acc, f3, A);
  fp2_mulw(&t, f5, &Bx);
  fp2w_add(&acc, &t);
  fp2_mulw_fp_xi(&t, f2, yp);
  fp2w_add(&acc, &t);
  fp2w_redc(&out.b1.a0, &acc);
  fp2_mulw(&acc, f4, A);
  fp2_mulw(&t, f3, B);
  fp2w_add(&acc, &t);
  fp2_mulw_fp(&t, f0, yp);
  fp2w_add(&acc, &t);
  fp2w_redc(&out.b1.a1, &acc);
  fp2_mulw(&acc, f5, A);
  fp2_mulw(&t, f4, B);
  fp2w_add(&acc, &t);
  fp2_mulw_fp(&t, f1, yp);
  fp2w_add(&acc, &t);
  fp2w_redc(&out.b1.a2, &acc);
  *f = out;
}

// Fully general sparse line product: like fp12_mul_line but with the
// yp coefficient a full fp2 (the Jacobian ladder's lines carry a
// Z-dependent fp2 factor on every slot).  Same three-term lazy lanes,
// with the xi twist folded into canonical operands for the C terms too
// (Cx = xi*C); every product is (2,2)p^2 so each lane is <= 6p^2,
// within redc_wide's p*2^384 ~ 9.8p^2 budget.
static void fp12_mul_line_g(fp12 *f, const fp2 *A, const fp2 *B,
                            const fp2 *C) {
  fp2 Bx, Cx;
  fp2_mul_xi(&Bx, B);
  fp2_mul_xi(&Cx, C);
  const fp2 *f0 = &f->b0.a0, *f1 = &f->b0.a1, *f2 = &f->b0.a2;
  const fp2 *f3 = &f->b1.a0, *f4 = &f->b1.a1, *f5 = &f->b1.a2;
  fp2w acc, t;
  fp12 out;
  fp2_mulw(&acc, f0, A);
  fp2_mulw(&t, f2, &Bx);
  fp2w_add(&acc, &t);
  fp2_mulw(&t, f4, &Cx);
  fp2w_add(&acc, &t);
  fp2w_redc(&out.b0.a0, &acc);
  fp2_mulw(&acc, f1, A);
  fp2_mulw(&t, f0, B);
  fp2w_add(&acc, &t);
  fp2_mulw(&t, f5, &Cx);
  fp2w_add(&acc, &t);
  fp2w_redc(&out.b0.a1, &acc);
  fp2_mulw(&acc, f2, A);
  fp2_mulw(&t, f1, B);
  fp2w_add(&acc, &t);
  fp2_mulw(&t, f3, C);
  fp2w_add(&acc, &t);
  fp2w_redc(&out.b0.a2, &acc);
  fp2_mulw(&acc, f3, A);
  fp2_mulw(&t, f5, &Bx);
  fp2w_add(&acc, &t);
  fp2_mulw(&t, f2, &Cx);
  fp2w_add(&acc, &t);
  fp2w_redc(&out.b1.a0, &acc);
  fp2_mulw(&acc, f4, A);
  fp2_mulw(&t, f3, B);
  fp2w_add(&acc, &t);
  fp2_mulw(&t, f0, C);
  fp2w_add(&acc, &t);
  fp2w_redc(&out.b1.a1, &acc);
  fp2_mulw(&acc, f5, A);
  fp2_mulw(&t, f4, B);
  fp2w_add(&acc, &t);
  fp2_mulw(&t, f1, C);
  fp2w_add(&acc, &t);
  fp2w_redc(&out.b1.a2, &acc);
  *f = out;
}

// Per-step line coefficients (lam, pre-step T) — everything a line
// evaluation needs besides P's affine coordinates.  Recording them per
// fixed Q is the Miller-loop precomputation: for a group public key the
// whole G2 ladder (point arithmetic + per-step inversions) runs once per
// DistPublic instead of once per verify.
typedef struct { fp2 lam, xt, yt; } line_rec;

// steps with lambda precomputed (denominator already inverted); the
// _rec cores record (lam, pre-T) and advance T — shared verbatim by the
// live path and g2_prepare so both are bit-identical by construction.
static void dbl_step_rec(g2aff *t, line_rec *rec, const fp2 *dinv) {
  fp2 lam, num, x3, y3, s;
  fp2_sqr(&num, &t->x);
  fp2_mul_small(&num, &num, 3);
  fp2_mul(&lam, &num, dinv);
  fp2_sqr(&x3, &lam);
  fp2_add(&s, &t->x, &t->x);
  fp2_sub(&x3, &x3, &s);
  fp2_sub(&s, &t->x, &x3);
  fp2_mul(&y3, &lam, &s);
  fp2_sub(&y3, &y3, &t->y);
  rec->lam = lam;
  rec->xt = t->x;
  rec->yt = t->y;
  t->x = x3;
  t->y = y3;
}

static void add_step_rec(g2aff *t, const g2aff *q, line_rec *rec,
                         const fp2 *dinv) {
  fp2 lam, num, x3, y3, s;
  fp2_sub(&num, &t->y, &q->y);
  fp2_mul(&lam, &num, dinv);
  fp2_sqr(&x3, &lam);
  fp2_sub(&x3, &x3, &t->x);
  fp2_sub(&x3, &x3, &q->x);
  fp2_sub(&s, &t->x, &x3);
  fp2_mul(&y3, &lam, &s);
  fp2_sub(&y3, &y3, &t->y);
  rec->lam = lam;
  rec->xt = t->x;
  rec->yt = t->y;
  t->x = x3;
  t->y = y3;
}

// accumulate one recorded line into f: A = lam*xt - yt, B = -lam*xp,
// C = yp — then the lazy sparse product (fp12_mul_line)
static void miller_mul_line(fp12 *f, const line_rec *rec, const fp *xp,
                            const fp *yp) {
  fp2 A, B, t;
  fp2_mul(&t, &rec->lam, &rec->xt);
  fp2_sub(&A, &t, &rec->yt);
  fp2_neg(&B, &rec->lam);
  fp2_mul_fp(&B, &B, xp);
  fp12_mul_line(f, &A, &B, yp);
}

// 62 doublings + 5 additions for |x| = 0xd201000000010000
#define MILLER_STEPS 70

typedef struct {
  int n;
  line_rec steps[MILLER_STEPS];
} g2prep;

static void g2_prepare(g2prep *pre, const g2aff *q) {
  g2aff t = *q;
  int n = 0;
  int top = 63 - __builtin_clzll(BLS_X_ABS);
  for (int b = top - 1; b >= 0; b--) {
    fp2 den, dinv;
    fp2_add(&den, &t.y, &t.y);
    fp2_inv(&dinv, &den);
    dbl_step_rec(&t, &pre->steps[n++], &dinv);
    if ((BLS_X_ABS >> b) & 1) {
      fp2_sub(&den, &t.x, &q->x);
      fp2_inv(&dinv, &den);
      add_step_rec(&t, q, &pre->steps[n++], &dinv);
    }
  }
  pre->n = n;
}

// Inversion-free Miller steps on a Jacobian ladder (x = X/Z^2,
// y = Y/Z^3).  The affine tangent line at T evaluated at P is
//   l = (lam*xt - yt) - lam*xp + yp,   lam = 3*xt^2 / (2*yt);
// scaling l by the nonzero 2*Y*Z^3 clears every denominator:
//   l' = (3X^3 - 2Y^2) + (-3X^2*Z^2)*xp + (2Y*Z^3)*yp.
// A scalar c in Fp2* on a line only scales the final f by an Fp2
// element, and the final exponentiation kills it: c^(p^2-1) = 1, and
// (p^12-1)/r contains the factor p^6-1 = (p^2-1)(p^4+p^2+1), so
// c^((p^12-1)/r) = 1 and final_exp's output is bit-identical to the
// affine ladder's.  This trades the per-step Fermat-chain inversions
// (the dominant multi_miller cost) for a handful of fp2 muls.
// Point-update algebra is the same dbl-2009-l used by g2_dbl.
static void dbl_step_jac(g2p *t, fp2 *A, fp2 *B, fp2 *C) {
  fp2 a, b, c, d, e, f, s, zz, c8, x3, y3, z3;
  fp2_sqr(&a, &t->x);                    // X^2
  fp2_sqr(&b, &t->y);                    // Y^2
  fp2_sqr(&c, &b);                       // Y^4
  fp2_add(&s, &t->x, &b);
  fp2_sqr(&d, &s);
  fp2_sub(&d, &d, &a);
  fp2_sub(&d, &d, &c);
  fp2_add(&d, &d, &d);                   // 4*X*Y^2
  fp2_add(&e, &a, &a);
  fp2_add(&e, &e, &a);                   // 3*X^2
  fp2_sqr(&f, &e);
  fp2_add(&s, &d, &d);
  fp2_sub(&x3, &f, &s);                  // e^2 - 2d
  fp2_add(&c8, &c, &c);
  fp2_add(&c8, &c8, &c8);
  fp2_add(&c8, &c8, &c8);                // 8*Y^4
  fp2_sub(&s, &d, &x3);
  fp2_mul(&y3, &e, &s);
  fp2_sub(&y3, &y3, &c8);                // e*(d - x3) - 8*Y^4
  fp2_sqr(&zz, &t->z);                   // Z^2
  fp2_mul(&z3, &t->y, &t->z);
  fp2_add(&z3, &z3, &z3);                // 2*Y*Z
  fp2_mul(A, &e, &t->x);
  fp2_add(&s, &b, &b);
  fp2_sub(A, A, &s);                     // 3X^3 - 2Y^2
  fp2_mul(B, &e, &zz);
  fp2_neg(B, B);                         // -3X^2*Z^2   (coeff of xp)
  fp2_mul(C, &z3, &zz);                  // 2Y*Z^3      (coeff of yp)
  t->x = x3;
  t->y = y3;
  t->z = z3;
}

// Mixed addition T += Q (Q affine) with the chord line through T and Q
// scaled by Z_new = Z*h:  lam = rr/(Z*h) with rr = yq*Z^3 - Y and
// h = xq*Z^2 - X, so
//   l' = (rr*xq - Z_new*yq) + (-rr)*xp + Z_new*yp.
// Point-update algebra is madd (add-2007-bl with Z2 = 1).
static void add_step_jac(g2p *t, const g2aff *q, fp2 *A, fp2 *B, fp2 *C) {
  fp2 zz, zzz, u2, s2, h, rr, hh, hhh, v, s, x3, y3, z3;
  fp2_sqr(&zz, &t->z);
  fp2_mul(&zzz, &zz, &t->z);
  fp2_mul(&u2, &q->x, &zz);              // xq*Z^2
  fp2_mul(&s2, &q->y, &zzz);             // yq*Z^3
  fp2_sub(&h, &u2, &t->x);
  fp2_sub(&rr, &s2, &t->y);
  fp2_sqr(&hh, &h);
  fp2_mul(&hhh, &hh, &h);
  fp2_mul(&v, &t->x, &hh);
  fp2_sqr(&x3, &rr);
  fp2_sub(&x3, &x3, &hhh);
  fp2_sub(&x3, &x3, &v);
  fp2_sub(&x3, &x3, &v);                 // rr^2 - h^3 - 2*X*h^2
  fp2_sub(&s, &v, &x3);
  fp2_mul(&y3, &rr, &s);
  fp2_mul(&s, &t->y, &hhh);
  fp2_sub(&y3, &y3, &s);                 // rr*(v - x3) - Y*h^3
  fp2_mul(&z3, &t->z, &h);
  fp2_mul(A, &rr, &q->x);
  fp2_mul(&s, &z3, &q->y);
  fp2_sub(A, A, &s);                     // rr*xq - z3*yq
  fp2_neg(B, &rr);                       // -rr        (coeff of xp)
  *C = z3;                               // z3         (coeff of yp)
  t->x = x3;
  t->y = y3;
  t->z = z3;
}

// fold one Jacobian line into f: scale the xp/yp slots by P's affine
// coordinates, then the general lazy sparse product.
static void miller_mul_line_j(fp12 *f, const fp2 *A, const fp2 *B,
                              const fp2 *C, const fp *xp, const fp *yp) {
  fp2 Bs, Cs;
  fp2_mul_fp(&Bs, B, xp);
  fp2_mul_fp(&Cs, C, yp);
  fp12_mul_line_g(f, A, &Bs, &Cs);
}

static void multi_miller(fp12 *f_out, const g1aff *ps, const g2aff *qs,
                         int n) {
  g2p ts[4];
  for (int i = 0; i < n; i++) {
    ts[i].x = qs[i].x;
    ts[i].y = qs[i].y;
    memset(&ts[i].z, 0, sizeof(fp2));
    ts[i].z.c0 = BLS_ONE_M;
  }
  fp12 f;
  fp12_one(&f);
  fp2 A, B, C;
  // MSB-first over |x| bits, skipping the leading 1
  int top = 63 - __builtin_clzll(BLS_X_ABS);
  for (int b = top - 1; b >= 0; b--) {
    fp12_sqr(&f, &f);
    for (int i = 0; i < n; i++) {
      dbl_step_jac(&ts[i], &A, &B, &C);
      miller_mul_line_j(&f, &A, &B, &C, &ps[i].x, &ps[i].y);
    }
    if ((BLS_X_ABS >> b) & 1) {
      for (int i = 0; i < n; i++) {
        add_step_jac(&ts[i], &qs[i], &A, &B, &C);
        miller_mul_line_j(&f, &A, &B, &C, &ps[i].x, &ps[i].y);
      }
    }
  }
  fp12_conj(f_out, &f);  // x < 0
}

// multi_miller over PREPARED Q ladders: same pairing value (the
// recorded affine lines differ from the live Jacobian ones only by
// per-line Fp2* scalars, which final_exp kills — see dbl_step_jac),
// with zero G2 point arithmetic and zero inversions at verify time.
static void multi_miller_prepared(fp12 *f_out, const g1aff *ps,
                                  const g2prep *const *preps, int n) {
  fp12 f;
  fp12_one(&f);
  int idx[4] = {0, 0, 0, 0};
  int top = 63 - __builtin_clzll(BLS_X_ABS);
  for (int b = top - 1; b >= 0; b--) {
    fp12_sqr(&f, &f);
    for (int i = 0; i < n; i++)
      miller_mul_line(&f, &preps[i]->steps[idx[i]++], &ps[i].x, &ps[i].y);
    if ((BLS_X_ABS >> b) & 1) {
      for (int i = 0; i < n; i++)
        miller_mul_line(&f, &preps[i]->steps[idx[i]++], &ps[i].x, &ps[i].y);
    }
  }
  fp12_conj(f_out, &f);  // x < 0
}

// Granger-Scott cyclotomic squaring for UNITARY f (post-easy-part):
// three Fp4 squarings instead of a full fp12_sqr.  Slot/sign assignment
// verified against the golden model (see tools history) — pairs
// (c0,c4), (c3,c2), (c1,c5); even slots 3t-2c, odd slots 3t+2c, with
// xi on the c3 term.
static void fp4_sq(fp2 *A, fp2 *B, const fp2 *a, const fp2 *b) {
  fp2 a2, b2, s, x;
  fp2_sqr(&a2, a);
  fp2_sqr(&b2, b);
  fp2_mul_xi(&x, &b2);
  fp2_add(A, &a2, &x);
  fp2_add(&s, a, b);
  fp2_sqr(&s, &s);
  fp2_sub(&s, &s, &a2);
  fp2_sub(B, &s, &b2);  // 2ab
}

static void cyclo_sqr(fp12 *r, const fp12 *f) {
  const fp2 *c0 = &f->b0.a0, *c1 = &f->b0.a1, *c2 = &f->b0.a2;
  const fp2 *c3 = &f->b1.a0, *c4 = &f->b1.a1, *c5 = &f->b1.a2;
  fp2 t0, t1, t2, t3, t4, t5;
  fp4_sq(&t0, &t1, c0, c4);
  fp4_sq(&t2, &t3, c3, c2);
  fp4_sq(&t4, &t5, c1, c5);
  fp12 out;
#define THREE_M_TWO(dst, t, c)            \
  {                                       \
    fp2 th, tw;                           \
    fp2_add(&th, &(t), &(t));             \
    fp2_add(&th, &th, &(t));              \
    fp2_add(&tw, (c), (c));               \
    fp2_sub(&(dst), &th, &tw);            \
  }
#define THREE_P_TWO(dst, t, c)            \
  {                                       \
    fp2 th, tw;                           \
    fp2_add(&th, &(t), &(t));             \
    fp2_add(&th, &th, &(t));              \
    fp2_add(&tw, (c), (c));               \
    fp2_add(&(dst), &th, &tw);            \
  }
  THREE_M_TWO(out.b0.a0, t0, c0);
  THREE_M_TWO(out.b0.a1, t2, c1);
  THREE_M_TWO(out.b0.a2, t4, c2);
  fp2 xt5;
  fp2_mul_xi(&xt5, &t5);
  THREE_P_TWO(out.b1.a0, xt5, c3);
  THREE_P_TWO(out.b1.a1, t1, c4);
  THREE_P_TWO(out.b1.a2, t3, c5);
#undef THREE_M_TWO
#undef THREE_P_TWO
  *r = out;
}

static void pow_x(fp12 *r, const fp12 *f) {  // f^|x| then conj (unitary f)
  fp12 out;
  fp12_one(&out);
  int top = 63 - __builtin_clzll(BLS_X_ABS);
  for (int b = top; b >= 0; b--) {
    cyclo_sqr(&out, &out);
    if ((BLS_X_ABS >> b) & 1) fp12_mul(&out, &out, f);
  }
  fp12_conj(r, &out);
}

// Only called from poly_pow on the hard-part g[k], which are UNITARY
// (post-easy-part), so the squarings are cyclotomic (Granger-Scott) —
// same values as fp12_sqr on this domain, at a third of the cost.
static void pow_small(fp12 *r, const fp12 *f, int e) {
  int neg = e < 0;
  unsigned ue = (unsigned)(neg ? -e : e);
  fp12 out, base = *f;
  fp12_one(&out);
  while (ue) {
    if (ue & 1) fp12_mul(&out, &out, &base);
    if (ue >> 1) cyclo_sqr(&base, &base);
    ue >>= 1;
  }
  if (neg) fp12_conj(&out, &out);
  *r = out;
}

// hard-part coefficients (golden pairing.py _L0.._L3, high-first)
static const int HP_L0[6] = {1, -2, 0, 2, -1, 3};
static const int HP_L1[5] = {1, -2, 0, 2, -1};
static const int HP_L2[4] = {1, -2, 1, 0};
static const int HP_L3[3] = {1, -2, 1};

static void poly_pow(fp12 *r, const fp12 g[6], const int *coeffs, int n) {
  fp12 out;
  fp12_one(&out);
  int deg = n - 1;
  for (int i = 0; i < n; i++) {
    if (coeffs[i]) {
      fp12 t;
      pow_small(&t, &g[deg - i], coeffs[i]);
      fp12_mul(&out, &out, &t);
    }
  }
  *r = out;
}

static void final_exp(fp12 *r, const fp12 *f_in) {
  fp12 f, c, inv, t;
  // easy: f^(p^6-1) = conj(f) * f^-1; then f^(p^2+1)
  fp12_conj(&c, f_in);
  fp12_inv(&inv, f_in);
  fp12_mul(&f, &c, &inv);
  fp12_frob_n(&t, &f, 2);
  fp12_mul(&f, &t, &f);
  // hard part
  fp12 g[6];
  g[0] = f;
  for (int k = 1; k < 6; k++) pow_x(&g[k], &g[k - 1]);
  fp12 p0, p1, p2, p3;
  poly_pow(&p0, g, HP_L0, 6);
  poly_pow(&p1, g, HP_L1, 5);
  fp12_frob_n(&p1, &p1, 1);
  poly_pow(&p2, g, HP_L2, 4);
  fp12_frob_n(&p2, &p2, 2);
  poly_pow(&p3, g, HP_L3, 3);
  fp12_frob_n(&p3, &p3, 3);
  fp12_mul(&t, &p0, &p1);
  fp12 t2;
  fp12_mul(&t2, &p2, &p3);
  fp12_mul(r, &t, &t2);
}

// prod e(P_i, Q_i) == 1 ?
static int pairing_check(const g1p *ps, const g2p *qs, int n) {
  g1aff pa[4];
  g2aff qa[4];
  int live = 0;
  for (int i = 0; i < n; i++) {
    if (g1_is_inf(&ps[i]) || g2_is_inf(&qs[i])) continue;
    g1_to_affine(&pa[live].x, &pa[live].y, &ps[i]);
    g2_to_affine(&qa[live].x, &qa[live].y, &qs[i]);
    live++;
  }
  if (!live) return 1;
  fp12 f, e;
  multi_miller(&f, pa, qa, live);
  final_exp(&e, &f);
  return fp12_is_one(&e);
}

static int pairing_check_prepared(const g1p *ps,
                                  const g2prep *const *preps, int n) {
  g1aff pa[4];
  const g2prep *pl[4];
  int live = 0;
  for (int i = 0; i < n; i++) {
    if (g1_is_inf(&ps[i])) continue;
    g1_to_affine(&pa[live].x, &pa[live].y, &ps[i]);
    pl[live] = preps[i];
    live++;
  }
  if (!live) return 1;
  fp12 f, e;
  multi_miller_prepared(&f, pa, pl, live);
  final_exp(&e, &f);
  return fp12_is_one(&e);
}

// ---------------------------------------------------------------------------
// Public-key caches.
//
// The group public key is fixed across rounds, so per-verify we cache:
//   - G2-scheme pk (48 B, G1 point): the decompression square root — a
//     full Fp Fermat chain per call otherwise;
//   - G1-scheme pk (96 B, G2 point): decompression (Fp2 sqrt chain) AND
//     the whole Miller-loop line precomputation (g2_prepare) — the G2
//     side of both pairings is fixed (generator + pk), so verify-time
//     pairing work drops to line evaluations at P plus the Fp12 ladder.
// Keyed by raw wire bytes; small LRU-ish ring, copy-out under a mutex so
// eviction never races a verify in another thread.  Results are
// bit-identical to the uncached path (unique decompression/inverses).
// ---------------------------------------------------------------------------

#include <mutex>

#define PK_G1_SLOTS 24  /* covers an n=16 group's evaluated signer keys */
#define PK_G2_SLOTS 8

static struct {
  int used;
  uint8_t key[48];
  g1p pk;
} g_pk_g1_cache[PK_G1_SLOTS];
static int g_pk_g1_next = 0;

static struct {
  int used;
  uint8_t key[96];
  g2prep prep;
} g_pk_g2_cache[PK_G2_SLOTS];
static int g_pk_g2_next = 0;

static std::mutex g_pk_mu;

// decompressed-G1 pk by wire bytes; returns 0 on invalid/infinity
static int g1_pk_cached(g1p *out, const uint8_t pk48[48]) {
  {
    std::lock_guard<std::mutex> lk(g_pk_mu);
    for (int i = 0; i < PK_G1_SLOTS; i++)
      if (g_pk_g1_cache[i].used &&
          !memcmp(g_pk_g1_cache[i].key, pk48, 48)) {
        *out = g_pk_g1_cache[i].pk;
        return 1;
      }
  }
  g1p pk;
  if (!g1_from_bytes(&pk, pk48) || g1_is_inf(&pk)) return 0;
  {
    std::lock_guard<std::mutex> lk(g_pk_mu);
    int s = g_pk_g1_next++ % PK_G1_SLOTS;
    memcpy(g_pk_g1_cache[s].key, pk48, 48);
    g_pk_g1_cache[s].pk = pk;
    g_pk_g1_cache[s].used = 1;
  }
  *out = pk;
  return 1;
}

// prepared-G2 pk (decompression + line precomputation) by wire bytes
static int g2_pk_prep_cached(g2prep *out, const uint8_t pk96[96]) {
  {
    std::lock_guard<std::mutex> lk(g_pk_mu);
    for (int i = 0; i < PK_G2_SLOTS; i++)
      if (g_pk_g2_cache[i].used &&
          !memcmp(g_pk_g2_cache[i].key, pk96, 96)) {
        *out = g_pk_g2_cache[i].prep;
        return 1;
      }
  }
  g2p pk;
  if (!g2_from_bytes(&pk, pk96) || g2_is_inf(&pk)) return 0;
  g2aff qa;
  g2_to_affine(&qa.x, &qa.y, &pk);
  g2prep prep;
  g2_prepare(&prep, &qa);
  {
    std::lock_guard<std::mutex> lk(g_pk_mu);
    int s = g_pk_g2_next++ % PK_G2_SLOTS;
    memcpy(g_pk_g2_cache[s].key, pk96, 96);
    g_pk_g2_cache[s].prep = prep;
    g_pk_g2_cache[s].used = 1;
  }
  *out = prep;
  return 1;
}

static g2prep g_gen_prep;
static int g_gen_prep_done = 0;  /* idempotent, ensure_init-style */
static const g2prep *gen_prep(void) {
  if (!g_gen_prep_done) {
    g2aff gen;
    gen.x = BLS_G2_X;
    gen.y = BLS_G2_Y;
    g2_prepare(&g_gen_prep, &gen);
    g_gen_prep_done = 1;
  }
  return &g_gen_prep;
}

// ---------------------------------------------------------------------------
// Public API
// ---------------------------------------------------------------------------

static int g_init_done = 0;
static void ensure_init(void) {
  if (!g_init_done) {
    exps_init();
    g1_endo_init();
    g_init_done = 1;
  }
}

extern "C" {

// returns 1 on valid signature
int drand_bls_verify_g2(const uint8_t pk48[48], const uint8_t *msg,
                        size_t msg_len, const uint8_t sig96[96],
                        const uint8_t *dst, size_t dst_len) {
  ensure_init();
  g1p pk;
  g2p sig;
  // pk decompression (an Fp sqrt chain) caches by wire bytes — the
  // group key is fixed across rounds
  if (!g1_pk_cached(&pk, pk48)) return 0;
  if (!g2_from_bytes(&sig, sig96) || g2_is_inf(&sig)) return 0;
  if (!g2_in_subgroup(&sig)) return 0;
  g2p h;
  hash_to_g2(&h, msg, msg_len, dst, dst_len);
  g1p gen = {BLS_G1_X, BLS_G1_Y, BLS_ONE_M}, ngen;
  g1_neg(&ngen, &gen);
  g1p ps[2] = {ngen, pk};
  g2p qs[2] = {sig, h};
  return pairing_check(ps, qs, 2);
}

int drand_bls_verify_g1(const uint8_t pk96[96], const uint8_t *msg,
                        size_t msg_len, const uint8_t sig48[48],
                        const uint8_t *dst, size_t dst_len) {
  ensure_init();
  // The short-sig scheme's pairings have FIXED G2 arguments (generator
  // and group key): both Miller ladders run fully precomputed — per
  // verify only line evaluations at P and the Fp12 accumulator remain
  // (bit-identical to the live ladder; see multi_miller_prepared).
  g2prep pkprep;
  if (!g2_pk_prep_cached(&pkprep, pk96)) return 0;
  g1p sig;
  if (!g1_from_bytes(&sig, sig48) || g1_is_inf(&sig)) return 0;
  if (!g1_in_subgroup(&sig)) return 0;
  g1p h;
  hash_to_g1(&h, msg, msg_len, dst, dst_len);
  g1p nsig;
  g1_neg(&nsig, &sig);
  g1p ps[2] = {nsig, h};
  const g2prep *preps[2] = {gen_prep(), &pkprep};
  return pairing_check_prepared(ps, preps, 2);
}

// tbls partial: commits = t compressed G1 points (48 B each); partial =
// 2-byte BE index || 96-byte sig; evaluates the public polynomial at
// index+1 (Horner in the exponent) and verifies.
int drand_tbls_verify_partial(const uint8_t *commits, int t,
                              const uint8_t *msg, size_t msg_len,
                              const uint8_t *partial, size_t partial_len,
                              const uint8_t *dst, size_t dst_len) {
  ensure_init();
  if (partial_len != 98) return 0;
  uint64_t xi = ((uint64_t)partial[0] << 8 | partial[1]) + 1;
  g1p acc;
  memset(&acc, 0, sizeof(acc));
  for (int i = t - 1; i >= 0; i--) {
    g1p cm;
    if (!g1_from_bytes(&cm, commits + 48 * i)) return 0;
    g1p scaled;
    g1_mul_u64(&scaled, &acc, xi);
    g1_add(&acc, &scaled, &cm);
  }
  if (g1_is_inf(&acc)) return 0;
  uint8_t pk48[48];
  g1_to_bytes(pk48, &acc);
  return drand_bls_verify_g2(pk48, msg, msg_len, partial + 2, dst, dst_len);
}

// Lagrange combination of t G2 partial signatures: out = sum scal_i *
// sig_i with 32-byte big-endian scalars (the Lagrange basis values mod
// r, computed host-side).  The threshold-recovery latency path
// (reference seam: `share.PubPoly.Recover` behind
// `chain/beacon/chain.go:158-165`): ~t * 3 ms on this host vs ~700 ms
// through the pure-python golden model.  Returns 1 on success; 0 on a
// malformed point or an infinity result (both mean bad partials).
int drand_g2_lincomb(const uint8_t *sigs96, const uint8_t *scalars32,
                     int t, uint8_t out96[96]) {
  ensure_init();
  g2p acc;
  memset(&acc, 0, sizeof(acc));  // z == 0: the group identity
  for (int i = 0; i < t; i++) {
    g2p s;
    if (!g2_from_bytes(&s, sigs96 + 96 * i) || g2_is_inf(&s)) return 0;
    g2p term;
    g2_mul_be(&term, &s, scalars32 + 32 * i, 32);
    g2_add(&acc, &acc, &term);
  }
  if (g2_is_inf(&acc)) return 0;
  g2_to_bytes(out96, &acc);
  return 1;
}

// test hooks
void drand_hash_to_g2_compressed(uint8_t out96[96], const uint8_t *msg,
                                 size_t msg_len, const uint8_t *dst,
                                 size_t dst_len) {
  ensure_init();
  g2p h;
  hash_to_g2(&h, msg, msg_len, dst, dst_len);
  g2_to_bytes(out96, &h);
}
void drand_hash_to_g1_compressed(uint8_t out48[48], const uint8_t *msg,
                                 size_t msg_len, const uint8_t *dst,
                                 size_t dst_len) {
  ensure_init();
  g1p h;
  hash_to_g1(&h, msg, msg_len, dst, dst_len);
  g1_to_bytes(out48, &h);
}
void drand_sha256(uint8_t out32[32], const uint8_t *msg, size_t len) {
  sha256_ctx c;
  sha_init(&c);
  sha_update(&c, msg, len);
  sha_final(&c, out32);
}

// Tower-arithmetic KAT surface (tests/test_native.py): byte-in/byte-out
// versions of the rebuilt hot ops so the Python golden model can pin
// them point-for-point.  Elements are concatenated 48-byte big-endian
// canonical Fp coefficients in golden tuple order (fp2 = c0||c1,
// fp6 = a0||a1||a2, fp12 = b0||b1).  Returns 1, or 0 on a
// non-canonical encoding (per-coefficient >= p) or unknown op.
//   op 0 fp_mul   1 fp_sqr    2 fp2_mul  3 fp2_sqr  4 fp6_mul
//      5 fp6_sqr  6 fp12_mul  7 fp12_sqr 8 cyclo_sqr (a must be
//      unitary — caller's contract, as in final_exp)
//      9 fp12_mul_line: a = fp12, b = A(96) || B(96) || yp(48)
int drand_test_tower_op(int op, const uint8_t *a, const uint8_t *b,
                        uint8_t *out) {
  ensure_init();
  static const int NFP[10] = {1, 1, 2, 2, 6, 6, 12, 12, 12, 12};
  if (op < 0 || op > 9) return 0;
  fp av[12], bv[12];
  for (int i = 0; i < NFP[op]; i++)
    if (!fp_from_be48(&av[i], a + 48 * i)) return 0;
  int nb = 0;  // b coefficient count per op (0 = unary)
  if (op == 0) nb = 1;
  else if (op == 2) nb = 2;
  else if (op == 4) nb = 6;
  else if (op == 6) nb = 12;
  else if (op == 9) nb = 5;  // A.c0, A.c1, B.c0, B.c1, yp
  for (int i = 0; i < nb; i++)
    if (!fp_from_be48(&bv[i], b + 48 * i)) return 0;
  fp rv[12];
  int nout = NFP[op];
  switch (op) {
    case 0: fp_mul(&rv[0], &av[0], &bv[0]); break;
    case 1: fp_sqr(&rv[0], &av[0]); break;
    case 2: {
      fp2 x = {av[0], av[1]}, y = {bv[0], bv[1]}, z;
      fp2_mul(&z, &x, &y);
      rv[0] = z.c0; rv[1] = z.c1;
      break;
    }
    case 3: {
      fp2 x = {av[0], av[1]}, z;
      fp2_sqr(&z, &x);
      rv[0] = z.c0; rv[1] = z.c1;
      break;
    }
    case 4: case 5: {
      fp6 x, y, z;
      memcpy(&x, av, sizeof(x));
      if (op == 4) { memcpy(&y, bv, sizeof(y)); fp6_mul(&z, &x, &y); }
      else fp6_sqr(&z, &x);
      memcpy(rv, &z, sizeof(z));
      break;
    }
    case 6: case 7: case 8: {
      fp12 x, y, z;
      memcpy(&x, av, sizeof(x));
      if (op == 6) { memcpy(&y, bv, sizeof(y)); fp12_mul(&z, &x, &y); }
      else if (op == 7) fp12_sqr(&z, &x);
      else cyclo_sqr(&z, &x);
      memcpy(rv, &z, sizeof(z));
      break;
    }
    case 9: {
      fp12 x;
      memcpy(&x, av, sizeof(x));
      fp2 A = {bv[0], bv[1]}, B = {bv[2], bv[3]};
      fp12_mul_line(&x, &A, &B, &bv[4]);
      memcpy(rv, &x, sizeof(x));
      break;
    }
  }
  for (int i = 0; i < nout; i++) fp_to_be48(out + 48 * i, &rv[i]);
  return 1;
}

}  // extern "C"
