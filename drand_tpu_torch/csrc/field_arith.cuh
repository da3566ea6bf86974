// Montgomery arithmetic for one element, shared by the CUDA kernels
// (field_kernels.cu, and tower_kernels.cu through tower_arith.cuh) and the
// host harness (field_host.cpp, built with g++ by
// tests/test_torch_kernel_harness.py).
//
// Layout at the boundary: 32 little-endian limbs of 12 bits in int32, the
// layout of drand_tpu_torch/ops/field.py.  Inside, a value is 6 (or 13)
// little-endian 64-bit words.  The Montgomery radix is 2^384 in both
// layouts, so Montgomery form is the same number either way.
//
// Every function is straight-line code over small arrays whose indices are
// compile-time constants after unrolling, so on the card they live in
// registers.
#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#define DT_HD __host__ __device__ __forceinline__
#define DT_UNROLL _Pragma("unroll")
#else
#define DT_HD inline
#define DT_UNROLL
#endif

namespace dt {

constexpr int N_LIMBS = 32;   // 12-bit limbs of one element
constexpr int N_WORDS = 6;    // 64-bit words of one element
constexpr int W_LIMBS = 64;   // limbs of a wide (pre-reduction) value
constexpr int W_WORDS = 13;   // words of a wide value: 768 bits + carry

// The modulus argument: words of m (little-endian) and -m^-1 mod 2^64.
struct Mod {
  uint64_t m[N_WORDS];
  uint64_t ninv;
};

// The C entry points' modulus argument, 6 words of m then -m^-1 mod 2^64.
inline Mod mod_from_words(const uint64_t *mod7) {
  Mod M;
  for (int i = 0; i < N_WORDS; i++) M.m[i] = mod7[i];
  M.ninv = mod7[N_WORDS];
  return M;
}

DT_HD uint64_t mulhi(uint64_t a, uint64_t b) {
#if defined(__CUDA_ARCH__)
  return __umul64hi(a, b);
#else
  return (uint64_t)(((unsigned __int128)a * b) >> 64);
#endif
}

// lo(a*b + c + carry); carry <- hi.  a*b + c + carry < 2^128 always.
DT_HD uint64_t mac(uint64_t a, uint64_t b, uint64_t c, uint64_t &carry) {
  uint64_t lo = a * b;
  uint64_t hi = mulhi(a, b);
  lo += c;
  hi += (lo < c);
  lo += carry;
  hi += (lo < carry);
  carry = hi;
  return lo;
}

// 12-bit limbs (each in [0, 4096)) -> 6 words.
DT_HD void limbs_to_words(const int32_t *l, uint64_t *w) {
  DT_UNROLL
  for (int i = 0; i < N_WORDS; i++) w[i] = 0;
  DT_UNROLL
  for (int i = 0; i < N_LIMBS; i++) {
    const uint64_t v = (uint64_t)(uint32_t)l[i];
    const int bit = 12 * i, wi = bit / 64, off = bit % 64;
    w[wi] |= v << off;
    if (off > 52) w[wi + 1] |= v >> (64 - off);
  }
}

// 6 words -> 12-bit limbs.
DT_HD void words_to_limbs(const uint64_t *w, int32_t *l) {
  DT_UNROLL
  for (int i = 0; i < N_LIMBS; i++) {
    const int bit = 12 * i, wi = bit / 64, off = bit % 64;
    uint64_t v = w[wi] >> off;
    if (off > 52) v |= w[wi + 1] << (64 - off);
    l[i] = (int32_t)(v & 0xFFF);
  }
}

// One element's 32 limbs (128 bytes, 16-byte aligned) -> 6 words; on the
// card through eight 16-byte loads.
DT_HD void load_words(const int32_t *src, uint64_t *w) {
#if defined(__CUDA_ARCH__)
  int32_t l[N_LIMBS];
  const int4 *s = reinterpret_cast<const int4 *>(src);
  DT_UNROLL
  for (int i = 0; i < N_LIMBS / 4; i++) {
    const int4 v = s[i];
    l[4 * i] = v.x;
    l[4 * i + 1] = v.y;
    l[4 * i + 2] = v.z;
    l[4 * i + 3] = v.w;
  }
  limbs_to_words(l, w);
#else
  limbs_to_words(src, w);
#endif
}

// 6 words -> one element's 32 limbs; on the card eight 16-byte stores.
DT_HD void store_words(const uint64_t *w, int32_t *dst) {
#if defined(__CUDA_ARCH__)
  int32_t l[N_LIMBS];
  words_to_limbs(w, l);
  int4 *d = reinterpret_cast<int4 *>(dst);
  DT_UNROLL
  for (int i = 0; i < N_LIMBS / 4; i++)
    d[i] = make_int4(l[4 * i], l[4 * i + 1], l[4 * i + 2], l[4 * i + 3]);
#else
  words_to_limbs(w, dst);
#endif
}

// t (+ hi * 2^384) -> t - m when that is >= 0, else t.  Requires
// t + hi * 2^384 < 2m, and leaves the value in [0, m).
DT_HD void cond_sub(uint64_t *t, uint64_t hi, const Mod &M) {
  uint64_t d[N_WORDS];
  uint64_t borrow = 0;
  DT_UNROLL
  for (int j = 0; j < N_WORDS; j++) {
    const uint64_t x = t[j] - M.m[j];
    const uint64_t b1 = t[j] < M.m[j];
    d[j] = x - borrow;
    borrow = b1 | (x < borrow);
  }
  const bool take = (hi != 0) || (borrow == 0);
  DT_UNROLL
  for (int j = 0; j < N_WORDS; j++) t[j] = take ? d[j] : t[j];
}

// r = a + b mod m; a, b in [0, m).  r may alias a or b.
DT_HD void add_mod(const uint64_t *a, const uint64_t *b, uint64_t *r,
                   const Mod &M) {
  uint64_t c = 0;
  DT_UNROLL
  for (int j = 0; j < N_WORDS; j++) {
    const uint64_t s = a[j] + b[j];
    const uint64_t c1 = s < a[j];
    r[j] = s + c;
    c = c1 | (r[j] < s);
  }
  cond_sub(r, c, M);
}

// r = a - b mod m; a, b in [0, m).  r may alias a or b.
DT_HD void sub_mod(const uint64_t *a, const uint64_t *b, uint64_t *r,
                   const Mod &M) {
  uint64_t borrow = 0;
  DT_UNROLL
  for (int j = 0; j < N_WORDS; j++) {
    const uint64_t x = a[j] - b[j];
    const uint64_t b1 = a[j] < b[j];
    r[j] = x - borrow;
    borrow = b1 | (x < borrow);
  }
  const uint64_t mask = 0 - borrow;       // add m back where a < b
  uint64_t c = 0;
  DT_UNROLL
  for (int j = 0; j < N_WORDS; j++) {
    const uint64_t mj = M.m[j] & mask;
    const uint64_t s = r[j] + mj;
    const uint64_t c1 = s < mj;
    r[j] = s + c;
    c = c1 | (r[j] < s);
  }
}

// r = a * b * 2^-384 mod m for a, b in [0, m): CIOS (coarsely integrated
// operand scanning) with a 7th and 8th accumulator word, so it holds for
// any odd m < 2^381 (the BLS12-381 base and scalar fields alike), then one
// conditional subtract (the CIOS value is < 2m).  r may alias a or b.
DT_HD void mont_mul_words(const uint64_t *a, const uint64_t *b, uint64_t *r,
                          const Mod &M) {
  uint64_t t[N_WORDS] = {0, 0, 0, 0, 0, 0};
  uint64_t t6 = 0;
  DT_UNROLL
  for (int i = 0; i < N_WORDS; i++) {
    uint64_t c = 0;
    DT_UNROLL
    for (int j = 0; j < N_WORDS; j++) t[j] = mac(a[j], b[i], t[j], c);
    uint64_t s = t6 + c;
    const uint64_t t7 = s < c;
    t6 = s;
    const uint64_t q = t[0] * M.ninv;
    c = 0;
    (void)mac(q, M.m[0], t[0], c);
    DT_UNROLL
    for (int j = 1; j < N_WORDS; j++) t[j - 1] = mac(q, M.m[j], t[j], c);
    s = t6 + c;
    t[N_WORDS - 1] = s;
    t6 = t7 + (s < c);
  }
  cond_sub(t, t6, M);
  DT_UNROLL
  for (int j = 0; j < N_WORDS; j++) r[j] = t[j];
}

// w <- w + q*m over 13 words, q < 2^384 chosen word by word so that the
// low 6 words vanish (REDC): words 6..12 then hold (w + q*m) / 2^384.
// Requires w < 2^832 - 2^384 m, so the sum does not leave the 13 words.
DT_HD void redc_wide(uint64_t *w, const Mod &M) {
  DT_UNROLL
  for (int i = 0; i < N_WORDS; i++) {
    const uint64_t q = w[i] * M.ninv;
    uint64_t c = 0;
    DT_UNROLL
    for (int j = 0; j < N_WORDS; j++) w[i + j] = mac(q, M.m[j], w[i + j], c);
    DT_UNROLL
    for (int j = i + N_WORDS; j < W_WORDS; j++) {
      const uint64_t s = w[j] + c;
      c = s < c;
      w[j] = s;
    }
  }
}

// w = a^2 over 13 words (w[12] = 0) for a in [0, m): the triangular
// square, 15 off-diagonal products, doubled, plus 6 diagonal ones, against
// 36 for a general product.
DT_HD void sqr_wide(const uint64_t *a, uint64_t *w) {
  DT_UNROLL
  for (int i = 0; i < W_WORDS; i++) w[i] = 0;
  DT_UNROLL
  for (int i = 0; i < N_WORDS; i++) {
    uint64_t c = 0;
    DT_UNROLL
    for (int j = i + 1; j < N_WORDS; j++)
      w[i + j] = mac(a[i], a[j], w[i + j], c);
    w[i + N_WORDS] = c;
  }
  // the off-diagonal sum is < a^2 / 2 < 2^767: doubling stays in 12 words
  // (w[0] holds no off-diagonal product and stays 0)
  DT_UNROLL
  for (int i = 2 * N_WORDS - 1; i > 0; i--)
    w[i] = (w[i] << 1) | (w[i - 1] >> 63);
  uint64_t c = 0;
  DT_UNROLL
  for (int i = 0; i < N_WORDS; i++) {
    w[2 * i] = mac(a[i], a[i], w[2 * i], c);
    const uint64_t s = w[2 * i + 1] + c;
    c = s < c;
    w[2 * i + 1] = s;
  }
}

// K21 (sub: K22): canonical a + b (a - b) mod m, canonical limbs in and
// out.
DT_HD void add_sub_limbs(const int32_t *a, const int32_t *b, int32_t *o,
                         bool sub, const Mod &M) {
  uint64_t wa[N_WORDS], wb[N_WORDS];
  limbs_to_words(a, wa);
  limbs_to_words(b, wb);
  if (sub)
    sub_mod(wa, wb, wa, M);
  else
    add_mod(wa, wb, wa, M);
  words_to_limbs(wa, o);
}

// K3: T * 2^-384 mod m for a wide value given as 64 int32 limbs.
//
// Accepted input (the contract of drand_tpu_torch.ops.field.mont_reduce):
// limbs in [0, 2^14) -- cheap-carried, so a limb may exceed 4095 -- and
// value T = sum(limb[i] << 12i) below (2 - 2^-9) * 2^384 * m.  Then the
// REDC result (T + q*m) / 2^384 with q < 2^384 is below 3m, and two
// conditional subtracts make it canonical.  The limb sum runs with a
// signed carry, so it is exact for any limbs whose total is >= 0.
DT_HD void mont_reduce_limbs(const int32_t *l, int32_t *o, const Mod &M) {
  uint64_t w[W_WORDS];
  DT_UNROLL
  for (int i = 0; i < W_WORDS; i++) w[i] = 0;
  int64_t carry = 0;
  DT_UNROLL
  for (int i = 0; i < W_LIMBS; i++) {
    const int64_t v = (int64_t)l[i] + carry;
    const uint64_t d = (uint64_t)(v & 0xFFF);
    carry = v >> 12;                       // arithmetic shift
    const int bit = 12 * i, wi = bit / 64, off = bit % 64;
    w[wi] |= d << off;
    if (off > 52) w[wi + 1] |= d >> (64 - off);
  }
  w[W_WORDS - 1] = (uint64_t)carry;        // bits >= 768
  redc_wide(w, M);
  uint64_t r[N_WORDS];
  DT_UNROLL
  for (int j = 0; j < N_WORDS; j++) r[j] = w[N_WORDS + j];
  // r + w[12] * 2^384 < 3m: the first subtract leaves < 2m, the second < m
  cond_sub(r, w[W_WORDS - 1], M);
  cond_sub(r, 0, M);
  words_to_limbs(r, o);
}

}  // namespace dt
