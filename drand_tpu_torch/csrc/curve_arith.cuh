// G2 Jacobian point arithmetic and the Miller loop's line steps over the
// Fp2 value type of tower_arith.cuh, shared by the CUDA kernels
// (curve_kernels.cu, miller_kernels.cu) and the host harness
// (field_host.cpp, built with g++ by tests/test_torch_kernel_harness.py).
//
// Each function follows the formula of its plain PyTorch version step for
// step (ops/curve.py point_double and point_add, ops/pairing.py _dbl_step
// and _add_step): every intermediate is canonical, so the outputs equal
// the plain version's bit for bit -- Jacobian coordinates are not unique,
// so the same formula, not only the same point, is what is held equal.
#pragma once

#include "tower_arith.cuh"

namespace dt {

// Montgomery one (2^384 mod m), the Fp coordinate of the points at
// infinity and of the line that stands in for an inactive pair.
struct One {
  uint64_t w[N_WORDS];
};

inline One one_from_words(const uint64_t *w) {
  One one;
  for (int v = 0; v < N_WORDS; v++) one.w[v] = w[v];
  return one;
}

struct G2J {
  F2 X, Y, Z;                             // Z = 0 encodes infinity
};

DT_HD F2 f2_one(const One &one) {
  F2 r = f2_zero();
  DT_UNROLL
  for (int v = 0; v < N_WORDS; v++) r.x[v] = one.w[v];
  return r;
}

DT_HD G2J g2_select(bool c, const G2J &a, const G2J &b) {
  return {f2_select(c, a.X, b.X), f2_select(c, a.Y, b.Y),
          f2_select(c, a.Z, b.Z)};
}

// B9: dbl-2009-l (ops/curve.py point_double); Z3 = 2YZ keeps infinity.
DT_HD G2J g2_dbl(const G2J &p, const Mod &M) {
  const F2 a = f2_sqr(p.X, M), b = f2_sqr(p.Y, M), yz = f2_mul(p.Y, p.Z, M);
  const F2 xb = f2_add(p.X, b, M);
  const F2 c = f2_sqr(b, M), s2 = f2_sqr(xb, M);
  const F2 e = f2_add(f2_dbl(a, M), a, M);
  F2 d = f2_sub(s2, f2_add(a, c, M), M);
  d = f2_dbl(d, M);
  const F2 f = f2_sqr(e, M);
  G2J r;
  r.X = f2_sub(f, f2_dbl(d, M), M);
  const F2 y3t = f2_mul(e, f2_sub(d, r.X, M), M);
  r.Y = f2_sub(y3t, f2_dbl(f2_dbl(f2_dbl(c, M), M), M), M);
  r.Z = f2_dbl(yz, M);
  return r;
}

// B10: general Jacobian addition with every case branchless
// (ops/curve.py point_add): infinities, P + P (the doubling, when
// with_double), P + (-P) = infinity.
DT_HD G2J g2_add(const G2J &p1, const G2J &p2, bool with_double,
                 const One &one, const Mod &M) {
  const F2 z1z1 = f2_sqr(p1.Z, M), z2z2 = f2_sqr(p2.Z, M);
  const F2 y1z2 = f2_mul(p1.Y, p2.Z, M), y2z1 = f2_mul(p2.Y, p1.Z, M);
  const F2 u1 = f2_mul(p1.X, z2z2, M), u2 = f2_mul(p2.X, z1z1, M);
  const F2 s1 = f2_mul(y1z2, z2z2, M), s2 = f2_mul(y2z1, z1z1, M);
  const F2 h = f2_sub(u2, u1, M);
  const F2 h2 = f2_dbl(h, M);
  const F2 rr = f2_dbl(f2_sub(s2, s1, M), M);
  const F2 z12 = f2_add(p1.Z, p2.Z, M);
  const F2 i = f2_sqr(h2, M), rr2 = f2_sqr(rr, M), z12sq = f2_sqr(z12, M);
  const F2 j = f2_mul(h, i, M), v = f2_mul(u1, i, M);
  G2J out;
  out.X = f2_sub(f2_sub(rr2, j, M), f2_dbl(v, M), M);
  const F2 zz = f2_sub(z12sq, f2_add(z1z1, z2z2, M), M);
  const F2 y3t = f2_mul(rr, f2_sub(v, out.X, M), M);
  const F2 s1j = f2_mul(s1, j, M);
  out.Z = f2_mul(zz, h, M);
  out.Y = f2_sub(y3t, f2_dbl(s1j, M), M);

  const bool inf1 = f2_is_zero(p1.Z), inf2 = f2_is_zero(p2.Z);
  const bool eq_u = f2_eq(u1, u2) && !inf1 && !inf2;
  const bool eq_s = f2_eq(s1, s2);
  if (with_double) out = g2_select(eq_u && eq_s, g2_dbl(p1, M), out);
  const G2J inf = {f2_one(one), f2_one(one), f2_zero()};
  out = g2_select(eq_u && !eq_s, inf, out);
  out = g2_select(inf1, p2, out);
  return g2_select(inf2 && !inf1, p1, out);
}

// A line a + b w^2 + c w^3 as the six flat coefficients of the w-powers
// LINE_IDX = (0, 2, 3, 6, 8, 9) (ops/pairing.py line_to_flat): the cell
// x + y u at slot s is (x - y) w^s + y w^(s+6).
struct Line {
  uint64_t c[6][N_WORDS];
};

// The same line as its Fp2 triple (a, b, c): what a Miller step returns.
struct LineF2 {
  F2 a, b, c;
};

DT_HD Line line_flat(const LineF2 &t, const Mod &M) {
  Line l;
  sub_mod(t.a.x, t.a.y, l.c[0], M);
  sub_mod(t.b.x, t.b.y, l.c[1], M);
  sub_mod(t.c.x, t.c.y, l.c[2], M);
  DT_UNROLL
  for (int v = 0; v < N_WORDS; v++) {
    l.c[3][v] = t.a.y[v];
    l.c[4][v] = t.b.y[v];
    l.c[5][v] = t.c.y[v];
  }
  return l;
}

// The line of an inactive pair: the flat one.
DT_HD Line line_one(const One &one) {
  Line l;
  DT_UNROLL
  for (int q = 0; q < 6; q++) {
    DT_UNROLL
    for (int v = 0; v < N_WORDS; v++) l.c[q][v] = q == 0 ? one.w[v] : 0;
  }
  return l;
}

// The Miller doubling step (ops/pairing.py _dbl_step): T <- 2T, and the
// line scaled by 2YZ^3, a = 3X^3 - 2Y^2, b = -3X^2 Z^2 xp, c = 2YZ^3 yp.
DT_HD LineF2 miller_dbl_step(G2J &T, const uint64_t *xp, const uint64_t *yp,
                             const Mod &M) {
  const F2 XX = f2_sqr(T.X, M), YY = f2_sqr(T.Y, M), ZZ = f2_sqr(T.Z, M);
  const F2 YZ = f2_mul(T.Y, T.Z, M);
  const F2 xyy = f2_add(T.X, YY, M);
  const F2 E = f2_add(f2_dbl(XX, M), XX, M);
  const F2 X3c = f2_mul(XX, T.X, M), YZ3 = f2_mul(YZ, ZZ, M);
  const F2 XXZZ = f2_mul(XX, ZZ, M), C = f2_sqr(YY, M);
  const F2 S2 = f2_sqr(xyy, M), F_ = f2_sqr(E, M);
  const F2 a = f2_sub(f2_add(f2_dbl(X3c, M), X3c, M), f2_dbl(YY, M), M);
  const F2 nb3 = f2_neg(f2_add(f2_dbl(XXZZ, M), XXZZ, M), M);
  const F2 b = f2_mul_fp(nb3, xp, M);
  const F2 c = f2_mul_fp(f2_dbl(YZ3, M), yp, M);
  F2 D = f2_sub(S2, f2_add(XX, C, M), M);
  D = f2_dbl(D, M);
  const F2 X2 = f2_sub(F_, f2_dbl(D, M), M);
  const F2 Et = f2_mul(E, f2_sub(D, X2, M), M);
  T.Y = f2_sub(Et, f2_dbl(f2_dbl(f2_dbl(C, M), M), M), M);
  T.X = X2;
  T.Z = f2_dbl(YZ, M);
  return {a, b, c};
}

// The Miller mixed-addition step (ops/pairing.py _add_step), Q = (xq, yq)
// affine: with H = xq Z^2 - X and r = 2(yq Z^3 - Y), the line is
// a = r xq - 2HZ yq, b = -r xp, c = 2HZ yp.
DT_HD LineF2 miller_add_step(G2J &T, const F2 &xq, const F2 &yq,
                             const uint64_t *xp, const uint64_t *yp,
                             const Mod &M) {
  const F2 ZZ = f2_sqr(T.Z, M), yqZ = f2_mul(yq, T.Z, M);
  const F2 U2 = f2_mul(xq, ZZ, M), S2 = f2_mul(yqZ, ZZ, M);
  const F2 H = f2_sub(U2, T.X, M);
  const F2 r = f2_dbl(f2_sub(S2, T.Y, M), M);
  const F2 ZH = f2_add(T.Z, H, M);
  const F2 HH = f2_sqr(H, M), rr = f2_sqr(r, M), ZH2 = f2_sqr(ZH, M);
  const F2 HZ = f2_mul(H, T.Z, M);
  const F2 I = f2_dbl(f2_dbl(HH, M), M);
  const F2 HZ2 = f2_dbl(HZ, M);
  const F2 J = f2_mul(H, I, M), V = f2_mul(T.X, I, M);
  const F2 rxq = f2_mul(r, xq, M), hzyq = f2_mul(HZ2, yq, M);
  const F2 X3 = f2_sub(f2_sub(rr, J, M), f2_dbl(V, M), M);
  const F2 rV = f2_mul(r, f2_sub(V, X3, M), M), YJ = f2_mul(T.Y, J, M);
  T.Y = f2_sub(rV, f2_dbl(YJ, M), M);
  T.Z = f2_sub(ZH2, f2_add(ZZ, HH, M), M);
  T.X = X3;
  const F2 a = f2_sub(rxq, hzyq, M);
  const F2 b = f2_mul_fp(f2_neg(r, M), xp, M);
  const F2 c = f2_mul_fp(HZ2, yp, M);
  return {a, b, c};
}


// ---------------------------------------------------------------------------
// Pieces of the merged Miller iterations (B11, B12) for the two-pair check,
// shared by the kernels and the harness.  A row's state is f [12 x 32
// limbs], T [2 pairs x (X0 X1 Y0 Y1 Z0 Z1) x 32], P [2 x (xp yp) x 32],
// Q [2 x (xq0 xq1 yq0 yq1) x 32] and two int32 masks (0: inactive pair).
// ---------------------------------------------------------------------------

// A point's six coordinates X0 X1 Y0 Y1 Z0 Z1, coordinate c at c * cs
// limbs: cs = 32 for a row's own block, rows * 32 for a coordinate-major
// stack.
DT_HD G2J g2_load6(const int32_t *c, long long cs) {
  return {f2_load(c, c + cs), f2_load(c + 2 * cs, c + 3 * cs),
          f2_load(c + 4 * cs, c + 5 * cs)};
}

DT_HD void g2_store6(const G2J &p, int32_t *c, long long cs) {
  f2_store(p.X, c, c + cs);
  f2_store(p.Y, c + 2 * cs, c + 3 * cs);
  f2_store(p.Z, c + 4 * cs, c + 5 * cs);
}

// One pair's step of a Miller iteration: the doubling step (q == nullptr)
// or the mixed addition with Q = q, on T (6 coordinates at t), writing the
// new T at t_out and returning the pair's flat line -- the flat one where
// the pair is inactive, whose T the addition then leaves as it was
// (ops/pairing.py: masked lines in both halves, T selected in add_half).
DT_HD Line miller_pair_step(const int32_t *t, const int32_t *p,
                            const int32_t *q, int32_t mask, int32_t *t_out,
                            const One &one, const Mod &M) {
  G2J T = g2_load6(t, N_LIMBS);
  uint64_t xp[N_WORDS], yp[N_WORDS];
  load_words(p, xp);
  load_words(p + N_LIMBS, yp);
  LineF2 l;
  if (q == nullptr) {
    l = miller_dbl_step(T, xp, yp, M);
  } else {
    const G2J old = T;
    l = miller_add_step(T, f2_load(q, q + N_LIMBS),
                        f2_load(q + 2 * N_LIMBS, q + 3 * N_LIMBS), xp, yp, M);
    T = g2_select(mask != 0, T, old);
  }
  g2_store6(T, t_out, N_LIMBS);
  return mask != 0 ? line_flat(l, M) : line_one(one);
}

// B18 (q == nullptr) and B19, one stacked row of the trio loop's step: in
// holds T (X0 X1 Y0 Y1 Z0 Z1), for B19 Q (xq0 xq1 yq0 yq1), then P (xp
// yp), 32 limbs each; T' goes to t_out and the line triple a0 a1 b0 b1 c0
// c1 to l_out, six coordinates of 32 limbs each.  No mask: the trio loop
// masks the lines and selects T itself (ops/pairing.py).
DT_HD void miller_line_step(const int32_t *in, bool add, int32_t *t_out,
                            int32_t *l_out, const Mod &M) {
  G2J T = g2_load6(in, N_LIMBS);
  const int32_t *p = in + (add ? 10 : 6) * N_LIMBS;
  uint64_t xp[N_WORDS], yp[N_WORDS];
  load_words(p, xp);
  load_words(p + N_LIMBS, yp);
  const LineF2 l =
      add ? miller_add_step(T, f2_load(in + 6 * N_LIMBS, in + 7 * N_LIMBS),
                            f2_load(in + 8 * N_LIMBS, in + 9 * N_LIMBS), xp,
                            yp, M)
          : miller_dbl_step(T, xp, yp, M);
  g2_store6(T, t_out, N_LIMBS);
  f2_store(l.a, l_out, l_out + N_LIMBS);
  f2_store(l.b, l_out + 2 * N_LIMBS, l_out + 3 * N_LIMBS);
  f2_store(l.c, l_out + 4 * N_LIMBS, l_out + 5 * N_LIMBS);
}

// Word v of line coefficient c at dst[(c * 6 + v) * stride]: the sparse
// operand layout flat_mul_class reads.
DT_HD void line_stage(const Line &l, uint64_t *dst, int stride) {
  DT_UNROLL
  for (int c = 0; c < 6; c++) {
    DT_UNROLL
    for (int v = 0; v < N_WORDS; v++)
      dst[(c * N_WORDS + v) * stride] = l.c[c][v];
  }
}

// Coefficient i of a flat row (32 limbs) into words at
// dst[(i * 6 + v) * stride].
DT_HD void flat_stage_coeff(const int32_t *limbs, uint64_t *dst, int stride) {
  uint64_t w[N_WORDS];
  load_words(limbs, w);
  DT_UNROLL
  for (int v = 0; v < N_WORDS; v++) dst[v * stride] = w[v];
}

DT_HD void flat_unstage(const uint64_t *lo, const uint64_t *hi, int j,
                        uint64_t *dst, int stride) {
  DT_UNROLL
  for (int v = 0; v < N_WORDS; v++) {
    dst[(j * N_WORDS + v) * stride] = lo[v];
    dst[((j + 6) * N_WORDS + v) * stride] = hi[v];
  }
}

}  // namespace dt
