// G2 Jacobian point arithmetic and the Miller loop's line steps over the
// Fp2 value type of tower_arith.cuh, shared by the CUDA kernels
// (curve_kernels.cu, miller_kernels.cu) and the host harness
// (field_host.cpp, built with g++ by tests/test_torch_kernel_harness.py).
//
// Each function follows the formula of its plain PyTorch version step for
// step (ops/curve.py point_double and point_add, ops/pairing.py _dbl_step
// and _add_step), split into level shares: every intermediate is
// canonical, so the outputs equal the plain version's bit for bit --
// Jacobian coordinates are not unique, so the same formula, not only the
// same point, is what is held equal.
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

// A product class's output slots j and j + 6 into dst (flat_load's layout).
DT_HD void flat_unstage(const uint64_t *lo, const uint64_t *hi, int j,
                        uint64_t *dst, int stride) {
  DT_UNROLL
  for (int v = 0; v < N_WORDS; v++) {
    dst[(j * N_WORDS + v) * stride] = lo[v];
    dst[((j + 6) * N_WORDS + v) * stride] = hi[v];
  }
}


// ---------------------------------------------------------------------------
// The Miller doubling step (ops/pairing.py _dbl_step_plain: T <- 2T, and
// the line scaled by 2YZ^3, a = 3X^3 - 2Y^2, b = -3X^2 Z^2 xp, c = 2YZ^3
// yp) split over three threads of a pair by its dependency levels, for
// both Miller executors: K11 (the merged iteration, B11) and K18 (the trio
// loop's step, B18).  Each level's Fp2 values pass to the next through
// buffers in flat_load's layout (element e, word v at base[(e * 6 + v) *
// stride]), a barrier between levels.  Per pair:
//
//   t   T, elements X0 X1 Y0 Y1 Z0 Z1 (read at levels 0 and 1)
//   s1  level 0's XX YY ZZ YZ, elements 0-7
//   s2  level 1's X3c C YZ3 S2 XXZZ F, elements 0-11
//
// and where level 2 reads P and puts the line and T', fixed at compile
// time by the executor's Io (MergedDblIo, TrioDblIo below; level 2 reads
// no T, so either may write over it).
//
// Share j of each level (the work of one thread, in Fp2 products and
// squares of 1776 and 1248 multiply-adds, Fp products of 600):
//
//   level 0: j = 0: XX = X^2 and ZZ's y half; 1: YY = Y^2 and ZZ's x
//            half (an Fp2 square's halves: 600 and 648); 2: YZ = Y Z
//   level 1: j = 0: X3c = XX X, C = YY^2; 1: YZ3 = YZ ZZ,
//            S2 = (X + YY)^2; 2: XXZZ = XX ZZ, F = E^2 (E = 3 XX)
//   level 2: j = 0: the line's a = 3 X3c - 2 YY and b = -3 XXZZ xp;
//            1: its c = 2 YZ3 yp, and Z' = 2 YZ; 2: D = 2 (S2 - XX - C),
//            X' = F - 2D, Y' = E (D - X') - 8C
//
// Every intermediate is canonical, so the shares give _dbl_step_plain's
// outputs bit for bit.
// ---------------------------------------------------------------------------

DT_HD F2 f2_at(const uint64_t *b, int e, int stride) {
  F2 r;
  flat_load(b, e, stride, r.x);
  flat_load(b, e + 1, stride, r.y);
  return r;
}

DT_HD void f2_put(const F2 &a, uint64_t *b, int e, int stride) {
  flat_store(a.x, b, e, stride);
  flat_store(a.y, b, e + 1, stride);
}

DT_HD F2 f2_triple(const F2 &a, const Mod &M) {
  return f2_add(f2_dbl(a, M), a, M);
}

// Half h of the Fp2 product a b: its x (h = 0) or its y (h = 1).
DT_HD void f2_mul_half(int h, const F2 &a, const F2 &b, uint64_t *r,
                       const Mod &M) {
  if (h == 0)
    fp2_mul_re(a.x, a.y, b.x, b.y, r, M);
  else
    fp2_mul_im(a.x, a.y, b.x, b.y, r, M);
}

// Cell i (0, 1, 2 for a, b, c) of a pair's flat line on the w-powers
// LINE_IDX = (0, 2, 3, 6, 8, 9) (ops/pairing.py line_to_flat: the cell
// x + y u at slot s is (x - y) w^s + y w^(s+6)): x - y at element i and y
// at element i + 3, or the flat one's (Montgomery one at element 0, zero
// elsewhere) where the pair is inactive.
DT_HD void line_put_cell(const F2 &c, int i, bool active, const One &one,
                         uint64_t *l, int stride, const Mod &M) {
  uint64_t lo[N_WORDS], hi[N_WORDS];
  sub_mod(c.x, c.y, lo, M);
  DT_UNROLL
  for (int v = 0; v < N_WORDS; v++) {
    lo[v] = active ? lo[v] : (i == 0 ? one.w[v] : 0);
    hi[v] = active ? c.y[v] : 0;
  }
  flat_store(lo, l, i, stride);
  flat_store(hi, l, i + 3, stride);
}

// A row's buffer in a merged Miller iteration (K11, K12 and the host
// harness), in elements.  K11: f at MB_F (12); T at MB_L (12: pair k's at
// MB_L + 6k), then the two lines over it; level 0's values at MB_S1 (pair
// k's at MB_S1 + 8k); level 1's at MB_S2 (pair k's at MB_S2 + 12k); the
// products go where nothing is read any more: f^2 at MB_S1, f^2 l1 at
// MB_F, f' at MB_S2.  K12: T at MA_T (12: pair k's at MA_T + 6k), Q at
// MA_Q (8: pair k's at MA_Q + 4k), pair k's level values at MA_S +
// MA_SW k (miller_add_share), its line over the first six of them; after
// the steps f is staged at MA_F (over T), f l1 goes to MA_MID (over pair
// 0's level values) and f' over f.
constexpr int MB_F = 0, MB_L = 12, MB_S1 = 24, MB_S2 = 40;
constexpr int MA_T = 0, MA_Q = 12, MA_S = 20, MA_SW = 24;
constexpr int MA_F = 0, MA_MID = MA_S + 6;
constexpr int MB_DBL = 64, MB_ADD = MA_S + 2 * MA_SW;   // elements K11, K12 use

// K11's level 2: P (xp then yp, 32 limbs each) from device memory at p;
// the pair's flat line on LINE_IDX at l (line_put_cell: the flat one
// where the pair is inactive); T' to device memory, 6 x 32 limbs at t_out,
// skipped when t_out is null.
struct MergedDblIo {
  uint64_t *l;
  const int32_t *p;
  bool active;
  int32_t *t_out;
  const One &one;
  int stride;

  DT_HD void load_p(int i, uint64_t *x) const {
    load_words(p + i * N_LIMBS, x);
  }
  DT_HD void line(const F2 &c, int i, const Mod &M) const {
    line_put_cell(c, i, active, one, l, stride, M);
  }
  DT_HD bool keeps_t() const { return t_out != nullptr; }
  DT_HD void fence() const {}
  DT_HD void point(const F2 &v, int e) const {
    f2_store(v, t_out + e * N_LIMBS, t_out + (e + 1) * N_LIMBS);
  }
};

// A K18 row's buffer, in elements: T and P as staged (X0 X1 Y0 Y1 Z0 Z1 xp
// yp: DL_T, DL_P), the level values (DL_S1: 8, DL_S2: 12) and the line
// triple a0 a1 b0 b1 c0 c1 (DL_L); T' goes over T.
constexpr int DL_T = 0, DL_P = 6, DL_S1 = 8, DL_S2 = 16, DL_L = 28;
constexpr int DL_BUF = DL_L + 6;

// K18's level 2: P beside T in the row's buffer t (DL_P), the unmasked
// line triple to l, T' over T.  Its fence is a __syncwarp (every lane of a
// K18 warp runs the same share): ptxas then does not start a share's next
// product before the last one is stored, and the shares fit 168 registers
// with no local memory (56 bytes of spill stores without).
struct TrioDblIo {
  uint64_t *t, *l;
  int stride;

  DT_HD void load_p(int i, uint64_t *x) const {
    flat_load(t, DL_P + i, stride, x);
  }
  DT_HD void line(const F2 &c, int i, const Mod &) const {
    f2_put(c, l, 2 * i, stride);
  }
  DT_HD bool keeps_t() const { return true; }
  DT_HD void fence() const {
#if defined(__CUDA_ARCH__)
    __syncwarp();
#endif
  }
  DT_HD void point(const F2 &v, int e) const {
    f2_put(v, t, DL_T + e, stride);
  }
};

// Share j of `level` for one pair: t, s1, s2 its buffers, io where level 2
// reads P and puts the line (cell i = 0, 1, 2 for a, b, c) and T'
// (element e = 0, 2, 4 for X', Y', Z'), and io.fence() between a share's
// products (K11's is empty).
template <class Io>
DT_HD void miller_dbl_share(int level, int j, const uint64_t *t,
                            uint64_t *s1, uint64_t *s2, const Io &io,
                            int stride, const Mod &M) {
  if (level == 0) {
    if (j < 2) {                          // XX or YY, and half of ZZ
      f2_put(f2_sqr(f2_at(t, 2 * j, stride), M), s1, 2 * j, stride);
      io.fence();
      const F2 Z = f2_at(t, 4, stride);
      uint64_t h[N_WORDS];
      if (j == 0)
        fp2_sqr_im(Z.x, Z.y, h, M);
      else
        fp2_sqr_re(Z.x, Z.y, h, M);
      flat_store(h, s1, 5 - j, stride);
    } else {
      f2_put(f2_mul(f2_at(t, 2, stride), f2_at(t, 4, stride), M), s1, 6,
             stride);
    }
  } else if (level == 1) {
    if (j == 0) {
      f2_put(f2_mul(f2_at(s1, 0, stride), f2_at(t, 0, stride), M), s2, 0,
             stride);
      io.fence();
      f2_put(f2_sqr(f2_at(s1, 2, stride), M), s2, 2, stride);
    } else if (j == 1) {
      f2_put(f2_mul(f2_at(s1, 6, stride), f2_at(s1, 4, stride), M), s2, 4,
             stride);
      io.fence();
      const F2 xyy = f2_add(f2_at(t, 0, stride), f2_at(s1, 2, stride), M);
      f2_put(f2_sqr(xyy, M), s2, 6, stride);
    } else {
      const F2 XX = f2_at(s1, 0, stride);
      f2_put(f2_mul(XX, f2_at(s1, 4, stride), M), s2, 8, stride);
      io.fence();
      f2_put(f2_sqr(f2_triple(XX, M), M), s2, 10, stride);
    }
  } else if (j == 0) {
    const F2 a = f2_sub(f2_triple(f2_at(s2, 0, stride), M),
                        f2_dbl(f2_at(s1, 2, stride), M), M);
    uint64_t xp[N_WORDS];
    io.load_p(0, xp);
    const F2 b = f2_mul_fp(f2_neg(f2_triple(f2_at(s2, 8, stride), M), M),
                           xp, M);
    io.line(a, 0, M);
    io.fence();
    io.line(b, 1, M);
  } else if (j == 1) {
    uint64_t yp[N_WORDS];
    io.load_p(1, yp);
    const F2 c = f2_mul_fp(f2_dbl(f2_at(s2, 4, stride), M), yp, M);
    io.line(c, 2, M);
    io.fence();
    if (io.keeps_t()) io.point(f2_dbl(f2_at(s1, 6, stride), M), 4);
  } else {
    const F2 XX = f2_at(s1, 0, stride), C = f2_at(s2, 2, stride);
    F2 D = f2_sub(f2_at(s2, 6, stride), f2_add(XX, C, M), M);
    D = f2_dbl(D, M);
    const F2 X2 = f2_sub(f2_at(s2, 10, stride), f2_dbl(D, M), M);
    if (io.keeps_t()) io.point(X2, 0);
    io.fence();
    const F2 Et = f2_mul(f2_triple(XX, M), f2_sub(D, X2, M), M);
    const F2 Y2 = f2_sub(Et, f2_dbl(f2_dbl(f2_dbl(C, M), M), M), M);
    if (io.keeps_t()) io.point(Y2, 2);
  }
}


// ---------------------------------------------------------------------------
// The Miller mixed-addition step (ops/pairing.py _add_step_plain, Q = (xq,
// yq) affine: with H = xq Z^2 - X and r = 2 (yq Z^3 - Y), the line is a =
// r xq - 2HZ yq, b = -r xp, c = 2HZ yp) split over three threads of a pair
// by its dependency levels, as miller_dbl_share splits the doubling, for
// both Miller executors: K12 (the merged iteration, B12) and K19 (the trio
// loop's step, B19).  Per pair, in flat_load's layout:
//
//   t   T, elements X0 X1 Y0 Y1 Z0 Z1
//   q   Q, elements xq0 xq1 yq0 yq1
//   s   the level values, elements: ZZ 0-1, yqZ 2-3 (then ZH2 from level
//       2 on), H 4-5, HH 6-7, r 8-9, HZ2 = 2 H Z 10-11, rr 12-13, the
//       line's b 14-15, J 16-17, V 18-19, the line's c 20-21, hzyq 22-23;
//       the line over elements 0-5, written at level 4
//
// and where the shares read P and put T' and the line, fixed at compile
// time by the executor's Io (MergedAddIo, TrioAddIo below).
//
// Share j of each level (Fp2 products 1776 multiply-adds, a product's
// half 888, squares 1248, Fp products 600):
//
//   level 0: j = 0, 1: yqZ = yq Z, its x or y half; 2: ZZ = Z^2
//   level 1: j = 0, 1: H = xq ZZ - X, its x or y half; 2: r = 2 (yqZ ZZ
//            - Y)
//   level 2: j = 0: HH = H^2, ZH2 = (Z + H)^2; 1: HZ2; 2: rr = r^2 and
//            the line's b = -r xp
//   level 3: with I = 4 HH: j = 0: J = H I and c's x, 2 HZ.x yp; 1: V =
//            X I and c's y; 2: hzyq = HZ2 yq, and Z' = ZH2 - ZZ - HH
//   level 4: with X' = rr - J - 2V: j = 0, 1: Y' = r (V - X') - 2 Y J,
//            its x or y half; 2: X', rxq = r xq, and the line: a = rxq -
//            hzyq, b, c
//
// so no level holds more than 2,496 multiply-adds on a thread (one
// thread alone: 25,152 a step).  Reads by level, for where T' may go: T.Z
// at levels 0 and 2, T.X at 1 and 3, T.Y at 1 and 4 (both j < 2 shares of
// level 4 read it whole), yq at 0 and 3, xq at 1 and 4, xp at 2, yp at 3;
// level 4 reads no element of s below 8.  Every intermediate is
// canonical, so the shares give _add_step_plain's outputs bit for bit.
// ---------------------------------------------------------------------------

// K12's: P (xp then yp, 32 limbs each) from device memory at p; T' to
// device memory, 6 x 32 limbs at t_out, T where the pair is inactive; the
// pair's flat line on LINE_IDX over the first six level values
// (line_put_cell: the flat one where the pair is inactive).
struct MergedAddIo {
  const int32_t *p;
  bool active;
  int32_t *t_out;
  const One &one;

  DT_HD void load_p(int i, uint64_t *x) const {
    load_words(p + i * N_LIMBS, x);
  }
  // T' coordinate pair e, e + 1 (e = 0 for X', 4 for Z')
  DT_HD void point(const F2 &v, int e, const uint64_t *t, int stride) const {
    f2_store(f2_select(active, v, f2_at(t, e, stride)), t_out + e * N_LIMBS,
             t_out + (e + 1) * N_LIMBS);
  }
  // T' coordinate e alone (e = 2, 3: Y's halves)
  DT_HD void point_half(uint64_t *h, int e, const uint64_t *t,
                        int stride) const {
    uint64_t w[N_WORDS];
    flat_load(t, e, stride, w);
    DT_UNROLL
    for (int v = 0; v < N_WORDS; v++) h[v] = active ? h[v] : w[v];
    store_words(h, t_out + e * N_LIMBS);
  }
  DT_HD void line(const F2 &c, int i, uint64_t *s, int stride,
                  const Mod &M) const {
    line_put_cell(c, i, active, one, s, stride, M);
  }
};

// A K19 row's buffer, in elements: T, Q and P as staged (X0 X1 Y0 Y1 Z0
// Z1 xq0 xq1 yq0 yq1 xp yp: AL_T, AL_Q, AL_P), then the level values
// (AL_S, miller_add_share's s).  T' goes where nothing of its level or a
// later one still reads: Z' over T.Z (level 3), X' over T.X and Y' over yq
// (level 4: both Y' shares read T.Y whole); the unmasked line triple a0
// a1 b0 b1 c0 c1 over the first six level values.
constexpr int AL_T = 0, AL_Q = 6, AL_P = 10, AL_S = 12;
constexpr int AL_BUF = AL_S + MA_SW;

// The element of a K19 row's buffer that holds coordinate c of T'.
DT_HD int al_t_out(int c) { return c == 2 || c == 3 ? AL_Q + c : AL_T + c; }

// K19's: P from the row's buffer b (AL_P), T' into it (al_t_out), the
// line triple over s.
struct TrioAddIo {
  uint64_t *b;
  int stride;

  DT_HD void load_p(int i, uint64_t *x) const {
    flat_load(b, AL_P + i, stride, x);
  }
  DT_HD void point(const F2 &v, int e, const uint64_t *, int) const {
    f2_put(v, b, al_t_out(e), stride);
  }
  DT_HD void point_half(uint64_t *h, int e, const uint64_t *, int) const {
    flat_store(h, b, al_t_out(e), stride);
  }
  DT_HD void line(const F2 &c, int i, uint64_t *s, int,
                  const Mod &) const {
    f2_put(c, s, 2 * i, stride);
  }
};

// Share j of `level` for one pair: t, q, s its buffers, io where the
// shares read P and put T' and the line.
template <class Io>
DT_HD void miller_add_share(int level, int j, const uint64_t *t,
                            const uint64_t *q, uint64_t *s, const Io &io,
                            int stride, const Mod &M) {
  uint64_t h[N_WORDS], u[N_WORDS], w[N_WORDS];
  if (level == 0) {
    const F2 Z = f2_at(t, 4, stride);
    if (j < 2) {
      f2_mul_half(j, f2_at(q, 2, stride), Z, h, M);
      flat_store(h, s, 2 + j, stride);
    } else {
      f2_put(f2_sqr(Z, M), s, 0, stride);
    }
  } else if (level == 1) {
    const F2 ZZ = f2_at(s, 0, stride);
    if (j < 2) {
      f2_mul_half(j, f2_at(q, 0, stride), ZZ, u, M);
      flat_load(t, j, stride, w);
      sub_mod(u, w, h, M);
      flat_store(h, s, 4 + j, stride);
    } else {
      const F2 S2 = f2_mul(f2_at(s, 2, stride), ZZ, M);
      f2_put(f2_dbl(f2_sub(S2, f2_at(t, 2, stride), M), M), s, 8, stride);
    }
  } else if (level == 2) {
    const F2 H = f2_at(s, 4, stride);
    if (j == 0) {
      f2_put(f2_sqr(H, M), s, 6, stride);
      f2_put(f2_sqr(f2_add(f2_at(t, 4, stride), H, M), M), s, 2, stride);
    } else if (j == 1) {
      f2_put(f2_dbl(f2_mul(H, f2_at(t, 4, stride), M), M), s, 10, stride);
    } else {
      const F2 r = f2_at(s, 8, stride);
      f2_put(f2_sqr(r, M), s, 12, stride);
      io.load_p(0, w);
      f2_put(f2_mul_fp(f2_neg(r, M), w, M), s, 14, stride);
    }
  } else if (level == 3) {
    const F2 I = f2_dbl(f2_dbl(f2_at(s, 6, stride), M), M);
    if (j < 2) {
      const F2 HX = j == 0 ? f2_at(s, 4, stride) : f2_at(t, 0, stride);
      f2_put(f2_mul(HX, I, M), s, 16 + 2 * j, stride);
      io.load_p(1, w);
      flat_load(s, 10 + j, stride, u);
      mont_mul_words(u, w, h, M);
      flat_store(h, s, 20 + j, stride);
    } else {
      f2_put(f2_mul(f2_at(s, 10, stride), f2_at(q, 2, stride), M), s, 22,
             stride);
      const F2 Z2 = f2_sub(f2_at(s, 2, stride),
                           f2_add(f2_at(s, 0, stride), f2_at(s, 6, stride), M),
                           M);
      io.point(Z2, 4, t, stride);
    }
  } else {
    const F2 r = f2_at(s, 8, stride), J = f2_at(s, 16, stride),
             V = f2_at(s, 18, stride);
    const F2 X2 = f2_sub(f2_sub(f2_at(s, 12, stride), J, M), f2_dbl(V, M), M);
    if (j < 2) {
      const F2 Y = f2_at(t, 2, stride);
      f2_mul_half(j, r, f2_sub(V, X2, M), u, M);
      f2_mul_half(j, Y, J, w, M);
      add_mod(w, w, w, M);
      sub_mod(u, w, h, M);
      io.point_half(h, 2 + j, t, stride);
    } else {
      io.point(X2, 0, t, stride);
      const F2 a = f2_sub(f2_mul(r, f2_at(q, 0, stride), M),
                          f2_at(s, 22, stride), M);
      io.line(a, 0, s, stride, M);
      io.line(f2_at(s, 14, stride), 1, s, stride, M);
      io.line(f2_at(s, 20, stride), 2, s, stride, M);
    }
  }
}


// ---------------------------------------------------------------------------
// B9 in chain form (K9): n dbl-2009-l doublings of a row's point (the
// formula of ops/curve.py point_double, n times), split over three
// threads of the row by dependency level as miller_dbl_share splits B11's
// step, a barrier between levels.  K10 runs the same shares at n = 1 for
// its doubling of P1 (g2_add_share).  Per row, in flat_load's layout:
//
//   t   the point, elements X0 X1 Y0 Y1 Z0 Z1, doubled in place at level
//       2 (which reads no T)
//   s   the level values, elements: A = X^2 0-1 in even doublings and
//       2-3 in odd ones, B = Y^2 4-5, YZ 6-7, C = B^2 8-9,
//       S2 = (X + B)^2 10-11, F = (3A)^2 12-13
//
// Share j of each level of doubling i of n (squares 1248 multiply-adds,
// a product's half 888):
//
//   level 0: j = 0: B; 1, 2: YZ = Y Z, its x or y half -- in the first
//            doubling 1: YZ whole and 2: A (later ones have theirs)
//   level 1: j = 0: C; 1: S2; 2: F
//   level 2: with D = 2 (S2 - A - C) and X' = F - 2D: j = 0, 1: Y' =
//            3A (D - X') - 8C, its x or y half; 2: X', Z' = 2 YZ and,
//            unless this doubling is the last, the next one's A = X'^2
//
// Level 2's only product is split by halves, and its third thread begins
// the next doubling, so every level holds at most one square (1248) on a
// thread: 3,744 a doubling on the longest path against 9,792 in all.
// Infinity (Z = 0) stays infinity: Z' = 2 YZ.  Every intermediate is
// canonical, so n rounds of shares give the formula's output n times
// over bit for bit.
// ---------------------------------------------------------------------------

constexpr int G2_DBL_BUF = 20;          // elements of a row: t (6), s (14)

DT_HD void g2_dbl_share(int level, int j, int i, int n, uint64_t *t,
                        uint64_t *s, int stride, const Mod &M) {
  const int a_at = 2 * (i & 1);
  uint64_t h[N_WORDS];
  if (level == 0) {
    const F2 Y = f2_at(t, 2, stride);
    if (j == 0) {
      f2_put(f2_sqr(Y, M), s, 4, stride);
    } else if (i > 0) {
      f2_mul_half(j - 1, Y, f2_at(t, 4, stride), h, M);
      flat_store(h, s, 5 + j, stride);
    } else if (j == 1) {
      f2_put(f2_mul(Y, f2_at(t, 4, stride), M), s, 6, stride);
    } else {
      f2_put(f2_sqr(f2_at(t, 0, stride), M), s, a_at, stride);
    }
  } else if (level == 1) {
    if (j == 0)
      f2_put(f2_sqr(f2_at(s, 4, stride), M), s, 8, stride);
    else if (j == 1)
      f2_put(f2_sqr(f2_add(f2_at(t, 0, stride), f2_at(s, 4, stride), M), M),
             s, 10, stride);
    else
      f2_put(f2_sqr(f2_triple(f2_at(s, a_at, stride), M), M), s, 12, stride);
  } else {
    const F2 A = f2_at(s, a_at, stride);
    F2 D = f2_sub(f2_at(s, 10, stride), f2_add(A, f2_at(s, 8, stride), M), M);
    D = f2_dbl(D, M);
    const F2 X2 = f2_sub(f2_at(s, 12, stride), f2_dbl(D, M), M);
    if (j < 2) {
      f2_mul_half(j, f2_triple(A, M), f2_sub(D, X2, M), h, M);
      uint64_t c8[N_WORDS];               // 8C, half j
      flat_load(s, 8 + j, stride, c8);
      add_mod(c8, c8, c8, M);
      add_mod(c8, c8, c8, M);
      add_mod(c8, c8, c8, M);
      sub_mod(h, c8, h, M);
      flat_store(h, t, 2 + j, stride);
    } else {
      f2_put(X2, t, 0, stride);
      f2_put(f2_dbl(f2_at(s, 6, stride), M), t, 4, stride);
      if (i + 1 < n) f2_put(f2_sqr(X2, M), s, 2 - a_at, stride);
    }
  }
}

// ---------------------------------------------------------------------------
// B10 (K10): the general Jacobian addition P1 + P2 of ops/curve.py
// point_add, every case branchless (infinities, P + (-P) = infinity and,
// where with_double, P + P the doubling of P1), split over three threads
// of the row by the dependency levels the Pallas kernel stacks, a barrier
// after each level.  Every Fp2 product and square of the addition is
// taken as two half-products (fp2_half, 888 multiply-adds each, squares
// as products), and share j of a level is a short list of them (ga_task)
// run through one fp2_half body in a loop, so the kernel holds one copy
// of the product code: 42k instructions, where these levels written
// with their products inlined took 101k and, without the doubling, ran
// 1.4x slower, their code far past the instruction cache.  With
// h = u2 - u1 and rr = 2 (s2 - s1):
//
//   level 0: j = 0, 1: Z1^2 or Z2^2, and Y1 Z2's x or y half; 2: Y2 Z1
//   level 1: j = 0, 1: u1 = X1 Z2^2 or u2 = X2 Z1^2, and s1 = Y1 Z2 Z2^2's
//            x or y half; 2: s2 = Y2 Z1 Z1^2
//   level 2: j = 0: i = (2h)^2; 1, 2: zz = (Z1 + Z2)^2 - Z1^2 - Z2^2, its
//            x or y half
//   level 3: j = 0: j = h i; 1, 2: v = u1 i and rr2 = rr^2, their x or y
//            halves; and every thread the cases: inf1, inf2 (Z = 0),
//            u1 = u2, s1 = s2
//   level 4: with X3 = rr2 - j - 2v: j = 0, 1: Y3 = rr (v - X3) - 2 s1 j,
//            its x or y half; 2: X3 and Z3 = zz h; then each thread picks
//            its elements of the sum by the cases, P2's read from device
//            memory
//
// With with_double the doubling of P1 runs beside them: g2_dbl_share's
// level 0 at level 1 (share (3 - j) % 3, so the thread with the lighter
// addition share takes YZ), its level 1 at level 2, and its level 2 at
// level 4, where share j writes into P1 exactly the elements that thread
// j owns: each thread reads its elements of P1 before that.  No thread
// carries more than three half-products in a level, 2,664 multiply-adds
// (3,912 with the doubling, level 1); the longest path over the threads
// is 10,656 of 28,416 a row (14,040 of 38,208 with the doubling).
//
// A row's buffer, in flat_load's layout, 36 elements (GA_BUF) with or
// without the doubling, each slot taken again once what it held is
// read for the last time:
//
//   0-5    P1 (X1 Y1 Z1), the sum over it at level 4
//   6-7    Z2 (P2's X2 and Y2 are staged into the doubling's slots)
//   8-11   Z1^2, Z2^2 (level 0); j, v over them (level 3)
//   12-13  Y2 Z1 (level 0); i over it (level 2)
//   14-21  u1, u2, s1, s2 (level 1)
//   22-35  g2_dbl_share's level values at n = 1 (GA_DBL): A 22, B 26,
//          YZ 28 (its level 0, at level 1), C 30, S2 32, F 34 (its
//          level 1, at level 2); and the addition's zz 24 (in the slot
//          the doubling's odd steps use), rr2 26 (over B, level 3), X2
//          30 and Y2 32 (read at levels 1 and 0), Y1 Z2 34 (level 0)
//
// Every intermediate is canonical, so the shares give the formula's
// output bit for bit.
// ---------------------------------------------------------------------------

constexpr int GA_P1 = 0, GA_Z2 = 6, GA_Z1Z1 = 8, GA_Z2Z2 = 10;
constexpr int GA_Y2Z1 = 12, GA_U1 = 14, GA_U2 = 16, GA_S1 = 18, GA_S2 = 20;
constexpr int GA_DBL = 22, GA_ZZ = GA_DBL + 2, GA_RR2 = GA_DBL + 4;
constexpr int GA_X2 = GA_DBL + 8, GA_Y2 = GA_DBL + 10, GA_Y1Z2 = GA_DBL + 12;
constexpr int GA_I = GA_Y2Z1, GA_J = GA_Z1Z1, GA_V = GA_Z2Z2;
constexpr int GA_BUF = GA_DBL + 14;                // elements of a row

// The element P2's coordinate c (X0 X1 Y0 Y1 Z0 Z1) is staged into.
DT_HD int ga_p2_at(int c) {
  return c < 2 ? GA_X2 + c : c < 4 ? GA_Y2 + c - 2 : GA_Z2 + c - 4;
}

// The cases of a row, found at level 3 and used at level 4.
struct G2AddCase {
  bool inf1, inf2, eq_u, eq_s;
};

DT_HD F2 ga_h(const uint64_t *b, int stride, const Mod &M) {
  return f2_sub(f2_at(b, GA_U2, stride), f2_at(b, GA_U1, stride), M);
}

DT_HD F2 ga_rr(const uint64_t *b, int stride, const Mod &M) {
  return f2_dbl(f2_sub(f2_at(b, GA_S2, stride), f2_at(b, GA_S1, stride), M),
                M);
}

// X3 = rr2 - j - 2v, from level 3's values
DT_HD F2 ga_x3(const uint64_t *b, int stride, const Mod &M) {
  return f2_sub(f2_sub(f2_at(b, GA_RR2, stride), f2_at(b, GA_J, stride), M),
                f2_dbl(f2_at(b, GA_V, stride), M), M);
}

// Operands of K10's half-products: an element of the buffer (e >= 0, the
// Fp2 value at e and e + 1), or one formed from level values.
constexpr int GA_OP_H = -1, GA_OP_2H = -2, GA_OP_RR = -3, GA_OP_Z12 = -4,
              GA_OP_VX3 = -5;
// What a half-product's result becomes: a buffer element (>= 0), the x
// or y half of zz = (Z1 + Z2)^2 - Z1^2 - Z2^2, or a register of level 4.
constexpr int GA_TO_ZZ = -1, GA_TO_ACC = -2, GA_TO_Y3 = -3, GA_TO_Z3Y = -4;

DT_HD F2 ga_operand(int src, const uint64_t *b, int stride, const Mod &M) {
  switch (src) {
    case GA_OP_H:
      return ga_h(b, stride, M);
    case GA_OP_2H:
      return f2_dbl(ga_h(b, stride, M), M);
    case GA_OP_RR:
      return ga_rr(b, stride, M);
    case GA_OP_Z12:
      return f2_add(f2_at(b, GA_P1 + 4, stride), f2_at(b, GA_Z2, stride), M);
    case GA_OP_VX3:
      return f2_sub(f2_at(b, GA_V, stride), ga_x3(b, stride, M), M);
    default:
      return f2_at(b, src, stride);
  }
}

// Half-product t of share j at `level` (the schedule above): operands a
// and b, half h, destination `to`.  False past the share's last one.
struct GaTask {
  int a, b, h, to;
};

DT_HD bool ga_task(int level, int j, int t, GaTask &k) {
  constexpr int X1 = GA_P1, Y1 = GA_P1 + 2, Z1 = GA_P1 + 4;
  const int q = j < 2 ? j : 0;            // the half a share j < 2 takes
  switch (level * 3 + j) {
    case 0:                               // Z1^2, Y1 Z2's x
    case 1:                               // Z2^2, Y1 Z2's y
      if (t < 2) k = {j ? GA_Z2 : Z1, j ? GA_Z2 : Z1, t, GA_Z1Z1 + 2 * j + t};
      else k = {Y1, GA_Z2, q, GA_Y1Z2 + q};
      return t < 3;
    case 2:                               // Y2 Z1
      k = {GA_Y2, Z1, t, GA_Y2Z1 + t};
      return t < 2;
    case 3:                               // u1, s1's x
    case 4:                               // u2, s1's y
      if (t < 2)
        k = {j ? GA_X2 : X1, j ? GA_Z1Z1 : GA_Z2Z2, t, GA_U1 + 2 * j + t};
      else k = {GA_Y1Z2, GA_Z2Z2, q, GA_S1 + q};
      return t < 3;
    case 5:                               // s2
      k = {GA_Y2Z1, GA_Z1Z1, t, GA_S2 + t};
      return t < 2;
    case 6:                               // i = (2h)^2
      k = {GA_OP_2H, GA_OP_2H, t, GA_I + t};
      return t < 2;
    case 7:                               // zz's x
    case 8:                               // zz's y
      k = {GA_OP_Z12, GA_OP_Z12, j - 1, GA_TO_ZZ};
      return t < 1;
    case 9:                               // j = h i
      k = {GA_OP_H, GA_I, t, GA_J + t};
      return t < 2;
    case 10:                              // v's and rr2's x
    case 11:                              // v's and rr2's y
      if (t == 0) k = {GA_U1, GA_I, j - 1, GA_V + j - 1};
      else k = {GA_OP_RR, GA_OP_RR, j - 1, GA_RR2 + j - 1};
      return t < 2;
    case 12:                              // Y3's x: rr (v - X3), 2 s1 j
    case 13:                              // Y3's y
      if (t == 0) k = {GA_OP_RR, GA_OP_VX3, j, GA_TO_ACC};
      else k = {GA_S1, GA_J, j, GA_TO_Y3};
      return t < 2;
    default:                              // Z3 = zz h
      k = {GA_ZZ, GA_OP_H, t, t ? GA_TO_Z3Y : GA_TO_ACC};
      return t < 2;
  }
}

// Element e of the sum, written over P1's: the addition's value `sum`,
// or by the cases the doubling's (in P1's slot by then, where it ran),
// (1, 1, 0), P2's (coordinate e of the row in device memory, p2 + e * cs
// limbs; zero where p2 is null, a row past the end) or P1's (`p1`, read
// before the doubling wrote there).
DT_HD void ga_pick(int e, const uint64_t *sum, const uint64_t *p1,
                   const int32_t *p2, long long cs, bool with_double,
                   const G2AddCase &c, const One &one, uint64_t *b,
                   int stride) {
  uint64_t d[N_WORDS], q[N_WORDS] = {0, 0, 0, 0, 0, 0}, r[N_WORDS];
  flat_load(b, GA_P1 + e, stride, d);
  if (p2 != nullptr) load_words(p2 + e * cs, q);
  const bool use_dbl = with_double && c.eq_u && c.eq_s;
  const bool cancel = c.eq_u && !c.eq_s;
  const bool one_el = e == 0 || e == 2;   // X0 and Y0 of (1, 1, 0)
  DT_UNROLL
  for (int v = 0; v < N_WORDS; v++) {
    uint64_t x = use_dbl ? d[v] : sum[v];
    x = cancel ? (one_el ? one.w[v] : 0) : x;
    x = c.inf1 ? q[v] : x;
    r[v] = c.inf2 && !c.inf1 ? p1[v] : x;
  }
  flat_store(r, b, GA_P1 + e, stride);
}

// p2: the row's P2 in device memory (coordinate c at p2 + c * cs limbs),
// null for a row past the end; read only by the picks of level 4.
DT_HD void g2_add_share(int level, int j, bool with_double, uint64_t *b,
                        G2AddCase &c, const int32_t *p2, long long cs,
                        const One &one, int stride, const Mod &M) {
  uint64_t *dbl = b + GA_DBL * N_WORDS * stride;
  if (with_double && level == 1)
    g2_dbl_share(0, (3 - j) % 3, 0, 1, b, dbl, stride, M);
  if (with_double && level == 2) g2_dbl_share(1, j, 0, 1, b, dbl, stride, M);
  uint64_t acc[N_WORDS] = {}, sum[N_WORDS] = {}, r[N_WORDS], w[N_WORDS];
  GaTask k;
  for (int t = 0; ga_task(level, j, t, k); t++) {
    fp2_half(k.h, ga_operand(k.a, b, stride, M), ga_operand(k.b, b, stride, M),
             r, M);
    if (k.to >= 0) {
      flat_store(r, b, k.to, stride);
    } else if (k.to == GA_TO_ZZ) {
      flat_load(b, GA_Z1Z1 + k.h, stride, acc);
      flat_load(b, GA_Z2Z2 + k.h, stride, w);
      add_mod(acc, w, acc, M);
      sub_mod(r, acc, r, M);
      flat_store(r, b, GA_ZZ + k.h, stride);
    } else if (k.to == GA_TO_Y3) {        // Y3 = rr (v - X3) - 2 s1 j
      add_mod(r, r, r, M);
      sub_mod(acc, r, sum, M);
    } else {
      DT_UNROLL
      for (int v = 0; v < N_WORDS; v++) {
        acc[v] = k.to == GA_TO_ACC ? r[v] : acc[v];
        sum[v] = k.to == GA_TO_Z3Y ? r[v] : sum[v];
      }
    }
  }
  if (level == 3) {
    c.inf1 = f2_is_zero(f2_at(b, GA_P1 + 4, stride));
    c.inf2 = f2_is_zero(f2_at(b, GA_Z2, stride));
    c.eq_u = f2_eq(f2_at(b, GA_U1, stride), f2_at(b, GA_U2, stride)) &&
             !c.inf1 && !c.inf2;
    c.eq_s = f2_eq(f2_at(b, GA_S1, stride), f2_at(b, GA_S2, stride));
  } else if (level == 4 && j < 2) {       // Y3's half j
    flat_load(b, GA_P1 + 2 + j, stride, w);
    if (with_double) g2_dbl_share(2, j, 0, 1, b, dbl, stride, M);
    ga_pick(2 + j, sum, w, p2, cs, with_double, c, one, b, stride);
  } else if (level == 4) {                // X3, and Z3 = (acc, sum)
    const F2 X3 = ga_x3(b, stride, M);
    const F2 X1 = f2_at(b, GA_P1, stride), Z1 = f2_at(b, GA_P1 + 4, stride);
    if (with_double) g2_dbl_share(2, 2, 0, 1, b, dbl, stride, M);
    ga_pick(0, X3.x, X1.x, p2, cs, with_double, c, one, b, stride);
    ga_pick(1, X3.y, X1.y, p2, cs, with_double, c, one, b, stride);
    ga_pick(4, acc, Z1.x, p2, cs, with_double, c, one, b, stride);
    ga_pick(5, sum, Z1.y, p2, cs, with_double, c, one, b, stride);
  }
}

}  // namespace dt
