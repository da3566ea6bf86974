// Host build of the kernels' arithmetic (field_arith.cuh, field_arith32.cuh,
// tower_arith.cuh, curve_arith.cuh), one loop per kernel over its elements
// or rows, with
// the C interface of field_kernels.cu, tower_kernels.cu, curve_kernels.cu
// and miller_kernels.cu minus the stream (dth_ for dt_).
// tests/test_torch_kernel_harness.py compiles it with g++ and holds it
// against the plain PyTorch versions on a machine with no CUDA:
//
//   g++ -std=c++17 -O2 -shared -fPIC -o libfield_host.so field_host.cpp

#include "curve_arith.cuh"
#include "field_arith32.cuh"

// The six classes of K13 in turn, on one row's words laid out with
// stride 1 (the kernel stages them in shared memory with stride 32), as
// K13's instance for a sparse b runs them.
static void flat_mul_rows(const int32_t *a, const int32_t *b, int32_t *o,
                          long long rows, const dt::FlatIdx &idx, int J,
                          const dt::Mod &M) {
  uint64_t wa[dt::FLAT * dt::N_WORDS], wb[dt::FLAT * dt::N_WORDS];
  for (long long r = 0; r < rows; r++) {
    for (int i = 0; i < dt::FLAT; i++)
      dt::load_words(a + (r * dt::FLAT + i) * dt::N_LIMBS,
                     wa + i * dt::N_WORDS);
    for (int i = 0; i < J; i++)
      dt::load_words(b + (r * J + i) * dt::N_LIMBS, wb + i * dt::N_WORDS);
    int32_t *out = o + r * dt::FLAT * dt::N_LIMBS;
    for (int j = 0; j < 6; j++) {
      uint64_t lo[dt::N_WORDS], hi[dt::N_WORDS];
      dt::flat_mul_slots(j, wa, wb, 1, idx, lo, hi, M);
      dt::store_words(lo, out + j * dt::N_LIMBS);
      dt::store_words(hi, out + (j + 6) * dt::N_LIMBS);
    }
  }
}

// K13's dense instance: each Karatsuba phase for the six classes in turn
// (in reverse order when `reverse`), as its barriers order them.
static void flat_kara_rows(const int32_t *a, const int32_t *b, int32_t *o,
                           long long rows, int reverse, const dt::Mod &M) {
  uint64_t wa[dt::FLAT * dt::N_WORDS], wb[dt::FLAT * dt::N_WORDS];
  uint64_t lo[6][dt::N_WORDS], hi[6][dt::N_WORDS];
  for (long long r = 0; r < rows; r++) {
    for (int i = 0; i < dt::FLAT; i++) {
      dt::load_words(a + (r * dt::FLAT + i) * dt::N_LIMBS,
                     wa + i * dt::N_WORDS);
      dt::load_words(b + (r * dt::FLAT + i) * dt::N_LIMBS,
                     wb + i * dt::N_WORDS);
    }
    for (int j = 0; j < 6; j++)
      for (int v = 0; v < dt::N_WORDS; v++) lo[j][v] = hi[j][v] = 0;
    for (int s = 0; s < 6; s++) {
      const int j = reverse ? 5 - s : s;
      dt::flat_kara_phase(0, j, wa, wb, 1, lo[j], hi[j], M);
    }
    for (int s = 0; s < 6; s++)
      dt::flat_kara_sums(reverse ? 5 - s : s, wa, wb, 1, M);
    for (int s = 0; s < 6; s++) {
      const int j = reverse ? 5 - s : s;
      dt::flat_kara_phase(1, j, wa, wb, 1, lo[j], hi[j], M);
    }
    int32_t *out = o + r * dt::FLAT * dt::N_LIMBS;
    for (int j = 0; j < 6; j++) {
      dt::store_words(lo[j], out + j * dt::N_LIMBS);
      dt::store_words(hi[j], out + (j + 6) * dt::N_LIMBS);
    }
  }
}

extern "C" {

// K1 on the 32-bit carry-chain arithmetic.
void dth_mont_mul(const int32_t *a, const int32_t *b, int32_t *o, long long n,
                  const uint64_t *mod7) {
  const dt::Mod32 M = dt::mod32_from_words(mod7);
  uint32_t x[dt::N_WORDS32], y[dt::N_WORDS32];
  for (long long e = 0; e < n; e++) {
    dt::load_words32(a + e * dt::N_LIMBS, x);
    dt::load_words32(b + e * dt::N_LIMBS, y);
    dt::mont_mul32(y, x, x, M);                // as K1: b the multiplicand
    dt::store_words32(x, o + e * dt::N_LIMBS);
  }
}

// K2 (and K4's square) on the 32-bit carry-chain arithmetic.
void dth_mont_sqr(const int32_t *a, int32_t *o, long long n,
                  const uint64_t *mod7) {
  const dt::Mod32 M = dt::mod32_from_words(mod7);
  uint32_t x[dt::N_WORDS32];
  for (long long e = 0; e < n; e++) {
    dt::load_words32(a + e * dt::N_LIMBS, x);
    dt::mont_sqr32(x, x, M);
    dt::store_words32(x, o + e * dt::N_LIMBS);
  }
}

void dth_mont_reduce(const int32_t *t, int32_t *o, long long n,
                     const uint64_t *mod7) {
  const dt::Mod M = dt::mod_from_words(mod7);
  for (long long e = 0; e < n; e++)
    dt::mont_reduce_limbs(t + e * dt::W_LIMBS, o + e * dt::N_LIMBS, M);
}

// K4: the program `steps` row by row, scratch as the kernel lays it out
// (48 bytes a row for each slot the program uses; null when none).
void dth_fp_pow_chain(const int32_t *a, const int32_t *t, int32_t *o,
                      long long n, const int32_t *steps, int n_steps,
                      uint32_t *scratch, const uint64_t *mod7) {
  const dt::Mod32 M = dt::mod32_from_words(mod7);
  for (long long e = 0; e < n; e++)
    dt::chain_row(a, t, o, steps, n_steps, scratch, n, e, M);
}

// K4 at one step, the one-step program the wrapper gives it.
void dth_sqr_chain_mul(const int32_t *a, const int32_t *t, int32_t *o,
                       long long n, int k, const uint64_t *mod7) {
  const int code = k << 8 | dt::CHAIN_SQRMUL << 6 |
                   (t != nullptr ? dt::CHAIN_T : dt::CHAIN_NONE);
  dth_fp_pow_chain(a, t, o, n, &code, 1, nullptr, mod7);
}

// K5: per pair-row its two lanes in turn (in reverse order when
// `reverse`), lane h writing half h of the product (fp2_half).
void dth_fp2_products(const int32_t *x, const int32_t *y, int32_t *o,
                      long long rows, int n, int reverse,
                      const uint64_t *mod7) {
  const dt::Mod M = dt::mod_from_words(mod7);
  for (long long p = 0; p < n; p++)
    for (long long r = 0; r < rows; r++) {
      const long long c0 = (2 * p * rows + r) * dt::N_LIMBS;
      const long long c1 = c0 + rows * dt::N_LIMBS;
      const dt::F2 a = dt::f2_load(x + c0, x + c1);
      const dt::F2 b = dt::f2_load(y + c0, y + c1);
      for (int l = 0; l < 2; l++) {
        const int h = reverse ? 1 - l : l;
        uint64_t half[dt::N_WORDS];
        dt::fp2_half(h, a, b, half, M);
        dt::store_words(half, o + (h ? c1 : c0));
      }
    }
}

// K6 the same way: lane h writes half h of the square (fp2_sqr_lane32).
void dth_fp2_sqrs(const int32_t *x, int32_t *o, long long rows, int n,
                  int reverse, const uint64_t *mod7) {
  const dt::Mod M = dt::mod_from_words(mod7);
  const dt::Mod32 M32 = dt::mod32_from_words(mod7);
  for (long long p = 0; p < n; p++)
    for (long long r = 0; r < rows; r++) {
      const long long c0 = (2 * p * rows + r) * dt::N_LIMBS;
      const long long c1 = c0 + rows * dt::N_LIMBS;
      const dt::F2 a = dt::f2_load(x + c0, x + c1);
      for (int l = 0; l < 2; l++) {
        const int h = reverse ? 1 - l : l;
        uint64_t half[dt::N_WORDS];
        dt::fp2_sqr_lane32(h, a.x, a.y, half, M, M32);
        dt::store_words(half, o + (h ? c1 : c0));
      }
    }
}

// K13 through the instance of b_idx (the dense one's phases in the
// kernel's order of classes or, when `reverse`, reversed).
void dth_flat_mul(const int32_t *a, const int32_t *b, int32_t *o,
                  long long rows, const int *b_idx, int J, int reverse,
                  const uint64_t *mod7) {
  const dt::Mod M = dt::mod_from_words(mod7);
  const dt::FlatIdx idx = dt::flat_idx(b_idx, J);
  if (dt::flat_pattern(b_idx, J) == dt::FlatB::DENSE)
    flat_kara_rows(a, b, o, rows, reverse, M);
  else
    flat_mul_rows(a, b, o, rows, idx, J, M);
}

// K17: the six classes in turn on one row's words, each folding its
// coefficients into its two output elements of wo (flat_sqr_slots).
void dth_flat_sqr(const int32_t *a, int32_t *o, long long rows,
                  const uint64_t *mod7) {
  const dt::Mod M = dt::mod_from_words(mod7);
  uint64_t wa[dt::FLAT * dt::N_WORDS], wo[dt::FLAT * dt::N_WORDS];
  for (long long r = 0; r < rows; r++) {
    for (int i = 0; i < dt::FLAT; i++)
      dt::load_words(a + (r * dt::FLAT + i) * dt::N_LIMBS,
                     wa + i * dt::N_WORDS);
    for (int j = 0; j < 6; j++) dt::flat_sqr_slots(j, wa, wo, 1, M);
    for (int i = 0; i < dt::FLAT; i++)
      dt::store_words(wo + i * dt::N_WORDS,
                      o + (r * dt::FLAT + i) * dt::N_LIMBS);
  }
}

// K20: the six classes in turn on one row's words.
void dth_line_merge(const int32_t *l1, const int32_t *l2, int32_t *o,
                    long long rows, const uint64_t *mod7) {
  const dt::Mod M = dt::mod_from_words(mod7);
  uint64_t w1[6 * dt::N_WORDS], w2[6 * dt::N_WORDS];
  for (long long r = 0; r < rows; r++) {
    for (int i = 0; i < 6; i++) {
      dt::load_words(l1 + (r * 6 + i) * dt::N_LIMBS, w1 + i * dt::N_WORDS);
      dt::load_words(l2 + (r * 6 + i) * dt::N_LIMBS, w2 + i * dt::N_WORDS);
    }
    int32_t *out = o + r * dt::FLAT * dt::N_LIMBS;
    for (int j = 0; j < 6; j++) {
      uint64_t lo[dt::N_WORDS], hi[dt::N_WORDS];
      dt::line_merge_class(j, w1, w2, 1, lo, hi, M);
      dt::store_words(lo, out + j * dt::N_LIMBS);
      dt::store_words(hi, out + (j + 6) * dt::N_LIMBS);
    }
  }
}

// K14's chain: per row the shares of each phase in turn (in reverse
// order when `reverse`: a share that read what another share of its
// phase writes would then give another result), on one row's words laid
// out with stride 1 (the kernel's stride is its 32 rows).
void dth_cyclo_sqr(const int32_t *a, int32_t *o, long long rows, int k,
                   int reverse, const uint64_t *mod7) {
  const dt::Mod M = dt::mod_from_words(mod7);
  uint64_t cells[dt::FLAT * dt::N_WORDS], sq[18 * dt::N_WORDS];
  for (long long r = 0; r < rows; r++) {
    for (int i = 0; i < dt::FLAT; i++)
      dt::load_words(a + (r * dt::FLAT + i) * dt::N_LIMBS,
                     cells + i * dt::N_WORDS);
    for (int s = 0; s < 6; s++) dt::cyclo_to_cell(s, cells, 1, M);
    for (int i = 0; i < k; i++) {
      for (int q = 0; q < 9; q++)
        dt::cyclo_sqr_square(reverse ? 8 - q : q, cells, sq, 1, M);
      for (int s = 0; s < 6; s++)
        dt::cyclo_sqr_fold(reverse ? 5 - s : s, cells, sq, 1, M);
    }
    for (int s = 0; s < 6; s++) dt::cyclo_to_flat(s, cells, 1, M);
    for (int i = 0; i < dt::FLAT; i++)
      dt::store_words(cells + i * dt::N_WORDS,
                      o + (r * dt::FLAT + i) * dt::N_LIMBS);
  }
}

// K7's chain: per row the two lanes' halves of each square and of the
// product in turn (in reverse order when `reverse`), each lane writing
// its own half, then both halves swapped in, as the kernel's shuffle
// does.
void dth_fp2_sqr_chain_mul(const int32_t *x, const int32_t *t, int32_t *o,
                           long long rows, int k, int reverse,
                           const uint64_t *mod7) {
  const dt::Mod M = dt::mod_from_words(mod7);
  dt::F2 cur, tt;
  uint64_t nxt[2][dt::N_WORDS];
  for (long long r = 0; r < rows; r++) {
    cur = dt::f2_load(x + r * dt::N_LIMBS, x + (rows + r) * dt::N_LIMBS);
    if (t != nullptr)
      tt = dt::f2_load(t + r * dt::N_LIMBS, t + (rows + r) * dt::N_LIMBS);
    for (int s = 0; s < k + (t != nullptr); s++) {   // k squares, the product
      for (int l = 0; l < 2; l++) {
        const int h = reverse ? 1 - l : l;
        if (s < k)
          dt::fp2_sqr_lane(h, cur.x, cur.y, nxt[h], M);
        else
          dt::fp2_half(h, cur, tt, nxt[h], M);
      }
      for (int v = 0; v < dt::N_WORDS; v++) {
        cur.x[v] = nxt[0][v];
        cur.y[v] = nxt[1][v];
      }
    }
    dt::f2_store(cur, o + r * dt::N_LIMBS, o + (rows + r) * dt::N_LIMBS);
  }
}

void dth_fp2_sqr5_mul(const int32_t *x, const int32_t *t, int32_t *o,
                      long long rows, const uint64_t *mod7) {
  dth_fp2_sqr_chain_mul(x, t, o, rows, 5, 0, mod7);
}

// K15 a warp at a time: 32 chunks of four limbs (four coefficients, eight
// lanes each), every lane's flags into the three masks the kernel's
// ballots give, then every lane's chunk from them.
void dth_flat_conj(const int32_t *a, int32_t *o, long long rows,
                   const uint64_t *mod7) {
  const dt::Mod M = dt::mod_from_words(mod7);
  int32_t pl[8][4];
  for (int j = 0; j < 8; j++) dt::conj_p_chunk(j, M, pl[j]);
  const long long n = rows * dt::FLAT * 8;
  for (long long q0 = 0; q0 < n; q0 += 32) {
    uint32_t gen = 0, pass = 0, zero = 0;
    for (int lane = 0; lane < 32; lane++) {
      bool g, t, z;
      dt::conj_flags(a + (q0 + lane) * 4, pl[lane & 7], g, t, z);
      gen |= (uint32_t)g << lane;
      pass |= (uint32_t)t << lane;
      zero |= (uint32_t)z << lane;
    }
    for (int lane = 0; lane < 32; lane++) {
      const long long q = q0 + lane;
      dt::conj_chunk(lane, (q >> 3) & 1, a + q * 4, pl[lane & 7], gen, pass,
                     zero, o + q * 4);
    }
  }
}

// K16: per row the twelve warps' output coefficients in turn (slot s =
// w % 6, half w / 6), each through its constants' classes, on one row's
// words laid out with stride 1.
void dth_flat_frob(const int32_t *a, int32_t *o, long long rows,
                   const uint64_t *consts, const uint64_t *mod7) {
  const dt::Mod M = dt::mod_from_words(mod7);
  const dt::Mod32 M32 = dt::mod32_from_words(mod7);
  const dt::FrobConsts F = dt::frob_from_words(consts, M);
  uint64_t w[dt::FLAT * dt::N_WORDS], out[dt::N_WORDS];
  for (long long r = 0; r < rows; r++) {
    for (int i = 0; i < dt::FLAT; i++)
      dt::load_words(a + (r * dt::FLAT + i) * dt::N_LIMBS,
                     w + i * dt::N_WORDS);
    for (int k = 0; k < 12; k++) {
      const int s = k % 6, h = k / 6;
      dt::flat_frob_out(s, h, w, 1, F, out, M, M32);
      dt::store_words(out, o + (r * dt::FLAT + s + 6 * h) * dt::N_LIMBS);
    }
  }
}

// K16's classes of the 24 constants (dt::FrobClass), cls[s * 4 + q] for
// matrix q = A, B, C, D of slot s, as the entry point finds them.
void dth_frob_classes(const uint64_t *consts, const uint64_t *mod7,
                      int32_t *cls) {
  const dt::FrobConsts F =
      dt::frob_from_words(consts, dt::mod_from_words(mod7));
  for (int s = 0; s < 6; s++)
    for (int q = 0; q < 4; q++) cls[s * 4 + q] = F.cls[s][q];
}

// K9's chain: per row n doublings, the shares of each level in turn (in
// reverse order when `reverse`, as in dth_cyclo_sqr), on one row's words
// laid out with stride 1.
void dth_g2_point_dbl(const int32_t *p, int32_t *o, long long rows, int n,
                      int reverse, const uint64_t *mod7) {
  const dt::Mod M = dt::mod_from_words(mod7);
  const int W = dt::N_WORDS;
  uint64_t buf[dt::G2_DBL_BUF * dt::N_WORDS];
  for (long long r = 0; r < rows; r++) {
    for (int c = 0; c < 6; c++)
      dt::load_words(p + (c * rows + r) * dt::N_LIMBS, buf + c * W);
    for (int i = 0; i < n; i++)
      for (int level = 0; level < 3; level++)
        for (int s = 0; s < 3; s++)
          dt::g2_dbl_share(level, reverse ? 2 - s : s, i, n, buf, buf + 6 * W,
                           1, M);
    for (int c = 0; c < 6; c++)
      dt::store_words(buf + c * W, o + (c * rows + r) * dt::N_LIMBS);
  }
}

// K10: per row the shares of each level in turn (in reverse order when
// `reverse`), on one row's buffer (curve_arith.cuh GA_*) with stride 1;
// each share keeps its own cases, as each thread does in registers.
void dth_g2_point_add(const int32_t *p1, const int32_t *p2, int32_t *o,
                      long long rows, int with_double, int reverse,
                      const uint64_t *one6, const uint64_t *mod7) {
  const dt::Mod M = dt::mod_from_words(mod7);
  const dt::One one = dt::one_from_words(one6);
  const int W = dt::N_WORDS;
  uint64_t buf[dt::GA_BUF * dt::N_WORDS];
  dt::G2AddCase cases[3];
  const long long cs = rows * dt::N_LIMBS;
  for (long long r = 0; r < rows; r++) {
    for (int c = 0; c < 6; c++) {
      dt::load_words(p1 + c * cs + r * dt::N_LIMBS, buf + (dt::GA_P1 + c) * W);
      dt::load_words(p2 + c * cs + r * dt::N_LIMBS, buf + dt::ga_p2_at(c) * W);
    }
    for (int level = 0; level < 5; level++)
      for (int s = 0; s < 3; s++) {
        const int j = reverse ? 2 - s : s;
        dt::g2_add_share(level, j, with_double != 0, buf, cases[j],
                         p2 + r * dt::N_LIMBS, cs, one, 1, M);
      }
    for (int c = 0; c < 6; c++)
      dt::store_words(buf + (dt::GA_P1 + c) * W, o + c * cs + r * dt::N_LIMBS);
  }
}

// K18: per row the shares of each level in turn (in reverse order when
// `reverse`, as in dth_cyclo_sqr), on one row's buffer as the kernel lays
// it out (curve_arith.cuh DL_*: T and P as staged, the level values, the
// line triple; T' over T) with stride 1.
void dth_g2_dbl_line(const int32_t *in, int32_t *to, int32_t *lo,
                     long long rows, int reverse, const uint64_t *mod7) {
  const dt::Mod M = dt::mod_from_words(mod7);
  const int W = dt::N_WORDS;
  uint64_t buf[dt::DL_BUF * dt::N_WORDS];
  const dt::TrioDblIo io{buf + dt::DL_T * W, buf + dt::DL_L * W, 1};
  for (long long r = 0; r < rows; r++) {
    for (int i = 0; i < 8; i++)
      dt::load_words(in + (r * 8 + i) * dt::N_LIMBS, buf + i * W);
    for (int level = 0; level < 3; level++)
      for (int s = 0; s < 3; s++)
        dt::miller_dbl_share(level, reverse ? 2 - s : s, buf + dt::DL_T * W,
                             buf + dt::DL_S1 * W, buf + dt::DL_S2 * W, io, 1,
                             M);
    for (int i = 0; i < 6; i++) {
      dt::store_words(buf + (dt::DL_T + i) * W,
                      to + (r * 6 + i) * dt::N_LIMBS);
      dt::store_words(buf + (dt::DL_L + i) * W,
                      lo + (r * 6 + i) * dt::N_LIMBS);
    }
  }
}

// K19 the same way (curve_arith.cuh AL_*: T, Q and P as staged, the
// level values; T' into the elements al_t_out names, the line triple over
// the first six level values).
void dth_g2_add_line(const int32_t *in, int32_t *to, int32_t *lo,
                     long long rows, int reverse, const uint64_t *mod7) {
  const dt::Mod M = dt::mod_from_words(mod7);
  const int W = dt::N_WORDS;
  uint64_t buf[dt::AL_BUF * dt::N_WORDS];
  const dt::TrioAddIo io{buf, 1};
  for (long long r = 0; r < rows; r++) {
    for (int i = 0; i < 12; i++)
      dt::load_words(in + (r * 12 + i) * dt::N_LIMBS, buf + i * W);
    for (int level = 0; level < 5; level++)
      for (int s = 0; s < 3; s++)
        dt::miller_add_share(level, reverse ? 2 - s : s, buf + dt::AL_T * W,
                             buf + dt::AL_Q * W, buf + dt::AL_S * W, io, 1,
                             M);
    for (int i = 0; i < 6; i++) {
      dt::store_words(buf + dt::al_t_out(i) * W,
                      to + (r * 6 + i) * dt::N_LIMBS);
      dt::store_words(buf + (dt::AL_S + i) * W,
                      lo + (r * 6 + i) * dt::N_LIMBS);
    }
  }
}

void dth_add(const int32_t *a, const int32_t *b, int32_t *o, long long n,
             const uint64_t *mod7) {
  const dt::Mod M = dt::mod_from_words(mod7);
  for (long long e = 0; e < n; e++)
    dt::add_sub_limbs(a + e * dt::N_LIMBS, b + e * dt::N_LIMBS,
                      o + e * dt::N_LIMBS, false, M);
}

void dth_sub(const int32_t *a, const int32_t *b, int32_t *o, long long n,
             const uint64_t *mod7) {
  const dt::Mod M = dt::mod_from_words(mod7);
  for (long long e = 0; e < n; e++)
    dt::add_sub_limbs(a + e * dt::N_LIMBS, b + e * dt::N_LIMBS,
                      o + e * dt::N_LIMBS, true, M);
}

// K11 (Q == nullptr) and K12 row by row: the kernel's phases in its
// order on one row's buffer (curve_arith.cuh MB_* and MA_*, stride 1), the
// shares of each phase in turn, in reverse order when `reverse` (as in
// dth_cyclo_sqr).
static void miller_iter(const int32_t *f, const int32_t *T, const int32_t *Q,
                        const int32_t *P, const int32_t *mask, int32_t *fo,
                        int32_t *To, long long rows, int reverse,
                        const uint64_t *one6, const uint64_t *mod7) {
  const dt::Mod M = dt::mod_from_words(mod7);
  const dt::One one = dt::one_from_words(one6);
  const int W = dt::N_WORDS;
  constexpr int E = dt::MB_DBL > dt::MB_ADD ? dt::MB_DBL : dt::MB_ADD;
  uint64_t buf[E * dt::N_WORDS], lo[dt::N_WORDS], hi[dt::N_WORDS];
  auto at = [&](int e) { return buf + e * W; };
  const bool add = Q != nullptr;
  for (long long r = 0; r < rows; r++) {
    for (int i = 0; i < 12; i++)
      dt::load_words(T + (r * 12 + i) * dt::N_LIMBS,
                     at((add ? dt::MA_T : dt::MB_L) + i));
    for (int i = 0; add && i < 8; i++)
      dt::load_words(Q + (r * 8 + i) * dt::N_LIMBS, at(dt::MA_Q + i));
    if (!add)
      for (int i = 0; i < dt::FLAT; i++)
        dt::load_words(f + (r * dt::FLAT + i) * dt::N_LIMBS, at(dt::MB_F + i));
    for (int level = 0; level < (add ? 5 : 3); level++)
      for (int s = 0; s < 6; s++) {
        const int js = reverse ? 5 - s : s, j = js / 2, k = js % 2;
        const long long pk = r * 2 + k;
        if (add)
          dt::miller_add_share(
              level, j, at(dt::MA_T + 6 * k), at(dt::MA_Q + 4 * k),
              at(dt::MA_S + dt::MA_SW * k),
              dt::MergedAddIo{P + pk * 2 * dt::N_LIMBS, mask[pk] != 0,
                              To + pk * 6 * dt::N_LIMBS, one},
              1, M);
        else
          dt::miller_dbl_share(
              level, j, at(dt::MB_L + 6 * k), at(dt::MB_S1 + 8 * k),
              at(dt::MB_S2 + 12 * k),
              dt::MergedDblIo{at(dt::MB_L + 6 * k), P + pk * 2 * dt::N_LIMBS,
                              mask[pk] != 0, To + pk * 6 * dt::N_LIMBS, one,
                              1},
              1, M);
      }
    int cur = dt::MA_F, l1 = dt::MA_S, l2 = dt::MA_S + dt::MA_SW,
        mid = dt::MA_MID, out = dt::MA_F;
    if (add) {
      for (int i = 0; i < dt::FLAT; i++)
        dt::load_words(f + (r * dt::FLAT + i) * dt::N_LIMBS, at(dt::MA_F + i));
    } else {
      for (int s = 0; s < 6; s++) {
        const int c = reverse ? 5 - s : s;
        dt::flat_sqr_class(c, at(dt::MB_F), 1, lo, hi, M);
        dt::flat_unstage(lo, hi, c, at(dt::MB_S1), 1);
      }
      cur = dt::MB_S1;
      l1 = dt::MB_L;
      l2 = dt::MB_L + 6;
      mid = dt::MB_F;
      out = dt::MB_S2;
    }
    for (int s = 0; s < 6; s++) {
      const int c = reverse ? 5 - s : s;
      dt::flat_mul_line_class(c, at(cur), at(l1), 1, lo, hi, M);
      dt::flat_unstage(lo, hi, c, at(mid), 1);
    }
    for (int s = 0; s < 6; s++) {
      const int c = reverse ? 5 - s : s;
      dt::flat_mul_line_class(c, at(mid), at(l2), 1, lo, hi, M);
      dt::flat_unstage(lo, hi, c, at(out), 1);
    }
    for (int i = 0; i < dt::FLAT; i++)
      dt::store_words(at(out + i), fo + (r * dt::FLAT + i) * dt::N_LIMBS);
  }
}

void dth_miller_dbl_iter(const int32_t *f, const int32_t *T, const int32_t *P,
                         const int32_t *mask, int32_t *fo, int32_t *To,
                         long long rows, int reverse, const uint64_t *one6,
                         const uint64_t *mod7) {
  miller_iter(f, T, nullptr, P, mask, fo, To, rows, reverse, one6, mod7);
}

void dth_miller_add_iter(const int32_t *f, const int32_t *T, const int32_t *Q,
                         const int32_t *P, const int32_t *mask, int32_t *fo,
                         int32_t *To, long long rows, int reverse,
                         const uint64_t *one6, const uint64_t *mod7) {
  miller_iter(f, T, Q, P, mask, fo, To, rows, reverse, one6, mod7);
}

}  // extern "C"
