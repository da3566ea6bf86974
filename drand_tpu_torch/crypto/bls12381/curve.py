"""G1/G2 group operations for BLS12-381 (pure-Python golden model).

Points are Jacobian triples (X, Y, Z): affine (X/Z^2, Y/Z^3); Z == 0 is the
point at infinity.  G1 coordinates are Fp ints, G2 coordinates are Fp2 tuples.

Counterpart of the reference's kyber `Point` interface on bls12-381
(`key/curve.go:26-33`: keys on G1 48B, sigs on G2 96B); rebuilt from curve
math, not ported.  Serialization follows the ZCash BLS12-381 compressed
encoding used by drand's wire format.
"""

from . import fp as F
from .constants import (B_G1, B_G2, G1_GEN_X, G1_GEN_Y, G2_GEN_X, G2_GEN_Y,
                        H1, H2, P, R, X)

# ---------------------------------------------------------------------------
# Generic Jacobian arithmetic parameterized by the field (works for Fp / Fp2
# and, for the untwist self-check, Fp12).
# ---------------------------------------------------------------------------

class _Ops:
    """Field operation bundle so one set of curve formulas serves all fields."""

    def __init__(self, add, sub, neg, mul, sqr, inv, zero, one, eq=None):
        self.add, self.sub, self.neg, self.mul, self.sqr, self.inv = add, sub, neg, mul, sqr, inv
        self.zero, self.one = zero, one
        self.eq = eq or (lambda a, b: a == b)


FP_OPS = _Ops(F.fp_add, F.fp_sub, F.fp_neg, F.fp_mul, F.fp_sqr, F.fp_inv, 0, 1)
FP2_OPS = _Ops(F.fp2_add, F.fp2_sub, F.fp2_neg, F.fp2_mul, F.fp2_sqr, F.fp2_inv,
               F.FP2_ZERO, F.FP2_ONE)


def point_is_inf(pt, ops):
    return ops.eq(pt[2], ops.zero)


def point_double(pt, ops):
    """Jacobian doubling for y^2 = x^3 + b (a = 0)."""
    x, y, z = pt
    if ops.eq(z, ops.zero):
        return pt
    a = ops.sqr(x)
    b = ops.sqr(y)
    c = ops.sqr(b)
    d = ops.sub(ops.sqr(ops.add(x, b)), ops.add(a, c))
    d = ops.add(d, d)
    e = ops.add(ops.add(a, a), a)
    f = ops.sqr(e)
    x3 = ops.sub(f, ops.add(d, d))
    c8 = ops.add(c, c)
    c8 = ops.add(c8, c8)
    c8 = ops.add(c8, c8)
    y3 = ops.sub(ops.mul(e, ops.sub(d, x3)), c8)
    yz = ops.mul(y, z)
    z3 = ops.add(yz, yz)
    return (x3, y3, z3)


def point_add(p1, p2, ops):
    """General Jacobian addition."""
    x1, y1, z1 = p1
    x2, y2, z2 = p2
    if ops.eq(z1, ops.zero):
        return p2
    if ops.eq(z2, ops.zero):
        return p1
    z1z1 = ops.sqr(z1)
    z2z2 = ops.sqr(z2)
    u1 = ops.mul(x1, z2z2)
    u2 = ops.mul(x2, z1z1)
    s1 = ops.mul(ops.mul(y1, z2), z2z2)
    s2 = ops.mul(ops.mul(y2, z1), z1z1)
    if ops.eq(u1, u2):
        if ops.eq(s1, s2):
            return point_double(p1, ops)
        return (ops.one, ops.one, ops.zero)  # P + (-P) = inf
    h = ops.sub(u2, u1)
    i = ops.sqr(ops.add(h, h))
    j = ops.mul(h, i)
    rr = ops.sub(s2, s1)
    rr = ops.add(rr, rr)
    v = ops.mul(u1, i)
    x3 = ops.sub(ops.sub(ops.sqr(rr), j), ops.add(v, v))
    s1j = ops.mul(s1, j)
    y3 = ops.sub(ops.mul(rr, ops.sub(v, x3)), ops.add(s1j, s1j))
    z3 = ops.mul(ops.sub(ops.sqr(ops.add(z1, z2)), ops.add(z1z1, z2z2)), h)
    return (x3, y3, z3)


def point_neg(pt, ops):
    return (pt[0], ops.neg(pt[1]), pt[2])


def point_mul(pt, k, ops):
    """Double-and-add scalar multiplication (golden model; not constant-time)."""
    if k < 0:
        return point_mul(point_neg(pt, ops), -k, ops)
    acc = (ops.one, ops.one, ops.zero)
    add_pt = pt
    while k > 0:
        if k & 1:
            acc = point_add(acc, add_pt, ops)
        add_pt = point_double(add_pt, ops)
        k >>= 1
    return acc


def point_to_affine(pt, ops):
    """Return (x, y) or None for infinity."""
    x, y, z = pt
    if ops.eq(z, ops.zero):
        return None
    zi = ops.inv(z)
    zi2 = ops.sqr(zi)
    return (ops.mul(x, zi2), ops.mul(y, ops.mul(zi, zi2)))


def point_eq(p1, p2, ops):
    """Projective equality."""
    x1, y1, z1 = p1
    x2, y2, z2 = p2
    i1 = ops.eq(z1, ops.zero)
    i2 = ops.eq(z2, ops.zero)
    if i1 or i2:
        return i1 and i2
    z1z1 = ops.sqr(z1)
    z2z2 = ops.sqr(z2)
    if not ops.eq(ops.mul(x1, z2z2), ops.mul(x2, z1z1)):
        return False
    return ops.eq(ops.mul(ops.mul(y1, z2), z2z2), ops.mul(ops.mul(y2, z1), z1z1))


# ---------------------------------------------------------------------------
# G1
# ---------------------------------------------------------------------------

G1_GEN = (G1_GEN_X, G1_GEN_Y, 1)
G1_INF = (1, 1, 0)


def g1_neg(pt):
    return point_neg(pt, FP_OPS)


def g1_mul(pt, k):
    if pt is G1_GEN:
        # ceremony hot path: every schnorr verify, ECIES seal, and
        # polynomial commit multiplies the generator — route those
        # through the fixed-base window table (~6x over double-and-add)
        return g1_mul_gen(k)
    return point_mul(pt, k % R, FP_OPS)


# --- fixed-base generator multiplication -----------------------------------
# Window-4 precomputed table over G1_GEN: 64 windows x 15 non-zero digits.
# Built lazily on first use (~1k additions, a few ms) and amortized across
# the O(n^2) generator multiplications of a DKG ceremony.  The result is
# the same group element as point_mul(G1_GEN, k) — Jacobian coordinates may
# differ, but every consumer compares via g1_eq / affine / compressed bytes.

_GEN_WINDOW = 4
_GEN_TABLE: list[list[tuple]] | None = None


def _build_gen_table() -> list[list[tuple]]:
    windows = (R.bit_length() + _GEN_WINDOW - 1) // _GEN_WINDOW
    table = []
    base = G1_GEN
    for _ in range(windows):
        row = [G1_INF]
        acc = G1_INF
        for _ in range((1 << _GEN_WINDOW) - 1):
            acc = point_add(acc, base, FP_OPS)
            row.append(acc)
        table.append(row)
        # base <- 2^w * base for the next window
        for _ in range(_GEN_WINDOW):
            base = point_double(base, FP_OPS)
    return table


def g1_mul_gen(k):
    """k * G1_GEN via the fixed-base window table (canonicalizes k mod r)."""
    global _GEN_TABLE
    if _GEN_TABLE is None:
        _GEN_TABLE = _build_gen_table()
    k %= R
    acc = G1_INF
    w = 0
    while k:
        digit = k & ((1 << _GEN_WINDOW) - 1)
        if digit:
            acc = point_add(acc, _GEN_TABLE[w][digit], FP_OPS)
        k >>= _GEN_WINDOW
        w += 1
    return acc


def g1_affine(pt):
    return point_to_affine(pt, FP_OPS)


def g1_eq(p1, p2):
    return point_eq(p1, p2, FP_OPS)


def g1_on_curve(pt):
    aff = point_to_affine(pt, FP_OPS)
    if aff is None:
        return True
    x, y = aff
    return F.fp_sqr(y) == F.fp_add(F.fp_mul(F.fp_sqr(x), x), B_G1)


def g1_in_subgroup(pt):
    if not g1_on_curve(pt):
        return False
    return point_is_inf(point_mul(pt, R, FP_OPS), FP_OPS)


# ---------------------------------------------------------------------------
# G2
# ---------------------------------------------------------------------------

G2_GEN = (G2_GEN_X, G2_GEN_Y, F.FP2_ONE)
G2_INF = (F.FP2_ONE, F.FP2_ONE, F.FP2_ZERO)


def g2_on_curve(pt):
    aff = point_to_affine(pt, FP2_OPS)
    if aff is None:
        return True
    x, y = aff
    return F.fp2_sqr(y) == F.fp2_add(F.fp2_mul(F.fp2_sqr(x), x), B_G2)


def g2_mul_raw(pt, k):
    return point_mul(pt, k, FP2_OPS)


def g2_affine(pt):
    return point_to_affine(pt, FP2_OPS)


# --- untwist selection (runtime-verified, not memorized) -------------------
# The sextic twist satisfies E'(Fp2) -> E(Fp12) via (x, y) -> (x * w^a, y * w^b)
# for one of a small set of exponent conventions.  We pick the one that maps
# the G2 generator onto E: y^2 = x^3 + 4 over Fp12, at import time.

def _fp12_from_fp2(a):
    return ((a, F.FP2_ZERO, F.FP2_ZERO), F.FP6_ZERO)


def _select_untwist():
    """Find the curve isomorphism E' -> E: (x, y) -> (c^2 x, c^3 y).

    It needs c^6 * (4*xi) = 4, i.e. c^6 = xi^{-1}; since w^6 = xi, c = w^{-1}
    works.  We still *verify* by mapping the G2 generator onto
    y^2 = x^3 + 4 over Fp12 instead of trusting the algebra.
    """
    w = (F.FP6_ZERO, F.FP6_ONE)
    b12 = _fp12_from_fp2((4, 0))  # b = 4 in Fp12
    for c in (F.fp12_inv(w), w):
        wx = F.fp12_sqr(c)
        wy = F.fp12_mul(wx, c)
        ux = F.fp12_mul(_fp12_from_fp2(G2_GEN_X), wx)
        uy = F.fp12_mul(_fp12_from_fp2(G2_GEN_Y), wy)
        lhs = F.fp12_sqr(uy)
        rhs = F.fp12_add(F.fp12_mul(F.fp12_sqr(ux), ux), b12)
        if lhs == rhs:
            return wx, wy
    raise AssertionError("no valid untwist convention found")


_UNTWIST_WX, _UNTWIST_WY = _select_untwist()


def g2_untwist(pt):
    """Map an affine G2 point (Fp2 coords) to E(Fp12)."""
    aff = point_to_affine(pt, FP2_OPS)
    if aff is None:
        return None
    x, y = aff
    return (F.fp12_mul(_fp12_from_fp2(x), _UNTWIST_WX),
            F.fp12_mul(_fp12_from_fp2(y), _UNTWIST_WY))


# --- psi endomorphism ------------------------------------------------------
# psi = twist . Frobenius . untwist.  We derive the two Fp2 constants from
# that definition once at import (rather than hard-coding), then apply them
# cheaply: psi(x, y) = (conj(x) * PSI_X, conj(y) * PSI_Y).

def _derive_psi_constants():
    # untwist generator, frobenius, re-twist
    x12, y12 = g2_untwist(G2_GEN)
    fx = F.fp12_frob(x12)
    fy = F.fp12_frob(y12)
    # twist back: multiply by inverse w powers
    tx = F.fp12_mul(fx, F.fp12_inv(_UNTWIST_WX))
    ty = F.fp12_mul(fy, F.fp12_inv(_UNTWIST_WY))
    # results must be "scalar" Fp2 elements embedded in Fp12
    def _extract(a):
        c = a[0][0]
        assert a[1] == F.FP6_ZERO and a[0][1] == F.FP2_ZERO and a[0][2] == F.FP2_ZERO, \
            "psi derivation did not land in Fp2"
        return c
    px = _extract(tx)
    py = _extract(ty)
    # psi(gen) = (conj(gx)*cx, conj(gy)*cy): solve for cx, cy
    cx = F.fp2_mul(px, F.fp2_inv(F.fp2_conj(G2_GEN_X)))
    cy = F.fp2_mul(py, F.fp2_inv(F.fp2_conj(G2_GEN_Y)))
    return cx, cy


PSI_X, PSI_Y = _derive_psi_constants()


def g2_psi(pt):
    """The untwist-Frobenius-twist endomorphism on Jacobian G2 points."""
    x, y, z = pt
    # In Jacobian coords: x' = conj(x)*PSI_X, y' = conj(y)*PSI_Y, z' = conj(z)
    return (F.fp2_mul(F.fp2_conj(x), PSI_X),
            F.fp2_mul(F.fp2_conj(y), PSI_Y),
            F.fp2_conj(z))


def g2_in_subgroup(pt):
    """Fast subgroup check: psi(Q) == [x]Q  (Bowe's criterion for BLS12-381)."""
    if not g2_on_curve(pt):
        return False
    if point_is_inf(pt, FP2_OPS):
        return True
    return point_eq(g2_psi(pt), g2_mul_raw(pt, X), FP2_OPS)


def g2_clear_cofactor(pt):
    """Budroni-Pintore efficient cofactor clearing:
    h_eff(Q) = [x^2 - x - 1]Q + [x - 1]psi(Q) + psi^2([2]Q).
    Verified against plain [h2]Q multiplication in tests."""
    xq = g2_mul_raw(pt, X)          # [x]Q  (X negative handled by point_mul)
    x2q = g2_mul_raw(xq, X)         # [x^2]Q
    t = point_add(x2q, point_neg(xq, FP2_OPS), FP2_OPS)   # [x^2 - x]Q
    t = point_add(t, point_neg(pt, FP2_OPS), FP2_OPS)     # [x^2 - x - 1]Q
    p1 = point_add(xq, point_neg(pt, FP2_OPS), FP2_OPS)   # [x-1]Q
    p1 = g2_psi(p1)
    p2 = g2_psi(g2_psi(point_double(pt, FP2_OPS)))        # psi^2(2Q)
    return point_add(point_add(t, p1, FP2_OPS), p2, FP2_OPS)


# ---------------------------------------------------------------------------
# Serialization (ZCash compressed format, drand wire compatible)
# ---------------------------------------------------------------------------

_COMP_FLAG = 0x80
_INF_FLAG = 0x40
_SIGN_FLAG = 0x20
_HALF_P = (P - 1) // 2


def g1_to_bytes(pt):
    """48-byte compressed G1."""
    aff = g1_affine(pt)
    if aff is None:
        out = bytearray(48)
        out[0] = _COMP_FLAG | _INF_FLAG
        return bytes(out)
    x, y = aff
    out = bytearray(x.to_bytes(48, "big"))
    out[0] |= _COMP_FLAG
    if y > _HALF_P:
        out[0] |= _SIGN_FLAG
    return bytes(out)


def _fp2_lex_gt_half(a):
    """ZCash sign rule for Fp2: lexicographic with c1 most significant."""
    c0, c1 = a
    if c1 != 0:
        return c1 > _HALF_P
    return c0 > _HALF_P


def g2_to_bytes(pt):
    """96-byte compressed G2 (c1 first, per ZCash convention)."""
    aff = g2_affine(pt)
    if aff is None:
        out = bytearray(96)
        out[0] = _COMP_FLAG | _INF_FLAG
        return bytes(out)
    (x0, x1), y = aff
    out = bytearray(x1.to_bytes(48, "big") + x0.to_bytes(48, "big"))
    out[0] |= _COMP_FLAG
    if _fp2_lex_gt_half(y):
        out[0] |= _SIGN_FLAG
    return bytes(out)


# Decoding of compressed points (the public key a ChainVerifier takes as
# bytes).  Like drand_tpu's, it checks length, flags, range and the curve
# equation; subgroup membership is g1_in_subgroup / g2_in_subgroup.

def g1_from_bytes(data):
    if len(data) != 48:
        raise ValueError("G1 compressed point must be 48 bytes")
    flags = data[0]
    if not flags & _COMP_FLAG:
        raise ValueError("only compressed encoding supported")
    if flags & _INF_FLAG:
        return G1_INF
    x = int.from_bytes(bytes([flags & 0x1F]) + data[1:], "big")
    if x >= P:
        raise ValueError("x out of range")
    y2 = F.fp_add(F.fp_mul(F.fp_sqr(x), x), B_G1)
    y = F.fp_sqrt(y2)
    if y is None:
        raise ValueError("point not on curve")
    if bool(flags & _SIGN_FLAG) != (y > _HALF_P):
        y = F.fp_neg(y)
    return (x, y, 1)


def g2_from_bytes(data):
    if len(data) != 96:
        raise ValueError("G2 compressed point must be 96 bytes")
    flags = data[0]
    if not flags & _COMP_FLAG:
        raise ValueError("only compressed encoding supported")
    if flags & _INF_FLAG:
        return G2_INF
    x1 = int.from_bytes(bytes([flags & 0x1F]) + data[1:48], "big")
    x0 = int.from_bytes(data[48:96], "big")
    if x0 >= P or x1 >= P:
        raise ValueError("x out of range")
    x = (x0, x1)
    y2 = F.fp2_add(F.fp2_mul(F.fp2_sqr(x), x), B_G2)
    y = F.fp2_sqrt(y2)
    if y is None:
        raise ValueError("point not on curve")
    if _fp2_lex_gt_half(y) != bool(flags & _SIGN_FLAG):
        y = F.fp2_neg(y)
    return (x, y, F.FP2_ONE)
