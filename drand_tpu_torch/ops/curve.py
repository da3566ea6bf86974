"""Batched G1/G2 Jacobian point arithmetic in PyTorch (branchless).

Counterpart of `drand_tpu/ops/curve.py` (its generic formulas).  Points
are Jacobian (X, Y, Z) tuples of Montgomery limb tensors; Z == 0 encodes
infinity.  All control flow is masked selects over the batch.  A G2
doubling or addition on a GPU tensor is one hand-written CUDA kernel (K9,
K10 in `ops/kernels.py`, as `drand_tpu` takes its Pallas kernels on its
chip), and so is each run of doublings of a ladder (K9 in chain form);
the formulas below, under `Fp2PlainOps`, are their plain versions.
"""

from __future__ import annotations

import torch

from drand_tpu_torch.crypto.bls12381 import curve as GC
from drand_tpu_torch.crypto.bls12381.constants import X as BLS_X
from drand_tpu_torch.ops import kernels as K
from drand_tpu_torch.ops import towers as T
from drand_tpu_torch.ops.field import FP, segmented_ladder, tail_segments


class FpOps:
    """Fp as a curve coordinate field."""
    add = staticmethod(T.fp_add)
    sub = staticmethod(T.fp_sub)
    neg = staticmethod(T.fp_neg)
    mul = staticmethod(T.fp_mul)
    sqr = staticmethod(T.fp_sqr)
    inv = staticmethod(T.fp_inv)
    select = staticmethod(T.fp_select)
    eq = staticmethod(FP.eq)
    is_zero = staticmethod(FP.is_zero)
    zero = T.FP_ZERO
    one = T.FP_ONE
    products = staticmethod(FP.products)
    mul_small = staticmethod(FP.mul_small)
    broadcast = staticmethod(T.fp_broadcast)


class Fp2Ops:
    """Fp2 as a curve coordinate field (the G2 twist)."""
    add = staticmethod(T.fp2_add)
    sub = staticmethod(T.fp2_sub)
    neg = staticmethod(T.fp2_neg)
    mul = staticmethod(T.fp2_mul)
    sqr = staticmethod(T.fp2_sqr)
    inv = staticmethod(T.fp2_inv)
    select = staticmethod(T.fp2_select)
    eq = staticmethod(T.fp2_eq)
    is_zero = staticmethod(T.fp2_is_zero)
    zero = T.FP2_ZERO
    one = T.FP2_ONE
    products = staticmethod(T.fp2_products)
    mul_small = staticmethod(T.fp2_mul_small)
    broadcast = staticmethod(T.fp2_broadcast)
    scalar_products = staticmethod(FP.products)   # Fp2 coordinate x Fp


def _fp_products_plain(pairs):
    a, b = FP._stack2(pairs)
    return list(FP._mont_mul_plain(a, b).unbind(0))


class Fp2PlainOps(Fp2Ops):
    """Fp2Ops with every product through a plain version, never a kernel:
    the G2 point and Miller-step formulas under it are the plain versions
    of K9-K12."""
    mul = staticmethod(lambda a, b: T._fp2_products_plain([(a, b)])[0])
    sqr = staticmethod(lambda a: T._fp2_sqrs_plain([a])[0])
    products = staticmethod(T._fp2_products_plain)
    scalar_products = staticmethod(_fp_products_plain)


# ---------------------------------------------------------------------------
# Generic Jacobian arithmetic
# ---------------------------------------------------------------------------

def point_inf(ops, shape, device):
    return (ops.broadcast(ops.one, shape, device),
            ops.broadcast(ops.one, shape, device),
            ops.broadcast(ops.zero, shape, device))


def point_is_inf(pt, ops):
    return ops.is_zero(pt[2])


def point_neg(pt, ops):
    return (pt[0], ops.neg(pt[1]), pt[2])


def g2_pack(pt):
    """G2 Jacobian point -> one [6, ..., 32] tensor (X0 X1 Y0 Y1 Z0 Z1):
    the operand layout of K9 and K10."""
    return torch.stack(FP._common([c for xy in pt for c in xy]), 0)


def g2_unpack(st):
    return ((st[0], st[1]), (st[2], st[3]), (st[4], st[5]))


def _on_card(pt):
    return pt[0][0].device.type != "cpu"


def point_double(pt, ops):
    """dbl-2009-l; preserves infinity (Z3 = 2YZ = 0).  A G2 point on a GPU
    tensor is one K9 launch."""
    if ops is Fp2Ops and _on_card(pt):
        return g2_unpack(K.g2_point_dbl(g2_pack(pt), FP))
    return _point_double_formula(pt, ops)


def _g2_point_dbl_plain(st, n: int = 1):
    """[2^n]P of packed G2 points [6, ..., 32]: n doublings by the formula
    under Fp2PlainOps (the plain version of K9's chain)."""
    pt = g2_unpack(st)
    for _ in range(n):
        pt = _point_double_formula(pt, Fp2PlainOps)
    return g2_pack(pt)


def _point_double_formula(pt, ops):
    """dbl-2009-l in staged stacked products (the plain version of K9
    under Fp2PlainOps)."""
    x, y, z = pt
    a, b, yz = ops.products([(x, x), (y, y), (y, z)])
    xb = ops.add(x, b)
    c, s2 = ops.products([(b, b), (xb, xb)])
    e = ops.mul_small(a, 3)
    d = ops.sub(s2, ops.add(a, c))
    d = ops.add(d, d)
    f = ops.sqr(e)
    x3 = ops.sub(f, ops.add(d, d))
    (y3t,) = ops.products([(e, ops.sub(d, x3))])
    y3 = ops.sub(y3t, ops.mul_small(c, 8))
    z3 = ops.add(yz, yz)
    return (x3, y3, z3)


def point_add(p1, p2, ops, with_double: bool = True):
    """General Jacobian addition with every case branchless: infinities,
    P + P (doubling fallback unless with_double=False), P + (-P) = inf.
    G2 points on a GPU tensor are one K10 launch."""
    if ops is Fp2Ops and _on_card(p1):
        return g2_unpack(K.g2_point_add(g2_pack(p1), g2_pack(p2),
                                        with_double, FP))
    return _point_add_formula(p1, p2, ops, with_double)


def _point_add_formula(p1, p2, ops, with_double: bool = True):
    """The staged formula of point_add (the plain version of K10 under
    Fp2PlainOps)."""
    x1, y1, z1 = p1
    x2, y2, z2 = p2
    z1z1, z2z2, y1z2, y2z1 = ops.products(
        [(z1, z1), (z2, z2), (y1, z2), (y2, z1)])
    u1, u2, s1, s2 = ops.products(
        [(x1, z2z2), (x2, z1z1), (y1z2, z2z2), (y2z1, z1z1)])
    h = ops.sub(u2, u1)
    h2 = ops.add(h, h)
    rr = ops.sub(s2, s1)
    rr = ops.add(rr, rr)
    z12 = ops.add(z1, z2)
    i, rr2, z12sq = ops.products([(h2, h2), (rr, rr), (z12, z12)])
    j, v = ops.products([(h, i), (u1, i)])
    x3 = ops.sub(ops.sub(rr2, j), ops.add(v, v))
    zz = ops.sub(z12sq, ops.add(z1z1, z2z2))
    y3t, s1j, z3 = ops.products([(rr, ops.sub(v, x3)), (s1, j), (zz, h)])
    y3 = ops.sub(y3t, ops.add(s1j, s1j))
    out = (x3, y3, z3)

    inf1 = ops.is_zero(z1)
    inf2 = ops.is_zero(z2)
    eq_u = ops.eq(u1, u2) & ~inf1 & ~inf2
    eq_s = ops.eq(s1, s2)
    if with_double:
        dbl = _point_double_formula(p1, ops)
        out = tuple(ops.select(eq_u & eq_s, d, o) for d, o in zip(dbl, out))
    cancel = eq_u & ~eq_s
    inf = point_inf(ops, cancel.shape, cancel.device)
    out = tuple(ops.select(cancel, i_, o) for i_, o in zip(inf, out))
    out = tuple(ops.select(inf1, b, o) for b, o in zip(p2, out))
    out = tuple(ops.select(inf2 & ~inf1, a, o) for a, o in zip(p1, out))
    return out


def point_eq(p1, p2, ops):
    """Projective equality (both-infinite counts as equal)."""
    x1, y1, z1 = p1
    x2, y2, z2 = p2
    z1z1, z2z2, y1z2, y2z1 = ops.products(
        [(z1, z1), (z2, z2), (y1, z2), (y2, z1)])
    a, b, c, d = ops.products(
        [(x1, z2z2), (x2, z1z1), (y1z2, z2z2), (y2z1, z1z1)])
    i1 = ops.is_zero(z1)
    i2 = ops.is_zero(z2)
    return (i1 & i2) | (~i1 & ~i2 & ops.eq(a, b) & ops.eq(c, d))


def point_to_affine(pt, ops):
    """Returns ((x, y), inf_mask); (0, 0) where infinite."""
    x, y, z = pt
    inf = ops.is_zero(z)
    zi = ops.inv(z)
    zi2 = ops.sqr(zi)
    ax = ops.mul(x, zi2)
    ay = ops.mul(y, ops.mul(zi, zi2))
    zero = ops.broadcast(ops.zero, inf.shape, inf.device)
    return (ops.select(inf, zero, ax), ops.select(inf, zero, ay)), inf


def point_mul_const(pt, k: int, ops):
    """Scalar mul by a static sparse scalar: statically segmented
    double-and-add (zero runs double only, set bits add), no doubling
    fallback in the add (acc = m*pt with 2 <= m < order never equals
    +-pt for pt of odd prime order).  On a GPU tensor each run of
    doublings is one K9 launch."""
    if k <= 0:
        raise ValueError("point_mul_const takes k >= 1")
    segments = tail_segments(bin(k)[3:])
    if ops is Fp2Ops and _on_card(pt):
        # the ladder's state stays packed: one stack in, one view out
        base = g2_pack(pt)

        def doublings(acc, n=1):
            return K.g2_point_dbl(acc, FP, n)

        return g2_unpack(segmented_ladder(
            segments, base, doublings,
            lambda acc: K.g2_point_add(acc, base, False, FP),
            run_fn=doublings))
    return segmented_ladder(
        segments, pt,  # starting from pt consumes the leading 1 bit
        lambda acc: point_double(acc, ops),
        lambda acc: point_add(acc, pt, ops, with_double=False))


# ---------------------------------------------------------------------------
# G2 specializations
# ---------------------------------------------------------------------------

_PSI_X = T.fp2_const(GC.PSI_X)
_PSI_Y = T.fp2_const(GC.PSI_Y)
_B_G2 = T.fp2_const((4, 4))
_X_ABS = -BLS_X


def _bc2(c, like):
    return T.fp2_broadcast(c, like.shape[:-1], like.device)


def g2_psi(pt):
    """Untwist-Frobenius-twist endomorphism (golden curve.py g2_psi)."""
    x, y, z = pt
    px, py = T.fp2_products([(T.fp2_conj(x), _bc2(_PSI_X, x[0])),
                             (T.fp2_conj(y), _bc2(_PSI_Y, y[0]))])
    return (px, py, T.fp2_conj(z))


def g2_mul_x_abs(pt):
    """[|x|]Q for the BLS parameter."""
    return point_mul_const(pt, _X_ABS, Fp2Ops)


def g2_clear_cofactor(pt):
    """Budroni-Pintore: [x^2-x-1]Q + [x-1]psi(Q) + psi^2([2]Q), with the
    negative x folded into point negations."""
    ops = Fp2Ops
    xq = point_neg(g2_mul_x_abs(pt), ops)             # [x]Q, x < 0
    x2q = point_neg(g2_mul_x_abs(xq), ops)            # [x^2]Q
    t = point_add(x2q, point_neg(xq, ops), ops)       # [x^2 - x]Q
    t = point_add(t, point_neg(pt, ops), ops)         # [x^2 - x - 1]Q
    p1 = point_add(xq, point_neg(pt, ops), ops)       # [x - 1]Q
    p1 = g2_psi(p1)
    p2 = g2_psi(g2_psi(point_double(pt, ops)))
    return point_add(point_add(t, p1, ops), p2, ops)


def g2_on_curve(pt):
    x, y, z = pt
    z2 = T.fp2_sqr(z)
    z6 = T.fp2_mul(T.fp2_sqr(z2), z2)
    lhs = T.fp2_sqr(y)
    rhs = T.fp2_add(T.fp2_mul(T.fp2_sqr(x), x),
                    T.fp2_mul(z6, _bc2(_B_G2, z[0])))
    return T.fp2_eq(lhs, rhs) | T.fp2_is_zero(z)


def g2_in_subgroup(pt):
    """Bowe's criterion psi(Q) == [x]Q, plus the on-curve check."""
    on = g2_on_curve(pt)
    lhs = g2_psi(pt)
    rhs = point_neg(g2_mul_x_abs(pt), Fp2Ops)
    return on & (point_eq(lhs, rhs, Fp2Ops) | point_is_inf(pt, Fp2Ops))


# ---------------------------------------------------------------------------
# Device -> host point conversion (golden Jacobian tuples of ints)
# ---------------------------------------------------------------------------

def g2_decode(pt, i=None):
    return tuple(T.fp2_decode(c, i) for c in pt)
