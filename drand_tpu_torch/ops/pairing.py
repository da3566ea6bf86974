"""Batched optimal-ate pairing check in PyTorch.

Counterpart of `drand_tpu/ops/pairing.py` with both of its Miller-loop
executors: the merged one for the two-pair check (one K11 or K12 launch
per iteration on a GPU tensor, the two lines multiplied in one after the
other; the plain versions merge them first, as `drand_tpu` does, which
gives the same canonical element) and the trio one for any number of pairs (per
iteration the shared square K17, the stacked pair steps K18 or K19 and
one sparse product K13 per pair).  Jacobian line steps with
denominator-cleared coefficients (no inversion in the loop), the Fp12
accumulator in the flat representation, the loop over the BLS parameter
statically segmented by its bit pattern, and the final exponentiation in
the factored form (x - 1)^2 (x + p) (x^2 + p^2 - 1) + 3, which equals
3(p^4 - p^2 + 1)/r for BLS12-381 -- the same pairing power as the golden
model.
"""

from __future__ import annotations

import torch

from drand_tpu_torch.crypto.bls12381.constants import X as _BLS_X
from drand_tpu_torch.ops import curve as DC
from drand_tpu_torch.ops import flat12 as F
from drand_tpu_torch.ops import kernels as K
from drand_tpu_torch.ops import towers as T
from drand_tpu_torch.ops.field import FP, segmented_ladder, tail_segments
from drand_tpu_torch.ops.flat12 import LINE_IDX

_X_ABS = -_BLS_X
# |x| = 0xd201000000010000 has only 5 set tail bits
_X_SEGMENTS = tail_segments(bin(_X_ABS)[3:])


def line_to_flat(line):
    """Fp2 line triple -> [..., 6, 32] sparse flat coefficients."""
    a, b, c = line
    xs = torch.stack([a[0], b[0], c[0]], -2)
    ys = torch.stack([a[1], b[1], c[1]], -2)
    return torch.cat([FP.sub(xs, ys), ys], -2)


def fp12_mul_line(f, line):
    """Flat f times a sparse line: K13 on LINE_IDX on a GPU tensor."""
    return F.flat_mul(f, line_to_flat(line), LINE_IDX)


def line_one(shape, device):
    one = T.fp2_broadcast(T.FP2_ONE, shape, device)
    zero = T.fp2_broadcast(T.FP2_ZERO, shape, device)
    return (one, zero, zero)


def line_select(mask, la, lb):
    return tuple(T.fp2_select(mask, x, y) for x, y in zip(la, lb))


# ---------------------------------------------------------------------------
# Miller loop steps (Jacobian T, denominator-cleared lines), over the pairs
# stacked on one leading axis
# ---------------------------------------------------------------------------

def _dbl_step(Tj, xp, yp):
    """Doubling step: kernel K18 on a GPU tensor, the formula under
    Fp2PlainOps on a CPU one.  Returns (2T, the line triple (a, b, c))."""
    if xp.device.type == "cpu":
        return _dbl_step_plain(Tj, xp, yp)
    X, Y, Z = Tj
    return _unpack_step(*K.g2_dbl_line(_pack_rows(
        [X[0], X[1], Y[0], Y[1], Z[0], Z[1], xp, yp]), FP))


def _add_step(Tj, Q, xp, yp):
    """Mixed addition step with Q = (xq, yq) affine: kernel K19 on a GPU
    tensor, the formula under Fp2PlainOps on a CPU one."""
    if xp.device.type == "cpu":
        return _add_step_plain(Tj, Q, xp, yp)
    X, Y, Z = Tj
    xq, yq = Q
    return _unpack_step(*K.g2_add_line(_pack_rows(
        [X[0], X[1], Y[0], Y[1], Z[0], Z[1], xq[0], xq[1], yq[0], yq[1],
         xp, yp]), FP))


def _pack_rows(coords):
    """[..., 32] coordinates -> one [..., n, 32] tensor, broadcast."""
    return torch.stack(FP._common(coords), -2)


def _unpack_step(To, L):
    def fp2s(x):
        return tuple((x[..., i, :], x[..., i + 1, :]) for i in (0, 2, 4))
    return fp2s(To), fp2s(L)


def _dbl_step_plain(Tj, xp, yp):
    """Plain version of K18, every product a plain one (Fp2PlainOps).
    Line (scaled by 2YZ^3, killed by the final exp):
    a = 3X^3 - 2Y^2, b = -3X^2 Z^2 * xp, c = 2YZ^3 * yp."""
    ops = DC.Fp2PlainOps
    X, Y, Z = Tj
    XX, YY, ZZ, YZ = ops.products([(X, X), (Y, Y), (Z, Z), (Y, Z)])
    xyy = ops.add(X, YY)
    E = ops.mul_small(XX, 3)
    X3c, YZ3, XXZZ, C, S2, F_ = ops.products(
        [(XX, X), (YZ, ZZ), (XX, ZZ), (YY, YY), (xyy, xyy), (E, E)])
    a = ops.sub(ops.mul_small(X3c, 3), ops.mul_small(YY, 2))
    nb3 = ops.neg(ops.mul_small(XXZZ, 3))
    cc2 = ops.mul_small(YZ3, 2)
    sc = ops.scalar_products(
        [(nb3[0], xp), (nb3[1], xp), (cc2[0], yp), (cc2[1], yp)])
    b = (sc[0], sc[1])
    c = (sc[2], sc[3])
    D = ops.sub(S2, ops.add(XX, C))
    D = ops.add(D, D)
    X2 = ops.sub(F_, ops.add(D, D))
    (Et,) = ops.products([(E, ops.sub(D, X2))])
    Y2 = ops.sub(Et, ops.mul_small(C, 8))
    Z2 = ops.add(YZ, YZ)
    return (X2, Y2, Z2), (a, b, c)


def _add_step_plain(Tj, Q, xp, yp):
    """Plain version of K19.  With H = xq Z^2 - X, r = 2(yq Z^3 - Y):
    a = r*xq - 2HZ*yq, b = -r*xp, c = 2HZ*yp."""
    ops = DC.Fp2PlainOps
    X, Y, Z = Tj
    xq, yq = Q
    ZZ, yqZ = ops.products([(Z, Z), (yq, Z)])
    U2, S2 = ops.products([(xq, ZZ), (yqZ, ZZ)])
    H = ops.sub(U2, X)
    r = ops.mul_small(ops.sub(S2, Y), 2)
    ZH = ops.add(Z, H)
    HH, rr, ZH2, HZ = ops.products([(H, H), (r, r), (ZH, ZH), (H, Z)])
    I = ops.mul_small(HH, 4)
    HZ2 = ops.mul_small(HZ, 2)
    J, V, rxq, hzyq = ops.products([(H, I), (X, I), (r, xq), (HZ2, yq)])
    X3 = ops.sub(ops.sub(rr, J), ops.mul_small(V, 2))
    rV, YJ = ops.products([(r, ops.sub(V, X3)), (Y, J)])
    Y3 = ops.sub(rV, ops.mul_small(YJ, 2))
    Z3 = ops.sub(ZH2, ops.add(ZZ, HH))
    a = ops.sub(rxq, hzyq)
    nr = ops.neg(r)
    sc = ops.scalar_products(
        [(nr[0], xp), (nr[1], xp), (HZ2[0], yp), (HZ2[1], yp)])
    return (X3, Y3, Z3), (a, (sc[0], sc[1]), (sc[2], sc[3]))


# ---------------------------------------------------------------------------
# Merged Miller iterations: f, T of every pair, P, Q and the masks as
# stacked tensors -- f [..., 12, 32], T [..., K, 6, 32] (X0 X1 Y0 Y1 Z0 Z1),
# P [..., K, 2, 32] (xp yp), Q [..., K, 4, 32] (xq0 xq1 yq0 yq1), masks
# [..., K] int32 (0: the pair is inactive and contributes 1)
# ---------------------------------------------------------------------------

def miller_dbl_iter(f, Ts, P, masks):
    """One doubling iteration, f^2 * l_1 * ... * l_K and every pair's
    doubling step: kernel K11 (K = 2) on a GPU tensor."""
    if f.device.type == "cpu":
        return _miller_dbl_iter_plain(f, Ts, P, masks)
    return K.miller_dbl_iter(f, Ts, P, masks, FP)


def miller_add_iter(f, Ts, Q, P, masks):
    """One addition step, f * l_1 * ... * l_K and every pair's mixed
    addition (an inactive pair keeps its T): kernel K12 (K = 2) on a GPU
    tensor."""
    if f.device.type == "cpu":
        return _miller_add_iter_plain(f, Ts, Q, P, masks)
    return K.miller_add_iter(f, Ts, Q, P, masks, FP)


def _pair_major(x):
    """[..., K, c, 32] -> the c coordinates, each [K, ..., 32]."""
    x = x.movedim(-3, 0)
    return [x[..., c, :] for c in range(x.shape[-2])]


def _pair_minor(coords):
    """Inverse of _pair_major."""
    return torch.stack(coords, -2).movedim(0, -3)


def _mul_lines(f, lines, masks):
    """f times every pair's line, the flat one where a pair is inactive,
    through the plain products: the first two lines multiplied together
    first (the plain line merge, `drand_tpu`'s default form; K11 and K12
    multiply them in one after the other, the same element)."""
    a, b, c = lines
    flat = []
    for k in range(masks.shape[-1]):
        lk = tuple((x[0][k], x[1][k]) for x in (a, b, c))
        one = line_one(masks.shape[:-1], masks.device)
        flat.append(line_to_flat(line_select(masks[..., k] != 0, lk, one)))
    if len(flat) >= 2:
        f = F._flat_mul_plain(f, F._line_merge_plain(flat[0], flat[1]))
        flat = flat[2:]
    for lk in flat:
        f = F._flat_mul_plain(f, lk, LINE_IDX)
    return f


def _miller_dbl_iter_plain(f, Ts, P, masks):
    """Plain version of K11: the plain flat square, the K doubling steps
    stacked on one leading axis under Fp2PlainOps, and the plain line
    products."""
    X0, X1, Y0, Y1, Z0, Z1 = _pair_major(Ts)
    xp, yp = _pair_major(P)
    (X, Y, Z), lines = _dbl_step_plain(((X0, X1), (Y0, Y1), (Z0, Z1)),
                                       xp, yp)
    f = _mul_lines(F._flat_sqr_plain(f), lines, masks)
    return f, _pair_minor([X[0], X[1], Y[0], Y[1], Z[0], Z[1]])


def _miller_add_iter_plain(f, Ts, Q, P, masks):
    """Plain version of K12: the K mixed additions stacked under
    Fp2PlainOps, T kept where a pair is inactive, and the plain line
    products."""
    old = _pair_major(Ts)
    X0, X1, Y0, Y1, Z0, Z1 = old
    xq0, xq1, yq0, yq1 = _pair_major(Q)
    xp, yp = _pair_major(P)
    (X, Y, Z), lines = _add_step_plain(((X0, X1), (Y0, Y1), (Z0, Z1)),
                                       ((xq0, xq1), (yq0, yq1)), xp, yp)
    keep = masks.movedim(-1, 0) != 0
    new = [torch.where(keep[..., None], n, o) for n, o in
           zip((X[0], X[1], Y[0], Y[1], Z[0], Z[1]), old)]
    return _mul_lines(f, lines, masks), _pair_minor(new)


# ---------------------------------------------------------------------------
# Multi-pair Miller loop
# ---------------------------------------------------------------------------

def miller_loop_pairs(pairs, active=None, merged=None):
    """Product of Miller loops over K (P, Q) pairs with shared squarings.

    pairs: list of ((xp, yp), (xq, yq)) -- P affine Fp, Q affine Fp2,
    each broadcast to the batch shape.  active: optional list of bool[...]
    masks; inactive pairs contribute 1.  merged: `drand_tpu`'s merged
    executor (K = 2 only; None takes it exactly when K = 2), else its trio
    executor.  Returns flat Fp12 f, conjugated for the negative BLS
    parameter."""
    K_ = len(pairs)
    if merged is None:
        merged = K_ == 2
    if merged and K_ != 2:
        raise ValueError(f"the merged Miller executor takes 2 pairs, got {K_}")
    if active is None:
        active = [None] * K_
    f = (_miller_loop_merged(pairs, active) if merged
         else _miller_loop_trio(pairs, active))
    return F.flat_conj(f)                 # x < 0


def _miller_loop_merged(pairs, active):
    """`drand_tpu`'s merged executor: every doubling iteration is one
    `miller_dbl_iter`, every set bit of |x| one `miller_add_iter` (K11
    and K12 on a GPU tensor)."""
    shape = pairs[0][0][0].shape[:-1]
    d = pairs[0][0][0].device

    def stack(coords):
        return torch.stack([c.expand(shape + (32,)) for c in coords], -2)

    one = T.fp2_broadcast(T.FP2_ONE, shape, d)
    Ts = torch.stack([stack([xq[0], xq[1], yq[0], yq[1], one[0], one[1]])
                      for _, (xq, yq) in pairs], -3)
    Q = torch.stack([stack([xq[0], xq[1], yq[0], yq[1]])
                     for _, (xq, yq) in pairs], -3)
    P = torch.stack([stack([xp, yp]) for (xp, yp), _ in pairs], -3)
    masks = torch.stack([
        torch.ones(shape, dtype=torch.int32, device=d) if a is None
        else a.to(torch.int32) for a in active], -1)
    f = F.flat_broadcast(F.FLAT_ONE, shape, d).contiguous()
    f, _ = segmented_ladder(
        _X_SEGMENTS, (f, Ts),
        lambda st: miller_dbl_iter(*st, P, masks),
        lambda st: miller_add_iter(*st, Q, P, masks))
    return f


def _miller_loop_trio(pairs, active):
    """`drand_tpu`'s trio executor (`pairing.py:187-255`), any K: each
    iteration squares f once (K17 on a GPU tensor), runs the K pairs'
    steps stacked on one leading axis (K18, K19) and multiplies f by
    each pair's masked line (K13 on LINE_IDX); an inactive pair keeps
    its T in the addition."""
    shape = pairs[0][0][0].shape[:-1]
    d = pairs[0][0][0].device
    K_ = len(pairs)

    def stack_pts(pts):
        return tuple(
            tuple(torch.stack([p[c][j].expand(shape + (32,)) for p in pts], 0)
                  for j in range(2))
            for c in range(len(pts[0])))

    def unstack(st, ncoord):
        return [tuple((st[c][0][k], st[c][1][k]) for c in range(ncoord))
                for k in range(K_)]

    def masked_line(line, mask):
        if mask is None:
            return line
        return line_select(mask, line, line_one(mask.shape, d))

    p_stack = tuple(torch.stack([pairs[k][0][j].expand(shape + (32,))
                                 for k in range(K_)], 0) for j in range(2))
    q_stack = stack_pts([q for _, q in pairs])
    one = T.fp2_broadcast(T.FP2_ONE, shape, d)
    f = F.flat_broadcast(F.FLAT_ONE, shape, d)
    Ts = tuple((q[0], q[1], one) for _, q in pairs)

    def dbl_half(state):
        f, Ts = state
        f = F.flat_sqr(f)
        Tst, lines = _dbl_step(stack_pts(Ts), *p_stack)
        lns = unstack(lines, 3)
        for k in range(K_):
            f = fp12_mul_line(f, masked_line(tuple(lns[k]), active[k]))
        return f, tuple(unstack(Tst, 3))

    def add_half(state):
        f, Ts = state
        Ast, lines = _add_step(stack_pts(Ts), q_stack, *p_stack)
        Aks = unstack(Ast, 3)
        lns = unstack(lines, 3)
        newTs = []
        for k in range(K_):
            if active[k] is None:
                Tk = tuple(Aks[k])
            else:
                Tk = tuple(T.fp2_select(active[k], x, y)
                           for x, y in zip(Aks[k], Ts[k]))
            f = fp12_mul_line(f, masked_line(tuple(lns[k]), active[k]))
            newTs.append(Tk)
        return f, tuple(newTs)

    f, _ = segmented_ladder(_X_SEGMENTS, (f, Ts), dbl_half, add_half)
    return f


# ---------------------------------------------------------------------------
# Final exponentiation (flat)
# ---------------------------------------------------------------------------

def _unitary_pow_x_abs(f):
    """f^|x| with cyclotomic squarings (post-easy-part elements only),
    each run of squarings in a row one `flat_cyclo_sqr(acc, n)` (one K14
    launch on a GPU tensor): runs of 1, 2, 3, 9, 32 and 16."""
    return segmented_ladder(_X_SEGMENTS, f, F.flat_cyclo_sqr,
                            lambda acc: F.flat_mul(acc, f),
                            run_fn=F.flat_cyclo_sqr)


def _pow_x(f):
    """f^x = conj(f^|x|) for unitary f (x < 0)."""
    return F.flat_conj(_unitary_pow_x_abs(f))


def _pow_x_minus_1(f):
    """f^(x - 1) = conj(f^(|x| + 1)) for unitary f (x < 0)."""
    return F.flat_conj(F.flat_mul(_unitary_pow_x_abs(f), f))


def final_exp(f):
    """Easy part f^((p^6 - 1)(p^2 + 1)), then the hard part through
    (x - 1)^2 (x + p) (x^2 + p^2 - 1) + 3."""
    f = F.flat_mul(F.flat_conj(f), F.flat_inv(f))        # f^(p^6 - 1)
    f = F.flat_mul(F.flat_frob(f, 2), f)                 # ^(p^2 + 1)
    m2 = _pow_x_minus_1(_pow_x_minus_1(f))               # f^((x-1)^2)
    m3 = F.flat_mul(_pow_x(m2), F.flat_frob(m2, 1))      # ^(x + p)
    m4 = F.flat_mul(F.flat_mul(_pow_x(_pow_x(m3)), F.flat_frob(m3, 2)),
                    F.flat_conj(m3))                     # ^(x^2 + p^2 - 1)
    f3 = F.flat_mul(F.flat_cyclo_sqr(f), f)              # the +3 term
    return F.flat_mul(m4, f3)


def pairing_check_pairs(pairs, active=None, merged=None):
    """bool[...]: prod over pairs of e(P_i, Q_i) == 1, one final exp; the
    Miller executor as `miller_loop_pairs` takes it."""
    return F.flat_is_one(final_exp(miller_loop_pairs(pairs, active, merged)))
