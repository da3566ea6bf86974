"""Flat Fp12 arithmetic: 12 Fp coefficients over the power basis of w.

Counterpart of `drand_tpu/ops/flat12.py`.  The tower Fp2 -> Fp6 -> Fp12
is flattened onto {1, w, ..., w^11} over Fp (w^2 = v, v^3 = xi = 1 + u,
u^2 = -1), so a product is a convolution of all coefficient pairs onto
w-powers, a Montgomery reduction and a signed recombination through the
minimal polynomial w^12 - 2 w^6 + 2 = 0.  On a GPU tensor the product
(`flat_mul`, dense or sparse), the cyclotomic square (a run of k in one
launch), the conjugation,
the Frobenius map, the slot-symmetric square and the product of two
sparse lines are one hand-written CUDA kernel each (K13, K14, K15, K16,
K17 and K20 in `ops/kernels.py`, as `drand_tpu` takes its Pallas kernels
on its chip); a CPU tensor takes the plain versions `_flat_mul_plain`,
`_flat_cyclo_sqr_plain`, `_flat_conj_plain`, `_flat_frob_plain`,
`_flat_sqr_plain` and `_line_merge_plain`, `drand_tpu`'s composite
branches.  Every output is canonical, so kernel and plain version agree
bit for bit.

Basis mapping: the tower element ((a0,a1,a2),(b0,b1,b2)) with Fp2 cells
c = x + y*u occupies slots s(a0)=0, s(b0)=1, s(a1)=2, s(b1)=3, s(a2)=4,
s(b2)=5, with x + y*u at slot s -> (x - y)*w^s + y*w^(s+6).

A flat element is an [..., 12, 32] int32 tensor (w-power axis, then
limbs), canonical Montgomery form per coefficient.  The convolution and
recombination tables are static 0/1 and small-integer tables applied by
gathers and `index_add_` (there is no integer einsum on CUDA).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as TF

from drand_tpu_torch.crypto.bls12381 import fp as G
from drand_tpu_torch.crypto.bls12381.constants import P
from drand_tpu_torch.ops import kernels as K
from drand_tpu_torch.ops import towers as T
from drand_tpu_torch.ops.field import (FP, N_LIMBS, _carry, _carry_cheap,
                                       _poly_mul_var, dev, host, int_to_words,
                                       limbs_to_int)

# ---------------------------------------------------------------------------
# Host-side basis conversion (golden ints <-> flat coefficient lists)
# ---------------------------------------------------------------------------

_SLOT = [0, 2, 4, 1, 3, 5]  # tower cell order a0,a1,a2,b0,b1,b2 -> w-power


def flat_coeffs_from_tower(t) -> list[int]:
    """Golden fp12 tuple -> 12 plain-int coefficients over the w basis."""
    cells = list(t[0]) + list(t[1])
    out = [0] * 12
    for cell, s in zip(cells, _SLOT):
        x, y = cell
        out[s] = (x - y) % P
        out[s + 6] = y % P
    return out


def tower_from_flat_coeffs(c) -> tuple:
    """12 plain ints -> golden fp12 tuple."""
    cells = []
    for s in _SLOT:
        y = c[s + 6] % P
        x = (c[s] + y) % P
        cells.append((x, y))
    return ((cells[0], cells[1], cells[2]), (cells[3], cells[4], cells[5]))


def flat_encode(vals, device="cpu") -> torch.Tensor:
    """List of golden fp12 tuples -> [len, 12, 32] Montgomery flat."""
    return torch.as_tensor(np.stack([
        np.stack([FP.to_mont_host(c) for c in flat_coeffs_from_tower(v)])
        for v in vals]), device=device)


def flat_decode(a, i=None) -> tuple:
    if i is not None:
        a = a[i]
    a = a.cpu().numpy()
    return tower_from_flat_coeffs([FP.from_limbs_host(a[k]) for k in range(12)])


# ---------------------------------------------------------------------------
# Convolution and reduction tables (static)
# ---------------------------------------------------------------------------

def _reduce_matrix(K):
    """[K, 12] signed small-int matrix reducing w^k (k < K <= 23) onto the
    basis, via w^12 = 2w^6 - 2 iterated."""
    rows = []
    for k in range(K):
        r = np.zeros(12, np.int64)
        if k < 12:
            r[k] = 1
        elif k < 18:
            r[k - 6] += 2
            r[k - 12] -= 2
        else:  # 18..22: w^k = 2 w^(k-12) - 4 w^(k-18)
            r[k - 12] += 2
            r[k - 18] -= 4
        rows.append(r)
    return np.stack(rows)


def _check_reduction():
    """Row k of the reduction matrix must equal the flat coefficients of
    w^k computed through the golden tower arithmetic."""
    w = (((0, 0), (0, 0), (0, 0)), ((1, 0), (0, 0), (0, 0)))
    red = _reduce_matrix(23)
    acc = G.FP12_ONE
    for k in range(23):
        want = flat_coeffs_from_tower(acc)
        got = [int(red[k, j]) % P for j in range(12)]
        if want != got:
            raise AssertionError(f"reduction row {k}: {want} != {got}")
        acc = G.fp12_mul(acc, w)


_check_reduction()

_TABLES: dict = {}


def _tables(b_idx):
    """For a static b_idx: the conv target k of every (i, j) coefficient
    pair, the number K of conv coefficients, the (k, j, weight) entries of
    the positive and negative parts of the reduction matrix, and the bound
    of the recombined sum in units of p."""
    key = tuple(b_idx)
    if key not in _TABLES:
        conv_k = np.array([i + bj for i in range(12) for bj in b_idx])
        K = 11 + max(b_idx) + 1
        red = _reduce_matrix(K)
        pos = np.argwhere(red > 0)
        neg = np.argwhere(red < 0)
        bound = int(np.abs(red).sum(axis=0).max()) + 1
        _TABLES[key] = dict(
            conv_k=torch.as_tensor(conv_k, dtype=torch.int64), K=K,
            pos_k=torch.as_tensor(pos[:, 0]), pos_j=torch.as_tensor(pos[:, 1]),
            pos_w=host(red[pos[:, 0], pos[:, 1]][:, None]),
            neg_k=torch.as_tensor(neg[:, 0]), neg_j=torch.as_tensor(neg[:, 1]),
            neg_w=host(-red[neg[:, 0], neg[:, 1]][:, None]),
            bound=bound)
    return _TABLES[key]


# ---------------------------------------------------------------------------
# Core ops
# ---------------------------------------------------------------------------

FLAT_ONE = host(np.stack([FP.one_mont.numpy()] +
                         [np.zeros(N_LIMBS, np.int32)] * 11))
_ODD = torch.as_tensor((np.arange(12) % 2).astype(bool))


def flat_broadcast(a, shape, device):
    return dev(a, device).expand(tuple(shape) + (12, N_LIMBS))


def flat_eq(a, b):
    return (a == b).all(-1).all(-1)


def flat_is_one(a):
    return flat_eq(a, dev(FLAT_ONE, a.device))


def flat_mul(a, b, b_idx=tuple(range(12))):
    """Flat Fp12 product.  a [..., 12, 32]; b [..., J, 32] holding the
    coefficients of the w-powers listed in static `b_idx` (full element by
    default; Miller-loop lines pass their 6 non-zero powers).  Kernel K13
    on a GPU tensor."""
    if a.device.type == "cpu":
        return _flat_mul_plain(a, b, b_idx)
    return K.flat_mul(a, b, b_idx, FP)


def _flat_mul_plain(a, b, b_idx=tuple(range(12))):
    """Plain version of K13: broadcast limb multiply -> convolution onto
    w-powers (<= 12 canonical products per coefficient keeps the value
    inside the mont_reduce contract) -> stacked Montgomery reduction ->
    signed recombination with negatives folded through p - x."""
    tb = _tables(b_idx)
    d = a.device
    cols = _poly_mul_var(a[..., :, None, :], b[..., None, :, :])
    # pad to 64 limbs BEFORE carrying: a product spans up to 762 bits and
    # a conv sum up to 766
    cols = _carry_cheap(TF.pad(cols, (0, 1)))            # [..., 12, J, 64]
    shape = cols.shape[:-3]
    conv = torch.zeros(shape + (tb["K"], 2 * N_LIMBS), dtype=cols.dtype,
                       device=d)
    conv.index_add_(-2, dev(tb["conv_k"], d),
                    cols.reshape(shape + (-1, 2 * N_LIMBS)))
    red = FP._mont_reduce_plain(_carry_cheap(conv))      # [..., K, 32]
    nred = FP.neg(red)
    s = torch.zeros(shape + (12, N_LIMBS), dtype=red.dtype, device=d)
    s.index_add_(-2, dev(tb["pos_j"], d),
                 red[..., dev(tb["pos_k"], d), :] * dev(tb["pos_w"], d))
    s.index_add_(-2, dev(tb["neg_j"], d),
                 nred[..., dev(tb["neg_k"], d), :] * dev(tb["neg_w"], d))
    return FP.reduce_small_multiple(_carry(s), tb["bound"])


def flat_sqr(a):
    """a^2, slot-symmetric: kernel K17 on a GPU tensor."""
    if a.device.type == "cpu":
        return _flat_sqr_plain(a)
    return K.flat_sqr(a, FP)


def _flat_sqr_plain(a):
    """Plain version of K17: the product a * a (the same canonical
    element)."""
    return _flat_mul_plain(a, a)


# Sparse line: Fp2 triple (a, b, c) meaning a + b*w^2 + c*w^3, i.e. flat
# slots {0, 2, 3, 6, 8, 9}.
LINE_IDX = (0, 2, 3, 6, 8, 9)


def line_merge(l1, l2):
    """The dense [..., 12, 32] product of two sparse lines [..., 6, 32] on
    LINE_IDX: kernel K20 on a GPU tensor."""
    if l1.device.type == "cpu":
        return _line_merge_plain(l1, l2)
    return K.line_merge(l1, l2, FP)


def _line_merge_plain(l1, l2):
    """Plain version of K20: l1 scattered to a dense element, times l2
    through the plain sparse product."""
    shape = torch.broadcast_shapes(l1.shape[:-2], l2.shape[:-2])
    dense = torch.zeros(shape + (12, N_LIMBS), dtype=l1.dtype,
                        device=l1.device)
    dense[..., list(LINE_IDX), :] = l1
    return _flat_mul_plain(dense, l2, LINE_IDX)


def flat_conj(a):
    """f^(p^6): negate the odd w-powers.  Kernel K15 on a GPU tensor."""
    if a.device.type == "cpu":
        return _flat_conj_plain(a)
    return K.flat_conj(a, FP)


def _flat_conj_plain(a):
    return torch.where(dev(_ODD, a.device)[:, None], FP.neg(a), a)


# ---------------------------------------------------------------------------
# Frobenius: block-diagonal over the slot pairs (s, s+6)
# ---------------------------------------------------------------------------

def _w_power_tower(k: int):
    acc = G.FP12_ONE
    w = (((0, 0), (0, 0), (0, 0)), ((1, 0), (0, 0), (0, 0)))
    for _ in range(k):
        acc = G.fp12_mul(acc, w)
    return acc


def _frob_consts(n: int):
    """Per-slot 2x2 Fp matrices [[A,B],[C,D]]: frob^n maps
    (c_s, c_(s+6)) -> (A c_s + B c_(s+6), C c_s + D c_(s+6))."""
    A, B, C, D = (np.zeros((6, N_LIMBS), np.int32) for _ in range(4))
    for s in range(6):
        for src, (lo_t, hi_t) in (("lo", (A, C)), ("hi", (B, D))):
            k = s if src == "lo" else s + 6
            coeffs = flat_coeffs_from_tower(G.fp12_frob_n(_w_power_tower(k), n))
            if any(c for j, c in enumerate(coeffs) if j not in (s, s + 6)):
                raise AssertionError(f"frobenius not block-diagonal at {k}")
            lo_t[s] = FP.to_mont_host(coeffs[s])
            hi_t[s] = FP.to_mont_host(coeffs[s + 6])
    return tuple(host(x) for x in (A, B, C, D))


_FROB = {n: _frob_consts(n) for n in (1, 2, 3)}
# K16's constant argument: per slot s, A B C D as 6 words each
_FROB_WORDS = {n: np.stack([
    np.stack([int_to_words(limbs_to_int(c[s].numpy())) for c in consts])
    for s in range(6)]) for n, consts in _FROB.items()}


def flat_frob(a, n: int = 1):
    """a^(p^n) for n in 1..3.  Kernel K16 on a GPU tensor."""
    if a.device.type == "cpu":
        return _flat_frob_plain(a, n)
    return K.flat_frob(a, n, _FROB_WORDS[n], FP)


def _flat_frob_plain(a, n: int = 1):
    A, B, C, D = (dev(x, a.device) for x in _FROB[n])
    lo, hi = a[..., :6, :], a[..., 6:, :]
    st_a = torch.stack([lo, hi, lo, hi], 0)
    st_b = torch.stack([A.expand(lo.shape), B.expand(hi.shape),
                        C.expand(lo.shape), D.expand(hi.shape)], 0)
    p = FP._mont_mul_plain(*torch.broadcast_tensors(st_a, st_b))
    return torch.cat([FP.add(p[0], p[1]), FP.add(p[2], p[3])], -2)


# ---------------------------------------------------------------------------
# Tower <-> flat on device
# ---------------------------------------------------------------------------

def flat_from_tower(t):
    cells = list(t[0]) + list(t[1])
    xs = torch.stack([cells[i][0] for i in (0, 3, 1, 4, 2, 5)], -2)
    ys = torch.stack([cells[i][1] for i in (0, 3, 1, 4, 2, 5)], -2)
    return torch.cat([FP.sub(xs, ys), ys], -2)


def flat_to_tower(a):
    lo, hi = a[..., :6, :], a[..., 6:, :]
    xs = FP.add(lo, hi)

    def cell(i):
        return (xs[..., i, :], hi[..., i, :])
    return ((cell(0), cell(2), cell(4)), (cell(1), cell(3), cell(5)))


def flat_inv(a):
    """Inverse via the tower formulas (once per pairing check)."""
    return flat_from_tower(T.fp12_inv(flat_to_tower(a)))


def flat_cyclo_sqr(a, k: int = 1):
    """k Granger-Scott cyclotomic squarings for UNITARY elements
    (everything after the final exponentiation's easy part): 9 Fp2
    squares each instead of the full flat square.  Kernel K14 on a GPU
    tensor, all k squares in one launch."""
    if a.device.type == "cpu":
        return _flat_cyclo_sqr_plain(a, k)
    return K.cyclo_sqr(a, FP, k)


def _flat_cyclo_sqr_plain(a, k: int = 1):
    """Plain version of K14: k times the 9 Fp2 squares in one stack and
    the rest in stacked Fp2 adds and subtracts.  A fixed function of any
    canonical input; it equals a^(2^k) where `a` is unitary."""
    for _ in range(k):
        a = _cyclo_sqr_once(a)
    return a


def _cyclo_sqr_once(a):
    hi = a[..., 6:, :]
    xs = FP.add(a[..., :6, :], hi)          # tower-cell x coordinates

    def cell(slot):
        return (xs[..., slot, :], hi[..., slot, :])

    g0, g1, g2 = cell(0), cell(2), cell(4)
    g3, g4, g5 = cell(1), cell(3), cell(5)
    s_a, s_b, s_c = T.fp2_sums([(g0, g4), (g3, g2), (g1, g5)])
    a2, b2, sa2, c2, d2, sb2, e2, f2, sc2 = T._fp2_products_plain([
        (g0, g0), (g4, g4), (s_a, s_a),
        (g3, g3), (g2, g2), (s_b, s_b),
        (g1, g1), (g5, g5), (s_c, s_c)])

    def fp4(a_sq, b_sq, s_sq):
        re = T.fp2_add(a_sq, T.fp2_mul_xi(b_sq))
        im = T.fp2_sub(T.fp2_sub(s_sq, a_sq), b_sq)
        return re, im

    re_a, im_a = fp4(a2, b2, sa2)
    re_b, im_b = fp4(c2, d2, sb2)
    re_c, im_c = fp4(e2, f2, sc2)

    def tm(t, g):   # 3t - 2g
        d = T.fp2_sub(t, g)
        return T.fp2_add(T.fp2_add(d, d), t)

    def tp(t, g):   # 3t + 2g
        s = T.fp2_add(t, g)
        return T.fp2_add(T.fp2_add(s, s), t)

    out = {
        0: tm(re_a, g0), 2: tm(re_b, g1), 4: tm(re_c, g2),
        1: tp(T.fp2_mul_xi(im_c), g3), 3: tp(im_a, g4), 5: tp(im_b, g5),
    }
    xs2 = torch.stack([out[i][0] for i in range(6)], -2)
    ys2 = torch.stack([out[i][1] for i in range(6)], -2)
    return torch.cat([FP.sub(xs2, ys2), ys2], -2)
