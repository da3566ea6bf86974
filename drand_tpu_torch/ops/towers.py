"""Batched BLS12-381 field towers in PyTorch: Fp2, and the Fp6/Fp12
tower formulas the flat Fp12 inverse needs.

Counterpart of `drand_tpu/ops/towers.py`.  A stack of Fp2 products or
squares, and an Fp2 chain step x^(2^k) * t, is one hand-written CUDA
kernel on a GPU tensor (K5, K6, K7 and K8 in `ops/kernels.py`, as
`drand_tpu` takes its Pallas kernels on its chip); a CPU tensor takes the
plain versions `_fp2_products_plain`, `_fp2_sqrs_plain` and
`_fp2_sqr_chain_mul_plain`, `drand_tpu`'s composite branches: ONE wide limb
convolution, the u^2 = -1 combination in the wide domain (the subtraction
through a K*p^2 offset), and ONE stacked Montgomery reduction.  Every
output is canonical, so kernel and plain version agree bit for bit.
Elements are tuples of `[..., 32]` int32 Montgomery limb tensors:

  Fp2  : (c0, c1)           c0 + c1*u,   u^2 = -1
  Fp6  : (a0, a1, a2)       a_i in Fp2,  v^3 = xi = 1 + u
  Fp12 : (b0, b1)           b_i in Fp6,  w^2 = v
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as TF

from drand_tpu_torch.crypto.bls12381 import fp as G
from drand_tpu_torch.crypto.bls12381.constants import P
from drand_tpu_torch.ops import kernels as K
from drand_tpu_torch.ops.field import (FP, LIMB_MASK, N_LIMBS, _carry,
                                       _carry_cheap, _poly_mul_var,
                                       addchain_plan, dev, host)

# ---------------------------------------------------------------------------
# Fp helpers
# ---------------------------------------------------------------------------

fp_add, fp_sub, fp_neg = FP.add, FP.sub, FP.neg
fp_mul, fp_sqr, fp_inv = FP.mont_mul, FP.sqr, FP.inv

_SQRT_EXP = (P + 1) // 4


def fp_const(x: int) -> torch.Tensor:
    """Host int -> [32] Montgomery constant (CPU; `dev` places it)."""
    return host(FP.to_mont_host(x % P))


FP_ZERO = host(np.zeros(N_LIMBS, np.int32))
FP_ONE = FP.one_mont


def fp_broadcast(c: torch.Tensor, shape, device) -> torch.Tensor:
    return dev(c, device).expand(tuple(shape) + (N_LIMBS,))


def fp_sqrt_cand(a):
    """Candidate sqrt a^((p+1)/4) (a root exactly where a is a square)."""
    return FP.pow_const(a, _SQRT_EXP)


def fp_sgn0(a):
    """Parity of the canonical (non-Montgomery) representative."""
    return FP.from_mont(a)[..., 0] & 1


def fp_select(mask, a, b):
    return FP.select(mask, a, b)


# ---------------------------------------------------------------------------
# Fp2
# ---------------------------------------------------------------------------

FP2_ZERO = (FP_ZERO, FP_ZERO)
FP2_ONE = (FP_ONE, FP_ZERO)


def fp2_broadcast(a, shape, device):
    return tuple(fp_broadcast(c, shape, device) for c in a)


def fp2_const(c: tuple):
    return (fp_const(c[0]), fp_const(c[1]))


def fp2_sums(pairs):
    """[(x, y), ...] Fp2 pairs -> [x+y, ...] via one stacked Fp add."""
    flat = FP.sums([(x[0], y[0]) for x, y in pairs] +
                   [(x[1], y[1]) for x, y in pairs])
    n = len(pairs)
    return [(flat[i], flat[n + i]) for i in range(n)]


def fp2_diffs(pairs):
    flat = FP.diffs([(x[0], y[0]) for x, y in pairs] +
                    [(x[1], y[1]) for x, y in pairs])
    n = len(pairs)
    return [(flat[i], flat[n + i]) for i in range(n)]


def wide_neg_offset(scale: int = 1, min_value: int | None = None):
    """A 64-limb constant O with value K*p^2 >= min_value (a multiple of
    p, so adding it keeps the residue of a wide product), used to fold a
    wide-domain subtraction into the Montgomery reduction:
    a - b ~~> a + (O - b).  The VALUE must cover the subtracted value;
    per-limb bases of scale*4300 keep the limbs of O - b non-negative.
    Returns (limbs, value)."""
    pp = P * P
    base = [scale * 4300] * 63
    B = sum(v << (12 * c) for c, v in enumerate(base))
    need = B + ((scale * 64) << 756)
    if min_value is not None:
        need = max(need, min_value)
    K = -(-need // pp)
    rem = K * pp - B
    o63 = rem >> 756
    rem2 = rem - (o63 << 756)
    limbs = np.array(base + [o63], dtype=np.int64)
    for c in range(63):
        limbs[c] += (rem2 >> (12 * c)) & 0xFFF
    val = int(sum(int(v) << (12 * c) for c, v in enumerate(limbs)))
    if val != K * pp or limbs.max() >= (1 << 31) or \
            (min_value is not None and val < min_value):
        raise AssertionError("wide offset construction failed")
    return limbs.astype(np.int32), K * pp


# covers the subtracted conv of one product of canonical operands (< p^2)
_WIDE_NEG_OFF = host(wide_neg_offset(1, min_value=P * P)[0])


def _fp2_stack(items):
    """[x, ...] Fp2 elements -> one [n, 2, ..., 32] tensor, every
    coordinate broadcast to the common shape."""
    coords = FP._common([c for x in items for c in x])
    return torch.stack(coords, 0).unflatten(0, (len(items), 2))


def _fp2_unstack(st):
    return [(st[i, 0], st[i, 1]) for i in range(st.shape[0])]


def fp2_products(pairs):
    """[(x, y), ...] Fp2 pairs -> [x*y, ...]: kernel K5 on a GPU tensor."""
    if pairs[0][0][0].device.type == "cpu":
        return _fp2_products_plain(pairs)
    st = _fp2_stack([x for x, _ in pairs] + [y for _, y in pairs])
    n = len(pairs)
    return _fp2_unstack(K.fp2_products(st[:n], st[n:], FP))


def fp2_sqrs(items):
    """[x, ...] -> [x^2, ...]: kernel K6 on a GPU tensor."""
    if items[0][0].device.type == "cpu":
        return _fp2_sqrs_plain(items)
    return _fp2_unstack(K.fp2_sqrs(_fp2_stack(items), FP))


def _fp2_products_plain(pairs):
    """Plain version of K5: the 4n coefficient products as ONE wide limb
    multiply, x0y0 - x1y1 in the wide domain through the K*p^2 offset, and
    ONE stacked Montgomery reduction of all 2n outputs."""
    n = len(pairs)
    coords = FP._common(
        [x[0] for x, _ in pairs] + [x[1] for x, _ in pairs] +
        [y[0] for _, y in pairs] + [y[1] for _, y in pairs])
    x0, x1 = coords[:n], coords[n:2 * n]
    y0, y1 = coords[2 * n:3 * n], coords[3 * n:]
    A = torch.stack(x0 + x1 + x0 + x1, 0)
    B = torch.stack(y0 + y1 + y1 + y0, 0)
    t = _carry_cheap(TF.pad(_poly_mul_var(A, B), (0, 1)))
    t00, t11 = t[:n], t[n:2 * n]
    t01, t10 = t[2 * n:3 * n], t[3 * n:]
    c0w = t00 + (dev(_WIDE_NEG_OFF, t.device) - t11)   # x0y0 - x1y1 (+ K p^2)
    c1w = t01 + t10                                    # x0y1 + x1y0
    red = FP._mont_reduce_plain(torch.cat([c0w, c1w], 0))
    return [(red[i], red[n + i]) for i in range(n)]


def _stack2c(a, b):
    a0, a1, b0, b1 = FP._common([a[0], a[1], b[0], b[1]])
    return torch.stack([a0, a1]), torch.stack([b0, b1])


def fp2_add(a, b):
    s = fp_add(*_stack2c(a, b))
    return (s[0], s[1])


def fp2_sub(a, b):
    s = fp_sub(*_stack2c(a, b))
    return (s[0], s[1])


def fp2_neg(a):
    n = fp_neg(torch.stack(FP._common([a[0], a[1]])))
    return (n[0], n[1])


def fp2_conj(a):
    return (a[0], fp_neg(a[1]))


def fp2_mul(a, b):
    return fp2_products([(a, b)])[0]


def fp2_sqr(a):
    return fp2_sqrs([a])[0]


def _fp2_sqrs_plain(items):
    """Plain version of K6: the composite product stack on (x, x)."""
    return _fp2_products_plain([(x, x) for x in items])


def fp2_mul_fp(a, s):
    t = FP.products([(a[0], s), (a[1], s)])
    return (t[0], t[1])


def fp2_mul_small(a, c: int):
    s = FP.mul_small(torch.stack(FP._common([a[0], a[1]])), c)
    return (s[0], s[1])


def fp2_mul_xi(a):
    """xi = 1 + u: (c0 - c1) + (c0 + c1) u in one stacked carry (the
    subtraction rides the limb complement)."""
    a0, a1 = FP._common([a[0], a[1]])
    comp = FP.c(FP.MODP1, a0) + (LIMB_MASK - a1)
    s = _carry(torch.stack([a0 + comp, a0 + a1]))
    s = FP._cond_sub_full(s)
    return (s[0], s[1])


def fp2_norm(a):
    t = FP.products([(a[0], a[0]), (a[1], a[1])])
    return fp_add(t[0], t[1])


def fp2_inv(a):
    a0, a1 = a
    ninv = fp_inv(fp2_norm(a))
    t = FP.products([(a0, ninv), (fp_neg(a1), ninv)])
    return (t[0], t[1])


def fp2_is_zero(a):
    return FP.is_zero(a[0]) & FP.is_zero(a[1])


def fp2_eq(a, b):
    return FP.eq(a[0], b[0]) & FP.eq(a[1], b[1])


def fp2_select(mask, a, b):
    return (fp_select(mask, a[0], b[0]), fp_select(mask, a[1], b[1]))


def fp2_sgn0(a):
    s0 = fp_sgn0(a[0])
    z0 = FP.is_zero(a[0]).to(s0.dtype)
    s1 = fp_sgn0(a[1])
    return s0 | (z0 & s1)


def fp2_pack(a):
    """Fp2 element -> one [2, ..., 32] tensor, coordinate c at [c]: the
    operand layout of the chain-step kernels K7 and K8."""
    return _fp2_stack([a])[0]


def fp2_unpack(st):
    return (st[0], st[1])


def fp2_sqr_chain_mul(x, k: int, t=None):
    """x^(2^k) * t, or x^(2^k) when t is None, on packed Fp2 (`fp2_pack`):
    kernel K7 on a GPU tensor."""
    if x.device.type == "cpu":
        return _fp2_sqr_chain_mul_plain(x, k, t)
    return K.fp2_sqr_chain_mul(x, k, t, FP)


def fp2_sqr5_mul(x, t):
    """The window step x^32 * t on packed Fp2: kernel K8 on a GPU tensor."""
    if x.device.type == "cpu":
        return _fp2_sqr_chain_mul_plain(x, 5, t)
    return K.fp2_sqr5_mul(x, t, FP)


def _fp2_sqr_chain_mul_plain(x, k: int, t=None):
    """Plain version of K7 (and of K8 at k = 5): k plain Fp2 squares, then
    one plain product."""
    a = fp2_unpack(x)
    for _ in range(k):
        (a,) = _fp2_sqrs_plain([a])
    if t is not None:
        (a,) = _fp2_products_plain([(a, fp2_unpack(t))])
    return fp2_pack(a)


def fp2_pow_const(a, e: int):
    """a^e (Fp2, Montgomery) for a static exponent, by the executor
    `drand_tpu` takes on its chip: for exponents of 64 bits and more an
    addition chain (`fp2_pow_addchain`, every step one K7 launch) where
    the planner says it costs fewer operations than the uniform 5-bit
    window; else the window (table a^0..a^31 in four doubling levels,
    then one K8 launch x^32 * t per digit)."""
    a = tuple(FP._common([a[0], a[1]]))
    shape, device = a[0].shape[:-1], a[0].device
    one = fp2_broadcast(FP2_ONE, shape, device)
    if e == 0:
        return one
    if e < 32:
        res = a
        for bit in bin(e)[3:]:
            res = fp2_sqr(res)
            if bit == "1":
                res = fp2_mul(res, a)
        return res
    if e >= (1 << 64):
        ops, build, n_sqr, n_mul, used_odd = addchain_plan(e)
        nd = (e.bit_length() + 4) // 5
        if n_sqr + n_mul < 6 * (nd - 1) + 32:
            return fp2_pow_addchain(a, ops, build, used_odd)
    tab = [one, a] + [None] * 30
    for lvl in (1, 2, 4, 8):
        evens = fp2_sqrs([tab[k] for k in range(lvl, 2 * lvl)])
        odds = fp2_products([(ev, a) for ev in evens])
        for i, k in enumerate(range(lvl, 2 * lvl)):
            tab[2 * k] = evens[i]
            tab[2 * k + 1] = odds[i]
    digits = []
    x = e
    while x:
        digits.append(x & 31)
        x >>= 5
    digits = digits[::-1]
    packs = [fp2_pack(t) for t in tab]
    res = packs[digits[0]]
    for d in digits[1:]:
        res = fp2_sqr5_mul(res, packs[d])
    return fp2_unpack(res)


def fp2_pow_addchain(a, ops, build, used_odd: bool):
    """Execute an `addchain_plan` over Fp2 (`drand_tpu`'s
    fp2_pow_addchain): the odd table from K5/K6 products, then every step
    res^(2^k) (* t) one K7 launch on packed operands."""
    seed_lens = set()
    for _, src, shift in build:
        seed_lens.update(x for x in (src, shift) if 2 <= x <= 5)
    for op in ops:
        if op[0] in ("init_rep", "sqrmul_rep") and 2 <= op[-1] <= 5:
            seed_lens.add(op[-1])
    tab = {}
    if used_odd:
        need = max([op[2] for op in ops if op[0] == "sqrmul_odd"] +
                   [op[1] for op in ops if op[0] == "init_odd"] +
                   [(1 << l) - 1 for l in seed_lens] + [1])
        tab[1] = a
        a2 = fp2_sqr(a)
        v = 3
        while v <= need:
            tab[v] = fp2_mul(tab[v - 2], a2)
            v += 2
    packed = {v: fp2_pack(t) for v, t in tab.items()}
    reps = {1: fp2_pack(a)}
    if used_odd:
        for l in seed_lens:
            reps[l] = packed[(1 << l) - 1]
    for new, src, shift in build:
        reps[new] = fp2_sqr_chain_mul(reps[src], shift, reps[shift])
    res = None
    for op in ops:
        if op[0] == "init_rep":
            res = reps[op[1]]
        elif op[0] == "init_odd":
            res = packed[op[1]]
        elif op[0] == "sqrmul_rep":
            res = fp2_sqr_chain_mul(res, op[1], reps[op[2]])
        elif op[0] == "sqrmul_odd":
            res = fp2_sqr_chain_mul(res, op[1], packed[op[2]])
        elif op[1]:
            res = fp2_sqr_chain_mul(res, op[1])
    return fp2_unpack(res)


# Direct Fp2 square roots: q = p^2 = 9 (mod 16), so a^((q+7)/16) is a root
# of a up to a 4th root of unity, and one of the four candidates
# c * {1, s, u, s*u} with s = sqrt(u) is exact.
_Q = P * P
_E_SQRT = (_Q + 7) // 16
_E_RATIO = (_Q - 9) // 16


def _mu8_table():
    s = G.fp2_sqrt((0, 1))          # s^2 = u
    w = [(1, 0), s, (0, 1), G.fp2_mul(s, (0, 1))]
    if [G.fp2_sqr(x) for x in w] != [(1, 0), (0, 1), (P - 1, 0), (0, P - 1)]:
        raise AssertionError("mu_8 table does not square onto mu_4")
    return [fp2_const(x) for x in w]


_MU8_W = _mu8_table()


def fp2_sqrt_cand(a):
    """Branchless sqrt: (cand, ok_mask); cand is a square root of `a`
    exactly where ok_mask is True.  One (q+7)/16 chain + a 4-way mu_8
    correction."""
    c = fp2_pow_const(a, _E_SQRT)
    shape, device = c[0].shape[:-1], c[0].device
    ws = [fp2_broadcast(w, shape, device) for w in _MU8_W]
    cands = [c] + fp2_products([(c, w) for w in ws[1:]])
    sqs = fp2_sqrs(cands)
    cand, ok = cands[0], fp2_eq(sqs[0], a)
    for cd, sq in zip(cands[1:], sqs[1:]):
        good = fp2_eq(sq, a)
        cand = fp2_select(good, cd, cand)
        ok = ok | good
    return cand, ok


def make_fp2_sqrt_ratio(z_c: tuple):
    """sqrt_ratio(u, v) for the SSWU Z = z_c: (y, is_square) with
    y = sqrt(u/v) where u/v is square, else y = sqrt(Z * u/v) -- no field
    inversion (RFC 9380 F.2.1.2 shape)."""
    if G.fp2_is_square(z_c):
        raise ValueError("SSWU Z must be a non-square")
    kz = fp2_const(G.fp2_pow(z_c, _E_SQRT))
    z_dev = fp2_const(z_c)

    def sqrt_ratio(u, v):
        v2, uv = fp2_sqrs([v])[0], fp2_mul(u, v)
        uv3, v4 = fp2_products([(uv, v2), (v2, v2)])
        (uv7,) = fp2_products([(uv3, v4)])
        t = fp2_pow_const(uv7, _E_RATIO)
        (c,) = fp2_products([(uv3, t)])
        shape, device = c[0].shape[:-1], c[0].device
        (c2,) = fp2_products([(c, fp2_broadcast(kz, shape, device))])
        zu = fp2_mul(fp2_broadcast(z_dev, shape, device), u)
        ws = [fp2_broadcast(w, shape, device) for w in _MU8_W]
        c1s = [c] + fp2_products([(c, w) for w in ws[1:]])
        c2s = [c2] + fp2_products([(c2, w) for w in ws[1:]])
        sqs = fp2_sqrs(c1s + c2s)
        checks = fp2_products([(s, v) for s in sqs])
        y = c1s[0]
        is_sq = torch.zeros(shape, dtype=torch.bool, device=device)
        for j in range(4):
            good = fp2_eq(checks[j], u)
            y = fp2_select(good, c1s[j], y)
            is_sq = is_sq | good
        for j in range(4):
            good = fp2_eq(checks[4 + j], zu) & ~is_sq
            y = fp2_select(good, c2s[j], y)
        return y, is_sq

    return sqrt_ratio


# ---------------------------------------------------------------------------
# Fp6 / Fp12 tower formulas (the flat Fp12 inverse evaluates through them)
# ---------------------------------------------------------------------------

def fp6_neg(a):
    n = FP.negs([a[0][0], a[0][1], a[1][0], a[1][1], a[2][0], a[2][1]])
    return ((n[0], n[1]), (n[2], n[3]), (n[4], n[5]))


def fp6_sub(a, b):
    return tuple(fp2_diffs(list(zip(a, b))))


def fp6_products(pairs):
    """[(a, b), ...] Fp6 pairs -> [a*b, ...]: 6n Fp2 products in one
    stack (Karatsuba layout of the golden fp6_mul)."""
    n = len(pairs)
    pre = fp2_sums(
        [(a[1], a[2]) for a, _ in pairs] + [(b[1], b[2]) for _, b in pairs] +
        [(a[0], a[1]) for a, _ in pairs] + [(b[0], b[1]) for _, b in pairs] +
        [(a[0], a[2]) for a, _ in pairs] + [(b[0], b[2]) for _, b in pairs])
    a12 = pre[0:n]; b12 = pre[n:2 * n]
    a01 = pre[2 * n:3 * n]; b01 = pre[3 * n:4 * n]
    a02 = pre[4 * n:5 * n]; b02 = pre[5 * n:6 * n]
    prod = fp2_products(
        [(a[0], b[0]) for a, b in pairs] +
        [(a[1], b[1]) for a, b in pairs] +
        [(a[2], b[2]) for a, b in pairs] +
        [(a12[i], b12[i]) for i in range(n)] +
        [(a01[i], b01[i]) for i in range(n)] +
        [(a02[i], b02[i]) for i in range(n)])
    t0 = prod[0:n]; t1 = prod[n:2 * n]; t2 = prod[2 * n:3 * n]
    m12 = prod[3 * n:4 * n]; m01 = prod[4 * n:5 * n]; m02 = prod[5 * n:6 * n]
    s12 = fp2_sums([(t1[i], t2[i]) for i in range(n)] +
                   [(t0[i], t1[i]) for i in range(n)] +
                   [(t0[i], t2[i]) for i in range(n)])
    d = fp2_diffs([(m12[i], s12[i]) for i in range(n)] +
                  [(m01[i], s12[n + i]) for i in range(n)] +
                  [(m02[i], s12[2 * n + i]) for i in range(n)])
    xi_m12 = [fp2_mul_xi(d[i]) for i in range(n)]
    xi_t2 = [fp2_mul_xi(t2[i]) for i in range(n)]
    fin = fp2_sums([(t0[i], xi_m12[i]) for i in range(n)] +
                   [(d[n + i], xi_t2[i]) for i in range(n)] +
                   [(d[2 * n + i], t1[i]) for i in range(n)])
    return [(fin[i], fin[n + i], fin[2 * n + i]) for i in range(n)]


def fp6_mul_by_v(a):
    return (fp2_mul_xi(a[2]), a[0], a[1])


def fp6_inv(a):
    a0, a1, a2 = a
    t0, t1, t2, t3, t4, t5 = fp2_products(
        [(a0, a0), (a1, a1), (a2, a2), (a0, a1), (a0, a2), (a1, a2)])
    c0 = fp2_sub(t0, fp2_mul_xi(t5))
    c1 = fp2_sub(fp2_mul_xi(t2), t3)
    c2 = fp2_sub(t1, t4)
    dets = fp2_products([(a0, c0), (a2, c1), (a1, c2)])
    det = fp2_add(dets[0], fp2_mul_xi(fp2_add(dets[1], dets[2])))
    det_inv = fp2_inv(det)
    return tuple(fp2_products([(c0, det_inv), (c1, det_inv), (c2, det_inv)]))


def fp12_inv(a):
    a0, a1 = a
    s0, s1 = fp6_products([(a0, a0), (a1, a1)])
    det = fp6_sub(s0, fp6_mul_by_v(s1))
    det_inv = fp6_inv(det)
    o0, o1 = fp6_products([(a0, det_inv), (a1, det_inv)])
    return (o0, fp6_neg(o1))


# ---------------------------------------------------------------------------
# Device -> host conversion helpers (limbs -> golden tuples of ints)
# ---------------------------------------------------------------------------

def fp_decode(a, i=None) -> int:
    if i is not None:
        a = a[i]
    return FP.from_limbs_host(a.cpu().numpy())


def fp2_decode(a, i=None) -> tuple:
    return (fp_decode(a[0], i), fp_decode(a[1], i))
