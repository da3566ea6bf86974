"""The plain versions of the port's Fp2 chain, G2 point (K9 also as a
chain of doublings) and Miller iteration kernels (K7-K12) against
drand_tpu, limb for limb.

The same inputs (numpy, fixed seed) go through the port's plain version
on the CPU -- what the kernel is held against on the card -- and through
drand_tpu's composite functions on the CPU, the reference its own tests
hold its Pallas kernels to.  Every output is canonical, so the tolerance
is exact equality.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drand_tpu.crypto.bls12381.constants import P
from drand_tpu.ops import curve as JC
from drand_tpu.ops import flat12 as JF
from drand_tpu.ops import pairing as JP
from drand_tpu.ops import towers as JT
from drand_tpu_torch.ops import curve as TC
from drand_tpu_torch.ops import flat12 as TFL
from drand_tpu_torch.ops import pairing as TP
from drand_tpu_torch.ops import towers as TT
from drand_tpu_torch.ops.field import FP


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows(shape, seed):
    """Canonical Fp Montgomery limbs of `shape` + (32,): 0, 1, p-1, then
    random."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    vals = [0, 1, P - 1] + [int.from_bytes(rng.bytes(48), "little") % P
                            for _ in range(n - 3)]
    return np.ascontiguousarray(FP.encode(vals[:n]).reshape(shape + (32,)))


def _eq(jax_out, torch_out):
    np.testing.assert_array_equal(np.asarray(jax_out), torch_out.numpy())


def _fp2(st):
    return (st[0], st[1])


@pytest.mark.parametrize("k", [1, 5, 13])
def test_fp2_sqr_chain_mul_plain_vs_composite(k):
    """K7's plain version against drand_tpu's square run and product (its
    XLA twin of fp2_sqr_chain_mul); at k = 5 also K8's window step."""
    x, t = _rows((2, 6), 30), _rows((2, 6), 31)
    want = jax.jit(lambda x, t: JT.fp2_mul(JT._fp2_sqr_n(_fp2(x), k),
                                           _fp2(t)))(x, t)
    got = TT._fp2_sqr_chain_mul_plain(torch.as_tensor(x), k,
                                      torch.as_tensor(t))
    _eq(want[0], got[0])
    _eq(want[1], got[1])
    if k == 5:
        _eq(want[0], TT.fp2_sqr5_mul(torch.as_tensor(x),
                                     torch.as_tensor(t))[0])
    sq = jax.jit(lambda x: JT._fp2_sqr_n(_fp2(x), k))(x)
    got = TT.fp2_sqr_chain_mul(torch.as_tensor(x), k)
    _eq(sq[0], got[0])
    _eq(sq[1], got[1])


def test_fp2_pow_const_takes_the_addchain_and_matches():
    """The port's fp2_pow_const runs the SSWU exponent through the
    addition chain of K7 steps (drand_tpu's chip executor); drand_tpu's
    CPU path runs the window.  Same canonical powers."""
    from drand_tpu_torch.ops.field import addchain_plan
    e = TT._E_RATIO
    _, _, n_sqr, n_mul, _ = addchain_plan(e)
    assert n_sqr + n_mul < 6 * ((e.bit_length() + 4) // 5 - 1) + 32
    x = _rows((2, 3), 32)
    want = jax.jit(lambda x: JT.fp2_pow_const(_fp2(x), e))(x)
    got = TT.fp2_pow_const(_fp2(torch.as_tensor(x)), e)
    _eq(want[0], got[0])
    _eq(want[1], got[1])


def _points(seed):
    """(p1, p2) as [6, rows, 32] with random, doubling, cancelling,
    same-point (rescaled) and infinite rows (see the harness's cases)."""
    import test_torch_kernel_harness as H
    return H._g2_cases(seed)


def _jpt(st):
    st = jnp.asarray(st)
    return ((st[0], st[1]), (st[2], st[3]), (st[4], st[5]))


@pytest.mark.parametrize("with_double", [False, True])
def test_g2_point_formulas_plain_vs_composite(with_double):
    """K9's and K10's plain versions against drand_tpu's generic Fp2
    point_double and point_add, special cases included."""
    p1, p2 = _points(33)
    want = jax.jit(lambda a, b: JC.point_add(_jpt(a), _jpt(b), JC.Fp2Ops,
                                             with_double))(p1, p2)
    got = TC._point_add_formula(TC.g2_unpack(torch.as_tensor(p1)),
                                TC.g2_unpack(torch.as_tensor(p2)),
                                TC.Fp2PlainOps, with_double)
    for w, g in zip(want, got):
        _eq(w[0], g[0])
        _eq(w[1], g[1])
    if with_double:
        want = jax.jit(lambda a: JC.point_double(_jpt(a), JC.Fp2Ops))(p1)
        got = TC._point_double_formula(TC.g2_unpack(torch.as_tensor(p1)),
                                       TC.Fp2PlainOps)
        for w, g in zip(want, got):
            _eq(w[0], g[0])
            _eq(w[1], g[1])


@pytest.mark.parametrize("n", [2, 9])
def test_g2_point_dbl_chain_plain_vs_composite(n):
    """K9's chain plain version ([2^n]P in one call) against drand_tpu's
    generic Fp2 point_double applied n times, on random, doubling,
    cancelling and infinite rows."""
    dbl = jax.jit(lambda a: JC.point_double(a, JC.Fp2Ops))
    for p in _points(46):
        want = _jpt(p)
        for _ in range(n):
            want = dbl(want)
        got = TC.g2_unpack(TC._g2_point_dbl_plain(torch.as_tensor(p), n))
        for w, g in zip(want, got):
            _eq(w[0], g[0])
            _eq(w[1], g[1])


def _miller_state(rows=4):
    f = _rows((rows, 12), 34)
    Ts = _rows((rows, 2, 6), 35)
    Ts[0, :, 4] = FP.one_mont.numpy()
    Ts[0, :, 5] = 0
    P_ = _rows((rows, 2, 2), 36)
    Q = _rows((rows, 2, 4), 37)
    masks = np.array([[1, 1], [1, 0], [0, 1], [0, 0]] * (rows // 4),
                     np.int32)
    return f, Ts, P_, Q, masks


def _jax_iteration(f, Ts, P_, Q, masks, dbl):
    """drand_tpu's non-merged iteration on the same state: flat_sqr (for
    a doubling), each pair's step, the masked lines multiplied in."""
    f = jnp.asarray(f)
    newT = []
    for k in range(2):
        c = [jnp.asarray(Ts[:, k, i]) for i in range(6)]
        Tk = ((c[0], c[1]), (c[2], c[3]), (c[4], c[5]))
        xp, yp = jnp.asarray(P_[:, k, 0]), jnp.asarray(P_[:, k, 1])
        if dbl:
            Tn, line = JP._dbl_step(Tk, xp, yp)
        else:
            q = [jnp.asarray(Q[:, k, i]) for i in range(4)]
            Tn, line = JP._add_step(Tk, ((q[0], q[1]), (q[2], q[3])), xp, yp)
        m = jnp.asarray(masks[:, k] != 0)
        if not dbl:
            Tn = tuple(JT.fp2_select(m, a, b) for a, b in zip(Tn, Tk))
        line = JP.line_select(m, line, JP.line_one(m.shape))
        newT.append(Tn)
        if k == 0 and dbl:
            f = JF.flat_sqr(f)
        f = JP.fp12_mul_line(f, line)
    return f, newT


@pytest.mark.parametrize("dbl", [True, False])
def test_miller_iteration_plain_vs_composite(dbl):
    """K11's and K12's plain versions against drand_tpu's steps, flat
    square and line products, with every active/inactive pair mask."""
    f, Ts, P_, Q, masks = _miller_state()
    wf, wT = jax.jit(lambda *a: _jax_iteration(*a, dbl=dbl))(
        f, Ts, P_, Q, masks)
    args = tuple(map(torch.as_tensor, (f, Ts, P_, Q, masks)))
    if dbl:
        gf, gT = TP._miller_dbl_iter_plain(args[0], args[1], args[2], args[4])
    else:
        gf, gT = TP.miller_add_iter(args[0], args[1], args[3], args[2],
                                    args[4])
    _eq(wf, gf)
    for k in range(2):
        for i, c in enumerate(x for xy in wT[k] for x in xy):
            _eq(c, gT[:, k, i])


def test_flat_conj_and_frob_plain_vs_composite():
    """K15's and K16's plain versions on random and all-(p-1) rows."""
    a = _rows((3, 12), 38)
    a[0] = np.tile(FP.encode([P - 1]), (12, 1))
    ta = torch.as_tensor(a)
    _eq(jax.jit(JF.flat_conj)(a), TFL._flat_conj_plain(ta))
    for n in (1, 2, 3):
        _eq(jax.jit(lambda x: JF.flat_frob(x, n))(a),
            TFL._flat_frob_plain(ta, n))
