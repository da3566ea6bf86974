"""The plain versions of the port's Fp2 and flat-Fp12 kernels (K5, K6, K13,
K14, K15, K16) against drand_tpu, limb for limb.

The same inputs (numpy, fixed seed) go through the port's plain version
on the CPU -- what the kernel is held against on the card -- and through
drand_tpu: its composite XLA function on the CPU, and its Pallas kernel
(`PallasField`) run by the eager simulator of tests/pallas_sim.py, as
tests/test_sim_kats.py runs them.  Every output is canonical, so the
tolerance is exact equality.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drand_tpu.crypto.bls12381 import fp as G
from drand_tpu.crypto.bls12381.constants import P
from drand_tpu.ops import flat12 as JF
from drand_tpu.ops import pallas_field as PFm
from drand_tpu.ops import towers as JT
from drand_tpu_torch.ops import flat12 as TFL
from drand_tpu_torch.ops import towers as TT

LINE_IDX = (0, 2, 3, 6, 8, 9)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def sim():
    from pallas_sim import sim_kernels
    with sim_kernels():
        yield PFm.pallas_field(P)


def _fp2_vals(n, seed):
    rng = random.Random(seed)
    return [(0, 0), (1, 0), (P - 1, P - 1)][:n] + [
        (rng.randrange(P), rng.randrange(P)) for _ in range(max(0, n - 3))]


def _fp12_vals(n, seed):
    rng = random.Random(seed)
    return [tuple(tuple((rng.randrange(P), rng.randrange(P)) for _ in range(3))
                  for _ in range(2)) for _ in range(n)]


def _max_flat():
    """Every STORED coefficient p - 1 (tests/test_sim_kats.py _max_flat):
    the largest convolution values."""
    row = np.asarray([(P - 1 >> (12 * i)) & 0xFFF for i in range(32)],
                     np.int32)
    return np.tile(row, (12, 1))


def _unitary(seed):
    f = _fp12_vals(1, seed)[0]
    f = G.fp12_mul(G.fp12_conj(f), G.fp12_inv(f))
    return G.fp12_mul(G.fp12_frob_n(f, 2), f)


def _t(x):
    return torch.as_tensor(np.array(x))


def _eq(jax_out, torch_out):
    np.testing.assert_array_equal(np.asarray(jax_out), torch_out.numpy())


def _fp2_pairs(n, rows=3):
    """n pairs of Fp2 rows (numpy coordinates) with 0, 1, p-1 among them."""
    xs = [JT.fp2_encode(_fp2_vals(rows, 10 + p)) for p in range(n)]
    ys = [JT.fp2_encode(_fp2_vals(rows, 40 + p)[::-1]) for p in range(n)]
    return ([tuple(np.asarray(c) for c in x) for x in xs],
            [tuple(np.asarray(c) for c in y) for y in ys])


@pytest.mark.parametrize("n", [1, 4, 9])
def test_fp2_products_plain_vs_composite(n):
    xs, ys = _fp2_pairs(n)
    want = jax.jit(lambda x, y: JT.fp2_products(list(zip(x, y))))(xs, ys)
    got = TT._fp2_products_plain(
        [(tuple(map(_t, x)), tuple(map(_t, y))) for x, y in zip(xs, ys)])
    for w, g in zip(want, got):
        _eq(w[0], g[0])
        _eq(w[1], g[1])


def test_fp2_products_plain_vs_pallas_kernel(sim):
    """One simulated kernel call on 9 pairs (the kernel treats each pair
    on its own); the port's plain version on the first 1, 4 and 9."""
    xs, ys = _fp2_pairs(9)
    want = sim.fp2_products([(tuple(map(jnp.asarray, x)),
                              tuple(map(jnp.asarray, y)))
                             for x, y in zip(xs, ys)])
    for n in (1, 4, 9):
        got = TT._fp2_products_plain(
            [(tuple(map(_t, x)), tuple(map(_t, y)))
             for x, y in zip(xs[:n], ys[:n])])
        for w, g in zip(want, got):
            _eq(w[0], g[0])
            _eq(w[1], g[1])
    assert TT.fp2_decode(got[-1], 2) == G.fp2_mul(
        TT.fp2_decode(tuple(map(_t, xs[-1])), 2),
        TT.fp2_decode(tuple(map(_t, ys[-1])), 2))


def _raw_fp(v):
    """The stored limbs of v itself (not its Montgomery form)."""
    return np.asarray([(v >> (12 * i)) & 0xFFF for i in range(32)], np.int32)


def test_fp2_sqrs_plain_vs_pallas_kernel(sim):
    """One simulated kernel call on 9 items whose rows hold 0, 1, p-1
    (Montgomery forms) and raw p-1 in both coordinates, x1 = 0 and
    x0 = x1; the port's plain version on the first 1, 4, 8 and 9 (n = 1,
    4 and 8 are the path's calls)."""
    xs = [tuple(np.array(c) for c in x) for x in _fp2_pairs(9, rows=6)[0]]
    top = _raw_fp(P - 1)
    for x0, x1 in xs:
        x0[3], x1[3] = top, top          # raw p - 1 in both
        x1[4] = 0                        # x1 = 0
        x1[5] = x0[5]                    # x0 = x1
    want = sim.fp2_sqrs([tuple(map(jnp.asarray, x)) for x in xs])
    for n in (1, 4, 8, 9):
        got = TT._fp2_sqrs_plain([tuple(map(_t, x)) for x in xs[:n]])
        for w, g in zip(want, got):
            _eq(w[0], g[0])
            _eq(w[1], g[1])
    # the public entry points take the plain versions on a CPU tensor
    x0 = tuple(map(_t, xs[0]))
    sq = TT.fp2_sqr(x0)
    _eq(want[0][0], sq[0])
    _eq(want[0][1], sq[1])
    assert TT.fp2_decode(sq, 1) == G.fp2_sqr(TT.fp2_decode(x0, 1))


@pytest.mark.parametrize("b_idx", [tuple(range(12)), LINE_IDX])
def test_flat_mul_plain_vs_pallas_kernel(sim, b_idx):
    """Random rows and the all-(p-1) stored-coefficient operand on both
    sides, dense and on the Miller loop's sparse line layout."""
    a = np.asarray(JF.flat_encode(_fp12_vals(2, 4)))
    b = np.asarray(JF.flat_encode(_fp12_vals(2, 5)))[:, list(b_idx)]
    mx = _max_flat()
    a = np.concatenate([a, mx[None]])
    b = np.concatenate([b, mx[None, :len(b_idx)]])
    want = sim.flat_mul(jnp.asarray(a), jnp.asarray(b), b_idx)
    got = TFL._flat_mul_plain(_t(a), _t(b), b_idx)
    _eq(want, got)
    _eq(want, TFL.flat_mul(_t(a), _t(b), b_idx))


def test_flat_cyclo_sqr_plain_vs_pallas_kernel(sim):
    vals = [_unitary(6), _unitary(7)]
    a = np.asarray(JF.flat_encode(vals))
    want = sim.cyclo_sqr(jnp.asarray(a))
    got = TFL._flat_cyclo_sqr_plain(_t(a))
    _eq(want, got)
    _eq(want, TFL.flat_cyclo_sqr(_t(a)))
    for i, v in enumerate(vals):
        assert TFL.flat_decode(got, i) == G.fp12_mul(v, v)


def test_flat_conj_plain_vs_pallas_kernel(sim):
    """drand_tpu's packed conjugation (PallasField.flat_conj under the
    simulator, reached through flat12.flat_tile with use_pallas patched,
    as tests/test_sim_kats.py drives it) on random rows, a row with zero
    coefficients in odd and even slots, the flat one and the all-(p-1)
    row, against the port's plain version."""
    from unittest import mock
    a = np.array(JF.flat_encode(_fp12_vals(3, 8)))
    a[1, 3] = 0
    a[1, 4] = 0
    one = np.asarray(JF.flat_encode([G.FP12_ONE]))
    a = np.concatenate([a, one, _max_flat()[None]])
    with mock.patch.object(PFm, "use_pallas", return_value=True):
        ft = JF.flat_tile(jnp.asarray(a))
        assert isinstance(ft, PFm.TileForm)
        want = np.asarray(JF.flat_untile(JF.flat_conj(ft))).reshape(a.shape)
    got = TFL._flat_conj_plain(_t(a))
    _eq(want, got)
    _eq(want, TFL.flat_conj(_t(a)))
    assert (got.numpy()[1, 3] == 0).all()
    for i in (0, 2):                      # the rows left as encoded
        assert TFL.flat_decode(got, i) == G.fp12_conj(_fp12_vals(3, 8)[i])


@pytest.mark.parametrize("n", [1, 2, 3])
def test_flat_frob_plain_vs_pallas_kernel(sim, n):
    """drand_tpu's packed Frobenius (PallasField.flat_frob under the
    simulator, reached through flat12.flat_tile with use_pallas patched,
    as tests/test_sim_kats.py drives it) on random rows, a zero row and
    the all-(p-1) row, against the port's plain version (K16's)."""
    from unittest import mock
    a = np.concatenate([np.array(JF.flat_encode(_fp12_vals(2, 20 + n))),
                        np.zeros((1, 12, 32), np.int32), _max_flat()[None]])
    with mock.patch.object(PFm, "use_pallas", return_value=True):
        ft = JF.flat_tile(jnp.asarray(a))
        assert isinstance(ft, PFm.TileForm)
        want = np.asarray(JF.flat_untile(JF.flat_frob(ft, n))).reshape(a.shape)
    got = TFL._flat_frob_plain(_t(a), n)
    _eq(want, got)
    _eq(want, TFL.flat_frob(_t(a), n))
    assert (got.numpy()[2] == 0).all()
    for i, v in enumerate(_fp12_vals(2, 20 + n)):
        assert TFL.flat_decode(got, i) == G.fp12_frob_n(v, n)
