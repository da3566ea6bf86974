"""The port's two Miller executors and the plain versions of its last six
kernels (K17-K22) against drand_tpu, limb for limb.

The same inputs (numpy or the golden model, fixed seeds) go through the
port's plain versions on the CPU -- what each kernel is held against on
the card -- and through drand_tpu: its composite functions on the CPU,
its Pallas kernels (`PallasField.flat_sqr`, `line_merge`) under the eager
simulator of tests/pallas_sim.py, and its golden pairing.  Every output
is canonical, so the tolerance is exact equality.  Only single steps are
jitted; the Miller loops and pairing checks run the port's plain
versions.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drand_tpu.crypto.bls12381 import curve as JGC
from drand_tpu.crypto.bls12381 import fp as G
from drand_tpu.crypto.bls12381 import pairing as JGP
from drand_tpu.crypto.bls12381.constants import P
from drand_tpu.ops import field as JFd
from drand_tpu.ops import flat12 as JF
from drand_tpu.ops import pairing as JP
from drand_tpu.ops import pallas_field as PFm
from drand_tpu_torch.crypto.bls12381 import pairing as TGP
from drand_tpu_torch.ops import flat12 as TFL
from drand_tpu_torch.ops import pairing as TP
from drand_tpu_torch.ops.field import FP, FR


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


def _t(x):
    return torch.as_tensor(np.array(x))


def _eq(jax_out, torch_out):
    np.testing.assert_array_equal(np.asarray(jax_out), torch_out.numpy())


def _max_coeffs(n):
    """n coefficients whose every stored value is p - 1."""
    row = np.asarray([((P - 1) >> (12 * i)) & 0xFFF for i in range(32)],
                     np.int32)
    return np.tile(row, (n, 1))


def _rows(shape, seed):
    """Canonical Fp Montgomery limbs of `shape` + (32,), random."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    vals = [int.from_bytes(rng.bytes(48), "little") % P for _ in range(n)]
    return np.ascontiguousarray(FP.encode(vals).reshape(shape + (32,)))


def test_flat_sqr_plain_vs_composite_and_pallas_kernel(sim):
    """K17's plain version on a random row and the all-(p-1) row, against
    drand_tpu's flat_sqr on the CPU, its Pallas kernel and the golden
    square."""
    rng = random.Random(50)
    v = tuple(tuple((rng.randrange(P), rng.randrange(P)) for _ in range(3))
              for _ in range(2))
    a = np.stack([np.asarray(JF.flat_encode([v]))[0], _max_coeffs(12)])
    got = TFL._flat_sqr_plain(_t(a))
    want = sim.flat_sqr(jnp.asarray(a))
    _eq(want, got)
    _eq(want, TFL.flat_sqr(_t(a)))
    _eq(jax.jit(JF.flat_sqr)(a), got)
    assert TFL.flat_decode(got, 0) == G.fp12_mul(v, v)


def _line_tower(cs):
    full = [0] * 12
    for i, s in enumerate(TFL.LINE_IDX):
        full[s] = cs[i]
    return TFL.tower_from_flat_coeffs(full)


def test_line_merge_plain_vs_pallas_kernel_and_golden(sim):
    """K20's plain version against drand_tpu's line_merge kernel (random
    lines and the all-(p-1) line on both sides) and, on the random row,
    against the golden tower product of the two lines."""
    rng = random.Random(51)
    c1 = [rng.randrange(P) for _ in range(6)]
    c2 = [rng.randrange(P) for _ in range(6)]
    l1 = np.stack([FP.encode(c1), _max_coeffs(6)])
    l2 = np.stack([FP.encode(c2), _max_coeffs(6)])
    got = TFL._line_merge_plain(_t(l1), _t(l2))
    _eq(sim.line_merge(jnp.asarray(l1), jnp.asarray(l2)), got)
    _eq(np.asarray(got), TFL.line_merge(_t(l1), _t(l2)))
    assert TFL.flat_decode(got, 0) == G.fp12_mul(_line_tower(c1),
                                                 _line_tower(c2))


@pytest.mark.parametrize("step", ["dbl", "add"])
def test_stacked_steps_plain_vs_composite(step):
    """The plain doubling and mixed-addition steps (what K18 and K19 are
    held against) on K = 3 pairs stacked on the leading axis, against
    drand_tpu's _dbl_step and _add_step on the CPU."""
    x = _rows((3, 4, 12), 52 + (step == "add"))
    x[:, 0, 4] = FP.one_mont.numpy()             # Z = 1, as at the start
    x[:, 0, 5] = 0

    def args(arr, lib):
        c = [lib(arr[..., i, :]) for i in range(12)]
        Tj = ((c[0], c[1]), (c[2], c[3]), (c[4], c[5]))
        if step == "dbl":
            return Tj, c[10], c[11]
        return Tj, ((c[6], c[7]), (c[8], c[9])), c[10], c[11]

    jfn, tfn = {"dbl": (JP._dbl_step, TP._dbl_step),
                "add": (JP._add_step, TP._add_step)}[step]
    want = jax.jit(lambda a: jfn(*args(a, jnp.asarray)))(x)
    got = tfn(*args(x, torch.as_tensor))
    for w_part, g_part in zip(want, got):
        for w, g in zip(w_part, g_part):
            _eq(w[0], g[0])
            _eq(w[1], g[1])


def test_g2_dbl_line_plain_vs_pallas_kernel(sim):
    """K18's plain version against drand_tpu's g2_dbl_line kernel under the
    simulator on K = 3 pairs stacked on the leading axis (Z = 1 in the
    first row of each pair, as at the loop's start; Z = 0 in the second)."""
    x = _rows((3, 3, 8), 54)
    x[:, 0, 4] = FP.one_mont.numpy()
    x[:, 0, 5] = 0
    x[:, 1, 4:6] = 0

    def args(arr, lib):
        c = [lib(arr[..., i, :]) for i in range(8)]
        return ((c[0], c[1]), (c[2], c[3]), (c[4], c[5])), c[6], c[7]

    want = sim.g2_dbl_line(*args(x, jnp.asarray))
    got = TP._dbl_step_plain(*args(x, torch.as_tensor))
    for w_part, g_part in zip(want, got):
        for w, g in zip(w_part, g_part):
            _eq(w[0], g[0])
            _eq(w[1], g[1])


def _golden_pairs(n, seed):
    """n (P, Q) pairs of the golden model: Jacobian points a G1, b G2."""
    rng = random.Random(seed)
    return [(JGC.g1_mul(JGC.G1_GEN, rng.randrange(1, 1 << 64)),
             JGC.g2_mul_raw(JGC.G2_GEN, rng.randrange(1, 1 << 64)))
            for _ in range(n)]


def _device_pairs(rows):
    """rows[r][k] = golden pair k of row r -> the port's affine pairs, each
    coordinate [R, 32]."""
    out = []
    for k in range(len(rows[0])):
        ps = [JGC.g1_affine(r[k][0]) for r in rows]
        qs = [JGC.g2_affine(r[k][1]) for r in rows]

        def enc(vals):
            return torch.as_tensor(FP.encode(vals))
        out.append(((enc([p[0] for p in ps]), enc([p[1] for p in ps])),
                    ((enc([q[0][0] for q in qs]), enc([q[0][1] for q in qs])),
                     (enc([q[1][0] for q in qs]), enc([q[1][1] for q in qs])))))
    return out


@pytest.fixture(scope="module")
def trio_k2():
    """Two rows of two pairs (the verify shape), the second pair of row 1
    inactive; and the port's trio Miller loop on them."""
    (p1, q1), (p2, q2), (p3, q3) = _golden_pairs(3, 53)
    pairs = _device_pairs([[(p1, q1), (p2, q2)], [(p3, q3), (p1, q2)]])
    active = [torch.tensor([True, True]), torch.tensor([True, False])]
    return pairs, active, TP.miller_loop_pairs(pairs, active, merged=False)


@pytest.mark.parametrize("masked", [False, True])
def test_trio_loop_equals_merged_loop(trio_k2, masked):
    """The trio executor and the merged one (the two lines merged first)
    give the same f, bit for bit, with every pair active and with the
    second pair of row 1 inactive."""
    pairs, active, f_trio = trio_k2
    if not masked:
        active = [torch.tensor([True, True])] * 2
        f_trio = TP.miller_loop_pairs(pairs, active, merged=False)
    f_merged = TP.miller_loop_pairs(pairs, active, merged=True)
    assert torch.equal(f_trio, f_merged)


@pytest.mark.parametrize("K", [1, 3])
def test_pairing_check_trio_vs_golden(K):
    """pairing_check_pairs on the trio executor at K = 1 and K = 3, one
    row whose product is 1 and one whose product is not, with inactive
    pairs, against the golden pairing_check of each row's active pairs."""
    (p1, q1), (p2, q2) = _golden_pairs(2, 54 + K)
    if K == 1:      # row 0: the pair masked inactive (product 1)
        rows = [[(p1, q1)], [(p2, q2)]]
        masks = [[False], [True]]
    else:           # row 0: e(P, Q) e(-P, Q), the third pair inactive
        rows = [[(p1, q1), (JGC.g1_neg(p1), q1), (p2, q2)],
                [(p1, q1), (p2, q2), (p2, q1)]]
        masks = [[True, True, False], [True, True, True]]
    active = [torch.tensor([m[k] for m in masks]) for k in range(K)]
    got = TP.pairing_check_pairs(_device_pairs(rows), active, merged=False)
    want = [JGP.pairing_check([pq for pq, m in zip(r, ms) if m])
            for r, ms in zip(rows, masks)]
    assert want == [True, False]
    assert got.tolist() == want


def test_merged_executor_takes_two_pairs():
    pairs = _device_pairs([[pq] for pq in _golden_pairs(1, 57)])
    with pytest.raises(ValueError, match="2 pairs"):
        TP.miller_loop_pairs(pairs * 3, merged=True)


def test_golden_pairing_copy_matches_drand_tpu():
    """The port's copy of the golden pairing (chip_smoke.py's reference)
    computes drand_tpu's Miller loop, final exponentiation and check."""
    (p1, q1), (p2, q2) = _golden_pairs(2, 58)
    aff = [(JGC.g1_affine(p), JGC.g2_affine(q)) for p, q in
           ((p1, q1), (p2, q2))]
    f = TGP.multi_miller_loop(aff)
    assert f == JGP.multi_miller_loop(aff)
    assert TGP.final_exp(f) == JGP.final_exp(f)
    assert TGP.pairing_check([(p1, q1), (JGC.g1_neg(p1), q1)])
    assert not TGP.pairing_check([(p1, q1), (p2, q2)])


def test_final_exp_vs_golden():
    """The port's final exponentiation (each run of cyclotomic squares of
    its x ladder one flat_cyclo_sqr call, K14's chain on the card) on
    two random rows, bit for bit against drand_tpu's golden final_exp."""
    rng = random.Random(60)
    vals = [tuple(tuple((rng.randrange(P), rng.randrange(P))
                        for _ in range(3)) for _ in range(2))
            for _ in range(2)]
    got = TP.final_exp(TFL.flat_encode(vals))
    want = TFL.flat_encode([JGP.final_exp(v) for v in vals])
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", ["fp", "fr"])
def test_add_sub_plain_vs_drand_tpu(name):
    """K21's and K22's plain versions (Field.add, Field.sub) against
    drand_tpu's on 0, 1, m-1 and random values meeting each other."""
    F_, JF_ = {"fp": (FP, JFd.FP), "fr": (FR, JFd.FR)}[name]
    rng = np.random.default_rng(59)
    m = F_.modulus
    vals = [0, 1, m - 1] + [int.from_bytes(rng.bytes(48), "little") % m
                            for _ in range(9)]
    a = np.repeat(F_.encode(vals), len(vals), 0)
    b = np.tile(F_.encode(vals), (len(vals), 1))
    _eq(jax.jit(JF_.add)(a, b), F_.add(_t(a), _t(b)))
    _eq(jax.jit(JF_.sub)(a, b), F_.sub(_t(a), _t(b)))
