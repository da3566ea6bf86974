"""The port's Fp/Fr field layer against drand_tpu.ops.field, limb for limb.

Inputs are made with numpy from a fixed seed and go through both; the JAX
side runs its XLA path on the CPU (jitted, as one program per function),
the port its plain PyTorch versions (CPU tensors).  Outputs are canonical,
so the tolerance is exact equality of limbs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drand_tpu.crypto.bls12381.constants import P
from drand_tpu.ops import field as JF
from drand_tpu.ops import towers as JT
from drand_tpu_torch.ops import field as TF

FIELDS = {"fp": (JF.FP, TF.FP), "fr": (JF.FR, TF.FR)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _vals(m, n, seed):
    rng = np.random.default_rng(seed)
    return [0, 1, m - 1, m - 2] + [
        int.from_bytes(rng.bytes(48), "little") % m for _ in range(n)]


def _pair(name, seed=1, n=12):
    jf, tf = FIELDS[name]
    va = _vals(jf.modulus, n, seed)
    vb = _vals(jf.modulus, n, seed + 1)[::-1]
    a, b = jf.encode(va), jf.encode(vb)
    return jf, tf, a, b


def _eq(jax_out, torch_out):
    np.testing.assert_array_equal(np.asarray(jax_out), torch_out.numpy())


_OPS = {
    "mont_mul": (lambda F, x, y: F.mont_mul(x, y)),
    "sqr": (lambda F, x, y: F.sqr(x)),
    "add": (lambda F, x, y: F.add(x, y)),
    "sub": (lambda F, x, y: F.sub(x, y)),
    "neg": (lambda F, x, y: F.neg(x)),
    "mul_small3": (lambda F, x, y: F.mul_small(x, 3)),
    "mul_small8": (lambda F, x, y: F.mul_small(x, 8)),
    "to_mont": (lambda F, x, y: F.to_mont(x)),
    "from_mont": (lambda F, x, y: F.from_mont(x)),
}


@pytest.fixture(scope="module")
def jax_elementwise():
    """Every elementwise op of both JAX fields on the shared inputs, as
    one jitted program per field (one XLA compile instead of one per op)."""
    out = {}
    for name in FIELDS:
        jf, _, a, b = _pair(name)
        res = jax.jit(lambda x, y: {op: fn(jf, x, y) for op, fn in _OPS.items()})(
            jnp.asarray(a), jnp.asarray(b))
        out[name] = {op: np.asarray(v) for op, v in res.items()}
    return out


@pytest.mark.parametrize("name", ["fp", "fr"])
@pytest.mark.parametrize("op", sorted(_OPS))
def test_elementwise_ops_match(name, op, jax_elementwise):
    _, tf, a, b = _pair(name)
    got = _OPS[op](tf, torch.as_tensor(a), torch.as_tensor(b))
    np.testing.assert_array_equal(jax_elementwise[name][op], got.numpy())


@pytest.mark.parametrize("name", ["fp", "fr"])
def test_inv_and_pow_const(name):
    """inv (Fermat, the port's addition chain; inv(0) = 0) and a
    small-exponent window power against the JAX window executor."""
    jf, tf, a, _ = _pair(name, seed=3, n=4)
    ja, ta = jnp.asarray(a), torch.as_tensor(a)
    inv = tf.inv(ta)
    _eq(jax.jit(jf.inv)(ja), inv)
    assert inv[0].eq(0).all()
    e = 0xD201000000010001    # < 2^64: the 4-bit window (K4 at k = 4)
    _eq(jax.jit(lambda x: jf.pow_const(x, e))(ja), tf.pow_const(ta, e))
    _eq(jax.jit(lambda x: jf.pow_const(x, 11))(ja), tf.pow_const(ta, 11))


def test_pow_addchain_executor_matches():
    """The addition-chain executor, reachable directly on both sides, on
    an exponent with a long 1-run (repunit build steps) and odd windows."""
    e = (((1 << 110) - 1) << 24) | 0b101100111010110110000111
    ops, build, _, _, used_odd = JF.addchain_plan(e)
    assert TF.addchain_plan(e)[:2] == (ops, build)
    assert build and used_odd
    jf, tf, a, _ = _pair("fp", seed=5, n=3)
    got = tf._pow_addchain(torch.as_tensor(a), ops, build, used_odd)
    want = jax.jit(lambda x: jf._pow_addchain(x, ops, build, used_odd))(
        jnp.asarray(a))
    _eq(want, got)
    assert [tf.from_limbs_host(r) for r in got.numpy()] == \
        [pow(jf.from_limbs_host(r), e, P) for r in a]


@pytest.mark.parametrize("name", ["fp", "fr"])
def test_inv_and_sqrt_exponent_addchain_match_jax(name):
    """inv and pow_const at (m + 1) / 4 (both take the addition chain, one
    K4 launch each on a card) on the plain path, against drand_tpu's
    FP.inv / FR.inv and pow_const."""
    jf, tf, a, _ = _pair(name, seed=13, n=5)
    ja, ta = jnp.asarray(a), torch.as_tensor(a)
    e = (jf.modulus + 1) // 4
    assert e >= 1 << 64
    _eq(jax.jit(jf.inv)(ja), tf.inv(ta))
    _eq(jax.jit(lambda x: jf.pow_const(x, e))(ja), tf.pow_const(ta, e))


@pytest.mark.parametrize("e", [P - 2, (P + 1) // 4, JF.FR.modulus - 2,
                               (((1 << 110) - 1) << 24) | 0b1011001110101101])
def test_chain_program_computes_its_plan(e):
    """K4's program, run on exponents instead of field elements, computes
    e with the plan's squares and products (the counts `chain_work`
    gives), and its scratch slots are the odd table, a^2 and the built
    repunits."""
    ops, build, n_sqr, n_mul, used_odd = TF.addchain_plan(e)
    codes, n_slots, e_prog = TF.chain_program(ops, build, used_odd)
    x, slots, sqrs, muls = 1, {}, 0, 0
    for code in codes:
        op, slot, k = (code >> 6) & 3, code & 63, code >> 8
        if op == TF.K.CHAIN_LOAD:
            x = slots[slot]
        elif op == TF.K.CHAIN_STORE:
            slots[slot] = x
        else:
            x, sqrs = x << k, sqrs + k
            if slot != TF.K.CHAIN_NONE:
                x, muls = x + slots[slot], muls + 1
    assert x == e_prog == e
    assert TF.K.chain_work(codes) == (sqrs, muls)
    # the planner counts a full table of 15 products; the program builds
    # it up to the largest odd power the plan takes
    need = max(op[-1] for op in ops if op[0] == "sqrmul_odd")
    assert (sqrs, muls) == (n_sqr, n_mul - 15 + (need - 1) // 2)
    assert n_slots == len(slots) == (need + 1) // 2 + 1 + len(build)


def test_plan_beyond_the_kernel_raises():
    """A plan with more table entries than K4's scratch slots (w = 7: 64
    odd powers) raises on a non-CPU tensor rather than falling back to the
    plain steps, which compute it on the CPU; a plan the kernel takes goes
    to the kernel's wrapper, which refuses a tensor off the card."""
    e = P - 2
    plan = TF.addchain_plan(e, 7)
    ops, build, used_odd = plan[0], plan[1], plan[4]
    _, tf, a, _ = _pair("fp", seed=15, n=2)
    with pytest.raises(ValueError, match="scratch slots"):
        tf._pow_addchain(torch.empty(3, 32, dtype=torch.int32,
                                     device="meta"), ops, build, used_odd)
    got = tf._pow_addchain(torch.as_tensor(a), ops, build, used_odd)
    assert [tf.from_limbs_host(r) for r in got.numpy()] == \
        [pow(tf.from_limbs_host(r), e, P) for r in a]
    with pytest.raises(ValueError, match="CUDA tensor"):
        tf.inv(torch.empty(3, 32, dtype=torch.int32, device="meta"))


def test_mont_reduce_on_fp2_and_flat_wide_inputs():
    """Wide inputs built the way the composite Fp2 product (towers.py
    c0w/c1w with the K p^2 offset) and the flat Fp12 convolution build
    them, through JAX's mont_reduce and the port's."""
    jf, tf, a, b = _pair("fp", seed=7, n=8)
    n = a.shape[0]
    t = JF._carry_cheap(jnp.pad(JF._poly_mul_var(jnp.asarray(a), jnp.asarray(b)),
                                [(0, 0), (0, 1)]))
    t = np.asarray(t)
    tt = t[::-1].copy()
    c0w = t + (np.asarray(JT._WIDE_NEG_OFF) - tt)
    c1w = t + tt
    # a 12-term flat convolution of the maximal stored coefficients
    mx = np.tile(np.asarray([(P - 1 >> (12 * i)) & 0xFFF for i in range(32)],
                            np.int32), (12, 1))
    cols = JF._carry_cheap(jnp.pad(JF._poly_mul_var(jnp.asarray(mx)[:, None],
                                                    jnp.asarray(mx)[None]),
                                   [(0, 0), (0, 0), (0, 1)]))
    conv = np.asarray(JF._carry_cheap(jnp.asarray(np.asarray(cols).sum((0, 1)))))
    wide = np.concatenate([c0w, c1w, conv[None]]).astype(np.int32)
    assert wide.shape == (2 * n + 1, 64)
    _eq(jax.jit(jf.mont_reduce)(jnp.asarray(wide)),
        tf.mont_reduce(torch.as_tensor(wide)))


def test_reduce_wide_and_lex_ge():
    jf, tf, a, b = _pair("fp", seed=9, n=6)
    lo, hi = a.copy(), b.copy()
    lo[:, 31] = 4095                      # values >= p: not reduced limbs
    _eq(jax.jit(jf.reduce_wide)(jnp.asarray(lo), jnp.asarray(hi)),
        tf.reduce_wide(torch.as_tensor(lo), torch.as_tensor(hi)))
    probes = np.concatenate([a, jf.encode([P - 1])[:1], JF.int_to_limbs(P)[None],
                             JF.int_to_limbs(P + 1)[None]]).astype(np.int32)
    for const in (jf.MOD, JF.int_to_limbs((P - 1) // 2 + 1)):
        _eq(jax.jit(lambda x: jf._lex_ge(x, const))(jnp.asarray(probes)),
            tf._lex_ge(torch.as_tensor(probes), torch.as_tensor(const)))


def test_products_sums_diffs_stack():
    jf, tf, a, b = _pair("fp", seed=11, n=2)
    pairs_j = [(jnp.asarray(a), jnp.asarray(b)), (jnp.asarray(b), jnp.asarray(a[0]))]
    pairs_t = [(torch.as_tensor(a), torch.as_tensor(b)),
               (torch.as_tensor(b), torch.as_tensor(a[0]))]
    for meth in ("products", "sums", "diffs"):
        got = getattr(tf, meth)(pairs_t)
        want = getattr(jf, meth)(pairs_j)
        for w, g in zip(want, got):
            _eq(w, g)
