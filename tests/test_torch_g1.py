"""The port's short-signature path (bls-unchained-g1-rfc9380: signatures on
G1, the key on G2) on the CPU, held against drand_tpu bit for bit: the
Fp sqrt_ratio and G1 decompression against drand_tpu's jitted functions,
hash_to_g1 against its golden model, its C++ tier (`native`) and the RFC
9380 J.9.1 vector, the G1 subgroup check against the golden model, and one
`Verifier` batch of the committed fixture with negative controls against
the golden `bls_verify_g1` and `native.verify_g1`.

drand_tpu's jitted hash_to_g1 and verify_g1_sigs take minutes to compile
on XLA:CPU, so the port meets them only in the one `slow` test at the end.
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drand_tpu import fixtures as JFX
from drand_tpu import native
from drand_tpu import verify as JV
from drand_tpu.crypto import sign as S
from drand_tpu.crypto.bls12381 import curve as GC
from drand_tpu.crypto.bls12381 import fp as GF
from drand_tpu.crypto.bls12381 import h2c as GH
from drand_tpu.crypto.bls12381.constants import DST_G1, P
from drand_tpu.ops import bls as JBLS
from drand_tpu.ops import h2c as JH
from drand_tpu.ops import towers as JT
from drand_tpu_torch import convert
from drand_tpu_torch import fixtures as FX
from drand_tpu_torch import verify as V
from drand_tpu_torch.ops import bls as BLS
from drand_tpu_torch.ops import curve as DC
from drand_tpu_torch.ops import h2c as DH
from drand_tpu_torch.ops import towers as T
from drand_tpu_torch.ops.field import FP

FIXTURE_ROWS = 16
NEGATIVE = ("flipped_bit", "x_ge_p", "infinity_flag", "off_subgroup",
            "wrong_round")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _digest(rnd: int) -> bytes:
    return hashlib.sha256(rnd.to_bytes(8, "big")).digest()


def _off_subgroup_points(n: int):
    """On-curve G1 points outside the r-subgroup (as the reference's
    tests/test_ops_curve.py builds them)."""
    out, i = [], 0
    while len(out) < n:
        i += 1
        x = (i * 48271 + 11) % P
        y = GF.fp_sqrt((pow(x, 3, P) + 4) % P)
        if y is not None and not GC.g1_in_subgroup((x, y, 1)):
            out.append((x, y, 1))
    return out


def _not_on_curve_x() -> int:
    x = 3
    while GF.fp_sqrt((pow(x, 3, P) + 4) % P) is not None:
        x += 1
    return x


def _negative_sigs(sig0: bytes) -> dict:
    flipped = bytearray(sig0)
    flipped[20] ^= 0x04
    x_ge_p = bytearray(P.to_bytes(48, "big"))
    x_ge_p[0] |= 0x80
    inf = bytearray(48)
    inf[0] = 0xC0
    return {"flipped_bit": bytes(flipped), "x_ge_p": bytes(x_ge_p),
            "infinity_flag": bytes(inf),
            "off_subgroup": GC.g1_to_bytes(_off_subgroup_points(1)[0]),
            "wrong_round": sig0}


def _u8(rows) -> np.ndarray:
    return np.stack([np.frombuffer(r, np.uint8) for r in rows])


# ---------------------------------------------------------------------------
# sqrt_ratio over Fp (one K4 chain at (p - 3)/4 on the card)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sqrt_ratio_cases():
    """u/v square, u/v not square, u = 0: port and drand_tpu's jitted
    make_fp_sqrt_ratio(11) on the same limbs."""
    rng = np.random.default_rng(91)

    def rand():
        return int.from_bytes(rng.bytes(48), "big") % P or 1

    vs = [rand() for _ in range(24)]
    a = [rand() for _ in range(24)]
    us = {"square": [GF.fp_mul(v, GF.fp_sqr(x)) for v, x in zip(vs[:8], a)],
          "non_square": [GF.fp_mul(GF.fp_mul(v, 11), GF.fp_sqr(x))
                         for v, x in zip(vs[8:16], a[8:])],
          "zero": [0] * 8}
    u = FP.encode(us["square"] + us["non_square"] + us["zero"])
    v = FP.encode(vs)
    y, sq = T.make_fp_sqrt_ratio(11)(torch.from_numpy(u), torch.from_numpy(v))
    jy, jsq = jax.jit(JT.make_fp_sqrt_ratio(11))(jnp.asarray(u), jnp.asarray(v))
    return {"y": y.numpy(), "sq": sq.numpy(),
            "jy": np.asarray(jy), "jsq": np.asarray(jsq), "u": us, "v": vs}


@pytest.mark.parametrize("at,kind", enumerate(["square", "non_square", "zero"]))
def test_fp_sqrt_ratio_matches_drand_tpu(sqrt_ratio_cases, at, kind):
    c = sqrt_ratio_cases
    rows = slice(8 * at, 8 * at + 8)
    np.testing.assert_array_equal(c["y"][rows], c["jy"][rows])
    np.testing.assert_array_equal(c["sq"][rows], c["jsq"][rows])
    assert c["sq"][rows].tolist() == [kind != "non_square"] * 8
    for y, u, v in zip(c["y"][rows], c["u"][kind], c["v"][rows]):
        y2v = GF.fp_mul(GF.fp_sqr(FP.from_limbs_host(y)), v)
        assert y2v == (u if kind != "non_square" else GF.fp_mul(11, u))


# ---------------------------------------------------------------------------
# G1 decompression
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def decompressed():
    sigs = np.load(FX.G1_FIXTURE)[:FIXTURE_ROWS]
    neg = _negative_sigs(bytes(sigs[0]))
    off_curve = bytearray(_not_on_curve_x().to_bytes(48, "big"))
    off_curve[0] |= 0x80
    no_comp = bytearray(sigs[1])
    no_comp[0] &= 0x7F
    rows = np.concatenate([sigs, _u8([neg[k] for k in NEGATIVE[:4]]
                                     + [bytes(off_curve), bytes(no_comp)])])
    (x, y), inf, valid = BLS.g1_decompress(torch.from_numpy(rows))
    (jx, jy), jinf, jvalid = jax.jit(JBLS.g1_decompress)(jnp.asarray(rows))
    return {"port": [t.numpy() for t in (x, y, inf, valid)],
            "jax": [np.asarray(t) for t in (jx, jy, jinf, jvalid)]}


@pytest.mark.parametrize("at,what", enumerate(["x", "y", "inf", "valid"]))
def test_g1_decompress_matches_drand_tpu(decompressed, at, what):
    np.testing.assert_array_equal(decompressed["port"][at],
                                  decompressed["jax"][at])


def test_g1_decompress_flags(decompressed):
    """Fixture rows valid and finite; x >= p, off the curve and without
    the compression flag invalid; the infinity flag valid at infinity;
    the off-subgroup point valid here (its subgroup check is apart)."""
    _, _, inf, valid = decompressed["port"]
    n = FIXTURE_ROWS
    assert valid[:n].all() and not inf[:n].any()
    assert valid[n:].tolist() == [True, False, True, True, False, False]
    assert inf[n:].tolist() == [False, False, True, False, False, False]


# ---------------------------------------------------------------------------
# hash_to_g1
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def hashed():
    msgs = [_digest(r) for r in range(1, 17)]
    pt = DH.hash_to_g1(torch.from_numpy(_u8(msgs)), DST_G1)
    (ax, ay), inf = DC.point_to_affine(pt, DC.FpOps)
    assert not inf.any()
    return {"msgs": msgs, "pt": pt,
            "aff": [(FP.from_limbs_host(x), FP.from_limbs_host(y))
                    for x, y in zip(ax.numpy(), ay.numpy())]}


def test_hash_to_g1_matches_golden(hashed):
    for (x, y), msg in zip(hashed["aff"], hashed["msgs"]):
        assert GC.g1_affine(GH.hash_to_g1(msg, DST_G1)) == (x, y)


@pytest.mark.skipif(not native.available(), reason="native tier not built")
def test_hash_to_g1_matches_native(hashed):
    for (x, y), msg in zip(hashed["aff"], hashed["msgs"]):
        assert native.hash_to_g1(msg, DST_G1) == GC.g1_to_bytes((x, y, 1))


def test_hash_to_g1_rfc_vector():
    """RFC 9380 J.9.1 (msg = "", the QUUX test DST), as pinned in
    tests/test_h2c_sswu.py."""
    dst = b"QUUX-V01-CS02-with-BLS12381G1_XMD:SHA-256_SSWU_RO_"
    pt = DH.hash_to_g1(torch.zeros((1, 0), dtype=torch.uint8), dst)
    x, y = GC.g1_affine(DC.g1_decode(pt, 0))
    assert x == 0x052926add2207b76ca4fa57a8734416c8dc95e24501772c814278700eed6d1e4e8cf62d9c09db0fac349612b759e79a1
    assert y == 0x08ba738453bfed09cb546dbb0783dbb3a5f1f566ed67bb6be0e8c67e2e81a4cc68ee29813bb7994998f3eae0c9c6a265


# ---------------------------------------------------------------------------
# G1 subgroup check (phi(P) == [-x^2]P)
# ---------------------------------------------------------------------------

def test_g1_in_subgroup_matches_golden():
    rng = np.random.default_rng(92)
    good = [GC.g1_mul(GC.G1_GEN, int(k)) for k in rng.integers(1, 2**62, 3)]
    # a subgroup point in another Jacobian scaling (Z = 5)
    x, y = GC.g1_affine(good[0])
    good.append((GF.fp_mul(x, 25), GF.fp_mul(y, 125), 5))
    pts = good + _off_subgroup_points(3) + [GC.G1_INF]
    got = DC.g1_in_subgroup(DC.g1_encode(pts))
    want = [GC.g1_in_subgroup(p) for p in pts]
    assert want == [True] * 4 + [False] * 3 + [True]
    assert got.tolist() == want


def test_g1_phi_acts_as_minus_x_squared():
    """beta is the cube root of unity whose phi is [-x^2] on G1."""
    from drand_tpu_torch.crypto.bls12381.constants import X
    pt = GC.g1_mul(GC.G1_GEN, 0xC0FFEE)
    got = DC.g1_decode(DC.g1_phi(DC.g1_encode([pt])), 0)
    assert GC.point_eq(got, GC.g1_mul(pt, (-X * X) % GC.R), GC.FP_OPS)


# ---------------------------------------------------------------------------
# The Verifier on the scheme: fixture rows and negative controls
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def keys():
    sk, pk = JFX.fixture_keypair_g2()
    psk, ppk = FX.fixture_keypair_g2()
    assert psk == sk and GC.g2_to_bytes(ppk) == GC.g2_to_bytes(pk)
    return sk, pk


@pytest.fixture(scope="module")
def verdicts(keys):
    """One port verify batch: the first 16 fixture rounds, then the
    negative controls over rounds 1..5 (the last, round 1's signature
    presented as round 2's).  The verifier is built from drand_tpu's
    verifier state carried over by convert.from_drand_tpu."""
    _, pk = keys
    state = convert.from_drand_tpu(
        JV.Verifier(pk, JV.SHAPE_UNCHAINED_G1)._pk)
    ver = V.Verifier.from_pk_limbs(state, V.SHAPE_UNCHAINED_G1, device="cpu")
    golden_built = V.Verifier(pk, V.SHAPE_UNCHAINED_G1, device="cpu")
    for a, b in zip(ver.pk_limbs, golden_built.pk_limbs):
        assert all(torch.equal(u, v) for u, v in zip(a, b))
    sigs = np.load(FX.G1_FIXTURE)[:FIXTURE_ROWS]
    neg = _negative_sigs(bytes(sigs[0]))
    rows = [bytes(s) for s in sigs] + [neg[k] for k in NEGATIVE]
    rounds = list(range(1, FIXTURE_ROWS + 1)) + [1, 2, 3, 4, 2]
    ok = ver.verify_batch(np.asarray(rounds), _u8(rows))
    return {"ok": ok, "rows": rows, "rounds": rounds}


def test_g1_fixture_rows_all_true(verdicts):
    assert verdicts["ok"].shape == (FIXTURE_ROWS + len(NEGATIVE),)
    assert verdicts["ok"][:FIXTURE_ROWS].all()


@pytest.mark.parametrize("idx,name", enumerate(NEGATIVE))
def test_g1_negative_control_false(verdicts, keys, idx, name):
    row = FIXTURE_ROWS + idx
    assert not verdicts["ok"][row], name
    _, pk = keys
    msg = _digest(verdicts["rounds"][row])
    assert not S.bls_verify_g1(pk, msg, verdicts["rows"][row])
    if native.available():
        assert not native.verify_g1(GC.g2_to_bytes(pk), msg,
                                    verdicts["rows"][row], DST_G1)


def test_g1_every_verdict_matches_native_and_golden(verdicts, keys):
    _, pk = keys
    pkb = GC.g2_to_bytes(pk)
    for ok, rnd, row in zip(verdicts["ok"], verdicts["rounds"],
                            verdicts["rows"]):
        msg = _digest(rnd)
        assert bool(ok) == S.bls_verify_g1(pk, msg, row)
        if native.available():
            assert bool(ok) == native.verify_g1(pkb, msg, row, DST_G1)


def test_g1_verifier_rejects_wrong_signature_length(keys):
    _, pk = keys
    ver = V.Verifier(pk, V.SHAPE_UNCHAINED_G1, device="cpu")
    with pytest.raises(ValueError, match="signatures"):
        ver.verify_batch_async(np.arange(1, 3), np.zeros((2, 96), np.uint8))


# ---------------------------------------------------------------------------
# drand_tpu's jitted hash_to_g1 and verify_g1_sigs (minutes of XLA:CPU)
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_g1_path_matches_drand_tpu_jitted(keys):
    """8 rows: hash_to_g1 limb for limb (Jacobian) and verify_g1_sigs'
    verdicts, the first and sixth signatures broken."""
    _, pk = keys
    sigs = np.load(FX.G1_FIXTURE)[:8].copy()
    sigs[0, 10] ^= 1
    sigs[5] = _u8([_negative_sigs(bytes(sigs[1]))["off_subgroup"]])[0]
    digests = _u8([_digest(r) for r in range(1, 9)])
    got = DH.hash_to_g1(torch.from_numpy(digests), DST_G1)
    want = jax.jit(JH.hash_to_g1, static_argnums=1)(jnp.asarray(digests),
                                                    DST_G1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    jv = JV.Verifier(pk, JV.SHAPE_UNCHAINED_G1)
    jok = jax.jit(JBLS.verify_g1_sigs, static_argnums=3)(
        jnp.asarray(digests), jnp.asarray(sigs), jv._pk, DST_G1)
    ok = BLS.verify_g1_sigs(torch.from_numpy(digests), torch.from_numpy(sigs),
                            BLS.g2_affine_limbs(pk), DST_G1)
    assert ok.tolist() == np.asarray(jok).tolist()
    assert ok.tolist() == [False] + [True] * 4 + [False] + [True] * 2
