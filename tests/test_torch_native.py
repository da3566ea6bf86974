"""The port's native C++ tier (`drand_tpu_torch/native`) against
drand_tpu's (`drand_tpu/native`) and the golden model, on the same
inputs: verdicts and bytes equal, the RFC 9380 vectors, the tower
arithmetic hook, the build's cache and its failure.  The tolerance is
exact equality."""

import hashlib
import random
import subprocess
import sys
from pathlib import Path

import pytest

from drand_tpu import native as JN
from drand_tpu.crypto import sign as S
from drand_tpu.crypto import tbls as JT
from drand_tpu.crypto.bls12381 import curve as JGC
from drand_tpu.crypto.bls12381 import fp as JF
from drand_tpu.crypto.bls12381 import h2c as JH
from drand_tpu.crypto.poly import PriPoly as JPriPoly
from drand_tpu_torch import dispatch as D
from drand_tpu_torch import native as N
from drand_tpu_torch.crypto.bls12381.constants import DST_G1, DST_G2, P

ROOT = Path(__file__).resolve().parents[1]
RFC_G1_DST = b"QUUX-V01-CS02-with-BLS12381G1_XMD:SHA-256_SSWU_RO_"
RFC_G2_DST = b"QUUX-V01-CS02-with-BLS12381G2_XMD:SHA-256_SSWU_RO_"

pytestmark = pytest.mark.skipif(
    not JN.available(), reason="drand_tpu's native tier did not build")


def _be48(x: int) -> bytes:
    return x.to_bytes(48, "big")


def _enc_fp2(a) -> bytes:
    return _be48(a[0]) + _be48(a[1])


def _enc_fp6(a) -> bytes:
    return b"".join(_enc_fp2(c) for c in a)


def _enc_fp12(f) -> bytes:
    return _enc_fp6(f[0]) + _enc_fp6(f[1])


def _rfp2(rng):
    return (rng.randrange(P), rng.randrange(P))


def _rfp6(rng):
    return (_rfp2(rng), _rfp2(rng), _rfp2(rng))


def _rfp12(rng):
    return (_rfp6(rng), _rfp6(rng))


def flip(b: bytes, at: int) -> bytes:
    return b[:at] + bytes([b[at] ^ 1]) + b[at + 1:]


@pytest.fixture(scope="module")
def g2_case():
    sk, pk = S.keygen(b"torch-native-g2")
    msg = hashlib.sha256(b"round").digest()
    return JGC.g1_to_bytes(pk), msg, S.bls_sign(sk, msg)


@pytest.fixture(scope="module")
def g1_case():
    sk, pk = S.keygen_g2(b"torch-native-g1")
    msg = hashlib.sha256(b"round-g1").digest()
    return JGC.g2_to_bytes(pk), msg, S.bls_sign_g1(sk, msg)


def _cases(pk, msg, sig, sig_len):
    """(name, pk, msg, sig) inputs: valid, flipped, wrong length, off the
    curve, the infinity flag, x >= p, a truncated key."""
    x_ge_p = bytes([0xA0]) + b"\xff" * (sig_len - 1)
    return [("valid", pk, msg, sig), ("flipped_sig", pk, msg, flip(sig, 17)),
            ("other_msg", pk, msg[::-1], sig),
            ("short_sig", pk, msg, sig[:-1]),
            ("long_sig", pk, msg, sig + b"\0"),
            ("zero_sig", pk, msg, bytes(sig_len)),
            ("ff_sig", pk, msg, b"\xff" * sig_len),
            ("infinity_sig", pk, msg, bytes([0xC0]) + bytes(sig_len - 1)),
            ("x_ge_p_sig", pk, msg, x_ge_p),
            ("short_pk", pk[:-1], msg, sig),
            ("infinity_pk", bytes([0xC0]) + bytes(len(pk) - 1), msg, sig),
            ("empty_msg", pk, b"", sig)]


def test_verify_g2_matches_reference(g2_case):
    got = {name: N.verify_g2(pk, m, s, DST_G2)
           for name, pk, m, s in _cases(*g2_case, 96)}
    want = {name: JN.verify_g2(pk, m, s, DST_G2)
            for name, pk, m, s in _cases(*g2_case, 96)}
    assert got == want
    assert [k for k, v in got.items() if v] == ["valid"]


def test_verify_g1_matches_reference(g1_case):
    got = {name: N.verify_g1(pk, m, s, DST_G1)
           for name, pk, m, s in _cases(*g1_case, 48)}
    want = {name: JN.verify_g1(pk, m, s, DST_G1)
            for name, pk, m, s in _cases(*g1_case, 48)}
    assert got == want
    assert [k for k, v in got.items() if v] == ["valid"]


def test_verify_partial_matches_reference_and_golden():
    poly = JPriPoly.random(3, secret=31415)
    shares = poly.shares(5)
    pub = poly.commit()
    commits48 = [JGC.g1_to_bytes(c) for c in pub.commits]
    msg = hashlib.sha256(b"partial-round").digest()
    parts = [JT.sign_partial(s, msg) for s in shares]
    p0 = parts[0]
    inputs = parts + [
        (3).to_bytes(2, "big") + JT.sig_of(p0),     # another signer's index
        flip(p0, 30), p0[:-1], p0 + b"\0",
        p0[:2] + bytes([0xC0]) + bytes(95)]
    for p in inputs:
        ours = N.verify_partial(commits48, msg, p, DST_G2)
        assert ours == JN.verify_partial(commits48, msg, p, DST_G2) == \
            JT.verify_partial(pub, msg, p)
    assert [N.verify_partial(commits48, msg, p, DST_G2)
            for p in inputs] == [True] * 5 + [False] * 5
    bad_commits = [[bytes([0xC0]) + bytes(47)] * 3,
                   [c[:-1] for c in commits48], []]
    for c in bad_commits:
        assert N.verify_partial(c, msg, p0, DST_G2) is False
        assert JN.verify_partial(c, msg, p0, DST_G2) is False


def test_g2_lincomb_matches_reference_and_golden():
    t, n = 3, 5
    poly = JPriPoly.random(t, secret=777)
    pub = poly.commit()
    msg = hashlib.sha256(b"lincomb").digest()
    parts = [JT.sign_partial(s, msg) for s in poly.shares(n)]
    sigs = [JT.sig_of(p) for p in parts[:t]]
    rng = random.Random(5)
    scalars = [rng.randrange(2**256).to_bytes(32, "big") for _ in range(t)]
    assert N.g2_lincomb(sigs, scalars) == JN.g2_lincomb(sigs, scalars)
    from drand_tpu.crypto.poly import _lagrange_basis_at_zero
    basis = _lagrange_basis_at_zero([0, 1, 2])
    got = N.g2_lincomb(sigs, [basis[i].to_bytes(32, "big") for i in range(3)])
    assert got == JT.recover(pub, msg, parts[:t], t, n, verified=True)
    one = (1).to_bytes(32, "big")
    for args in (([bytes([0xC0]) + bytes(95)], [one]),
                 ([bytes([0xA0]) + b"\xff" * 95], [one]),
                 ([sigs[0][:-1]], [one]), ([sigs[0]], [one[:-1]]),
                 ([sigs[0]], [bytes(32)]), ([], [])):
        assert N.g2_lincomb(*args) is None
        assert JN.g2_lincomb(*args) is None


@pytest.mark.parametrize("msg", [b"", b"a", b"abc", bytes(range(64)),
                                 b"x" * 257])
def test_hash_to_curve_matches_reference_and_golden(msg):
    assert N.hash_to_g2(msg, DST_G2) == JN.hash_to_g2(msg, DST_G2) == \
        JGC.g2_to_bytes(JH.hash_to_g2(msg))
    assert N.hash_to_g1(msg, DST_G1) == JN.hash_to_g1(msg, DST_G1) == \
        JGC.g1_to_bytes(JH.hash_to_g1(msg))


def test_hash_to_curve_rfc_vectors():
    """RFC 9380 J.9.1 and J.10.1, msg = ''."""
    x, y = JGC.g1_affine(JGC.g1_from_bytes(N.hash_to_g1(b"", RFC_G1_DST)))
    assert x == 0x052926add2207b76ca4fa57a8734416c8dc95e24501772c814278700eed6d1e4e8cf62d9c09db0fac349612b759e79a1
    assert y == 0x08ba738453bfed09cb546dbb0783dbb3a5f1f566ed67bb6be0e8c67e2e81a4cc68ee29813bb7994998f3eae0c9c6a265
    (x0, x1), (y0, y1) = JGC.g2_affine(
        JGC.g2_from_bytes(N.hash_to_g2(b"", RFC_G2_DST)))
    assert x0 == 0x0141ebfbdca40eb85b87142e130ab689c673cf60f1a3e98d69335266f30d9b8d4ac44c1038e9dcdd5393faf5c41fb78a
    assert x1 == 0x05cb8437535e20ecffaef7752baddf98034139c38452458baeefab379ba13dff5bf5dd71b72418717047f5b0f37da03d
    assert y0 == 0x0503921d7f6a12805e72940b963c0cf3471c7b2a524950ca195d11062ee75ec076daf2d4bc358c4b190c0c98064fdd92
    assert y1 == 0x12424ac32561493f3fe3c260708a12b7c620e7be00099a974e259ddc7d1f6395c3c811cdd19f1e8dbf3e9ecfdcbab8d6


def _tower_cases(rng):
    """(op, a, b) for every opcode on random canonical operands, op 8 on
    a cyclotomic element, op 9 on a line."""
    f = _rfp12(rng)
    g = JF.fp12_mul(JF.fp12_conj(f), JF.fp12_inv(f))
    g = JF.fp12_mul(JF.fp12_frob_n(g, 2), g)
    a, b = rng.randrange(P), rng.randrange(P)
    a2, b2, a6, b6 = _rfp2(rng), _rfp2(rng), _rfp6(rng), _rfp6(rng)
    a12, b12 = _rfp12(rng), _rfp12(rng)
    line = (_enc_fp2(_rfp2(rng)) + _enc_fp2(_rfp2(rng))
            + _be48(rng.randrange(P)))
    return [(0, _be48(a), _be48(b)), (1, _be48(a), b""),
            (2, _enc_fp2(a2), _enc_fp2(b2)), (3, _enc_fp2(a2), b""),
            (4, _enc_fp6(a6), _enc_fp6(b6)), (5, _enc_fp6(a6), b""),
            (6, _enc_fp12(a12), _enc_fp12(b12)), (7, _enc_fp12(a12), b""),
            (8, _enc_fp12(g), b""), (9, _enc_fp12(a12), line)]


@pytest.mark.parametrize("seed", [0xB15381, 20260805])
def test_tower_op_matches_reference(seed):
    rng = random.Random(seed)
    for _ in range(3):
        for op, a, b in _tower_cases(rng):
            got = N.tower_op(op, a, b)
            assert got is not None and got == JN.tower_op(op, a, b)
    # the golden model on the products
    x, y = rng.randrange(P), rng.randrange(P)
    assert N.tower_op(0, _be48(x), _be48(y)) == _be48(JF.fp_mul(x, y))
    f = _rfp12(rng)
    assert N.tower_op(7, _enc_fp12(f)) == _enc_fp12(JF.fp12_sqr(f))


def test_tower_op_negative_controls():
    one = _be48(1)
    for op, a, b in [(0, _be48(P), one), (0, one, _be48(P)),
                     (3, _be48(P - 1) + _be48(P), b""),
                     (7, _be48(P) + bytes(48 * 11), b""), (99, one, b""),
                     (-1, one, b""), (0, one[:-1], one), (0, one, b""),
                     (1, one, one), (9, bytes(576), bytes(239))]:
        assert N.tower_op(op, a, b) is None
        assert JN.tower_op(op, a, b) is None


def test_verify_records_one_native_dispatch(g2_case):
    D.DISPATCH.clear()
    assert N.verify_g2(*g2_case, DST_G2)
    assert N.verify_g2(g2_case[0], g2_case[1], b"short", DST_G2) is False
    recs = D.DISPATCH.records()
    assert [(r.seam, r.n, r.bucket) for r in recs] == [("native", 1, 1)]
    assert recs[0].device_s > 0
    D.DISPATCH.clear()


def test_build_info_and_library_path():
    """The library is the port's own build under build/native/, keyed by
    a content hash, never drand_tpu's library; a second process reuses
    it."""
    info = N.build_info()
    assert info["flags"] in (["-O3", "-march=native"], ["-O2"])
    assert len(info["hash"]) == 64 and info["seconds"] >= 0
    lib = Path(info["lib"]).resolve()
    assert lib == (ROOT / "build" / "native" / N.LIB_NAME).resolve()
    assert lib.parent == N.BUILD_DIR.resolve()
    assert (ROOT / "drand_tpu" / "native") not in lib.parents
    assert N.SOURCES[0].read_bytes() != b"" and \
        N.SOURCES[0].parent == ROOT / "drand_tpu_torch" / "native"
    out = subprocess.run(
        [sys.executable, "-c", "import json; from drand_tpu_torch import "
         "native; print(json.dumps(native.build_info()))"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    again = __import__("json").loads(out.stdout)
    assert again["cached"] is True and again["hash"] == info["hash"]


def test_build_failure_raises_with_compiler_output(tmp_path, monkeypatch):
    """A compiler that cannot be run, or that fails on every flag set,
    raises NativeBuildError (no fallback); nothing is written outside the
    temporary directory."""
    monkeypatch.setattr(N, "BUILD_DIR", tmp_path / "missing")
    monkeypatch.setattr(N, "CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(N.NativeBuildError, match="could not run"):
        N.build()
    failing = tmp_path / "failing-g++"
    failing.write_text("#!/bin/sh\necho 'error: no such target' >&2\n"
                       "exit 1\n")
    failing.chmod(0o755)
    monkeypatch.setattr(N, "BUILD_DIR", tmp_path / "failed")
    monkeypatch.setattr(N, "CXX", str(failing))
    with pytest.raises(N.NativeBuildError, match="no such target") as exc:
        N.build()
    assert "-O2" in str(exc.value) and "-march=native" in str(exc.value)
    assert not (tmp_path / "failed" / N.LIB_NAME).exists()
