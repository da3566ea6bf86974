"""The port's host tier on the CPU, held against drand_tpu on the same
inputs: `ChainVerifier.verify_beacon` through the native library, batches
of at most 32 rows and a larger batch's irregular rows on the host, a
33-row batch on the port's Verifier; `HostBackend`, `_native_recover` and
`DeviceBackend.recover` byte-equal to drand_tpu's `HostBackend`; and a
native library that cannot be built raising.  The tolerance is exact
equality of verdicts and bytes.

drand_tpu's own batches of more than 32 rows would compile its XLA
verifier, so the port's 33-row batch is held against drand_tpu's
`verify_beacon` row by row.
"""

import hashlib

import numpy as np
import pytest
import torch

from drand_tpu.beacon import crypto_backend as JCB
from drand_tpu.chain import scheme as JS
from drand_tpu.chain.beacon import Beacon as JBeacon
from drand_tpu.chain.verify import ChainVerifier as JChainVerifier
from drand_tpu.crypto import poly as JP
from drand_tpu.crypto import tbls as JT
from drand_tpu_torch import dispatch as D
from drand_tpu_torch import fixtures as TFX
from drand_tpu_torch import native as N
from drand_tpu_torch.beacon import crypto_backend as CB
from drand_tpu_torch.chain import scheme as S
from drand_tpu_torch.chain import verify as CVM
from drand_tpu_torch.chain.beacon import Beacon
from drand_tpu_torch.chain.segment import PackedBeacons
from drand_tpu_torch.chain.verify import ChainVerifier
from drand_tpu_torch.crypto import poly as P
from drand_tpu_torch.crypto.bls12381 import curve as GC

T, N_SIGNERS = 3, 5
MSGS = [hashlib.sha256(r.to_bytes(8, "big")).digest() for r in (1, 2)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def flip(sig: bytes, at: int = 40) -> bytes:
    return sig[:at] + bytes([sig[at] ^ 1]) + sig[at + 1:]


def seams():
    return [r.seam for r in D.DISPATCH.records()]


@pytest.fixture(scope="module")
def chained():
    """The committed chained segment as port beacons (rounds 1-65, each
    prev the stored predecessor, the seed at round 1), and both packages'
    verifiers."""
    sigs, pk_bytes, seed = TFX.load_chained_fixture()
    beacons = [Beacon(r, bytes(sigs[r - 1]),
                      seed if r == 1 else bytes(sigs[r - 2]))
               for r in range(1, 66)]
    sid = "pedersen-bls-chained"
    return (beacons, seed,
            ChainVerifier(S.scheme_by_id(sid), pk_bytes, device="cpu"),
            JChainVerifier(JS.scheme_by_id(sid), pk_bytes))


def ref(beacons):
    return [JBeacon(b.round, b.signature, b.previous_sig) for b in beacons]


def damaged(beacons):
    """Round 30's signature flipped (round 31's prev then its flipped
    signature), round 50's prev replaced, round 60's signature cut to 95
    bytes, round 61's prev an empty string."""
    out = [Beacon(b.round, b.signature, b.previous_sig) for b in beacons]
    out[29].signature = flip(out[29].signature)
    out[30].previous_sig = out[29].signature
    out[49].previous_sig = hashlib.sha512(b"broken").digest() + bytes(32)
    out[59].signature = out[59].signature[:95]
    out[60].previous_sig = b""
    return out


# -- ChainVerifier on the host -----------------------------------------------

def test_verify_beacon_matches_reference_on_chained_fixture(chained):
    beacons, _, cv, jcv = chained
    bad = damaged(beacons)
    D.DISPATCH.clear()
    got = [cv.verify_beacon(b) for b in bad]
    want = [jcv.verify_beacon(b) for b in ref(bad)]
    assert got == want
    assert [i + 1 for i, ok in enumerate(got) if not ok] == \
        [30, 31, 50, 60, 61]
    # one native record a verify that reached the library (not the
    # 95-byte signature, refused before it), no card batch
    assert seams() == ["native"] * 64


def test_verify_beacon_g1_scheme_matches_reference():
    sigs = np.load(TFX.G1_FIXTURE)[:6]
    pk_bytes = GC.g2_to_bytes(TFX.fixture_keypair_g2()[1])
    sid = "bls-unchained-g1-rfc9380"
    cv = ChainVerifier(S.scheme_by_id(sid), pk_bytes, device="cpu")
    jcv = JChainVerifier(JS.scheme_by_id(sid), pk_bytes)
    ours = [Beacon(r, bytes(sigs[r - 1])) for r in range(1, 7)]
    ours[2].signature = flip(ours[2].signature, 20)
    ours[4].round = 99
    got = [cv.verify_beacon(b) for b in ours]
    assert got == [jcv.verify_beacon(b) for b in ref(ours)] == \
        [True, True, False, True, False, True]


def test_batches_of_32_rows_take_the_host(chained):
    """32 regular rows, a 32-row packed run and a 33-row batch whose
    regular rest is 32 (round 1 against the seed): native records only,
    every verdict the reference's."""
    beacons, seed, cv, jcv = chained
    bad = damaged(beacons)
    assert CVM._HOST_VERIFY_MAX == 32
    D.DISPATCH.clear()
    rows = bad[20:52]
    got = cv.verify_beacons(rows).tolist()
    assert got == jcv.verify_beacons(ref(rows)).tolist()
    assert seams() == ["native"] * 32
    D.DISPATCH.clear()
    sigs = np.stack([np.frombuffer(b.signature, np.uint8)
                     for b in beacons[:32]])
    sigs[9, 3] ^= 1
    packed = cv.verify_packed_segment_async(PackedBeacons(1, sigs), seed)()
    assert packed.tolist() == [True] * 9 + [False, False] + [True] * 21
    assert seams() == ["native"] * 32
    D.DISPATCH.clear()
    got = cv.verify_chain_segment(bad[:33], seed).tolist()
    assert got == [jcv.verify_beacon(b) for b in ref(bad[:33])] == \
        [True] * 29 + [False, False, True, True]
    assert seams() == ["native"] * 33


def test_33_rows_take_the_verifier_and_irregular_rows_the_host(chained):
    """Rounds 1-35 with round 30 flipped and round 35's signature cut: the
    33 regular rounds 2-34 are one Verifier batch (one "verify" record of
    n = 33 in bucket 64), issued before round 1 (the 32-byte genesis
    prev) and round 35 verify on the host; every verdict drand_tpu's
    verify_beacon."""
    beacons, _, cv, jcv = chained
    rows = [Beacon(b.round, b.signature, b.previous_sig)
            for b in damaged(beacons)[:35]]
    rows[34].signature = rows[34].signature[:90]
    D.DISPATCH.clear()
    pending = cv.verify_beacons_async(rows)
    assert seams() == ["native"]        # round 1 verified at issue
    got = pending().tolist()
    assert got == [jcv.verify_beacon(b) for b in ref(rows)] == \
        [True] * 29 + [False, False] + [True] * 3 + [False]
    recs = D.DISPATCH.records("verify")
    assert [(r.n, r.bucket) for r in recs] == [(33, 64)]
    assert seams() == ["native", "verify"]


# -- threshold backends on the host -------------------------------------------

def _stream(seed: bytes):
    def rand(n: int) -> bytes:
        return b"".join(hashlib.sha512(seed + i.to_bytes(8, "big")).digest()
                        for i in range(-(-n // 64)))[:n]
    return rand


@pytest.fixture(scope="module")
def group():
    """(port PubPoly, drand_tpu PubPoly, by_round[r][j]: signer j's
    partial on MSGS[r] by drand_tpu's golden sign_partial)."""
    jpoly = JP.PriPoly.random(T, secret=4321, rand=_stream(b"host tier"))
    poly = P.PriPoly.random(T, secret=4321, rand=_stream(b"host tier"))
    shares = jpoly.shares(N_SIGNERS)
    by_round = [[JT.sign_partial(s, m) for s in shares] for m in MSGS]
    return poly.commit(), jpoly.commit(), by_round


def test_host_backend_verdicts_match_reference(group):
    pub, jpub, by_round = group
    p = by_round[0]
    parts = list(by_round[1]) + [
        flip(p[1], 30), (2).to_bytes(2, "big") + JT.sig_of(p[3]),
        p[2][:95], p[2] + b"\x00", b"\x00",
        (3).to_bytes(2, "big") + bytes([0xC0]) + bytes(95),
        (N_SIGNERS + 2).to_bytes(2, "big") + JT.sig_of(p[0])]
    msgs = [MSGS[1]] * N_SIGNERS + [MSGS[0]] * 7
    ours = CB.HostBackend(pub, T, N_SIGNERS)
    jhost = JCB.HostBackend(jpub, T, N_SIGNERS)
    D.DISPATCH.clear()
    got = ours.verify_partials(msgs, parts)
    assert got == jhost.verify_partials(msgs, parts) == \
        [True] * N_SIGNERS + [False] * 7
    assert seams() == ["native"] * 9    # the three short or long ones
    # a partial that is not bytes raises in both host backends
    for item in (None, 5):
        with pytest.raises(TypeError):
            ours.verify_partials([MSGS[0]], [item])
        with pytest.raises(TypeError):
            jhost.verify_partials([MSGS[0]], [item])


def test_recover_matches_reference(group):
    """HostBackend.recover and DeviceBackend.recover (native first, no
    device multiplication) byte-equal to drand_tpu's HostBackend: the
    first t partials, a non-contiguous subset, junk in front; a signature
    that does not decode among the first t sends both host backends to
    the golden combination of the next t."""
    pub, jpub, by_round = group
    p = by_round[1]
    ours = CB.HostBackend(pub, T, N_SIGNERS)
    dev = CB.DeviceBackend(pub, T, N_SIGNERS, device="cpu")
    jhost = JCB.HostBackend(jpub, T, N_SIGNERS)

    def no_msm(*a):
        raise AssertionError("the device multiplication ran")
    dev._recover_msm = no_msm
    cases = [p[:T], [p[4], p[0], p[2]], [b"\x00", None, p[1]] + p[2:5],
             [p[0], p[0], p[3], p[4]]]
    for parts in cases:
        want = jhost.recover(MSGS[1], parts)
        assert ours.recover(MSGS[1], parts) == want
        assert dev.recover(MSGS[1], parts) == want
        assert CB._native_recover(parts, T, N_SIGNERS) == want
    assert JCB._native_recover(p[:T], T, N_SIGNERS) == \
        CB._native_recover(p[:T], T, N_SIGNERS)
    undecodable = p[0][:2] + bytes([0xA0]) + b"\xff" * 95
    parts = [undecodable] + p[1:]
    assert CB._native_recover(parts, T, N_SIGNERS) is None
    assert ours.recover(MSGS[1], parts) == jhost.recover(MSGS[1], parts) \
        == jhost.recover(MSGS[1], p[1:1 + T])
    with pytest.raises(ValueError):
        ours.recover(MSGS[1], p[:T - 1])
    with pytest.raises(ValueError):
        jhost.recover(MSGS[1], p[:T - 1])


# -- no quiet fallback -------------------------------------------------------

def test_unbuildable_library_raises_everywhere(group, chained, tmp_path,
                                               monkeypatch):
    """With the build pointed at a missing compiler in a temporary
    directory, every host-tier entry raises NativeBuildError: nothing
    falls back to a golden model or to the device."""
    pub, _, by_round = group
    beacons, _, cv, _ = chained
    monkeypatch.setattr(N, "_state", {})
    monkeypatch.setattr(N, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(N, "CXX", str(tmp_path / "no-such-g++"))
    assert N.available() is False
    with pytest.raises(N.NativeBuildError, match="no-such-g"):
        cv.verify_beacon(beacons[5])
    with pytest.raises(N.NativeBuildError):
        cv.verify_beacons(beacons[2:6])
    with pytest.raises(N.NativeBuildError):
        CB.HostBackend(pub, T, N_SIGNERS).verify_partials(
            [MSGS[0]], [by_round[0][0]])
    dev = CB.DeviceBackend(pub, T, N_SIGNERS, device="cpu")
    with pytest.raises(N.NativeBuildError):
        dev.recover(MSGS[0], by_round[0][:T])
    assert not (tmp_path / "native" / N.LIB_NAME).exists()
