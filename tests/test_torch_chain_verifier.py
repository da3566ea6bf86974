"""The port's ChainVerifier, scheme registry, key decoding and dispatch
feed on the CPU, held against drand_tpu's on the same inputs.

Every batch of 32 beacons or fewer takes the host path in both packages
(their native tiers), so no XLA program is compiled; the port's one CPU
verify here (the dispatch feed's) stays in bucket 8.  The tolerance is
exact equality of verdicts.
"""

import hashlib

import numpy as np
import pytest
import torch

from drand_tpu.chain import scheme as JS
from drand_tpu.chain.beacon import Beacon as JBeacon
from drand_tpu.chain.segment import PackedBeacons as JPacked
from drand_tpu.chain.verify import ChainVerifier as JChainVerifier
from drand_tpu.crypto.bls12381 import curve as JGC
from drand_tpu.profiling import dispatch as JD
from drand_tpu_torch import dispatch as D
from drand_tpu_torch import fixtures as TFX
from drand_tpu_torch.chain import scheme as S
from drand_tpu_torch.chain.beacon import Beacon
from drand_tpu_torch.chain.segment import PackedBeacons
from drand_tpu_torch.chain.verify import ChainVerifier
from drand_tpu_torch.crypto.bls12381 import curve as GC
from drand_tpu_torch.crypto.bls12381 import fp as GF
from drand_tpu_torch.crypto.bls12381.constants import P, R

UNCHAINED_16 = (TFX.G1_FIXTURE.parent
                / "bench_sigs_unchained_16_d6a762f2_ff8a2cc7.npy")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def chained():
    """(sigs [65, 96], compressed G1 key, genesis seed) of the committed
    chained segment, and both packages' verifiers for it."""
    sigs, pk_bytes, seed = TFX.load_chained_fixture()
    sch = S.scheme_by_id("pedersen-bls-chained")
    return (sigs, pk_bytes, seed,
            ChainVerifier(sch, pk_bytes, device="cpu"),
            JChainVerifier(JS.scheme_by_id("pedersen-bls-chained"), pk_bytes))


def chain_beacons(sigs, seed, start, stop):
    """Rounds start..stop-1 of the chained fixture as (port, reference)
    Beacon lists, each prev the stored predecessor (the seed at round 1)."""
    out = []
    for r in range(start, stop):
        prev = seed if r == 1 else bytes(sigs[r - 2])
        out.append((r, bytes(sigs[r - 1]), prev))
    return ([Beacon(r, s, p) for r, s, p in out],
            [JBeacon(r, s, p) for r, s, p in out])


def both(port_beacons):
    return [JBeacon(b.round, b.signature, b.previous_sig)
            for b in port_beacons]


def flip(sig: bytes, at: int = 40) -> bytes:
    b = bytearray(sig)
    b[at] ^= 0x01
    return bytes(b)


# -- schemes and keys --------------------------------------------------------

def test_schemes_match_reference():
    assert S.list_schemes() == JS.list_schemes()
    for sid in JS.list_schemes():
        ours, ref = S.scheme_by_id(sid), JS.scheme_by_id(sid)
        assert ours.id == ref.id
        assert ours.decouple_prev_sig == ref.decouple_prev_sig
        assert ours.sig_len == ref.sig_len
        assert ours.sig_group == ref.sig_group
        assert (ours.shape.chained, ours.shape.sig_on_g1, ours.shape.dst) \
            == (ref.shape.chained, ref.shape.sig_on_g1, ref.shape.dst)
    assert S.scheme_by_id("").id == JS.scheme_by_id("").id == \
        S.DEFAULT_SCHEME_ID
    with pytest.raises(S.UnknownSchemeError):
        S.scheme_by_id("no-such-scheme")
    with pytest.raises(JS.UnknownSchemeError):
        JS.scheme_by_id("no-such-scheme")


def test_digest_message_matches_reference(chained):
    sigs, pk_bytes, seed, cv, jcv = chained
    for r, prev in ((1, seed), (2, bytes(sigs[0])), (2**40 + 3, b"")):
        assert cv.digest_message(r, prev) == jcv.digest_message(r, prev)
    ucv = ChainVerifier(S.scheme_by_id("pedersen-bls-unchained"), pk_bytes,
                        device="cpu")
    ujcv = JChainVerifier(JS.scheme_by_id("pedersen-bls-unchained"),
                          pk_bytes)
    assert ucv.digest_message(7, seed) == ujcv.digest_message(7, seed) == \
        hashlib.sha256((7).to_bytes(8, "big")).digest()


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_key_decoding_matches_golden(group):
    if group == "g1":
        pt = TFX.fixture_keypair()[1]
        data = GC.g1_to_bytes(pt)
        ours, ref = GC.g1_from_bytes(data), JGC.g1_from_bytes(data)
        assert GC.g1_affine(ours) == JGC.g1_affine(ref) == GC.g1_affine(pt)
        assert GC.g1_to_bytes(ours) == data
        assert GC.g1_in_subgroup(ours) and JGC.g1_in_subgroup(ref)
    else:
        pt = TFX.fixture_keypair_g2()[1]
        data = GC.g2_to_bytes(pt)
        ours, ref = GC.g2_from_bytes(data), JGC.g2_from_bytes(data)
        assert GC.g2_affine(ours) == JGC.g2_affine(ref) == GC.g2_affine(pt)
        assert GC.g2_to_bytes(ours) == data
        assert GC.g2_in_subgroup(ours) and JGC.g2_in_subgroup(ref)


def _off_curve_x(group: str) -> bytes:
    """The first x >= 1 whose curve equation has no square root."""
    x = 1
    while True:
        if group == "g1":
            if GF.fp_sqrt((pow(x, 3, P) + 4) % P) is None:
                out = bytearray(x.to_bytes(48, "big"))
                out[0] |= 0x80
                return bytes(out)
        else:
            xx = (x, 1)
            y2 = GF.fp2_add(GF.fp2_mul(GF.fp2_sqr(xx), xx), (4, 4))
            if GF.fp2_sqrt(y2) is None:
                out = bytearray((1).to_bytes(48, "big") + x.to_bytes(48, "big"))
                out[0] |= 0x80
                return bytes(out)
        x += 1


def _off_subgroup(group: str) -> bytes:
    """A compressed point on the curve outside the r-subgroup."""
    x = 1
    while True:
        if group == "g1":
            y = GF.fp_sqrt((pow(x, 3, P) + 4) % P)
            if y is not None and not GC.point_is_inf(
                    GC.point_mul((x, y, 1), R, GC.FP_OPS), GC.FP_OPS):
                return GC.g1_to_bytes((x, y, 1))
        else:
            xx = (x, 0)
            y = GF.fp2_sqrt(GF.fp2_add(GF.fp2_mul(GF.fp2_sqr(xx), xx),
                                       (4, 4)))
            if y is not None and not GC.g2_in_subgroup((xx, y, GF.FP2_ONE)):
                return GC.g2_to_bytes((xx, y, GF.FP2_ONE))
        x += 1


def _bad_keys(group: str) -> dict:
    n = 48 if group == "g1" else 96
    good = (GC.g1_to_bytes(TFX.fixture_keypair()[1]) if group == "g1"
            else GC.g2_to_bytes(TFX.fixture_keypair_g2()[1]))
    x_ge_p = bytearray(P.to_bytes(48, "big") + bytes(n - 48))
    x_ge_p[0] |= 0x80
    return {
        "short": good[:-1],
        "long": good + b"\x00",
        "other_group": (GC.g2_to_bytes(TFX.fixture_keypair_g2()[1])
                        if group == "g1" else good[:48]),
        "uncompressed": bytes([good[0] & 0x7F]) + good[1:],
        "x_ge_p": bytes(x_ge_p),
        "off_curve": _off_curve_x(group),
        "off_subgroup": _off_subgroup(group),
        "infinity": bytes([0xC0]) + bytes(n - 1),
    }


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_invalid_keys_raise_where_reference_raises(group):
    """Each malformed key: the port's decoder raises ValueError exactly
    where drand_tpu's does, and where neither does (the point at infinity,
    an on-curve point outside G1/G2) the two decode to the same point and
    agree that it is outside the subgroup.  A ChainVerifier over a key
    that fails to decode raises in both packages."""
    ours_dec = GC.g1_from_bytes if group == "g1" else GC.g2_from_bytes
    ref_dec = JGC.g1_from_bytes if group == "g1" else JGC.g2_from_bytes
    sid = ("pedersen-bls-unchained" if group == "g1"
           else "bls-unchained-g1-rfc9380")
    raised = {}
    for name, data in _bad_keys(group).items():
        try:
            ref = ref_dec(data)
        except ValueError:
            ref = None
        if ref is None:
            with pytest.raises(ValueError):
                ours_dec(data)
            with pytest.raises(ValueError):
                ChainVerifier(S.scheme_by_id(sid), data, device="cpu")
            with pytest.raises(ValueError):
                JChainVerifier(JS.scheme_by_id(sid), data)
        else:
            ours = ours_dec(data)
            if group == "g1":
                assert GC.g1_affine(ours) == JGC.g1_affine(ref)
                assert GC.g1_in_subgroup(ours) == JGC.g1_in_subgroup(ref)
            else:
                assert GC.g2_affine(ours) == JGC.g2_affine(ref)
                assert GC.g2_in_subgroup(ours) == JGC.g2_in_subgroup(ref)
        raised[name] = ref is None
    assert raised == {"short": True, "long": True, "other_group": True,
                      "uncompressed": True, "x_ge_p": True,
                      "off_curve": True, "off_subgroup": False,
                      "infinity": False}
    # the subgroup check is what tells the on-curve point apart
    off = ours_dec(_bad_keys(group)["off_subgroup"])
    assert not (GC.g1_in_subgroup(off) if group == "g1"
                else GC.g2_in_subgroup(off))
    # the port builds its device key eagerly: the point at infinity, which
    # has no affine form, is refused at construction
    with pytest.raises(ValueError, match="infinity"):
        ChainVerifier(S.scheme_by_id(sid), _bad_keys(group)["infinity"],
                      device="cpu")


def test_chain_verifier_without_device_raises_on_cuda_less_host(chained):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is the GPU")
    _, pk_bytes, _, _, _ = chained
    with pytest.raises(RuntimeError, match="CUDA"):
        ChainVerifier(S.scheme_by_id("pedersen-bls-chained"), pk_bytes)
    _, pk2 = TFX.fixture_keypair_g2()
    with pytest.raises(RuntimeError, match="CUDA"):
        ChainVerifier(S.scheme_by_id("bls-unchained-g1-rfc9380"),
                      GC.g2_to_bytes(pk2))
    assert ChainVerifier(S.scheme_by_id("pedersen-bls-chained"), pk_bytes,
                         device="cpu").device == torch.device("cpu")


# -- verdicts ----------------------------------------------------------------

def test_first_nine_rounds_from_genesis(chained):
    """Rounds 1-9 against the genesis seed: round 1 (a 32-byte prev) takes
    the scalar path, rounds 2-9 one batch."""
    sigs, _, seed, cv, jcv = chained
    ours, ref = chain_beacons(sigs, seed, 1, 10)
    got = cv.verify_chain_segment(ours, seed)
    assert got.dtype == bool
    assert got.tolist() == jcv.verify_chain_segment(ref, seed).tolist() == \
        [True] * 9


def test_flipped_byte(chained):
    """Rounds 2-9 with a byte of round 5's signature flipped, round 6's
    prev the flipped signature: rounds 5 and 6 false."""
    sigs, _, seed, cv, jcv = chained
    ours, _ = chain_beacons(sigs, seed, 2, 10)
    ours[3].signature = flip(ours[3].signature)
    ours[4].previous_sig = ours[3].signature
    want = jcv.verify_chain_segment(both(ours), bytes(sigs[0])).tolist()
    assert cv.verify_chain_segment(ours, bytes(sigs[0])).tolist() == want
    assert want == [True] * 3 + [False, False] + [True] * 3


def test_broken_link(chained):
    """Rounds 2-9 with round 7's stored prev replaced: the host linkage
    fails at round 7, and its signature (over the stored prev) too."""
    sigs, _, seed, cv, jcv = chained
    ours, _ = chain_beacons(sigs, seed, 2, 10)
    ours[5].previous_sig = hashlib.sha512(b"not the chain").digest() + \
        bytes(32)
    want = jcv.verify_chain_segment(both(ours), bytes(sigs[0])).tolist()
    assert cv.verify_chain_segment(ours, bytes(sigs[0])).tolist() == want
    assert want == [True] * 5 + [False] + [True] * 2
    # an anchor that is not round 1's signature fails round 2's link
    # alone: round 2's signature is valid over its stored prev
    assert cv.verify_chain_segment(ours[:3], bytes(sigs[1])).tolist() == \
        jcv.verify_chain_segment(both(ours[:3]), bytes(sigs[1])).tolist() \
        == [False, True, True]


def test_round_one_inside_a_mixed_batch(chained):
    """verify_beacons on rounds out of order with round 1 (the genesis
    link) in the middle and a flipped signature: the regular rows are one
    batch issued before round 1's, every verdict the reference's."""
    sigs, _, seed, cv, jcv = chained
    ours, _ = chain_beacons(sigs, seed, 1, 7)
    ours[4].signature = flip(ours[4].signature, 7)
    mixed = [ours[i] for i in (3, 0, 5, 4, 1)]
    want = jcv.verify_beacons(both(mixed)).tolist()
    pending = cv.verify_beacons_async(mixed)
    assert pending().tolist() == want == [True, True, True, False, True]


def test_unchained_batch():
    sigs = np.load(UNCHAINED_16)
    pk_bytes = GC.g1_to_bytes(TFX.fixture_keypair()[1])
    cv = ChainVerifier(S.scheme_by_id("pedersen-bls-unchained"), pk_bytes,
                       device="cpu")
    jcv = JChainVerifier(JS.scheme_by_id("pedersen-bls-unchained"), pk_bytes)
    ours = [Beacon(r, bytes(sigs[r - 1])) for r in range(9, 17)]
    ours[2].signature = flip(ours[2].signature)
    # an unchained scheme ignores the stored prev
    ours[5].previous_sig = bytes(sigs[0])
    want = jcv.verify_beacons(both(ours)).tolist()
    assert cv.verify_beacons(ours).tolist() == want
    assert want == [True, True, False] + [True] * 5


def test_g1_scheme_batch():
    sigs = np.load(TFX.G1_FIXTURE)[:8]
    pk_bytes = GC.g2_to_bytes(TFX.fixture_keypair_g2()[1])
    sid = "bls-unchained-g1-rfc9380"
    cv = ChainVerifier(S.scheme_by_id(sid), pk_bytes, device="cpu")
    jcv = JChainVerifier(JS.scheme_by_id(sid), pk_bytes)
    ours = [Beacon(r, bytes(sigs[r - 1])) for r in range(1, 9)]
    ours[6].signature = flip(ours[6].signature, 20)
    want = jcv.verify_chain_segment(both(ours), b"").tolist()
    assert cv.verify_chain_segment(ours, b"").tolist() == want
    assert want == [True] * 6 + [False, True]


def test_empty_and_wrong_length_issue_nothing(chained):
    sigs, _, seed, cv, jcv = chained
    D.DISPATCH.clear()
    for out in (cv.verify_beacons([]), cv.verify_chain_segment([], seed),
                cv.verify_packed_segment_async(
                    PackedBeacons(5, sigs[:0]), bytes(sigs[3]))()):
        assert out.shape == (0,) and out.dtype == bool
    short = Beacon(3, bytes(sigs[2])[:95], bytes(sigs[1]))
    assert cv.verify_beacon(short) is False
    assert jcv.verify_beacon(JBeacon(3, short.signature, short.previous_sig)) \
        is False
    assert cv.verify_beacons([short]).tolist() == [False]
    # a packed run of another signature length
    assert cv.verify_packed_segment_async(
        PackedBeacons(3, sigs[2:4, :48].copy()), bytes(sigs[1]))().tolist() \
        == [False, False]
    assert len(D.DISPATCH) == 0


def test_packed_segment_from_genesis(chained):
    """verify_packed_segment_async on rounds 1-8 with the genesis seed as
    the caller's anchor (round 1 alone in a bucket of its own, the rest
    one batch) and round 4's signature flipped: its prev column is the
    packed rows themselves, so rounds 4 and 5 are false; the advisory
    first_prev is never used."""
    sigs, _, seed, cv, jcv = chained
    rows = sigs[:8].copy()
    rows[3, 11] ^= 0x01
    ours = PackedBeacons(1, rows, first_prev=b"advisory", chained=True)
    ref = JPacked(1, rows, first_prev=b"advisory", chained=True)
    want = jcv.verify_packed_segment_async(ref, seed)().tolist()
    assert cv.verify_packed_segment_async(ours, seed)().tolist() == want
    assert want == [True] * 3 + [False, False] + [True] * 3


# -- dispatch feed -----------------------------------------------------------

def test_dispatch_feed_records_each_batch_once():
    """One record for one verify_batch_async of the ChainVerifier's device
    Verifier, n = 3 in bucket 8, written at the first resolve and not
    again at the second.  (Through verify_beacons_async three beacons take
    the host tier: one "native" record each, tests/test_torch_host_tier.py.)"""
    sigs = np.load(UNCHAINED_16)
    pk_bytes = GC.g1_to_bytes(TFX.fixture_keypair()[1])
    cv = ChainVerifier(S.scheme_by_id("pedersen-bls-unchained"), pk_bytes,
                       device="cpu")
    D.DISPATCH.clear()
    pending = cv._verifier.verify_batch_async(
        np.array([4, 5, 6], dtype=np.uint64), sigs[3:6])
    assert len(D.DISPATCH) == 0          # recorded at resolve, not issue
    first = pending()
    second = pending()
    assert first.tolist() == second.tolist() == [True] * 3
    recs = D.DISPATCH.records("verify")
    assert len(recs) == 1 and len(D.DISPATCH) == 1
    rec = recs[0]
    assert (rec.seam, rec.n, rec.bucket, rec.padding_rounds) == \
        ("verify", 3, 8, 5)
    assert rec.device_s > 0 and rec.fill_ratio == 3 / 8


def test_dispatch_recorder_matches_reference():
    """The port's recorder against drand_tpu's on the same records: every
    field the port keeps but the wall stamp, and the bounded ring."""
    ours, ref = D.DispatchRecorder(maxlen=3), JD.DispatchRecorder(maxlen=3)
    calls = [("verify", 3, 8, 0.5), ("verify", 16384, 16384, 1.25),
             ("verify", 847, 4096, 0.75), ("verify", 0, 8, 0.0),
             ("verify", 9, 64, 0.125)]
    for seam, n, b, s in calls:
        da = ours.record(seam, n, b, s).to_dict()
        dr = ref.record(seam, n, b, s).to_dict()
        da.pop("wall")
        assert da == {k: dr[k] for k in da}
    assert len(ours) == len(ref) == 3
    assert [r.n for r in ours.records()] == [847, 0, 9] == \
        [r.n for r in ref.records()]
    assert ours.records("other") == []
    ours.clear()
    assert len(ours) == 0 and ours.records() == []


def test_timed_dispatch_records_one_call():
    D.DISPATCH.clear()
    with D.timed_dispatch("verify", n=5, bucket=8) as t:
        pass
    recs = D.DISPATCH.records()
    assert len(recs) == 1 and recs[0].device_s == t.device_s >= 0
    assert (recs[0].n, recs[0].bucket) == (5, 8)
    D.DISPATCH.clear()
