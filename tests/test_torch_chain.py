"""The port's pedersen-bls-chained path on the CPU, and the committed
chained fixture it shares with chip_smoke.py."""

import hashlib

import numpy as np
import pytest
import torch

from drand_tpu import fixtures as JFX
from drand_tpu.crypto import sign as S
from drand_tpu.crypto.bls12381 import curve as GC
from drand_tpu_torch import fixtures as TFX
from drand_tpu_torch import verify as V

GENESIS_SEED = hashlib.sha256(b"bench-genesis").digest()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def chain():
    sk, pk = JFX.fixture_keypair()
    return pk, JFX.make_chained_chain(sk, GENESIS_SEED, 9)


def test_fixture_keypair_matches_drand_tpu():
    sk, pk = JFX.fixture_keypair()
    tsk, tpk = TFX.fixture_keypair()
    assert tsk == sk
    assert GC.g1_to_bytes(tpk) == GC.g1_to_bytes(pk)


def test_committed_fixture_is_the_signed_chain(chain):
    pk, sigs = chain
    fx_sigs, fx_pk, fx_seed = TFX.load_chained_fixture()
    assert fx_sigs.shape == (65, 96) and fx_seed == GENESIS_SEED
    assert fx_pk == GC.g1_to_bytes(pk)
    np.testing.assert_array_equal(fx_sigs[:9], sigs)
    msg = hashlib.sha256(bytes(fx_sigs[63]) + (65).to_bytes(8, "big")).digest()
    assert S.bls_verify(pk, msg, bytes(fx_sigs[64]))


def test_chained_segment_verifies(chain):
    """Rounds 2..9 against the regular anchor round 1."""
    pk, sigs = chain
    ver = V.Verifier(pk, V.SHAPE_CHAINED, device="cpu")
    ok = ver.verify_chain_segment(2, sigs[1:], sigs[0])
    assert ok.shape == (8,) and ok.all()


def _golden_verdicts(pk, sigs, seed, start=1):
    """drand_tpu's golden bls_verify of each round of a chained segment
    from round `start`: round r's message is sha256(prev || be64(r)),
    prev the anchor `seed` (the genesis seed for round 1) for the first
    round and round r-1's signature after it."""
    prev, out = bytes(seed), []
    for r, sig in enumerate(sigs, start=start):
        msg = hashlib.sha256(prev + r.to_bytes(8, "big")).digest()
        out.append(S.bls_verify(pk, msg, bytes(sig)))
        prev = bytes(sig)
    return out


def test_genesis_anchor_verdicts_match_golden(chain):
    """Rounds 1..9 against the genesis seed (the irregular anchor: round
    1's message hashes the 32-byte seed), every verdict equal to the
    golden bls_verify of its round; then with a byte of round 1's
    signature flipped: False at round 1, and at round 2, whose message
    hashes round 1's signature, True elsewhere, as the golden says."""
    pk, sigs = chain
    ver = V.Verifier(pk, V.SHAPE_CHAINED, device="cpu")
    seed = np.frombuffer(GENESIS_SEED, np.uint8)
    ok = ver.verify_chain_segment(1, sigs, seed)
    assert ok.shape == (9,)
    assert ok.tolist() == _golden_verdicts(pk, sigs, GENESIS_SEED)
    assert ok.all()
    bad = sigs.copy()
    bad[0, 40] ^= 0x01
    ok = ver.verify_chain_segment(1, bad, seed)
    assert ok.tolist() == _golden_verdicts(pk, bad, GENESIS_SEED)
    assert ok.tolist() == [False, False] + [True] * 7


@pytest.fixture(scope="module")
def chained_65():
    sigs, pk_bytes, seed = TFX.load_chained_fixture()
    _sk, pk = TFX.fixture_keypair()
    assert GC.g1_to_bytes(pk) == pk_bytes
    return pk, sigs, np.frombuffer(seed, np.uint8)


def test_segment_async_out_of_order(chained_65):
    """Two verify_chain_segment_async calls queued on the committed
    chained segment, resolved in reverse order: rounds 1-5 from the
    genesis seed (the irregular anchor), and rounds 20-26 against round
    19 with a byte of round 22's signature flipped.  Each equals the
    blocking verify_chain_segment and the golden bls_verify of its
    rounds."""
    pk, sigs, seed = chained_65
    ver = V.Verifier(pk, V.SHAPE_CHAINED, device="cpu")
    bad = sigs[19:26].copy()
    bad[2, 40] ^= 0x01
    first = ver.verify_chain_segment_async(1, sigs[:5], seed)
    second = ver.verify_chain_segment_async(20, bad, sigs[18])
    ok2, ok1 = second(), first()
    assert ok1.dtype == ok2.dtype == bool
    assert ok1.tolist() == [True] * 5
    assert ok1.tolist() == _golden_verdicts(pk, sigs[:5], bytes(seed))
    assert ok2.tolist() == [True, True, False, False] + [True] * 3
    assert ok2.tolist() == _golden_verdicts(pk, bad, bytes(sigs[18]),
                                            start=20)
    np.testing.assert_array_equal(
        ok1, ver.verify_chain_segment(1, sigs[:5], seed))
    np.testing.assert_array_equal(
        ok2, ver.verify_chain_segment(20, bad, sigs[18]))


@pytest.mark.parametrize("anchor", ["regular", "genesis"])
def test_segment_async_empty(chained_65, anchor):
    """An empty segment resolves to bool[0] under either anchor, issuing
    nothing."""
    pk, sigs, seed = chained_65
    ver = V.Verifier(pk, V.SHAPE_CHAINED, device="cpu")
    a = sigs[0] if anchor == "regular" else seed
    out = ver.verify_chain_segment_async(2, sigs[:0], a)()
    assert out.shape == (0,) and out.dtype == bool
    assert ver.verify_chain_segment(2, sigs[:0], a).shape == (0,)


def test_segment_async_genesis_round_alone(chained_65):
    """A one-round segment at the genesis anchor: round 1 alone, its
    verdict the golden one, and False once its signature is flipped."""
    pk, sigs, seed = chained_65
    ver = V.Verifier(pk, V.SHAPE_CHAINED, device="cpu")
    assert ver.verify_chain_segment_async(1, sigs[:1], seed)().tolist() == \
        [True]
    bad = sigs[:1].copy()
    bad[0, 7] ^= 0x80
    assert ver.verify_chain_segment_async(1, bad, seed)().tolist() == \
        _golden_verdicts(pk, bad, bytes(seed)) == [False]
