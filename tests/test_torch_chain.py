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


def _golden_verdicts(pk, sigs, seed):
    """drand_tpu's golden bls_verify of each round of a chained segment
    from round 1: round r's message is sha256(prev || be64(r)), prev the
    genesis seed for round 1 and round r-1's signature after it."""
    prev, out = bytes(seed), []
    for r, sig in enumerate(sigs, start=1):
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
