"""The port's signing and Lagrange recovery on the CPU, held against
drand_tpu on a small group (t = 3, n = 5, fixed coefficients, 2 rounds):
`fixtures.sign_batch_g2` byte for byte against the golden
`tbls.sign_partial`; the G2 `point_mul_bits` limb for limb against
drand_tpu's jitted one at 256 bits, rows at scalar 0 and r - 1 among
them; the Lagrange bits; and `DeviceBackend(device="cpu")`
`recover_rounds` and `recover` byte for byte against drand_tpu's
`DeviceBackend.recover_rounds` (jitted on the CPU) and the golden
`tbls.recover`, with the rounds' signers rotated so their Lagrange bases
differ.  Every comparison is exact.
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drand_tpu.beacon import crypto_backend as JCB
from drand_tpu.crypto import poly as JP
from drand_tpu.crypto import tbls as JT
from drand_tpu.crypto.bls12381 import curve as JGC
from drand_tpu.ops import curve as JDC
from drand_tpu_torch import fixtures as FX
from drand_tpu_torch.beacon import crypto_backend as CB
from drand_tpu_torch.crypto import poly as P
from drand_tpu_torch.crypto.bls12381.constants import R
from drand_tpu_torch.ops import curve as DC
from drand_tpu_torch.ops.field import FP

T, N = 3, 5
SECRET = 4242
ROUNDS = (7, 8)
MSGS = [hashlib.sha256(r.to_bytes(8, "big")).digest() for r in ROUNDS]


def _stream(seed: bytes):
    def rand(n: int) -> bytes:
        return b"".join(hashlib.sha512(seed + i.to_bytes(8, "big")).digest()
                        for i in range(-(-n // 64)))[:n]
    return rand


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def group():
    """(port PubPoly, drand_tpu PubPoly, drand_tpu shares, the partials
    by round of all N signers, by drand_tpu's golden sign_partial)."""
    poly = P.PriPoly.random(T, secret=SECRET, rand=_stream(b"recover"))
    jpoly = JP.PriPoly.random(T, secret=SECRET, rand=_stream(b"recover"))
    shares = jpoly.shares(N)
    parts = [[JT.sign_partial(s, m) for s in shares] for m in MSGS]
    return poly.commit(), jpoly.commit(), shares, parts


def _rotated(parts, r):
    """Round r's partials from signer r + 1 on, so each round takes
    another set of signers."""
    return [parts[r][(r + 1 + j) % N] for j in range(N)]


# -- signing -------------------------------------------------------------------

@pytest.fixture(scope="module")
def signed(group):
    _, _, shares, _ = group
    be8 = np.array([list(r.to_bytes(8, "big")) for r in ROUNDS], np.uint8)
    return (FX.sign_batch_g2(shares[2].value, be8, device="cpu"),
            FX.sign_batch_g2(SECRET, be8, device="cpu"))


def test_sign_batch_g2_share_equals_golden(group, signed):
    parts = group[3]
    got, _ = signed
    assert got.shape == (2, 96) and got.dtype == np.uint8
    assert [bytes(s) for s in got] == [JT.sig_of(parts[r][2])
                                      for r in range(2)]


def test_sign_batch_g2_secret_equals_golden(signed):
    _, got = signed
    assert [bytes(s) for s in got] == [
        JT.sig_of(JT.sign_partial(JP.PriShare(0, SECRET), m)) for m in MSGS]


def test_sign_batch_g2_without_device_raises_on_cuda_less_host():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        FX.sign_batch_g2(1, np.zeros((1, 8), np.uint8))


# -- the G2 ladder against drand_tpu -------------------------------------------

def test_point_mul_bits_g2_matches_drand_tpu():
    rng = np.random.default_rng(16)
    pts = [JGC.g2_mul(JGC.G2_GEN, int(rng.integers(1, 2 ** 62)))
           for _ in range(4)]
    scal = [0, R - 1, int.from_bytes(rng.bytes(32), "big") % R, 5]
    bits = np.array([[(s >> (255 - b)) & 1 for b in range(256)]
                     for s in scal], dtype=np.int32)
    enc = [tuple(FP.encode([p[k][c] for p in pts]) for c in range(2))
           for k in range(3)]
    got = DC.point_mul_bits(
        tuple(tuple(torch.from_numpy(e) for e in xy) for xy in enc),
        torch.from_numpy(bits), DC.Fp2Ops)
    want = jax.jit(lambda p, b: JDC.point_mul_bits(p, b, JDC.Fp2Ops))(
        tuple(tuple(jnp.asarray(e) for e in xy) for xy in enc),
        jnp.asarray(bits))
    for g, w in zip(got, want):
        for gc, wc in zip(g, w):
            assert np.array_equal(gc.numpy(), np.asarray(wc))
    for row, (p, s) in enumerate(zip(pts, scal)):
        assert JGC.g2_eq(DC.g2_decode(got, row), JGC.g2_mul(p, s))


@pytest.mark.parametrize("lams", [[[0, 1, R - 1]],
                                  [[5, 2 ** 255, 2 ** 256 - 1],
                                   [R - 2, 3, 2 ** 200 + 7]]])
def test_lagrange_bits(lams):
    want = np.array([[[(v >> (255 - b)) & 1 for b in range(256)]
                      for v in row] for row in lams], dtype=np.int32)
    assert np.array_equal(CB._lagrange_bits(lams), want)


# -- recovery --------------------------------------------------------------------

@pytest.fixture(scope="module")
def recovered(group):
    pub, jpub, _, parts = group
    by_round = [_rotated(parts, r) for r in range(2)]
    be = CB.DeviceBackend(pub, T, N, device="cpu")
    return (by_round, be.recover_rounds(MSGS, by_round),
            be.recover(MSGS[1], by_round[1]),
            JCB.DeviceBackend(jpub, T, N).recover_rounds(MSGS, by_round))


def test_recover_rounds_equals_drand_tpu(recovered):
    _, got, _, want = recovered
    assert got == want and len(got) == 2


def test_recover_rounds_equals_golden_recover(group, recovered):
    _, jpub, _, _ = group
    by_round, got, _, _ = recovered
    assert got == [JT.recover(jpub, m, p, T, N, verified=True)
                   for m, p in zip(MSGS, by_round)]
    assert got == [JT.sig_of(JT.sign_partial(JP.PriShare(0, SECRET), m))
                   for m in MSGS]


def test_recover_equals_recover_rounds(recovered):
    _, got, one, _ = recovered
    assert one == got[1]


def test_recover_takes_the_first_t_in_group_signers(group):
    """Duplicates and out-of-group indices are skipped before t are
    taken, as in drand_tpu; fewer than t left raises."""
    pub, _, _, parts = group
    be = CB.DeviceBackend(pub, T, N, device="cpu")
    off = (N + 1).to_bytes(2, "big") + JT.sig_of(parts[0][0])
    with pytest.raises(ValueError, match="not enough partials: 2/3"):
        be.recover(MSGS[0], [parts[0][1], off, parts[0][1], parts[0][4]])
    with pytest.raises(ValueError, match="round 1: not enough"):
        be.recover_rounds(MSGS, [parts[0][:T], parts[1][:T - 1]])
    with pytest.raises(ValueError):
        be.recover(MSGS[0], [parts[0][0], b"\x00"])
    assert be.recover_rounds([], []) == []


def test_recover_rejects_an_invalid_partial(group):
    """An infinity-flagged partial among the t raises, as drand_tpu's
    device recovery does (its validity covers decoding and infinity)."""
    pub, _, _, parts = group
    inf = (3).to_bytes(2, "big") + bytes([0xC0]) + bytes(95)
    be = CB.DeviceBackend(pub, T, N, device="cpu")
    with pytest.raises(ValueError, match="device recovery failed"):
        be.recover(MSGS[0], [parts[0][0], parts[0][1], inf])
