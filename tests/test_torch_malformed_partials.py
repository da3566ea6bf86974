"""Partials that are not bytes, through the port's DeviceBackend on the
CPU: false in their own row, every other row's verdict kept, as
drand_tpu's DeviceBackend gives them (it catches any exception around a
partial's wire form, drand_tpu/beacon/crypto_backend.py:400, :523); the
bytes rows held against drand_tpu's HostBackend.  The tolerance is exact
equality of verdicts.
"""

import asyncio
import hashlib

import pytest
import torch

from drand_tpu.beacon import crypto_backend as JCB
from drand_tpu.crypto import poly as JP
from drand_tpu.crypto import tbls as JT
from drand_tpu_torch.beacon import crypto_backend as CB
from drand_tpu_torch.crypto import poly as P

T, N_SIGNERS = 3, 5
MSG = hashlib.sha256((1).to_bytes(8, "big")).digest()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stream(seed: bytes):
    def rand(n: int) -> bytes:
        return b"".join(hashlib.sha512(seed + i.to_bytes(8, "big")).digest()
                        for i in range(-(-n // 64)))[:n]
    return rand


@pytest.fixture(scope="module")
def group():
    """(port PubPoly, drand_tpu PubPoly, each signer's partial on MSG by
    drand_tpu's golden sign_partial)."""
    jpoly = JP.PriPoly.random(T, secret=4321, rand=_stream(b"wire form"))
    poly = P.PriPoly.random(T, secret=4321, rand=_stream(b"wire form"))
    return (poly.commit(), jpoly.commit(),
            [JT.sign_partial(s, MSG) for s in jpoly.shares(N_SIGNERS)])


@pytest.fixture(scope="module")
def mixed(group):
    """One round's mixed batch (two valid partials, a flipped one, None,
    an int, a 95-byte one) through the port's DeviceBackend on the CPU:
    verify_partials_rounds, and AsyncPartialVerifier (whose one coalesced
    call is verify_partials)."""
    pub, _, p = group
    g = p[2]
    batch = [p[0], p[1], g[:50] + bytes([g[50] ^ 1]) + g[51:], None, 5,
             p[3][:95]]
    be = CB.DeviceBackend(pub, T, N_SIGNERS, device="cpu")
    calls = []
    inner = be.verify_partials

    def counted(msgs, parts):
        calls.append(len(msgs))
        return inner(msgs, parts)
    be.verify_partials = counted
    rounds = be.verify_partials_rounds([MSG], [batch])[0]

    async def burst():
        ver = CB.AsyncPartialVerifier(be, max_delay=0.2)
        oks = await asyncio.gather(*[ver.verify(MSG, x) for x in batch])
        ver.stop()
        return oks

    return batch, rounds, asyncio.run(burst()), calls


def test_non_bytes_partials_false_in_their_row(group, mixed):
    """None and an int are false in their rows; every other row keeps its
    verdict, drand_tpu's HostBackend's on the bytes rows."""
    _, jpub, _ = group
    batch, rounds, burst, calls = mixed
    jhost = JCB.HostBackend(jpub, T, N_SIGNERS)
    keep = [i for i, x in enumerate(batch) if isinstance(x, bytes)]
    ref_rows = jhost.verify_partials([MSG] * len(keep),
                                     [batch[i] for i in keep])
    want = [False] * len(batch)
    for i, ok in zip(keep, ref_rows):
        want[i] = ok
    assert want == [True, True, False, False, False, False]
    assert rounds == want
    assert burst == want
    assert calls == [len(batch)]        # the burst was one backend call
