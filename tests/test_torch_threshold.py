"""The port's threshold path on the CPU, held against drand_tpu on a small
group (t = 3, n = 5, fixed coefficients, 2 rounds): polynomial
evaluations, commitments and Lagrange bases; the partial wire form; the
signer-key table and its epochs; `pubpoly_eval_g1` and the G1
`point_mul_bits` against drand_tpu's jitted functions, limb for limb;
`verify_g2_sigs` with a key a row and with one key; and the verdicts of
`DeviceBackend(device="cpu")` (arrival order, rounds-major, and the path
without the table) against drand_tpu's `HostBackend` on the same
partials, negative rows among them; `dedup_messages` and the
`AsyncPartialVerifier` batching.  Every comparison is exact.

Each port verify here stays in the smallest bucket that fits (4 partials
or 8 rounds) and runs once, in a module fixture that several tests read.
drand_tpu's jitted verify takes minutes to compile on XLA:CPU, so the port
meets it only in the `slow` test at the end.
"""

import asyncio
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drand_tpu.beacon import crypto_backend as JCB
from drand_tpu.beacon import signer_table as JST
from drand_tpu.crypto import poly as JP
from drand_tpu.crypto import sign as JS
from drand_tpu.crypto import tbls as JT
from drand_tpu.crypto.bls12381 import curve as JGC
from drand_tpu.ops import bls as JBLS
from drand_tpu.ops import curve as JDC
from drand_tpu_torch import convert
from drand_tpu_torch import dispatch as D
from drand_tpu_torch.beacon import crypto_backend as CB
from drand_tpu_torch.beacon.signer_table import SignerKeyTable, poly_key
from drand_tpu_torch.crypto import poly as P
from drand_tpu_torch.crypto import tbls
from drand_tpu_torch.crypto.bls12381 import curve as GC
from drand_tpu_torch.crypto.bls12381.constants import DST_G2, R
from drand_tpu_torch.ops import bls as BLS
from drand_tpu_torch.ops import curve as DC
from drand_tpu_torch.ops.field import FP

T, N = 3, 5
SECRET = 1234
MSGS = [hashlib.sha256(r.to_bytes(8, "big")).digest() for r in (1, 2)]


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
    """(port PriPoly, drand_tpu PriPoly, port PubPoly, drand_tpu PubPoly,
    drand_tpu shares) from one coefficient stream."""
    poly = P.PriPoly.random(T, secret=SECRET, rand=_stream(b"threshold"))
    jpoly = JP.PriPoly.random(T, secret=SECRET, rand=_stream(b"threshold"))
    return poly, jpoly, poly.commit(), jpoly.commit(), jpoly.shares(N)


@pytest.fixture(scope="module")
def partials(group):
    """by_round[r][j]: signer j's partial on MSGS[r] (drand_tpu's golden
    tbls.sign_partial), for all N signers."""
    shares = group[4]
    return [[JT.sign_partial(s, m) for s in shares] for m in MSGS]


def _negatives(by_round):
    """Rounds-major rows with the negative cases: a flipped byte, a valid
    signature under another signer's index, the infinity flag, a 95-byte
    partial and a 1-byte one."""
    rows = [list(by_round[0][:4]), list(by_round[1][:4])]
    g = rows[1][1]
    rows[1][1] = g[:10] + bytes([g[10] ^ 1]) + g[11:]
    rows[0][2] = (2).to_bytes(2, "big") + JT.sig_of(by_round[0][3])
    rows[1][3] = (3).to_bytes(2, "big") + bytes([0xC0]) + bytes(95)
    rows[0][3] = by_round[0][3][:95]
    rows[1][0] = b"\x00"
    return rows


# -- polynomials, Lagrange bases, wire form ----------------------------------

def test_pripoly_coefficients_shares_and_commits(group):
    poly, jpoly, pub, jpub, jshares = group
    assert poly.coeffs == jpoly.coeffs and poly.secret() == SECRET
    assert poly.threshold == pub.threshold == T
    assert [(s.index, s.value) for s in poly.shares(N)] == \
        [(s.index, s.value) for s in jshares]
    assert [GC.g1_to_bytes(c) for c in pub.commits] == \
        [JGC.g1_to_bytes(c) for c in jpub.commits]


@pytest.mark.parametrize("index", [0, N - 1, N + 3, 65535])
def test_pubpoly_eval(group, index):
    _, _, pub, jpub, _ = group
    assert GC.g1_to_bytes(pub.eval(index)) == \
        JGC.g1_to_bytes(jpub.eval(index))


def test_pripoly_random_default_source():
    poly = P.PriPoly.random(4, secret=7)
    assert poly.threshold == 4 and poly.secret() == 7
    assert all(0 < c < R for c in poly.coeffs[1:])
    with pytest.raises(ValueError):
        P.PriPoly.random(2, rand=lambda n: bytes(n - 1))


@pytest.mark.parametrize("indices", [[0, 1, 2], [4, 2, 0], [1, 3, 4],
                                     [0, 7, 65535], list(range(9))])
def test_lagrange_basis_at_zero(indices):
    assert P._lagrange_basis_at_zero(indices) == \
        JP._lagrange_basis_at_zero(indices)


@pytest.mark.parametrize("partial", [b"\x00\x07" + bytes(96), b"\x01\x02",
                                     b"\xff\xff\x01", b"\x00", b""])
def test_tbls_wire_form(partial):
    assert tbls.INDEX_LEN == JT.INDEX_LEN
    assert tbls.sig_of(partial) == JT.sig_of(partial)
    if len(partial) < 2:
        with pytest.raises(ValueError):
            tbls.index_of(partial)
    else:
        assert tbls.index_of(partial) == JT.index_of(partial)


@pytest.mark.parametrize("msgs", [[], [b"a"], [b"a", b"b", b"a", b"c", b"b"],
                                  [b"x"] * 16, [bytes([i % 3]) for i in range(9)]])
def test_dedup_messages(msgs):
    assert CB.dedup_messages(msgs) == JCB.dedup_messages(msgs)


# -- the signer-key table ------------------------------------------------------

def test_signer_table_arrays(group):
    _, _, pub, jpub, _ = group
    got = BLS.signer_table_arrays(pub, N)
    want = convert.from_drand_tpu(JBLS.signer_table_arrays(jpub, N))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert got[0].dtype == torch.int32 and got[2].dtype == torch.bool


def test_signer_table_lookups(group):
    _, _, pub, jpub, _ = group
    table = SignerKeyTable(pub, N, device="cpu")
    jtable = JST.SignerKeyTable(jpub, N)
    assert poly_key(pub) == JST.poly_key(jpub) == table.key
    assert [table.contains(i) for i in (-1, 0, N - 1, N)] == \
        [jtable.contains(i) for i in (-1, 0, N - 1, N)]
    for idx in ([], [0, 4], [0, 5], [-1]):
        assert table.contains_all(idx) == jtable.contains_all(idx)
    for i in (0, N - 1, N + 3):
        assert GC.g1_to_bytes(table.eval(i)) == \
            JGC.g1_to_bytes(jtable.eval(i))
    assert all(a.device.type == "cpu" for a in table.arrays())
    assert table.matches(pub) and table.update(pub) is table


def test_update_group_starts_a_new_epoch(group):
    _, _, pub, _, _ = group
    be = CB.DeviceBackend(pub, T, N, device="cpu")
    first = be.table
    assert first.epoch == 0 and first.device == torch.device("cpu")
    be.update_group(pub, T, N)
    assert be.table is first
    other = P.PriPoly.random(T, secret=99, rand=_stream(b"reshare")).commit()
    be.update_group(other, T, N)
    assert be.table.epoch == 1 and be.table.matches(other)
    assert all(torch.equal(a, b) for a, b in
               zip(be.table.arrays(), BLS.signer_table_arrays(other, N)))
    assert all(torch.equal(a, b) for got, pt in zip(be._commits, other.commits)
               for a, b in zip(got, BLS.g1_affine_limbs(pt)))
    be.update_group(other, T, N + 2)
    assert be.table.epoch == 2 and be.table.n == N + 2


def test_backend_without_device_raises_on_cuda_less_host(group):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        CB.DeviceBackend(group[2], T, N)


# -- the in-batch Horner and the G1 ladder against drand_tpu -------------------

def test_pubpoly_eval_g1_matches_drand_tpu(group):
    _, _, pub, jpub, _ = group
    idx = np.array([0, N - 1, N + 3, 65535], dtype=np.int32)
    got = BLS.pubpoly_eval_g1([BLS.g1_affine_limbs(c) for c in pub.commits],
                              torch.from_numpy(idx))
    want = jax.jit(JBLS.pubpoly_eval_g1)(
        [JBLS._const_g1_affine(c) for c in jpub.commits], jnp.asarray(idx))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    for row, i in enumerate(idx[:3]):
        assert JGC.g1_eq(DC.g1_decode(got, row), jpub.eval(int(i)))
    # as in drand_tpu, 65535 + 1 keeps its low 16 bits (x = 0): the
    # evaluation is the constant term's commitment
    assert JGC.g1_eq(DC.g1_decode(got, 3), jpub.commits[0])


def test_point_mul_bits_g1_matches_drand_tpu():
    rng = np.random.default_rng(15)
    pts = [JGC.g1_mul(JGC.G1_GEN, int(rng.integers(1, 2 ** 62)))
           for _ in range(4)]
    scal = [0, 1, 2 ** 64 - 1, int(rng.integers(2, 2 ** 63))]
    bits = np.array([[(s >> (63 - b)) & 1 for b in range(64)]
                     for s in scal], dtype=np.int32)
    enc = [FP.encode([p[k] for p in pts]) for k in range(3)]
    got = DC.point_mul_bits(tuple(torch.from_numpy(e) for e in enc),
                            torch.from_numpy(bits), DC.FpOps)
    want = jax.jit(lambda p, b: JDC.point_mul_bits(p, b, JDC.FpOps))(
        tuple(jnp.asarray(e) for e in enc), jnp.asarray(bits))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    for row, (p, s) in enumerate(zip(pts, scal)):
        assert JGC.g1_eq(DC.g1_decode(got, row), JGC.g1_mul(p, s))


# -- verify_g2_sigs with a key a row, and with one key -------------------------

def test_verify_g2_sigs_key_per_row(group, partials):
    _, _, pub, jpub, _ = group
    rows = [(0, 0), (1, 2), (0, 4), (1, 3)]          # (round, signer)
    sigs = [JT.sig_of(partials[r][j]) for r, j in rows]
    keys = [j for _, j in rows]
    keys[3] = 1                                      # signer 3's sig, key 1
    tx, ty, _ = BLS.signer_table_arrays(pub, N)
    msgs = torch.from_numpy(np.stack([np.frombuffer(MSGS[r], np.uint8)
                                      for r, _ in rows]))
    got = BLS.verify_g2_sigs(msgs, torch.from_numpy(np.stack(
        [np.frombuffer(s, np.uint8) for s in sigs])),
        (tx[keys], ty[keys]), DST_G2).tolist()
    want = [JT.verify_partial_at(jpub.eval(k), MSGS[r], partials[r][j])
            if k == j else JS.bls_verify(jpub.eval(k), MSGS[r], s)
            for (r, j), k, s in zip(rows, keys, sigs)]
    assert got == want == [True, True, True, False]


def test_verify_g2_sigs_one_key(group):
    poly, _, pub, jpub, _ = group
    sigs = [JS.bls_sign(SECRET, m) for m in MSGS]
    sigs[1] = sigs[1][:5] + bytes([sigs[1][5] ^ 2]) + sigs[1][6:]
    msgs = torch.from_numpy(np.stack([np.frombuffer(m, np.uint8)
                                      for m in MSGS]))
    got = BLS.verify_g2_sigs(msgs, torch.from_numpy(np.stack(
        [np.frombuffer(s, np.uint8) for s in sigs])),
        BLS.g1_affine_limbs(pub.commits[0]), DST_G2).tolist()
    assert got == [JS.bls_verify(jpub.commits[0], m, s)
                   for m, s in zip(MSGS, sigs)] == [True, False]


# -- DeviceBackend verdicts against drand_tpu's HostBackend ---------------------

class _Counting(CB.DeviceBackend):
    calls: list

    def verify_partials(self, msgs, partials):
        self.calls.append(len(msgs))
        return super().verify_partials(msgs, partials)


@pytest.fixture(scope="module")
def verdicts(group, partials):
    """Each port backend call once, with its dispatch records and the
    backend's stats after it: rounds-major with the negatives; a burst of
    four partials in arrival order through the AsyncPartialVerifier (two
    messages, one flipped byte); a rounds-major call with an index
    outside the table."""
    _, _, pub, _, _ = group
    be = _Counting(pub, T, N, device="cpu")
    be.calls = []
    out = {}
    rows = _negatives(partials)
    D.DISPATCH.clear()
    out["rounds"] = be.verify_partials_rounds(MSGS, rows)
    out["rounds_rec"] = [(r.seam, r.n, r.bucket) for r in D.DISPATCH.records()]
    out["rounds_stats"] = dict(be.stats)
    flat = [partials[0][4], partials[1][2], rows[1][1], partials[0][0]]
    out["flat_in"] = ([MSGS[0], MSGS[1], MSGS[1], MSGS[0]], flat)

    async def burst():
        ver = CB.AsyncPartialVerifier(be, max_delay=0.2)
        oks = await asyncio.gather(*[ver.verify(m, p)
                                     for m, p in zip(*out["flat_in"])])
        ver.stop()
        return oks

    D.DISPATCH.clear()
    out["flat"] = asyncio.run(burst())
    out["flat_rec"] = [(r.seam, r.n, r.bucket) for r in D.DISPATCH.records()]
    out["flat_stats"] = dict(be.stats)
    out["flat_calls"] = list(be.calls)
    unt = [[partials[0][0], (N + 3).to_bytes(2, "big")
            + JT.sig_of(partials[0][1])], [partials[1][1], rows[1][1]]]
    D.DISPATCH.clear()
    out["untabled_in"] = unt
    out["untabled"] = be.verify_partials_rounds(MSGS, unt)
    out["untabled_rec"] = [(r.seam, r.n, r.bucket)
                           for r in D.DISPATCH.records()]
    out["untabled_stats"] = dict(be.stats)
    return out


@pytest.fixture(scope="module")
def host(group):
    return JCB.HostBackend(group[3], T, N)


def test_rounds_verdicts_equal_host(verdicts, partials, host):
    rows = _negatives(partials)
    want = [host.verify_partials([MSGS[r]] * len(row), row)
            for r, row in enumerate(rows)]
    assert verdicts["rounds"] == want
    assert verdicts["rounds"] == [[True, True, False, False],
                                  [False, False, True, False]]


def test_rounds_call_is_one_rounds_dispatch(verdicts):
    assert verdicts["rounds_rec"] == [("rounds", 2, 8)]
    st = verdicts["rounds_stats"]
    assert (st["batches"], st["partials"], st["table_hits"],
            st["table_fallbacks"], st["distinct_messages"]) == (1, 8, 8, 0, 2)


def test_arrival_order_verdicts_equal_host(verdicts, host):
    # the flipped partial fails closed; the others are true
    assert verdicts["flat"] == host.verify_partials(*verdicts["flat_in"])
    assert verdicts["flat"] == [True, True, False, True]


def test_async_burst_is_one_tabled_call(verdicts):
    assert verdicts["flat_calls"] == [4]
    assert verdicts["flat_rec"] == [("partials", 4, 4)]
    st = verdicts["flat_stats"]
    # two distinct messages, each hashed once; keys from the table
    assert (st["batches"], st["table_hits"], st["distinct_messages"]) == \
        (2, 12, 4)


def test_untabled_verdicts_equal_host(verdicts, host):
    want = [host.verify_partials([MSGS[r]] * len(row), row)
            for r, row in enumerate(verdicts["untabled_in"])]
    assert verdicts["untabled"] == want == [[True, False], [True, False]]
    # an index outside the table: the whole call went through the flat
    # verify_partials, keys evaluated in the batch
    assert verdicts["untabled_rec"] == [("partials", 4, 4)]
    assert verdicts["untabled_stats"]["table_fallbacks"] == 8


def test_verify_partials_empty(group):
    be = CB.DeviceBackend(group[2], T, N, device="cpu")
    assert be.verify_partials([], []) == []
    assert be.verify_partials_rounds([], []) == []
    assert be.stats["batches"] == 0


# -- the micro-batcher -------------------------------------------------------

class _Stub:
    def __init__(self, fail=False):
        self.fail, self.calls = fail, []

    def verify_partials(self, msgs, partials):
        self.calls.append(len(msgs))
        if self.fail:
            raise RuntimeError("backend down")
        return [p[0] == 1 for p in partials]


@pytest.mark.parametrize("fail", [False, True])
def test_async_verifier_batches_and_fails_closed_on_error(fail):
    stub = _Stub(fail)

    async def go():
        ver = CB.AsyncPartialVerifier(stub, max_delay=0.05, max_batch=3)
        oks = await asyncio.gather(*[ver.verify(b"m", bytes([i % 2]))
                                     for i in range(7)])
        ver.stop()
        return oks

    oks = asyncio.run(go())
    assert sum(stub.calls) == 7 and max(stub.calls) <= 3
    assert oks == ([False] * 7 if fail else [i % 2 == 1 for i in range(7)])


def test_async_verifier_stop_fails_pending_closed():
    class Slow(_Stub):
        def verify_partials(self, msgs, partials):
            import time
            time.sleep(0.3)
            return [True] * len(msgs)

    async def go():
        ver = CB.AsyncPartialVerifier(Slow(), max_delay=0.01, max_batch=1)
        first = asyncio.ensure_future(ver.verify(b"m", b"\x01"))
        rest = [asyncio.ensure_future(ver.verify(b"m", b"\x01"))
                for _ in range(3)]
        await asyncio.sleep(0.05)
        ver.stop()
        return await asyncio.gather(first, *rest)

    assert asyncio.run(go()) == [False] * 4


def test_run_in_crypto_thread():
    assert asyncio.run(CB.run_in_crypto_thread(lambda a, b: a + b, 2, 3)) == 5


# -- drand_tpu's jitted rounds-major kernel --------------------------------------

@pytest.mark.slow
def test_shared_kernel_matches_drand_tpu_jitted(group, partials):
    """verify_partial_g2_sigs_shared against drand_tpu's jitted form on 2 x
    3 partials, negatives among them (minutes of XLA:CPU compile)."""
    _, _, pub, jpub, _ = group
    rows = [r[:3] for r in _negatives(partials)]
    sigs = np.zeros((2, 3, 96), np.uint8)
    idx = np.zeros((2, 3), np.int32)
    for r, row in enumerate(rows):
        for j, p in enumerate(row):
            if len(p) >= 2:
                idx[r, j] = JT.index_of(p)
            if len(JT.sig_of(p)) == 96:
                sigs[r, j] = np.frombuffer(JT.sig_of(p), np.uint8)
    msgs = np.stack([np.frombuffer(m, np.uint8) for m in MSGS])
    jtable = JBLS.signer_table_arrays(jpub, N)
    want = np.asarray(jax.jit(
        lambda m, s, i, t: JBLS.verify_partial_g2_sigs_shared(
            m, s, i, t, DST_G2))(jnp.asarray(msgs), jnp.asarray(sigs),
                                 jnp.asarray(idx),
                                 tuple(jnp.asarray(a) for a in jtable)))
    got = BLS.verify_partial_g2_sigs_shared(
        torch.from_numpy(msgs), torch.from_numpy(sigs), torch.from_numpy(idx),
        BLS.signer_table_arrays(pub, N), DST_G2).numpy()
    assert np.array_equal(got, want)
