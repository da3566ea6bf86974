"""The port's SyncManager, its catch-up pipeline, `serve_sync_chain` and
the check-and-repair pair on the CPU, held against drand_tpu's on the same
streams and stores.

Both packages verify real signatures (the committed 65-round
pedersen-bls-chained fixture, signed by drand_tpu's fixtures) with their
own ChainVerifier: the port's on device="cpu", drand_tpu's on its host
path.  `SYNC_CHUNK` is patched to at most 32 rounds in both managers, so
every segment stays on both packages' native host tier (no XLA compile,
no CPU Verifier batch): a flush can overshoot its chunk target by one
stream item, so the targets stay at 16 where items are 8 rounds.  The
tolerance is exact equality of return values, stats, committed rows,
faulty lists and stream items.
"""

import asyncio
import random
import sqlite3
import threading

import numpy as np
import pytest

import drand_tpu.beacon.sync_manager as JSM
from drand_tpu.chain import scheme as JS
from drand_tpu.chain import segment as JSEG
from drand_tpu.chain import store as JST
from drand_tpu.chain.beacon import Beacon as JBeacon
from drand_tpu.chain.verify import ChainVerifier as JChainVerifier
from drand_tpu.core import convert as JC
import drand_tpu_torch.beacon.sync_manager as SM
from drand_tpu_torch import dispatch as DSP
from drand_tpu_torch import fixtures as TFX
from drand_tpu_torch import native
from drand_tpu_torch.chain import scheme as S
from drand_tpu_torch.chain import segment as SEG
from drand_tpu_torch.chain import store as ST
from drand_tpu_torch.chain.beacon import Beacon
from drand_tpu_torch.chain.verify import ChainVerifier
from drand_tpu_torch.core import convert as C
from drand_tpu_torch.core.process import ServingProcess
from drand_tpu_torch.chain.info import Info
from drand_tpu_torch.crypto.bls12381 import curve as GC

CHAINED, UNCHAINED = "pedersen-bls-chained", "pedersen-bls-unchained"
N = 65
UNCHAINED_512 = (TFX.G1_FIXTURE.parent
                 / "bench_sigs_unchained_512_d6a762f2_ff8a2cc7.npy")
PORT = (SM, ST, SEG, Beacon)
REF = (JSM, JST, JSEG, JBeacon)


class Group:
    period = 30
    genesis_time = 1_600_000_000
    scheme_id = CHAINED


class FixedClock:
    def now(self):
        return 0.0


class Peer:
    def __init__(self, address):
        self.address = address


@pytest.fixture(scope="module")
def chain():
    """(rows (round, sig, prev) of rounds 1..65, pk bytes, genesis seed,
    the port's and drand_tpu's verifiers)."""
    sigs, pk, seed = TFX.load_chained_fixture()
    rows, prev = [], seed
    for i in range(N):
        rows.append((i + 1, bytes(sigs[i]), prev))
        prev = bytes(sigs[i])
    return (rows, pk, seed,
            ChainVerifier(S.scheme_by_id(CHAINED), pk, device="cpu"),
            JChainVerifier(JS.scheme_by_id(CHAINED), pk))


def flipped(rows, at):
    return [(r, s[:40] + bytes([s[40] ^ 1]) + s[41:] if r == at else s, p)
            for r, s, p in rows]


def items_of(rows, pkg, chunk):
    """The stream a server sends: one Beacon a round (chunk 0) or packed
    runs of at most `chunk` rounds, in the package's own types."""
    seg, beacon = pkg[2], pkg[3]
    if chunk:
        return list(seg.pack_rows(rows, max_chunk=chunk))
    return [beacon(*r) for r in rows]


class FakeNet:
    """sync_chain of each peer address: its items from `from_round`; a
    peer with `drop_after` set raises after that many items."""

    def __init__(self, streams, drop_after=None):
        self.streams = streams
        self.drop_after = drop_after or {}
        self.opened = []

    def sync_chain(self, peer, from_round):
        items = self.streams[peer.address]
        drop = self.drop_after.get(peer.address)
        self.opened.append(peer.address)

        async def gen():
            for k, it in enumerate(items):
                if drop is not None and k == drop:
                    raise ConnectionError("stream dropped")
                last = it.end_round if hasattr(it, "end_round") else it.round
                if last >= from_round:
                    yield it
        return gen()


def new_store(tmp_path, name, pkg, seed):
    store = pkg[1].new_chain_store(str(tmp_path / f"{name}.db"), Group(),
                                   workers=1)
    store.put(pkg[3](0, seed))
    return store


def table(path):
    con = sqlite3.connect(str(path))
    try:
        return con.execute("SELECT round, data FROM beacons "
                           "ORDER BY round").fetchall()
    finally:
        con.close()


def set_chunks(monkeypatch, chunk, growth, top):
    for mod in (SM, JSM):
        monkeypatch.setattr(mod, "SYNC_CHUNK", chunk)
        monkeypatch.setattr(mod, "SYNC_CHUNK_GROWTH", growth)
        monkeypatch.setattr(mod, "SYNC_CHUNK_MAX", top)


def run_sync(tmp_path, name, pkg, chain, streams, up_to=N, drop_after=None,
             peers=None, seen_sizes=None):
    """One SyncManager.sync of a fresh store (genesis seeded) from the
    given peers' streams: (return value, stats, progress, table, the
    peers whose streams were opened)."""
    rows, pk, seed, cv, jcv = chain
    store = new_store(tmp_path, name, pkg, seed)
    verifier = cv if pkg is PORT else jcv
    if seen_sizes is not None:
        # segmentation only: every segment passes at once, so no verify
        # holds the loop past the manager's idle window
        class Sized:
            def verify_chain_segment_async(self, seg, anchor):
                seen_sizes.append(len(seg))
                return lambda: np.ones(len(seg), dtype=bool)

            verify_packed_segment_async = verify_chain_segment_async
        verifier = Sized()
    net = FakeNet(streams, drop_after)
    nodes = [Peer(a) for a in (peers or list(streams))]
    mgr = pkg[0].SyncManager(store, Group(), verifier, net, nodes,
                             FixedClock(),
                             insecure_store=store.insecure)
    progress = []
    mgr.on_progress = lambda r, t: progress.append((r, t))
    random.seed(11)
    ok = asyncio.run(asyncio.wait_for(
        mgr.sync(pkg[0].SyncRequest(1, up_to=up_to)), 120))
    store.close()
    return ok, dict(mgr.stats), progress, table(tmp_path / f"{name}.db"), \
        net.opened


def counters(stats):
    return stats["segments"], stats["rounds"]


@pytest.mark.parametrize("chunk", [0, 8])
@pytest.mark.parametrize("damage", [None, 30])
def test_sync_matches_reference(tmp_path, monkeypatch, chain, chunk, damage):
    """A clean chain, and one whose round 30 is flipped, over the
    per-beacon wire and the chunked one: the same return value, segments,
    rounds, progress and committed rows as drand_tpu's manager."""
    set_chunks(monkeypatch, 8, 2, 16)
    rows = chain[0] if damage is None else flipped(chain[0], damage)
    got = {}
    for name, pkg in (("ours", PORT), ("ref", REF)):
        got[name] = run_sync(tmp_path, name, pkg, chain,
                             {"a": items_of(rows, pkg, chunk)})
    (ok, stats, prog, tab, _), (jok, jstats, jprog, jtab, _) = \
        got["ours"], got["ref"]
    assert ok == jok and counters(stats) == counters(jstats)
    assert prog == jprog and tab == jtab
    if damage is None:
        assert ok is True and counters(stats) == (5, N) and len(tab) == N + 1
    else:
        # segments 1-8 and 9-24 commit; the third holds round 30
        assert ok is False and counters(stats) == (2, 24)
        assert [r for r, _ in tab] == list(range(25))


def test_stream_drop_mid_chunk_matches_reference(tmp_path, monkeypatch,
                                                 chain):
    """Peer "a" drops its stream mid-chunk (after round 20, inside the
    second segment): alone, both managers keep the first segment and
    report failure; with a clean peer "b" beside it, both end at the
    chain's tip with the same rows."""
    set_chunks(monkeypatch, 8, 2, 16)
    rows = chain[0]
    for peers in (["a"], ["a", "b"]):
        got = {}
        for name, pkg in (("ours", PORT), ("ref", REF)):
            streams = {"a": items_of(rows, pkg, 0),
                       "b": items_of(rows, pkg, 8)}
            got[name] = run_sync(tmp_path, f"{name}-{len(peers)}", pkg,
                                 chain, streams, drop_after={"a": 20},
                                 peers=peers)
        ours, ref = got["ours"], got["ref"]
        assert ours[0] == ref[0] and ours[2:] == ref[2:]
        if peers == ["a"]:
            assert ours[0] is False
            assert [r for r, _ in ours[3]] == list(range(9))
        else:
            assert ours[0] is True and len(ours[3]) == N + 1


def test_adaptive_chunk_growth_matches_reference(tmp_path, monkeypatch,
                                                 chain):
    """The segment sizes the verifier sees (a stub that passes every
    segment at once): SYNC_CHUNK, then growing by SYNC_CHUNK_GROWTH up to
    SYNC_CHUNK_MAX while the stream keeps chunks full, the tail short;
    and the shipped constants."""
    assert (SM.SYNC_CHUNK, SM.SYNC_CHUNK_GROWTH, SM.SYNC_CHUNK_MAX,
            SM.STALL_FACTOR, SM.PIPELINE_DEPTH) == \
        (JSM.SYNC_CHUNK, JSM.SYNC_CHUNK_GROWTH, JSM.SYNC_CHUNK_MAX,
         JSM.STALL_FACTOR, JSM.PIPELINE_DEPTH) == (512, 32, 16384, 2, 2)
    set_chunks(monkeypatch, 4, 2, 16)
    sizes = {}
    for chunk in (0, 4):
        for name, pkg in (("ours", PORT), ("ref", REF)):
            seen = []
            run_sync(tmp_path, f"{name}-{chunk}", pkg, chain,
                     {"a": items_of(chain[0], pkg, chunk)}, seen_sizes=seen)
            sizes[name, chunk] = seen
    assert sizes["ours", 0] == sizes["ref", 0] == \
        sizes["ours", 4] == sizes["ref", 4] == [4, 8, 16, 16, 16, 5]


def test_pipeline_two_segments_against_sequential(tmp_path, monkeypatch):
    """Two 64-round unchained segments through the real pipeline and the
    port's real ChainVerifier/Verifier batch path (bucket 64, one
    "verify" record each), with the device check itself stubbed by the
    native tier's verdicts: device work is issued only from the pack
    stage, one issue at a time and never while a resolver runs; the
    resolvers run in the settle stage; the rows committed equal a
    sequential verify-then-commit of the same segments; a flipped round
    in the second segment keeps the first."""
    monkeypatch.setattr(SM, "SYNC_CHUNK", 64)
    monkeypatch.setattr(SM, "SYNC_CHUNK_GROWTH", 1)
    sk_pk = TFX.fixture_keypair()
    pk = GC.g1_to_bytes(sk_pk[1])
    sigs = np.load(UNCHAINED_512)[:128]
    seed = b"\x05" * 32
    scheme = S.scheme_by_id(UNCHAINED)
    rows = [(r + 1, bytes(sigs[r]), b"") for r in range(128)]
    state = threading.local()
    log = []
    busy = {"issue": 0, "resolve": 0}
    lock = threading.Lock()

    def make_verifier():
        cv = ChainVerifier(scheme, pk, device="cpu")

        def on_device(msgs, sig_rows, merged=None):
            import hashlib
            import torch
            with lock:
                assert busy["issue"] == 0 and busy["resolve"] == 0
                busy["issue"] += 1
            log.append(("issue", getattr(state, "stage", None)))
            ok = [native.verify_g2(pk, hashlib.sha256(m.tobytes()).digest(),
                                   s.tobytes(), scheme.shape.dst)
                  for m, s in zip(msgs, sig_rows)]
            with lock:
                busy["issue"] -= 1
            return torch.tensor(ok)
        cv._verifier.verify_on_device = on_device
        inner = cv.verify_packed_segment_async

        def packed(seg, anchor):
            state.stage = "pack"
            try:
                resolve = inner(seg, anchor)
            finally:
                state.stage = None

            def resolver():
                with lock:
                    busy["resolve"] += 1
                log.append(("resolve", seg.start_round))
                try:
                    return resolve()
                finally:
                    with lock:
                        busy["resolve"] -= 1
            return resolver
        cv.verify_packed_segment_async = packed
        return cv

    def run(name, stream_rows):
        store = ST.new_chain_store(str(tmp_path / name),
                                   type("G", (Group,), {"scheme_id":
                                                         UNCHAINED}),
                                   workers=1)
        store.put(Beacon(0, seed))
        mgr = SM.SyncManager(store, Group(), make_verifier(),
                             FakeNet({"a": items_of(stream_rows, PORT, 16)}),
                             [Peer("a")], FixedClock(), store.insecure)
        DSP.DISPATCH.clear()
        log.clear()
        ok = asyncio.run(asyncio.wait_for(
            mgr.sync(SM.SyncRequest(1, up_to=128)), 60))
        store.close()
        recs = [(r.n, r.bucket) for r in DSP.DISPATCH.records("verify")]
        return ok, dict(mgr.stats), recs, list(log), table(tmp_path / name)

    ok, stats, recs, events, tab = run("piped.db", rows)
    assert ok is True and counters(stats) == (2, 128)
    assert recs == [(64, 64), (64, 64)]
    assert [e for e in events if e[0] == "issue"] == [("issue", "pack")] * 2
    assert [e for e in events if e[0] == "resolve"] == \
        [("resolve", 1), ("resolve", 65)]

    # the same segments verified and committed one after the other
    seq = ST.new_chain_store(str(tmp_path / "seq.db"),
                             type("G", (Group,), {"scheme_id": UNCHAINED}),
                             workers=1)
    seq.put(Beacon(0, seed))
    cv = make_verifier()
    anchor = seed
    for lo in (0, 64):
        packed = SEG.PackedBeacons(1 + lo, sigs[lo:lo + 64], chained=False)
        assert cv.verify_packed_segment_async(packed, anchor)().all()
        seq.put_many(packed.beacons(anchor_sig=anchor))
        anchor = packed.tail_sig
    seq.close()
    assert tab == table(tmp_path / "seq.db")

    ok, stats, recs, events, tab = run("bad.db", flipped(rows, 100))
    assert ok is False and counters(stats) == (1, 64)
    assert tab == table(tmp_path / "seq.db")[:65]


def write_db(path, rows, seed):
    s = ST.SqliteStore(str(path))
    s.put_many([Beacon(0, seed)] + [Beacon(*r) for r in rows])
    s.close()


def tear(path, round_):
    con = sqlite3.connect(str(path))
    with con:
        blob = con.execute("SELECT data FROM beacons WHERE round = ?",
                           (round_,)).fetchone()[0]
        con.execute("UPDATE beacons SET data = ? WHERE round = ?",
                    (bytes(blob)[:40], round_))
    con.close()


def wire(items, conv):
    return [conv.item_to_packet(i).SerializeToString() for i in items]


def serve_all(mod, store, from_round, chunk):
    async def main():
        return [it async for it in mod.serve_sync_chain(
            store, from_round, chunk_size=chunk)]
    return asyncio.run(asyncio.wait_for(main(), 30))


@pytest.mark.parametrize("chunk", [0, 8, 512])
def test_serve_sync_chain_matches_reference(tmp_path, chain, chunk):
    """The items served from one database (port's SqliteStore, drand_tpu's
    on the same file), per-beacon and chunked, from round 0 and from
    round 17; with round 30's row torn, both end after round 29."""
    rows, _, seed = chain[0], chain[1], chain[2]
    path = tmp_path / "src.db"
    write_db(path, rows, seed)
    for start in (0, 17):
        ours = serve_all(SM, ST.SqliteStore(str(path)), start, chunk)
        ref = serve_all(JSM, JST.SqliteStore(str(path)), start, chunk)
        assert wire(ours, C) == wire(ref, JC)
    tear(path, 30)
    ours = serve_all(SM, ST.SqliteStore(str(path)), 1, chunk)
    ref = serve_all(JSM, JST.SqliteStore(str(path)), 1, chunk)
    assert wire(ours, C) == wire(ref, JC)
    last = ours[-1]
    assert (last.end_round if hasattr(last, "end_round")
            else last.round) == 29


def test_serve_live_tail_matches_reference(tmp_path, chain):
    """The stored backlog in chunks, then beacons committed later through
    a CallbackStore, handed across its pool thread to the stream's loop:
    the port's ServingProcess and drand_tpu's serve_sync_chain (its
    queue fed the way its BeaconProcess feeds it) stream the same
    items."""
    rows, _, seed = chain[0], chain[1], chain[2]
    got = {}
    for name, mod, pkg in (("ours", SM, PORT), ("ref", JSM, REF)):
        write_db(tmp_path / f"{name}.db", rows[:40], seed)
        store = pkg[1].CallbackStore(pkg[1].SqliteStore(
            str(tmp_path / f"{name}.db")), workers=1)

        async def main(store=store, mod=mod, pkg=pkg, name=name):
            if name == "ours":
                proc = ServingProcess(store, Info(b"k", 30, 0, seed))
                gen = proc.sync_chain_source(33, chunk_size=4)
            else:
                loop = asyncio.get_running_loop()
                q = asyncio.Queue(maxsize=64)
                store.add_callback("live", lambda b: loop.call_soon_threadsafe(
                    q.put_nowait, b))
                gen = mod.serve_sync_chain(store, 33, live_queue=q,
                                           chunk_size=4)
            out = [await gen.__anext__(), await gen.__anext__()]
            # the backlog ends at 40: the stream now waits on the live
            # queue, and the next commits reach it from the pool thread
            nxt = asyncio.ensure_future(gen.__anext__())
            await asyncio.sleep(0.2)
            assert not nxt.done()
            await asyncio.to_thread(store.put_many,
                                    [pkg[3](*r) for r in rows[40:43]])
            out.append(await nxt)
            out += [await gen.__anext__(), await gen.__anext__()]
            await gen.aclose()
            if name == "ours":
                assert proc._live_queues == []
            return out
        got[name] = asyncio.run(asyncio.wait_for(main(), 30))
        store._pool.shutdown(wait=True)
        store.close()
    assert wire(got["ours"], C) == wire(got["ref"], JC)
    assert [type(i).__name__ for i in got["ours"]] == \
        ["PackedBeacons", "PackedBeacons", "Beacon", "Beacon", "Beacon"]


def test_check_and_correct_past_beacons_match_reference(tmp_path,
                                                        monkeypatch, chain):
    """A stored chain with round 30's signature flipped: both managers'
    check_past_beacons report the same faulty rounds (30, and 31, whose
    link no longer holds), correct_past_beacons refetches them from a
    peer, verifies and overwrites them through the insecure base, and
    the stores end byte-equal to the clean chain."""
    set_chunks(monkeypatch, 16, 2, 32)
    rows, seed = chain[0], chain[2]
    got = {}
    for name, pkg in (("ours", PORT), ("ref", REF)):
        store = new_store(tmp_path, name, pkg, seed)
        store.put_many([pkg[3](*r) for r in rows])
        bad = flipped(rows, 30)[29]
        store.insecure.put(pkg[3](*bad))
        verifier = chain[3] if pkg is PORT else chain[4]
        net = FakeNet({"a": items_of(rows, pkg, 8)})
        mgr = pkg[0].SyncManager(store, Group(), verifier, net, [Peer("a")],
                                 FixedClock(), insecure_store=store.insecure)
        faulty = mgr.check_past_beacons()
        fixed = asyncio.run(asyncio.wait_for(
            mgr.correct_past_beacons(faulty), 60))
        again = mgr.check_past_beacons(up_to=40)
        store.close()
        got[name] = (faulty, fixed, again, table(tmp_path / f"{name}.db"))
    assert got["ours"] == got["ref"]
    assert got["ours"][:3] == ([30, 31], 2, [])
    clean = tmp_path / "clean.db"
    write_db(clean, rows, seed)
    assert got["ours"][3] == table(clean)
