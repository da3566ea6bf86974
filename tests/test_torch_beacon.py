"""The port's beacon engine against drand_tpu's on the same inputs, with
no tolerance: `PartialCache` and `Ticker` under `FakeClock`; one node's
`Handler` and `ChainStore` on `HostBackend` fed the same packets (good,
bad, duplicate, self-echo, unknown index, future round, settled round)
give the same verdicts, sends and commits; a three-node group on an
in-process network, halted for more than five rounds, recovers at the
catch-up period's cadence with the same commits in both packages; the
same group told `stop_at(2)` commits rounds 0-2 and nothing after in both;
and one node whose backend is `DeviceBackend(device="cpu")` coalesces a
burst of two partials into one call whose verdicts equal `HostBackend`'s.

Every wait runs under a time limit and every engine is stopped before
its test ends.
"""

import asyncio
import time
from types import SimpleNamespace

import pytest

from drand_tpu.beacon import cache as JCACHE
from drand_tpu.beacon import chain as JCH
from drand_tpu.beacon import clock as JCLK
from drand_tpu.beacon import node as JN
from drand_tpu.beacon import ticker as JTK
from drand_tpu.chain import scheme as JSC
from drand_tpu.chain import store as JSTORE
from drand_tpu.chain import verify as JV
from drand_tpu.key import group as JG
from drand_tpu.key import keys as JK
from drand_tpu_torch.beacon import cache as CACHE
from drand_tpu_torch.beacon import chain as CH
from drand_tpu_torch.beacon import clock as CLK
from drand_tpu_torch.beacon import node as NODE
from drand_tpu_torch.beacon import ticker as TK
from drand_tpu_torch.beacon.crypto_backend import DeviceBackend, HostBackend
from drand_tpu_torch.chain import scheme as SC
from drand_tpu_torch.chain import store as STORE
from drand_tpu_torch.chain import verify as V
from drand_tpu_torch.chain.time import current_round, next_round_at
from drand_tpu_torch.crypto import poly as P
from drand_tpu_torch.crypto import tbls
from drand_tpu_torch.crypto.bls12381 import curve as GC
from drand_tpu_torch.key import group as G
from drand_tpu_torch.key import keys as K

PERIOD = 4
GENESIS = 1_700_000_000
START = GENESIS - 10

PORT = SimpleNamespace(
    name="port", FakeClock=CLK.FakeClock, Ticker=TK.Ticker,
    Group=G.Group, Share=K.Share, Identity=K.Identity,
    new_chain_store=STORE.new_chain_store, scheme_by_id=SC.scheme_by_id,
    ChainVerifier=lambda s, pk: V.ChainVerifier(s, pk, device="cpu"),
    ChainStore=lambda *a: CH.ChainStore(*a, device="cpu"),
    PartialPacket=CH.PartialPacket, Handler=NODE.Handler,
    HandlerConfig=NODE.HandlerConfig)
REF = SimpleNamespace(
    name="ref", FakeClock=JCLK.FakeClock, Ticker=JTK.Ticker,
    Group=JG.Group, Share=JK.Share, Identity=JK.Identity,
    new_chain_store=JSTORE.new_chain_store, scheme_by_id=JSC.scheme_by_id,
    ChainVerifier=JV.ChainVerifier, ChainStore=JCH.ChainStore,
    PartialPacket=JCH.PartialPacket, Handler=JN.Handler,
    HandlerConfig=JN.HandlerConfig)


async def wait_for(pred, limit: float = 30.0, what: str = ""):
    """Poll pred() on the event loop until it holds; fail past `limit`
    seconds."""
    deadline = time.monotonic() + limit
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        await asyncio.sleep(0.005)


async def settle():
    """Let started tasks run up to their first await (a ticker registers
    its fake-clock sleeper there; an advance before that misses it)."""
    for _ in range(20):
        await asyncio.sleep(0)


def make_group(n, t, scheme, secret=4242):
    """A port group of n identities, its polynomial's shares by node
    index and the key pairs, as TOML and dicts for either package."""
    pairs = [K.Pair.generate(f"node{i}:1", seed=b"beacon%d" % i)
             for i in range(n)]
    poly = P.PriPoly.random(t, secret=secret)
    commits = [GC.g1_to_bytes(c) for c in poly.commit().commits]
    group = G.Group(threshold=t, period=PERIOD,
                    nodes=G.Group.sort_nodes([p.public for p in pairs]),
                    genesis_time=GENESIS, catchup_period=1, scheme_id=scheme,
                    public_key=K.DistPublic(commits))
    group.get_genesis_seed()
    by_addr = {p.public.address: p for p in pairs}
    nodes = []
    for node in group.nodes:
        share = K.Share(commits, poly.eval(node.index))
        nodes.append((by_addr[node.address].public.to_dict(),
                      share.to_dict()))
    return SimpleNamespace(toml=group.to_toml(), nodes=nodes, poly=poly,
                           group=group)


class Recorder:
    """A backend proxy keeping every verify_partials call's inputs and
    verdicts."""

    def __init__(self, backend):
        self._b = backend
        self.name = backend.name
        self.calls = []

    def verify_partials(self, msgs, partials):
        out = self._b.verify_partials(msgs, partials)
        self.calls.append((list(msgs), list(partials), list(out)))
        return out


class LocalNet:
    """In-process transport: a send calls the addressee's
    process_partial, unless the network is cut."""

    def __init__(self):
        self.handlers = {}
        self.cut = False
        self.sent = []

    async def send_partial(self, node, packet, deadline=None):
        self.sent.append((node.address, packet.round, packet.partial_sig))
        if not self.cut and node.address in self.handlers:
            await self.handlers[node.address].process_partial(packet)


def make_node(pkg, gp, i, folder, clock, net, backend=None):
    group = pkg.Group.from_toml(gp.toml)
    ident_d, share_d = gp.nodes[i]
    share = pkg.Share.from_dict(share_d)
    store = pkg.new_chain_store(str(folder / f"{pkg.name}{i}.db"), group)
    verifier = pkg.ChainVerifier(pkg.scheme_by_id(group.scheme_id),
                                 group.public_key.key_bytes())
    cs = pkg.ChainStore(store, group, share, verifier)
    if backend is not None:
        cs.backend = backend
    h = pkg.Handler(pkg.HandlerConfig(
        group=group, share=share, public_identity=pkg.Identity.from_dict(
            ident_d), clock=clock), cs, net, verifier)
    rec = Recorder(h.partials.backend)
    h.partials.backend = rec
    net.handlers[ident_d["Address"]] = h
    return h, rec


def rows(h):
    return [(b.round, b.signature, b.previous_sig)
            for b in h.chain.store.iter_range(0)]


# -- PartialCache -------------------------------------------------------------

def test_partial_cache_matches_reference(monkeypatch):
    monkeypatch.setattr(CACHE, "MAX_PARTIALS_PER_NODE", 3)
    monkeypatch.setattr(JCACHE, "MAX_PARTIALS_PER_NODE", 3)
    ours, theirs = CACHE.PartialCache(), JCACHE.PartialCache()
    ops = [("a", 1, b"p", 0, b"s0"), ("a", 1, b"p", 1, b"s1"),
           ("a", 1, b"p", 1, b"dup"), ("a", 1, b"q", 2, b"s2"),
           ("a", 2, b"p", 0, b"t0"), ("a", 3, b"p", 0, b"u0"),
           ("a", 4, b"p", 0, b"v0"), ("a", 1, b"p", 2, b"s2"),
           ("a", 1, b"p", 3, b"s3"), ("a", 1, b"p", 4, b"s4"),
           ("f", 1), ("a", 4, b"p", 0, b"v0"), ("a", 5, b"p", 5, b"w5"),
           ("f", 4), ("a", 2, b"p", 1, b"late")]
    for op in ops:
        if op[0] == "f":
            ours.flush_rounds(op[1])
            theirs.flush_rounds(op[1])
        else:
            a, b = ours.append(*op[1:]), theirs.append(*op[1:])
            assert (a is None) == (b is None), op
            if a is not None:
                assert (a.round, a.prev_sig, a.partials(), len(a)) == \
                    (b.round, b.prev_sig, b.partials(), len(b)), op
        assert sorted(ours.rounds()) == sorted(theirs.rounds()), op
        assert len(ours) == len(theirs), op
        assert ours._per_signer == theirs._per_signer, op
    got = ours.get(5, b"p")
    assert got.partials() == theirs.get(5, b"p").partials() == [(5, b"w5")]
    assert ours.get(1, b"p") is None and theirs.get(1, b"p") is None


# -- Ticker and FakeClock -----------------------------------------------------

@pytest.mark.parametrize("start", [START, GENESIS + 2 * PERIOD + 1])
def test_ticker_under_fake_clock_matches_reference(start):
    async def ticks(pkg):
        clock = pkg.FakeClock(start)
        tk = pkg.Ticker(clock, PERIOD, GENESIS)
        q = tk.channel(maxsize=4)
        tk.start()
        seen = []
        for step in (1, 10, PERIOD, 0.5, 3 * PERIOD, PERIOD, PERIOD):
            await clock.advance(step)
            while not q.empty():
                info = q.get_nowait()
                seen.append((info.round, info.time))
            seen.append(("now", clock.now(), tk.current_round()))
        tk.stop()
        return seen

    async def main():
        return await asyncio.wait_for(
            asyncio.gather(ticks(PORT), ticks(REF)), 30)

    ours, theirs = asyncio.run(main())
    assert ours == theirs
    assert any(isinstance(r, int) for r, *_ in ours)


def test_fake_clock_sleepers_match_reference():
    async def run(pkg):
        clock = pkg.FakeClock(100.0)
        woke = []

        async def sleeper(name, secs):
            await clock.sleep(secs)
            woke.append((name, clock.now()))

        tasks = [asyncio.ensure_future(sleeper(n, s))
                 for n, s in (("a", 5), ("b", 1), ("c", 3), ("d", 0))]
        await clock.advance(2)
        await clock.set_time(104)
        await clock.sleep_until(90)
        await clock.advance(10)
        await asyncio.gather(*tasks)
        return woke, clock.now()

    async def main():
        return await asyncio.wait_for(
            asyncio.gather(run(PORT), run(REF)), 30)

    ours, theirs = asyncio.run(main())
    assert ours == theirs
    assert ours[1] == 114


# -- one node's Handler and ChainStore ---------------------------------------

def test_handler_packets_match_reference(tmp_path):
    """Both packages' engines, each fed the same packets for round 1:
    the same verdicts, the same sends and the same commit."""
    gp = make_group(4, 3, "pedersen-bls-chained")
    me = 0
    shares = {i: P.PriShare(i, gp.poly.eval(i).value) for i in range(4)}
    seed = gp.group.get_genesis_seed()

    async def run(pkg):
        clock = pkg.FakeClock(START)
        net = LocalNet()
        h, rec = make_node(pkg, gp, me, tmp_path, clock, net)
        msg1 = h.verifier.digest_message(1, seed)
        msg3 = h.verifier.digest_message(3, seed)

        def packet(rnd, partial):
            return pkg.PartialPacket(round=rnd, previous_signature=seed,
                                     partial_sig=partial)

        good1 = tbls.sign_partial(shares[1], msg1)
        good2 = tbls.sign_partial(shares[2], msg1)
        bad = good2[:40] + bytes([good2[40] ^ 1]) + good2[41:]
        unknown = tbls.sign_partial(P.PriShare(7, gp.poly.eval(7).value),
                                    msg1)
        try:
            await h.start()
            await settle()
            await clock.set_time(GENESIS)
            await wait_for(lambda: len(net.sent) == 3, what="own partial")
            for p in (packet(3, tbls.sign_partial(shares[1], msg3)),
                      packet(1, unknown),
                      packet(1, tbls.sign_partial(shares[me], msg1)),
                      packet(1, bad), packet(1, good1), packet(1, good1)):
                await asyncio.wait_for(h.process_partial(p), 30)
            assert h.chain.tip_round() == 0
            await asyncio.wait_for(h.process_partial(packet(1, good2)), 30)
            await wait_for(lambda: h.chain.tip_round() == 1, what="round 1")
            await asyncio.wait_for(h.process_partial(
                packet(1, tbls.sign_partial(shares[3], msg1))), 30)
            return (rows(h), rec.calls, sorted(net.sent),
                    sorted(h.chain.cache.rounds()))
        finally:
            h.stop()

    async def main():
        return await run(PORT), await run(REF)

    ours, theirs = asyncio.run(main())
    assert ours[0] == theirs[0] and ours[2:] == theirs[2:]
    assert [c[2] for c in ours[1]] == [[False], [True], [True], [True]]
    # drand_tpu also checks the settled round's late partial for its
    # participation ledger; the port, which has no ledger, drops it
    # unchecked
    assert ours[1] == theirs[1][:4]
    assert [tbls.index_of(p) for p in theirs[1][4][1]] == [3]
    assert len(theirs[1]) == 5
    assert [r for r, _, _ in ours[0]] == [0, 1]
    assert ours[3] == []


# -- a halted group's fast-forward -------------------------------------------

@pytest.mark.parametrize("scheme", ["pedersen-bls-unchained",
                                    "pedersen-bls-chained"])
def test_halted_group_recovers_at_catchup_cadence(tmp_path, scheme):
    """Three nodes, t = 2, on an in-process network: rounds 1-2, then the
    network is cut for more than five periods (each node alone, below
    threshold), then healed.  One period tick restarts production and
    each aggregated round behind the clock brings the next one a
    catch-up period later; both packages commit the same rows, and the
    fake time spent stays within two catch-up periods a round, as
    drand_tpu's tests/test_scenario.py asks of drand_tpu."""
    gp = make_group(3, 2, scheme)

    async def run(pkg):
        clock = pkg.FakeClock(START)
        net = LocalNet()
        nodes = [make_node(pkg, gp, i, tmp_path, clock, net)[0]
                 for i in range(3)]
        sync_asks = []
        for h in nodes:
            h.on_sync_needed = sync_asks.append

        def tips():
            return [h.chain.tip_round() for h in nodes]

        try:
            for h in nodes:
                await h.start()
            await settle()
            for r in (1, 2):
                await clock.set_time(GENESIS + (r - 1) * PERIOD)
                await wait_for(lambda: min(tips()) >= r, what=f"round {r}")
            net.cut = True
            await clock.advance(6 * PERIOD)
            stalled = min(tips())
            gap = current_round(clock.now(), PERIOD, GENESIS) - stalled
            assert stalled == 2 and gap >= 5, (tips(), gap)
            net.cut = False
            _, t_next = next_round_at(clock.now(), PERIOD, GENESIS)
            await clock.set_time(t_next)
            await wait_for(lambda: min(tips()) >= stalled + 1,
                           what="the restart round")
            target = current_round(clock.now(), PERIOD, GENESIS)
            spent = 0.0
            deadline = time.monotonic() + 60
            while min(tips()) < target:
                assert time.monotonic() < deadline, (tips(), target)
                before = min(tips())
                await clock.advance(1)
                spent += 1
                try:
                    await wait_for(lambda: min(tips()) > before, 2.0)
                except AssertionError:
                    pass        # the advance fired before the sleeper
            closed = min(tips()) - stalled - 1
            assert closed >= 5 and spent <= 2 * closed, (closed, spent)
            return [rows(h) for h in nodes], sorted(set(sync_asks))
        finally:
            for h in nodes:
                h.stop()

    async def main():
        return await run(PORT), await run(REF)

    (ours, asks), (theirs, jasks) = asyncio.run(main())
    assert ours == theirs
    assert ours[0] == ours[1] == ours[2]
    # the gap the first tick after the cut sees: a sync from round 3
    assert min(asks) == min(jasks) == 3
    assert [r for r, _, _ in ours[0]] == list(range(len(ours[0])))


def test_stop_at_ends_production_as_reference(tmp_path):
    """Three nodes, t = 2, each told `stop_at(2)`: both packages commit
    rounds 0-2, send no partial for a later round, and stop their run
    loop at the round-3 tick, the clock then past round 4."""
    gp = make_group(3, 2, "pedersen-bls-chained")

    async def run(pkg):
        clock = pkg.FakeClock(START)
        net = LocalNet()
        nodes = [make_node(pkg, gp, i, tmp_path, clock, net)[0]
                 for i in range(3)]

        def tips():
            return [h.chain.tip_round() for h in nodes]

        try:
            for h in nodes:
                h.stop_at(2)
                await h.start()
            await settle()
            for r in (1, 2):
                await clock.set_time(GENESIS + (r - 1) * PERIOD)
                await wait_for(lambda: min(tips()) >= r, what=f"round {r}")
            for r in (3, 4):
                await clock.set_time(GENESIS + (r - 1) * PERIOD)
                await settle()
            await wait_for(lambda: not any(h._running for h in nodes),
                           what="the run loops' stop")
            await asyncio.sleep(0.2)
            return ([rows(h) for h in nodes], tips(),
                    sorted({r for _, r, _ in net.sent}))
        finally:
            for h in nodes:
                h.stop()

    async def main():
        return await run(PORT), await run(REF)

    ours, theirs = asyncio.run(main())
    assert ours == theirs
    assert ours[1] == [2, 2, 2] and ours[2] == [1, 2]
    assert [r for r, _, _ in ours[0][0]] == [0, 1, 2]
    assert ours[0][0] == ours[0][1] == ours[0][2]


# -- the device backend on the CPU -------------------------------------------

def test_device_backend_node_coalesces_a_burst(tmp_path):
    """A node whose ChainStore holds DeviceBackend(device="cpu"): two
    partials arriving together become one verify_partials call of two
    (bucket 4), their verdicts HostBackend's, and round 1 commits."""
    gp = make_group(4, 3, "pedersen-bls-unchained")
    pub = gp.poly.commit()
    shares = {i: P.PriShare(i, gp.poly.eval(i).value) for i in range(4)}

    async def main():
        clock = CLK.FakeClock(START)
        net = LocalNet()
        h, rec = make_node(PORT, gp, 0, tmp_path, clock, net,
                           backend=DeviceBackend(pub, 3, 4, device="cpu"))
        assert (h.partials.max_delay, h.partials.max_batch) == \
            (NODE.WINDOW_DEVICE_S, NODE.BATCH_DEVICE)
        msg = h.verifier.digest_message(1, b"")
        good = tbls.sign_partial(shares[1], msg)
        other = tbls.sign_partial(shares[2], msg)
        try:
            await h.start()
            await settle()
            await clock.set_time(GENESIS)
            await asyncio.wait_for(asyncio.gather(*[
                h.process_partial(CH.PartialPacket(1, b"", p))
                for p in (good, other)]), 120)
            await wait_for(lambda: h.chain.tip_round() == 1, what="round 1")
            return rec.calls, msg, [good, other]
        finally:
            h.stop()

    calls, msg, parts = asyncio.run(main())
    assert len(calls) == 1
    assert calls[0][1] == parts and calls[0][2] == [True, True]
    assert HostBackend(pub, 3, 4).verify_partials([msg] * 2, parts) == \
        calls[0][2]
