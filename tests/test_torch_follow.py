"""Catch-up from a peer over real gRPC on localhost, on the CPU: the port's
follower (`core.follow.follow_chain`, its SyncManager and
GrpcBeaconNetwork) syncing from a drand_tpu peer, drand_tpu's
GrpcBeaconNetwork and SyncManager syncing from the port's gateway
(`net.gateway.PrivateGateway` over `core.services` and a
`core.process.ServingProcess`), both into stores byte-equal to the
source; a damaged peer beside a good one and alone ("follow stalled" at
the verified prefix); a chain hash that does not match; and `cli sync`
with and without `--follow` (a subprocess, and check-and-repair in
process).

Real signatures: the committed 65-round pedersen-bls-chained fixture.
Every segment stays at most 32 rounds (patched SYNC_CHUNK, the serving
chunk, or `--up-to 32` in the subprocess), so both packages verify on
their native host tier.  Every awaited RPC runs under a time limit.
"""

import asyncio
import json
import os
import shutil
import sqlite3
import subprocess
import sys
import threading
from pathlib import Path

import pytest

grpc = pytest.importorskip("grpc")

import drand_tpu.beacon.sync_manager as JSM  # noqa: E402
from drand_tpu.chain import scheme as JS  # noqa: E402
from drand_tpu.chain import store as JST  # noqa: E402
from drand_tpu.chain.beacon import Beacon as JBeacon  # noqa: E402
from drand_tpu.chain.info import Info as JInfo  # noqa: E402
from drand_tpu.chain.verify import ChainVerifier as JChainVerifier  # noqa: E402
from drand_tpu.core import convert as JC  # noqa: E402
from drand_tpu.key.group import Node as JNode  # noqa: E402
from drand_tpu.net import client as JNC  # noqa: E402
from drand_tpu.net import gateway as JGW  # noqa: E402
from drand_tpu.net import rpc as JRPC  # noqa: E402
import drand_tpu_torch.beacon.sync_manager as SM  # noqa: E402
from drand_tpu_torch import cli  # noqa: E402
from drand_tpu_torch import fixtures as TFX  # noqa: E402
from drand_tpu_torch.chain import store as ST  # noqa: E402
from drand_tpu_torch.chain.beacon import Beacon  # noqa: E402
from drand_tpu_torch.chain.info import Info  # noqa: E402
from drand_tpu_torch.core import follow as FW  # noqa: E402
from drand_tpu_torch.core import services as SV  # noqa: E402
from drand_tpu_torch.core.process import ServingProcess  # noqa: E402
from drand_tpu_torch.net.client import (GrpcBeaconNetwork, Peer,  # noqa: E402
                                        PeerClients)
from drand_tpu_torch.net.gateway import PrivateGateway  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CHAINED = "pedersen-bls-chained"
N = 65
GENESIS = 1_600_000_000


class Group:
    period = 30
    genesis_time = GENESIS
    scheme_id = CHAINED


class Clock:
    """Round 100 of the chain: later than the fixture's tip."""

    def now(self):
        return GENESIS + 30 * 99 + 1


@pytest.fixture(scope="module")
def chain():
    sigs, pk, seed = TFX.load_chained_fixture()
    rows, prev = [], seed
    for i in range(N):
        rows.append((i + 1, bytes(sigs[i]), prev))
        prev = bytes(sigs[i])
    return rows, pk, seed, Info(pk, 30, GENESIS, seed)


@pytest.fixture
def small_chunks(monkeypatch):
    """Segments of at most 23 rounds: flushes at 8, then 16, on items of
    at most 8 rounds."""
    for mod in (SM, JSM):
        monkeypatch.setattr(mod, "SYNC_CHUNK", 8)
        monkeypatch.setattr(mod, "SYNC_CHUNK_GROWTH", 2)
        monkeypatch.setattr(mod, "SYNC_CHUNK_MAX", 16)
    monkeypatch.setattr(SV, "WIRE_CHUNK_DEFAULT", 8)


def flipped(rows, at):
    return [(r, s[:40] + bytes([s[40] ^ 1]) + s[41:] if r == at else s, p)
            for r, s, p in rows]


def source(path, rows, seed, flip=None):
    """A port chain store (the full stack) of genesis and `rows`, round
    `flip`'s signature then flipped through the insecure base."""
    store = ST.new_chain_store(str(path), Group(), workers=1)
    store.put(Beacon(0, seed))
    store.put_many([Beacon(*r) for r in rows])
    if flip is not None:
        store.insecure.put(Beacon(*flipped(rows, flip)[flip - 1]))
    return store


def table(path):
    con = sqlite3.connect(str(path))
    try:
        return con.execute("SELECT round, data FROM beacons "
                           "ORDER BY round").fetchall()
    finally:
        con.close()


async def port_gateway(procs: dict):
    """The port's gateway on a free localhost port, started."""
    gw = PrivateGateway("127.0.0.1:0", SV.ProtocolService(procs),
                        SV.PublicService(procs))
    await gw.start()
    return gw


async def follow(addresses, folder, info, up_to=N, chain_hash=None):
    peers = PeerClients()
    progress = []
    try:
        async for cur, target in FW.follow_chain(
                peers, addresses, str(folder), Clock(),
                chain_hash=info.hash() if chain_hash is None else chain_hash,
                up_to=up_to, device="cpu"):
            progress.append((cur, target))
    finally:
        await peers.close()
    return progress


class RefPeer:
    """A drand_tpu peer: its SyncChain streams drand_tpu's
    serve_sync_chain items (chunks of at most 8 rounds to a client that
    asks for chunks), its ChainInfo drand_tpu's packet."""

    def __init__(self, store, info):
        self.store, self.info = store, info

    async def SyncChain(self, request, context):
        chunk = min(int(request.chunk_size), 8)
        async for item in JSM.serve_sync_chain(self.store, request.from_round,
                                               chunk_size=chunk):
            yield JC.item_to_packet(item)

    async def ChainInfo(self, request, context):
        return JC.info_to_proto(self.info)


def test_port_follower_from_reference_peer(tmp_path, chain, small_chunks):
    """follow_chain from a drand_tpu peer: progress from (0, 65) to (65,
    65) and a store byte-equal to the peer's."""
    rows, pk, seed, info = chain
    src = JST.SqliteStore(str(tmp_path / "ref.db"))
    src.put_many([JBeacon(0, seed)] + [JBeacon(*r) for r in rows])
    jinfo = JInfo(pk, 30, GENESIS, seed)
    assert jinfo.hash() == info.hash()

    async def main():
        impl = RefPeer(src, jinfo)
        server = JGW._server()
        server.add_generic_rpc_handlers((
            JRPC.service_handler("Protocol", impl, validate_version=True),
            JRPC.service_handler("Public", impl, validate_version=True)))
        port = server.add_insecure_port("127.0.0.1:0")
        await server.start()
        try:
            return await follow([f"127.0.0.1:{port}"], tmp_path / "f", info)
        finally:
            await server.stop(0)
    progress = asyncio.run(asyncio.wait_for(main(), 90))
    src.close()
    assert progress[0] == (0, N) and progress[-1] == (N, N)
    assert table(tmp_path / "f" / FW.DB_NAME) == table(tmp_path / "ref.db")


def test_reference_follower_from_port_gateway(tmp_path, chain, small_chunks,
                                              monkeypatch):
    """drand_tpu's ChainInfo stub, GrpcBeaconNetwork.status (equal to the
    port's own status call) and SyncManager against the port's gateway:
    the chain hash, the store's status, and a store byte-equal to the
    port peer's."""
    rows, pk, seed, info = chain
    monkeypatch.setenv("DRAND_TPU_SYNC_WIRE_CHUNK", "8")
    src = source(tmp_path / "port.db", rows, seed)
    dst = JST.new_chain_store(str(tmp_path / "ref.db"), Group(), workers=1)
    dst.put(JBeacon(0, seed))

    async def main():
        gw = await port_gateway({"default": ServingProcess(src, info)})
        peers = JNC.PeerClients()
        try:
            addr = f"127.0.0.1:{gw.port}"
            pkt = await JRPC.ServiceStub(peers.channel(addr),
                                         "Public").ChainInfo(
                JC.drand_pb2.ChainInfoRequest(), timeout=10)
            assert JC.info_from_proto(pkt).hash() == info.hash()
            net = JNC.GrpcBeaconNetwork(peers)
            status = await asyncio.wait_for(
                net.status(JNode(key=b"", address=addr, index=0)), 10)
            assert status["chain_store"] == {"last_round": N,
                                             "length": N + 1,
                                             "is_empty": False}
            ours = PeerClients()
            try:
                assert await asyncio.wait_for(GrpcBeaconNetwork(ours).status(
                    Peer(addr)), 10) == status
            finally:
                await ours.close()
            mgr = JSM.SyncManager(dst, Group(), JChainVerifier(
                JS.scheme_by_id(CHAINED), pk), net,
                [JNode(key=b"", address=addr, index=0)], Clock(),
                insecure_store=dst.insecure)
            return await mgr.sync(JSM.SyncRequest(1, up_to=N)), mgr.stats
        finally:
            await peers.close()
            await gw.stop()
    ok, stats = asyncio.run(asyncio.wait_for(main(), 90))
    dst.close()
    src.close()
    assert ok is True and stats["rounds"] == N
    assert table(tmp_path / "ref.db") == table(tmp_path / "port.db")


def test_damaged_peer_renewal_and_stall(tmp_path, chain, small_chunks):
    """Peer B serves round 30 flipped, peer A the clean chain: given [B,
    A] the follower ends at 65 with A's rows whichever it tries first;
    given [B] alone it stops at the verified prefix (segments 1-8 and
    9-24) with "follow stalled"; a pinned hash no peer has is refused."""
    rows, pk, seed, info = chain
    good = source(tmp_path / "a.db", rows, seed)
    bad = source(tmp_path / "b.db", rows, seed, flip=30)

    async def main():
        gwa = await port_gateway({"default": ServingProcess(good, info)})
        gwb = await port_gateway({"default": ServingProcess(bad, info)})
        a, b = f"127.0.0.1:{gwa.port}", f"127.0.0.1:{gwb.port}"
        try:
            both = await follow([b, a], tmp_path / "both", info)
            with pytest.raises(FW.FollowStalled,
                               match="follow stalled at round 24/65"):
                await follow([b], tmp_path / "alone", info)
            with pytest.raises(RuntimeError, match="no peer returned"):
                await follow([a], tmp_path / "pinned", info,
                             chain_hash=b"\x01" * 32)
            return both
        finally:
            await gwa.stop()
            await gwb.stop()
    both = asyncio.run(asyncio.wait_for(main(), 120))
    good.close()
    bad.close()
    assert both[-1] == (N, N)
    assert table(tmp_path / "both" / FW.DB_NAME) == table(tmp_path / "a.db")
    assert table(tmp_path / "alone" / FW.DB_NAME) == \
        table(tmp_path / "a.db")[:25]


def run_cli(args, timeout=120):
    """cli.main(args) in a thread, failing the test if it has not
    returned within `timeout` seconds."""
    out = {}
    t = threading.Thread(target=lambda: out.setdefault("rc", cli.main(args)),
                         daemon=True)
    t.start()
    t.join(timeout)
    assert "rc" in out, f"cli {args[:1]} did not return in {timeout} s"
    return out["rc"]


class ThreadedGateway:
    """The port's gateway on its own event loop in a thread, so this
    thread can run a CLI (subprocess, or its own asyncio.run)."""

    def __init__(self, procs):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever)
        self.thread.start()
        self.gw = asyncio.run_coroutine_threadsafe(
            port_gateway(procs), self.loop).result(30)
        self.address = f"127.0.0.1:{self.gw.port}"

    def close(self):
        asyncio.run_coroutine_threadsafe(self.gw.stop(),
                                         self.loop).result(30)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(30)
        self.loop.close()


def test_cli_sync_follow_subprocess(tmp_path, chain):
    """`python -m drand_tpu_torch.cli sync --follow --device cpu` in a
    fresh process against a port peer: exit 0, one JSON object with ok,
    synced_to 32, the target and the manager's stats, rows equal to the
    source's first 32 rounds (one 32-round segment on the host tier)."""
    rows, pk, seed, info = chain
    src = source(tmp_path / "src.db", rows, seed)
    gw = ThreadedGateway({"default": ServingProcess(src, info)})
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "drand_tpu_torch.cli", "sync", "--follow",
             "--sync-nodes", gw.address, "--db", str(tmp_path / "cli"),
             "--up-to", "32", "--chain-hash", info.hash().hex(),
             "--device", "cpu"],
            cwd=ROOT, capture_output=True, text=True, timeout=240)
    finally:
        gw.close()
        src.close()
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = json.loads(proc.stdout)
    assert (out["ok"], out["synced_to"], out["target"], out["error"]) == \
        (True, 32, 32, "")
    assert (out["stats"]["segments"], out["stats"]["rounds"]) == (1, 32)
    assert set(out["stats"]) == {"fetch_s", "pack_s", "verify_s",
                                 "commit_s", "segments", "rounds"}
    assert "sync 32/32" in proc.stderr
    assert table(tmp_path / "cli" / FW.DB_NAME) == \
        table(tmp_path / "src.db")[:33]


def test_cli_sync_check_and_repair(tmp_path, chain, small_chunks, capsys):
    """`cli sync` without --follow: check_past_beacons on the store finds
    rounds 30 and 31 (30 flipped), correct_past_beacons repairs them from
    the peer, exit 0 and the rows equal the peer's; a peer whose round
    30 is flipped as well repairs only round 31 (its own link holds),
    exit 1."""
    rows, pk, seed, info = chain
    src = source(tmp_path / "src.db", rows, seed)
    folder = tmp_path / "local"
    local = FW.open_follow_store(str(folder), info)[0]
    local.put_many([Beacon(*r) for r in rows])
    local.insecure.put(Beacon(*flipped(rows, 30)[29]))
    local.close()
    shutil.copytree(folder, tmp_path / "copy")
    gw = ThreadedGateway({"default": ServingProcess(src, info)})
    try:
        args = ["sync", "--sync-nodes", gw.address, "--chain-hash",
                info.hash().hex(), "--device", "cpu"]
        rc = run_cli(args + ["--db", str(folder)])
        out = json.loads(capsys.readouterr().out)
        short = source(tmp_path / "short.db", rows, seed, flip=30)
        gw2 = ThreadedGateway({"default": ServingProcess(short, info)})
        try:
            rc2 = run_cli(["sync", "--sync-nodes", gw2.address, "--device",
                           "cpu", "--db", str(tmp_path / "copy")])
            out2 = json.loads(capsys.readouterr().out)
        finally:
            gw2.close()
            short.close()
    finally:
        gw.close()
        src.close()
    assert rc == 0 and (out["ok"], out["faulty"], out["fixed"],
                        out["synced_to"], out["target"]) == \
        (True, [30, 31], 2, N, N)
    assert table(folder / FW.DB_NAME) == table(tmp_path / "src.db")
    assert rc2 == 1 and (out2["ok"], out2["faulty"], out2["fixed"]) == \
        (False, [30, 31], 1)
    assert os.path.exists(tmp_path / "copy" / FW.DB_NAME)
