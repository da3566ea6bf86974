"""Port beacon nodes over real gRPC on localhost, on the CPU (the host
tier checks partials), held against drand_tpu: a 4-node, t = 3 group of
port daemons under one FakeClock produces rounds 1-3 with both chained
schemes, its stores byte-equal to each other and to the group secret's
signatures, and drand_tpu's ChainVerifier accepts them; its services
answer PublicRand, PublicRandStream, GetIdentity, Status and ChainInfo;
a mixed 3-node, t = 2 group of two port daemons and one drand_tpu
DrandDaemon, all loading the same group and share files, produces three
rounds with partials crossing both ways, its three stores byte-equal and
PublicRand answering byte-equal from both packages; and `cli start`
serves GetIdentity and PublicRand in a subprocess and exits 0 on
SIGTERM, and without --tls-disable exits with drand_tpu's message.

Daemons start on 127.0.0.1:0 before the group exists (a group names each
node's address), as drand_tpu's scenario harness starts them
(`drand_tpu/chaos/runner.py`).  Every wait runs under a time limit, and
every daemon, channel and subprocess is stopped before its test ends.
"""

import asyncio
import importlib
import logging
import os
import queue
import signal
import socket
import sqlite3
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

grpc = pytest.importorskip("grpc")

from drand_tpu.chain import scheme as JSC  # noqa: E402
from drand_tpu.chain.beacon import Beacon as JBeacon  # noqa: E402
from drand_tpu.chain.verify import ChainVerifier as JChainVerifier  # noqa: E402
from drand_tpu.core import config as JCFG  # noqa: E402
from drand_tpu.core import daemon as JD  # noqa: E402
from drand_tpu.core import services as JSV  # noqa: E402
from drand_tpu.key import group as JG  # noqa: E402
from drand_tpu_torch import cli  # noqa: E402
from drand_tpu_torch.beacon.clock import FakeClock  # noqa: E402
from drand_tpu_torch.chain import codec  # noqa: E402
from drand_tpu_torch.chain.beacon import Beacon  # noqa: E402
from drand_tpu_torch.chain.scheme import scheme_by_id  # noqa: E402
from drand_tpu_torch.chain.verify import ChainVerifier  # noqa: E402
from drand_tpu_torch.core.config import Config  # noqa: E402
from drand_tpu_torch.core.daemon import DrandDaemon  # noqa: E402
from drand_tpu_torch.crypto import poly as P  # noqa: E402
from drand_tpu_torch.crypto import sign as S  # noqa: E402
from drand_tpu_torch.crypto.bls12381 import curve as GC  # noqa: E402
from drand_tpu_torch.key import group as G  # noqa: E402
from drand_tpu_torch.key import keys as K  # noqa: E402
from drand_tpu_torch.key.store import FileStore  # noqa: E402
from drand_tpu_torch.net.client import (GrpcBeaconNetwork,  # noqa: E402
                                        PeerClients, make_metadata)
from drand_tpu_torch.protogen import drand_pb2  # noqa: E402

# drand_tpu.cli exports its `main` function under the module's name
JCLI = importlib.import_module("drand_tpu.cli.main")
ROOT = Path(__file__).resolve().parents[1]
PERIOD = 3
START = 1_700_000_000.0
SECRET = 777


async def settle():
    for _ in range(20):
        await asyncio.sleep(0)


async def wait_for(pred, limit: float = 30.0, what: str = ""):
    deadline = time.monotonic() + limit
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        await asyncio.sleep(0.01)


def write_group(folders, pairs, t, scheme, genesis, secret=SECRET):
    """The group of `pairs` (sorted into share indices by key), each
    node's key pair, group and share written through the port's
    FileStore into its folder; returns the group and its polynomial."""
    poly = P.PriPoly.random(t, secret=secret)
    commits = [GC.g1_to_bytes(c) for c in poly.commit().commits]
    group = G.Group(threshold=t, period=PERIOD,
                    nodes=G.Group.sort_nodes([p.public for p in pairs]),
                    genesis_time=int(genesis), catchup_period=1,
                    scheme_id=scheme, public_key=K.DistPublic(commits))
    group.get_genesis_seed()
    for folder, pair in zip(folders, pairs):
        ks = FileStore(str(folder))
        ks.save_key_pair(pair)
        ks.save_group(group)
        ks.save_share(K.Share(commits, poly.eval(group.find(pair.public)
                                                 .index)))
    return group, poly


def db_rows(folder):
    con = sqlite3.connect(os.path.join(folder, "multibeacon", "default", "db",
                                       "drand.db"))
    try:
        return con.execute("SELECT round, data FROM beacons "
                           "ORDER BY round").fetchall()
    finally:
        con.close()


def group_sigs(group, poly, rounds):
    """The group secret's signatures of rounds 1..rounds, chained from the
    genesis seed when the scheme is."""
    cv = ChainVerifier(scheme_by_id(group.scheme_id),
                       group.public_key.key_bytes(), device="cpu")
    prev, out = group.genesis_seed, []
    for r in range(1, rounds + 1):
        p = b"" if cv.scheme.decouple_prev_sig else prev
        sig = S.bls_sign(poly.secret(), cv.digest_message(r, p))
        out.append(Beacon(r, sig, p))
        prev = sig
    return out


@pytest.mark.parametrize("scheme", ["pedersen-bls-chained",
                                    "pedersen-bls-unchained"])
def test_port_group_over_grpc(tmp_path, scheme):
    n, t, rounds = 4, 3, 3

    async def main():
        clock = FakeClock(START)
        daemons, pairs, folders = [], [], []
        peers = PeerClients()
        try:
            for i in range(n):
                folder = tmp_path / f"node{i}"
                d = DrandDaemon(Config(folder=str(folder),
                                       private_listen="127.0.0.1:0",
                                       clock=clock, device="cpu"))
                await d.start()
                daemons.append(d)
                folders.append(folder)
                pairs.append(K.Pair.generate(d.private_addr(),
                                             seed=b"port%d" % i))
            group, poly = write_group(folders, pairs, t, scheme,
                                      START + PERIOD)
            for d in daemons:
                assert await d.load_beacons_from_disk() == ["default"]
            await settle()
            addr0 = daemons[0].private_addr()
            pub = peers.public(addr0)
            md = make_metadata("default")
            stream = pub.PublicRandStream(drand_pb2.PublicRandRequest(
                round=0, metadata=md))

            def tips():
                return [d.processes["default"].chain_store.tip_round()
                        for d in daemons]

            for r in range(1, rounds + 1):
                await clock.set_time(group.genesis_time + (r - 1) * PERIOD)
                await wait_for(lambda: min(tips()) >= r, what=f"round {r}")
            streamed = []
            for _ in range(rounds):
                resp = await asyncio.wait_for(stream.read(), 30)
                streamed.append((resp.round, resp.signature))
            stream.cancel()
            tip = await asyncio.wait_for(pub.PublicRand(
                drand_pb2.PublicRandRequest(round=0, metadata=md)), 30)
            two = await asyncio.wait_for(pub.PublicRand(
                drand_pb2.PublicRandRequest(round=2, metadata=md)), 30)
            with pytest.raises(grpc.aio.AioRpcError) as missing:
                await asyncio.wait_for(pub.PublicRand(
                    drand_pb2.PublicRandRequest(round=99, metadata=md)), 30)
            ident = await asyncio.wait_for(GrpcBeaconNetwork(
                peers).get_identity(addr0), 30)
            status = await asyncio.wait_for(peers.protocol(addr0).Status(
                drand_pb2.StatusRequest(metadata=md)), 30)
            # an unknown beacon id with the chain hash: routed by the
            # daemon's map of chain hashes; without it, NOT_FOUND
            info = await asyncio.wait_for(pub.ChainInfo(
                drand_pb2.ChainInfoRequest(metadata=make_metadata(
                    "other", group.chain_info().hash()))), 30)
            with pytest.raises(grpc.aio.AioRpcError) as unknown:
                await asyncio.wait_for(pub.ChainInfo(
                    drand_pb2.ChainInfoRequest(
                        metadata=make_metadata("other"))), 30)
            assert unknown.value.code() == grpc.StatusCode.NOT_FOUND
            return (group, poly, [db_rows(f) for f in folders], streamed,
                    tip, two, missing.value.code(), ident, status, info)
        finally:
            await peers.close()
            for d in daemons:
                await d.stop()

    (group, poly, rows, streamed, tip, two, missing, ident, status,
     info) = asyncio.run(asyncio.wait_for(main(), 120))
    assert rows[0] == rows[1] == rows[2] == rows[3]
    want = group_sigs(group, poly, rounds)
    jcv = JChainVerifier(JSC.scheme_by_id(scheme),
                         group.public_key.key_bytes())
    stored = [codec.decode_beacon(data) for _, data in rows[0]]
    assert [b.round for b in stored] == list(range(rounds + 1))
    assert stored[0].signature == group.genesis_seed
    for got, exp in zip(stored[1:], want):
        assert (got.signature, got.previous_sig) == (exp.signature,
                                                     exp.previous_sig)
        assert jcv.verify_beacon(JBeacon(got.round, got.signature,
                                         got.previous_sig))
    assert streamed == [(b.round, b.signature) for b in want]
    assert (tip.round, tip.signature) == (rounds, want[-1].signature)
    assert tip.randomness == want[-1].randomness()
    assert tip.metadata.chain_hash == group.chain_info().hash()
    assert (two.round, two.signature) == (2, want[1].signature)
    assert missing == grpc.StatusCode.NOT_FOUND
    node0 = [n for n in group.nodes if n.address == ident.address][0]
    assert (ident.key, ident.signature) == (node0.key, node0.signature)
    assert K.Identity(ident.key, ident.address, ident.tls,
                      ident.signature).is_valid_signature()
    assert (status.beacon.is_running, status.chain_store.last_round,
            status.chain_store.length) == (True, rounds, rounds + 1)
    assert info.hash == group.chain_info().hash()


def test_restarted_node_scans_and_syncs_from_peers(tmp_path):
    """A port node stopped after round 2 misses rounds 3-4 (the other
    three still reach t = 3), then restarts: its startup scan passes the
    stored rounds, its first tick finds the gap and the sync manager's
    request queue fetches the missed rounds from its peers over gRPC;
    round 5 is produced by all four, every store byte-equal."""
    n, t = 4, 3

    async def main():
        clock = FakeClock(START)
        daemons, pairs, folders = [], [], []
        try:
            for i in range(n):
                folder = tmp_path / f"node{i}"
                d = DrandDaemon(Config(folder=str(folder),
                                       private_listen="127.0.0.1:0",
                                       clock=clock, device="cpu"))
                await d.start()
                daemons.append(d)
                folders.append(folder)
                pairs.append(K.Pair.generate(d.private_addr(),
                                             seed=b"restart%d" % i))
            group, _ = write_group(folders, pairs, t,
                                   "pedersen-bls-chained", START + PERIOD)
            for d in daemons:
                await d.load_beacons_from_disk()
            await settle()
            procs = [d.processes["default"] for d in daemons]

            def tips(ps):
                return [p.chain_store.tip_round() for p in ps]

            async def to_round(r, ps):
                await clock.set_time(group.genesis_time + (r - 1) * PERIOD)
                await wait_for(lambda: min(tips(ps)) >= r, what=f"round {r}")

            for r in (1, 2):
                await to_round(r, procs)
            procs[3].stop()
            for r in (3, 4):
                await to_round(r, procs[:3])
            await procs[3].start(catchup=True)
            await settle()
            report = procs[3].integrity_report
            await to_round(5, procs)
            return [db_rows(f) for f in folders], report
        finally:
            for d in daemons:
                await d.stop()

    rows, report = asyncio.run(asyncio.wait_for(main(), 120))
    assert rows[0] == rows[1] == rows[2] == rows[3]
    assert [r for r, _ in rows[3]] == list(range(6))
    assert report.ok and report.tip_round == 2


def test_set_group_saves_and_builds_the_engine(tmp_path):
    """A process with a key pair and no group loads nothing; set_group (a
    DKG's result) writes the group and share files drand_tpu's FileStore
    reads back, builds the engine over genesis, and the daemon routes the
    chain by its hash once registered."""
    from drand_tpu.key import store as JKS

    daemon = DrandDaemon(Config(folder=str(tmp_path), device="cpu"))
    pair = K.Pair.generate("127.0.0.1:4444", seed=b"set-group")
    FileStore(str(tmp_path)).save_key_pair(pair)
    bp = daemon.instantiate("default")
    assert bp.load() is False and bp.handler is None
    poly = P.PriPoly.random(1, secret=SECRET)
    commits = [GC.g1_to_bytes(c) for c in poly.commit().commits]
    group = G.Group(threshold=1, period=PERIOD,
                    nodes=G.Group.sort_nodes([pair.public]),
                    genesis_time=int(START), public_key=K.DistPublic(commits))
    group.get_genesis_seed()
    share = K.Share(commits, poly.eval(0))
    bp.set_group(group, share)
    try:
        ref = JKS.FileStore(str(tmp_path))
        assert ref.load_group().hash() == group.hash()
        assert ref.load_share().pri_share.value == share.pri_share.value
        assert bp.chain_store.last().signature == group.genesis_seed
        assert bp.status()["is_running"] is False
        daemon.register_chain_hash(bp)
        assert daemon.chain_hashes == {group.chain_info().hash_hex():
                                       "default"}
    finally:
        bp.stop()


def test_mixed_group_port_and_reference(tmp_path):
    """Two port daemons and one drand_tpu daemon load the same group and
    share files; partials cross both ways for three rounds."""
    n, t, rounds = 3, 2, 3

    async def main():
        clock = FakeClock(START)
        folders = [tmp_path / f"node{i}" for i in range(n)]
        daemons = [DrandDaemon(Config(folder=str(folders[0]),
                                      private_listen="127.0.0.1:0",
                                      clock=clock, device="cpu")),
                   DrandDaemon(Config(folder=str(folders[1]),
                                      private_listen="127.0.0.1:0",
                                      clock=clock, device="cpu")),
                   JD.DrandDaemon(JCFG.Config(folder=str(folders[2]),
                                              private_listen="127.0.0.1:0",
                                              control_port=0, clock=clock))]
        peers = PeerClients()
        started = []
        try:
            for d in daemons:
                await d.start()
                started.append(d)
            pairs = [K.Pair.generate(d.private_addr(), seed=b"mixed%d" % i)
                     for i, d in enumerate(daemons)]
            group, poly = write_group(folders, pairs, t,
                                      "pedersen-bls-chained", START + PERIOD)
            for d in daemons:
                assert await d.load_beacons_from_disk() == ["default"]
            await settle()

            def tips():
                return [d.processes["default"].chain_store.tip_round()
                        for d in daemons]

            for r in range(1, rounds + 1):
                await clock.set_time(group.genesis_time + (r - 1) * PERIOD)
                await wait_for(lambda: min(tips()) >= r, what=f"round {r}")
            md = make_metadata("default")
            answers = []
            for d in (daemons[0], daemons[2]):
                resp = await asyncio.wait_for(
                    peers.public(d.private_addr()).PublicRand(
                        drand_pb2.PublicRandRequest(round=2, metadata=md)),
                    30)
                # drand_tpu stamps its server span's trace context into
                # the answer's metadata; the port has no tracing
                resp.metadata.ClearField("trace_id")
                resp.metadata.ClearField("span_id")
                answers.append(resp.SerializeToString())
            return group, poly, [db_rows(f) for f in folders], answers
        finally:
            await peers.close()
            for d in started:
                await d.stop()

    group, poly, rows, answers = asyncio.run(asyncio.wait_for(main(), 120))
    assert rows[0] == rows[1] == rows[2]
    assert len(rows[0]) == rounds + 1
    assert answers[0] == answers[1]
    want = group_sigs(group, poly, rounds)
    assert [codec.decode_beacon(d).signature for _, d in rows[0][1:]] == \
        [b.signature for b in want]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _lines(stream, out: queue.Queue):
    for line in iter(stream.readline, ""):
        out.put(line)
    out.put(None)


def test_cli_start_serves_and_stops_on_sigterm(tmp_path):
    """`cli start --device cpu --tls-disable` on a one-node group whose
    genesis lies ahead: it prints the daemon line, answers GetIdentity and
    PublicRand (the genesis beacon) over gRPC, and exits 0 on SIGTERM."""
    port = _free_port()
    addr = f"127.0.0.1:{port}"
    pair = K.Pair.generate(addr, seed=b"cli")
    group, _ = write_group([tmp_path], [pair], 1, "pedersen-bls-chained",
                           time.time() + 3600)
    proc = subprocess.Popen(
        [sys.executable, "-m", "drand_tpu_torch.cli", "start", "--folder",
         str(tmp_path), "--private-listen", addr, "--tls-disable",
         "--device", "cpu"], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    lines: queue.Queue = queue.Queue()
    reader = threading.Thread(target=_lines, args=(proc.stdout, lines),
                              daemon=True)
    reader.start()
    try:
        first = lines.get(timeout=120)
        assert first == f"daemon running: private={addr} " \
                        f"beacons=['default']\n", first

        async def ask():
            peers = PeerClients()
            try:
                ident = await asyncio.wait_for(GrpcBeaconNetwork(
                    peers).get_identity(addr), 30)
                rand = await asyncio.wait_for(peers.public(addr).PublicRand(
                    drand_pb2.PublicRandRequest(
                        round=0, metadata=make_metadata("default"))), 30)
                return ident, rand
            finally:
                await peers.close()

        ident, rand = asyncio.run(ask())
        assert (ident.address, ident.key, ident.signature) == \
            (addr, pair.public.key, pair.public.signature)
        assert (rand.round, rand.signature) == (0, group.genesis_seed)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0, proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        reader.join(timeout=10)
        proc.stdout.close()
        proc.stderr.close()


def test_cli_start_refuses_tls_with_reference_message(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "drand_tpu_torch.cli", "start", "--folder",
         str(tmp_path)], cwd=ROOT, capture_output=True, text=True,
        timeout=120)
    assert out.returncode == 1
    root = logging.getLogger("drand_tpu")
    saved = (list(root.handlers), root.level, root.propagate)
    try:
        args = JCLI.build_parser().parse_args(["start", "--folder",
                                               str(tmp_path)])
        with pytest.raises(SystemExit) as ref:
            asyncio.run(JCLI.cmd_start(args))
    finally:
        root.handlers[:] = saved[0]
        root.setLevel(saved[1])
        root.propagate = saved[2]
    assert out.stderr.strip() == str(ref.value.code) == cli.TLS_REQUIRED
    assert not (tmp_path / "multibeacon").exists()
