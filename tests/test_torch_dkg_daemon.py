"""A fresh DKG through daemons over real gRPC on 127.0.0.1, on the CPU,
held against drand_tpu: a mixed ceremony of n = 4, t = 3 (two port
daemons, two drand_tpu daemons, all started through their Control
service's InitDKG), led by a port daemon and then by a drand_tpu one,
leaves byte-equal group files with one group key on all four nodes,
and that group then produces rounds 1-3 under one FakeClock with the
four stores byte-equal and the group key verifying them; `cli
generate-keypair`, `cli start --control` and `cli share` run as
processes (n = 3, t = 2) to the same group, which `cli show group`
prints as the same TOML; `share --transition` is refused.

Every wait runs under a time limit, and every daemon, channel and
subprocess is stopped before its test ends.
"""

import asyncio
import os
import signal
import socket
import sqlite3
import subprocess
import sys
import time
from pathlib import Path

import pytest

grpc = pytest.importorskip("grpc")

from drand_tpu.core import config as JCFG  # noqa: E402
from drand_tpu.core import daemon as JD  # noqa: E402
from drand_tpu_torch import cli  # noqa: E402
from drand_tpu_torch.beacon.clock import FakeClock  # noqa: E402
from drand_tpu_torch.chain import codec  # noqa: E402
from drand_tpu_torch.chain.scheme import scheme_by_id  # noqa: E402
from drand_tpu_torch.chain.verify import ChainVerifier  # noqa: E402
from drand_tpu_torch.core.config import Config  # noqa: E402
from drand_tpu_torch.core.daemon import DrandDaemon  # noqa: E402
from drand_tpu_torch.crypto.bls12381 import curve as C  # noqa: E402
from drand_tpu_torch.crypto.poly import recover_secret  # noqa: E402
from drand_tpu_torch.key.group import Group  # noqa: E402
from drand_tpu_torch.key.keys import Pair  # noqa: E402
from drand_tpu_torch.key.store import FileStore  # noqa: E402
from drand_tpu_torch.net.client import ControlClient, make_metadata  # noqa: E402
from drand_tpu_torch.protogen import drand_pb2  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
START = 1_700_000_000.0
PERIOD = 3
SECRET = b"test_torch_dkg_daemon setup secret"


def group_file(folder) -> bytes:
    return (Path(folder) / "multibeacon" / "default" / "groups" /
            "drand_group.toml").read_bytes()


def db_rows(folder):
    con = sqlite3.connect(os.path.join(folder, "multibeacon", "default", "db",
                                       "drand.db"))
    try:
        return con.execute("SELECT round, data FROM beacons "
                           "ORDER BY round").fetchall()
    finally:
        con.close()


def init_dkg(leader: bool, connect: str = "", n: int = 4, t: int = 3):
    """A phase closes once every bundle is in; its 60-s timeout on the
    wall clock only bounds a loaded host's slowest node (the rounds run
    on the fake clock, so the 3 x timeout to genesis costs no time)."""
    return drand_pb2.InitDKGPacket(
        info=drand_pb2.SetupInfoPacket(
            leader=leader, leader_address=connect, nodes=n, threshold=t,
            timeout=60, secret=SECRET),
        beacon_period=PERIOD, catchup_period=1,
        schemeID="pedersen-bls-chained", metadata=make_metadata("default"))


async def wait_for(pred, limit: float = 60.0, what: str = ""):
    deadline = time.monotonic() + limit
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        await asyncio.sleep(0.01)


@pytest.mark.parametrize("leader", [0, 2], ids=["port_leader",
                                                 "reference_leader"])
def test_mixed_ceremony_then_rounds(tmp_path, leader):
    """Nodes 0, 1 are port daemons and 2, 3 drand_tpu ones; node `leader`
    leads.  The ceremony's group files are byte-equal on all four, every
    phase closed complete with QUAL all four, t shares give the group
    key's secret, and rounds 1-3 land byte-equal in all four stores."""
    n, t, rounds = 4, 3, 3
    folders = [tmp_path / f"node{i}" for i in range(n)]

    async def main():
        clock = FakeClock(START)
        daemons = [DrandDaemon(Config(folder=str(f), private_listen=
                                      "127.0.0.1:0", control_port=0,
                                      clock=clock, device="cpu"))
                   for f in folders[:2]] + \
            [JD.DrandDaemon(JCFG.Config(folder=str(f), private_listen=
                                        "127.0.0.1:0", control_port=0,
                                        clock=clock))
             for f in folders[2:]]
        started, ccs = [], []
        try:
            for d in daemons:
                await d.start()
                started.append(d)
            for i, d in enumerate(daemons):
                FileStore(str(folders[i])).save_key_pair(Pair.generate(
                    d.private_addr(), seed=b"mixed dkg %d" % i))
                assert await d.load_beacons_from_disk() == []
            ccs = [ControlClient(d.control_listener.port) for d in daemons]
            lead = asyncio.ensure_future(ccs[leader].stub.InitDKG(
                init_dkg(True), timeout=120))
            await wait_for(lambda: daemons[leader].processes["default"]
                           .setup_manager is not None, what="the leader")
            rest = [ccs[i].stub.InitDKG(
                init_dkg(False, daemons[leader].private_addr()), timeout=120)
                for i in range(n) if i != leader]
            answers = await asyncio.wait_for(asyncio.gather(lead, *rest), 120)
            procs = [d.processes["default"] for d in daemons]
            statuses = [p.dkg_status.to_dict() for p in procs]
            group = procs[0].group
            for r in range(1, rounds + 1):
                await clock.set_time(group.genesis_time + (r - 1) * PERIOD)
                await wait_for(lambda: min(p.chain_store.tip_round()
                                           for p in procs) >= r,
                               what=f"round {r}")
            return answers, statuses
        finally:
            for cc in ccs:
                await cc.close()
            for d in started:
                await d.stop()

    answers, statuses = asyncio.run(asyncio.wait_for(main(), 240))
    assert len({a.SerializeToString() for a in answers}) == 1
    files = [group_file(f) for f in folders]
    assert all(f == files[0] for f in files)
    group = Group.from_toml(files[0].decode())
    assert group.size == n and group.threshold == t
    for st in statuses:
        assert st["state"] == "done" and st["qual"] == list(range(n))
        assert [(p["phase"], p["outcome"]) for p in st["phases"]] == \
            [("deal", "complete"), ("response", "complete")]
    shares = [FileStore(str(f)).load_share() for f in folders]
    assert all(s.commits == group.public_key.coefficients for s in shares)
    secret = recover_secret([s.pri_share for s in shares[1:]], t)
    assert C.g1_to_bytes(C.g1_mul(C.G1_GEN, secret)) == \
        group.public_key.key_bytes()
    rows = [db_rows(str(f)) for f in folders]
    assert all(r == rows[0] for r in rows)
    assert [r for r, _ in rows[0]] == list(range(rounds + 1))
    cv = ChainVerifier(scheme_by_id(group.scheme_id),
                       group.public_key.key_bytes(), device="cpu")
    stored = [codec.decode_beacon(d) for _, d in rows[0]]
    assert stored[0].signature == group.genesis_seed
    assert cv.verify_chain_segment(stored[1:], group.genesis_seed).all()


async def wait_leader_ready(addr: str, limit: float) -> None:
    """Until the leader's InitDKG has begun: its SignalDKGParticipant
    answers "no DKG setup in progress" before, and refuses an empty
    secret ("wrong setup secret") after."""
    from drand_tpu_torch.net.client import PeerClients
    peers = PeerClients()
    deadline = time.monotonic() + limit
    try:
        while True:
            try:
                await peers.protocol(addr).SignalDKGParticipant(
                    drand_pb2.SignalDKGPacket(
                        metadata=make_metadata("default")), timeout=10)
            except grpc.aio.AioRpcError as exc:
                # the leader's manager refuses the empty secret; any
                # other answer (no setup yet, a deadline, no connection)
                # says nothing of it
                if "wrong setup secret" in (exc.details() or ""):
                    return
            if time.monotonic() > deadline:
                raise AssertionError(f"leader {addr} not ready")
            await asyncio.sleep(0.2)
    finally:
        await peers.close()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run(args, timeout=120):
    return subprocess.run([sys.executable, "-m", "drand_tpu_torch.cli",
                           *args], cwd=ROOT, capture_output=True, text=True,
                          timeout=timeout)


def test_cli_generate_start_share_show(tmp_path):
    """n = 3, t = 2 through the CLI alone: generate-keypair, start
    --control --device cpu, share --leader and share --connect (each a
    process under a time limit), then show group, share and chain-info
    over each node's control port; every start exits 0 on SIGTERM."""
    n, t = 3, 2
    folders = [tmp_path / f"n{i}" for i in range(n)]
    ports = [_free_port() for _ in range(2 * n)]
    addrs = [f"127.0.0.1:{p}" for p in ports[:n]]
    controls = [str(p) for p in ports[n:]]
    secret = tmp_path / "secret"
    secret.write_bytes(SECRET)
    for f, a in zip(folders, addrs):
        out = _run(["generate-keypair", "--folder", str(f), a])
        assert out.returncode == 0, out.stderr
        assert f'"address": "{a}"' in out.stdout
    starts = []
    try:
        for f, a, c in zip(folders, addrs, controls):
            starts.append(subprocess.Popen(
                [sys.executable, "-m", "drand_tpu_torch.cli", "start",
                 "--folder", str(f), "--private-listen", a, "--tls-disable",
                 "--control", c, "--device", "cpu"], cwd=ROOT,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for p, a, c in zip(starts, addrs, controls):
            line = p.stdout.readline()
            assert line == f"daemon running: private={a} control={c} " \
                           f"beacons=[]\n", line + p.stderr.read()
        share = ["share", "--secret-file", str(secret), "--period",
                 str(PERIOD), "--catchup-period", "1", "--timeout", "5"]
        leader = subprocess.Popen(
            [sys.executable, "-m", "drand_tpu_torch.cli", *share,
             "--control", controls[0], "--leader", "--nodes", str(n),
             "--threshold", str(t)], cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        followers = []
        try:
            asyncio.run(wait_leader_ready(addrs[0], 60))
            followers = [subprocess.Popen(
                [sys.executable, "-m", "drand_tpu_torch.cli", *share,
                 "--control", c, "--connect", addrs[0]], cwd=ROOT,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                for c in controls[1:]]
            results = [p.communicate(timeout=120)
                       for p in [leader] + followers]
        finally:
            for p in [leader] + followers:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        errs = "\n".join(err for _, err in results)
        for p in [leader] + followers:
            assert p.returncode == 0, errs
        tomls = [out for out, _ in results]
        assert all(x == tomls[0] for x in tomls)
        for f, c in zip(folders, controls):
            shown = _run(["show", "group", "--control", c])
            assert shown.returncode == 0 and shown.stdout == tomls[0]
            assert group_file(f).decode() == tomls[0]
        group = Group.from_toml(tomls[0])
        info = _run(["show", "chain-info", "--control", controls[1]])
        assert f'"hash": "{group.chain_info().hash_hex()}"' in info.stdout
        sh = _run(["show", "share", "--control", controls[2]])
        assert f'"public": "{group.public_key.key_bytes().hex()}"' in \
            sh.stdout
    finally:
        for p in starts:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        rcs = []
        for p in starts:
            try:
                rcs.append(p.wait(timeout=60))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
                rcs.append("killed")
            p.stdout.close()
            p.stderr.close()
    assert rcs == [0] * n


def test_share_transition_refused(tmp_path):
    secret = tmp_path / "secret"
    secret.write_bytes(SECRET)
    for extra in (["--transition"], ["--from", str(tmp_path / "g.toml")]):
        with pytest.raises(SystemExit) as exc:
            cli.main(["share", "--secret-file", str(secret), "--control",
                      "1", "--connect", "127.0.0.1:1", *extra])
        assert "reshare is not ported" in str(exc.value)
    with pytest.raises(SystemExit, match="--secret-file"):
        cli.main(["share", "--control", "1", "--leader", "--nodes", "3",
                  "--threshold", "2"])


@pytest.mark.parametrize("argv", [
    ["share", "--leader", "--nodes", "3", "--threshold", "2"],
    ["show", "group"],
    ["generate-keypair", "127.0.0.1:1", "--tls"],
    ["generate-keypair", "127.0.0.1:1", "--source", "/bin/true"],
])
def test_cli_refuses_unported_or_missing_flags(argv, capsys):
    """`share` and `show` need `--control` (`start` serves none by
    default); `generate-keypair` takes no TLS or entropy-script flag."""
    with pytest.raises(SystemExit) as exc:
        cli.main(argv)
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert ("--control" in err) if argv[0] != "generate-keypair" else \
        ("unrecognized arguments" in err)


def test_generate_keypair_writes_plain_tcp_identity(tmp_path, capsys):
    from drand_tpu_torch.key.store import FileStore
    assert cli.main(["generate-keypair", "--folder", str(tmp_path),
                     "127.0.0.1:4444"]) == 0
    pair = FileStore(str(tmp_path)).load_key_pair()
    assert pair.public.address == "127.0.0.1:4444" and not pair.public.tls
    assert pair.public.is_valid_signature()
    assert pair.public.key.hex() in capsys.readouterr().out
