"""Command line of the port (counterpart of `drand_tpu/cli/main.py`'s
`util fsck` and `objectsync`).

    python -m drand_tpu_torch.cli util fsck <store.db> [--repair] [--json]
        [--id BEACON_ID]
    python -m drand_tpu_torch.cli objectsync publish|sync|status --dir DIR
        [--db DB] [--chain-hash HEX] [--scheme ID] [--public-key HEX]
        [--segment-rounds N] [--up-to ROUND] [--genesis-seed HEX]
        [--device cpu]
    python -m drand_tpu_torch.cli sync --sync-nodes HOST:PORT[,...] --db DIR
        [--follow] [--up-to ROUND] [--chain-hash HEX] [--id BEACON_ID]
        [--device cpu]
    python -m drand_tpu_torch.cli start --folder DIR --private-listen
        HOST:PORT --tls-disable [--control PORT] [--device cpu]
    python -m drand_tpu_torch.cli generate-keypair ADDRESS [--folder DIR]
        [--id BEACON_ID]
    python -m drand_tpu_torch.cli share (--leader --nodes N --threshold T
        | --connect HOST:PORT) --secret-file FILE --control PORT
        [--id BEACON_ID] [--period S] [--catchup-period S] [--scheme ID]
        [--timeout S] [--source EXE] [--user-source-only]
    python -m drand_tpu_torch.cli show share|group|chain-info
        --control PORT [--id BEACON_ID]

`util fsck` is the offline integrity check of a chain database: the
structural scan of `chain/recovery.py` (each row decoded, round
contiguity, previous-signature linkage) on binary and legacy JSON rows,
with no verifier, as drand_tpu's.  `--repair` quarantines the damaged
rows and rolls the tip back to the verified prefix.  Exit 0 on a clean
chain, 1 when damage was found, repaired or not.  The full BLS scan is
`chain.recovery.startup_recovery(store, ChainVerifier(...))`.

`objectsync` works on a directory of segment objects (`objectsync/`):
`publish` writes the sealed segments of the chain database `--db` and
the manifest; `sync` fetches, verifies and commits segments into `--db`
through `SchemeStore(AppendStore(SqliteStore))`, anchored on
`--genesis-seed` when the database is empty, verifying with the port's
`ChainVerifier` on the card (segments of more than 32 rounds) unless
`--device cpu` is given; `status` prints the manifest's summary.  Each
prints one JSON object; exit 1 when a publish or a sync stopped on an
error.  drand_tpu's `--url` (an HTTP object store) is not ported.

`sync` catches up from peers over gRPC, in this process (drand_tpu's CLI
asks a running daemon through its control port; the port has no daemon
yet).  With `--follow` it runs `core.follow.follow_chain` into the chain
store `DIR/drand.db` (the full decorator stack, genesis seeded when
empty) up to `--up-to` (default: the current round by the clock), the
chain info fetched from the peers and checked against `--chain-hash`;
without it, drand's check-chain: `SyncManager.check_past_beacons` on
that store, then `correct_past_beacons` of the faulty rounds from the
peers.  It verifies on the card unless `--device cpu` is given, writes
progress to stderr and prints one JSON object (`ok`, `synced_to`,
`target`, the manager's `stats`; check-chain also `faulty` and
`fixed`); exit 1 when the follow stalled short of its target or a faulty
round stayed unrepaired.

`start` runs a beacon node: a `core.daemon.DrandDaemon` on
`--private-listen` that loads every beacon folder under
`--folder`/multibeacon holding a key pair, a group and a share, and
produces the chain with its group's other nodes (a catch-up start, as
drand_tpu's); a folder with a key pair alone waits for a DKG.  With
`--control PORT` it also serves the Control service on 127.0.0.1:PORT
(without it, none: drand_tpu's default port 8888 is not assumed).  It
checks partials and a DKG's commitments on the card unless `--device
cpu` is given (then on the native host tier and the golden model).  It
prints drand_tpu's "daemon running: ..." line and runs until SIGINT or
SIGTERM; it then stops the daemon, prints each dispatch record of the
process (`dispatch.py`) as a JSON line {"dispatch": {...}}, and each
beacon's last DKG (its phases, QUAL and state) as {"dkg": {...}}, and
exits 0.  TLS is not ported: without `--tls-disable` it exits with
drand_tpu's message.

`generate-keypair` writes a node's long-term key pair for ADDRESS into
`--folder`, with an identity that dials plain TCP (TLS is not ported),
and prints it as JSON.  `share` asks the daemon on `--control` (a
required flag, since `start` serves no control port unless given one)
to run a fresh DKG (the Control
service's InitDKG): `--leader` collects `--nodes` participants and sets
the group's threshold, period, catch-up period and scheme; `--connect`
joins the leader at its private address.  The setup secret is read
from `--secret-file` (the port reads no environment, so not from
DRAND_SHARE_SECRET); each phase closes after `--timeout` seconds at
the latest, and genesis is 3 x timeout after the group is made.  It
blocks until the ceremony ends and prints the group's TOML.  Reshare
(`--transition`, `--from`) is not ported: it is refused.  `show` reads
the node's share (its index and the group key), group TOML or chain
info over the control port.  Only `sync`, `start`, `share` and `show`
need `grpc`.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys
import time


# how long `share` waits for the ceremony (drand_tpu's)
SHARE_TIMEOUT_S = 600
RESHARE_NOT_PORTED = (
    "share --transition/--from: reshare is not ported (drand_tpu's "
    "InitReshare, Handler.transition and the in-place group swap); only "
    "a fresh DKG runs")


def _control_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--control", type=int, required=True,
                   help="the daemon's control port (`start --control`)")
    p.add_argument("--id", default="default", dest="beacon_id",
                   help="beacon id")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m drand_tpu_torch.cli")
    sub = p.add_subparsers(dest="command", required=True)
    sp = sub.add_parser("util", help="operator utilities")
    sp.add_argument("--id", default="default", dest="beacon_id",
                    help="beacon id")
    sp.add_argument("what", choices=["fsck"])
    sp.add_argument("target", nargs="?", default="",
                    help="util fsck: the chain db path to scan")
    sp.add_argument("--repair", action="store_true",
                    help="util fsck: quarantine damaged rows and roll "
                    "the tip back to the verified prefix (nothing deleted)")
    sp.add_argument("--json", action="store_true", dest="json_out",
                    help="util fsck: machine-readable report on stdout")

    sp = sub.add_parser("objectsync",
                        help="content-addressed segment objects in a "
                        "directory (drand_tpu_torch/objectsync/)")
    sp.add_argument("action", choices=["publish", "sync", "status"])
    sp.add_argument("--dir", required=True,
                    help="filesystem object-store root")
    sp.add_argument("--db", default="",
                    help="chain store sqlite path (publish: source; "
                    "sync: destination)")
    sp.add_argument("--chain-hash", default="",
                    help="hex chain hash pinned into objects / checked "
                    "against the manifest")
    sp.add_argument("--scheme", default="",
                    help="scheme id (default: pedersen-bls-chained)")
    sp.add_argument("--public-key", default="",
                    help="hex group public key (sync: BLS verification)")
    sp.add_argument("--segment-rounds", type=int, default=0,
                    help="rounds per segment object (default 16384; an "
                    "existing manifest's value always wins)")
    sp.add_argument("--up-to", type=int, default=0,
                    help="sync: stop after this round (0 = whole chain)")
    sp.add_argument("--genesis-seed", default="",
                    help="sync: hex genesis seed to anchor an empty store "
                    "(round-0 row); an existing store ignores it")
    sp.add_argument("--device", default=None,
                    help="sync: the verifier's device (default: the "
                    "current CUDA device; 'cpu' for the plain path)")

    sp = sub.add_parser("sync", help="catch up a chain store from peers "
                        "over gRPC (follow, or check and repair)")
    sp.add_argument("--sync-nodes", required=True,
                    help="comma-separated peer addresses (host:port)")
    sp.add_argument("--db", required=True,
                    help="the chain store's folder (drand.db in it)")
    sp.add_argument("--up-to", type=int, default=0,
                    help="target round (0: the current round)")
    sp.add_argument("--follow", action="store_true",
                    help="follow the chain; without it, check the "
                    "stored chain and repair faulty rounds from the peers")
    sp.add_argument("--chain-hash", default="",
                    help="hex chain hash the peers' chain info must match")
    sp.add_argument("--id", default="default", dest="beacon_id",
                    help="beacon id")
    sp.add_argument("--device", default=None,
                    help="the verifier's device (default: the current "
                    "CUDA device; 'cpu' for the plain path)")

    sp = sub.add_parser("start", help="run a beacon node (the daemon)")
    sp.add_argument("--folder", default=os.path.expanduser("~/.drand"),
                    help="the node's base folder (multibeacon/ in it)")
    sp.add_argument("--private-listen", default="0.0.0.0:4444",
                    help="node-to-node gRPC listen address")
    sp.add_argument("--tls-disable", "--insecure", dest="tls_disable",
                    action="store_true",
                    help="serve and dial plain TCP (TLS is not ported)")
    sp.add_argument("--control", type=int, default=None,
                    help="serve the Control service on 127.0.0.1:PORT "
                    "(default: none)")
    sp.add_argument("--device", default=None,
                    help="where partials and a DKG's commitments are "
                    "checked (default: the current CUDA device; 'cpu' for "
                    "the native host tier and the golden model)")

    sp = sub.add_parser("generate-keypair",
                        help="create a node's long-term key pair")
    sp.add_argument("--folder", default=os.path.expanduser("~/.drand"),
                    help="the node's base folder")
    sp.add_argument("--id", default="default", dest="beacon_id",
                    help="beacon id")
    sp.add_argument("address", help="the node's public address host:port")

    sp = sub.add_parser("share", help="run a fresh DKG through the daemon")
    _control_flags(sp)
    sp.add_argument("--leader", action="store_true")
    sp.add_argument("--connect", default="", help="the leader's address")
    sp.add_argument("--nodes", type=int, default=0)
    sp.add_argument("--threshold", type=int, default=0)
    sp.add_argument("--period", type=int, default=30)
    sp.add_argument("--catchup-period", type=int, default=0)
    sp.add_argument("--scheme", default="pedersen-bls-chained")
    sp.add_argument("--timeout", type=int, default=10,
                    help="each phase's timeout, seconds")
    sp.add_argument("--secret-file", default="",
                    help="file holding the setup secret")
    sp.add_argument("--source", default="",
                    help="executable whose stdout supplies the DKG's "
                    "entropy, XOR-mixed with the OS CSPRNG")
    sp.add_argument("--user-source-only", action="store_true",
                    help="use only --source's entropy")
    sp.add_argument("--transition", action="store_true",
                    help="reshare from the existing group (not ported)")
    sp.add_argument("--from", dest="old_group_path", default="",
                    help="previous group TOML of a reshare (not ported)")

    sp = sub.add_parser("show", help="the daemon's share, group or chain "
                        "info, over the control port")
    _control_flags(sp)
    sp.add_argument("what", choices=["share", "group", "chain-info"])
    return p


TLS_REQUIRED = (
    "TLS is the default: provide --tls-cert and --tls-key, or explicitly "
    "opt out with --tls-disable (cmd/drand-cli/cli.go:62-119 enforces the "
    "same either/or)")


async def cmd_start(args) -> int:
    """Run the daemon until SIGINT or SIGTERM."""
    if not args.tls_disable:
        raise SystemExit(TLS_REQUIRED)
    import signal

    from drand_tpu_torch.core.config import Config
    from drand_tpu_torch.core.daemon import DrandDaemon
    from drand_tpu_torch.dispatch import DISPATCH
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    daemon = DrandDaemon(Config(folder=args.folder,
                                private_listen=args.private_listen,
                                control_port=args.control,
                                device=args.device))
    await daemon.start()
    try:
        loaded = await daemon.load_beacons_from_disk()
        control = "" if daemon.control_listener is None else \
            f"control={daemon.control_listener.port} "
        print(f"daemon running: private={daemon.private_addr()} "
              f"{control}beacons={loaded}", flush=True)
        await stop.wait()
    finally:
        await daemon.stop()
    for rec in DISPATCH.records():
        print(json.dumps({"dispatch": rec.to_dict()}), flush=True)
    for bp in daemon.processes.values():
        if bp.dkg_status is not None:
            print(json.dumps({"dkg": bp.dkg_status.to_dict()}), flush=True)
    return 0


async def cmd_generate_keypair(args) -> int:
    from drand_tpu_torch.key.keys import Pair
    from drand_tpu_torch.key.store import FileStore
    pair = Pair.generate(args.address)
    FileStore(args.folder, args.beacon_id).save_key_pair(pair)
    print(json.dumps({"address": args.address,
                      "public_key": pair.public.key.hex(),
                      "folder": args.folder, "beacon": args.beacon_id}))
    return 0


def _secret(args) -> bytes:
    if not args.secret_file:
        raise SystemExit("missing DKG secret: pass --secret-file")
    with open(args.secret_file, "rb") as f:
        return f.read().strip()


async def cmd_share(args) -> int:
    """A fresh DKG through the daemon's InitDKG; prints the group TOML."""
    if args.transition or args.old_group_path:
        raise SystemExit(RESHARE_NOT_PORTED)
    secret = _secret(args)
    from drand_tpu_torch.core import convert
    from drand_tpu_torch.net.client import ControlClient, make_metadata
    from drand_tpu_torch.protogen import drand_pb2
    req = drand_pb2.InitDKGPacket(
        info=drand_pb2.SetupInfoPacket(
            leader=args.leader, leader_address=args.connect,
            nodes=args.nodes, threshold=args.threshold,
            timeout=args.timeout, secret=secret),
        beacon_period=args.period, catchup_period=args.catchup_period,
        schemeID=args.scheme, metadata=make_metadata(args.beacon_id))
    if args.source:
        req.entropy.script = args.source
        req.entropy.userOnly = args.user_source_only
    cc = ControlClient(args.control)
    try:
        group = await cc.stub.InitDKG(req, timeout=SHARE_TIMEOUT_S)
    finally:
        await cc.close()
    print(convert.group_from_proto(group).to_toml(), end="")
    return 0


async def cmd_show(args) -> int:
    from drand_tpu_torch.core import convert
    from drand_tpu_torch.net.client import ControlClient, make_metadata
    from drand_tpu_torch.protogen import drand_pb2
    md = make_metadata(args.beacon_id)
    cc = ControlClient(args.control)
    try:
        if args.what == "share":
            r = await cc.stub.Share(drand_pb2.ShareRequest(metadata=md),
                                    timeout=10)
            print(json.dumps({"index": r.index, "public": r.share.hex()}))
        elif args.what == "group":
            r = await cc.stub.GroupFile(drand_pb2.GroupRequest(metadata=md),
                                        timeout=10)
            print(convert.group_from_proto(r).to_toml(), end="")
        else:
            r = await cc.stub.ChainInfo(
                drand_pb2.ChainInfoRequest(metadata=md), timeout=10)
            print(convert.info_from_proto(r).to_json().decode())
    finally:
        await cc.close()
    return 0


class _WallClock:
    @staticmethod
    def now() -> float:
        return time.time()


def _progress(cur: int, target: int) -> None:
    print(f"sync {cur}/{target}", file=sys.stderr, flush=True)


async def cmd_sync(args) -> int:
    """Follow a chain from peers, or check the stored one and repair its
    faulty rounds from them; prints one JSON object."""
    from drand_tpu_torch.core import follow as FW
    from drand_tpu_torch.net.client import PeerClients
    addresses = [a for a in args.sync_nodes.split(",") if a]
    kw = dict(beacon_id=args.beacon_id, up_to=args.up_to, device=args.device,
              chain_hash=bytes.fromhex(args.chain_hash)
              if args.chain_hash else b"")
    peers, managers = PeerClients(), []
    try:
        if args.follow:
            out = {"ok": True, "synced_to": 0, "target": args.up_to,
                   "error": ""}
            try:
                async for cur, target in FW.follow_chain(
                        peers, addresses, args.db, _WallClock(),
                        on_manager=managers.append, **kw):
                    out.update(synced_to=cur, target=target)
                    _progress(cur, target)
            except FW.FollowStalled as exc:
                out.update(ok=False, error=str(exc))
        else:
            out = await FW.check_chain(peers, addresses, args.db,
                                       _WallClock(),
                                       on_manager=managers.append, **kw)
            _progress(out["synced_to"], out["target"])
    finally:
        await peers.close()
    out["stats"] = dict(managers[0].stats) if managers else {}
    print(json.dumps(out, indent=1))
    return 0 if out["ok"] else 1


async def cmd_fsck(args) -> int:
    if not args.target:
        raise SystemExit("util fsck needs a chain db path: "
                         "python -m drand_tpu_torch.cli util fsck "
                         "<store.db> [--repair] [--json]")
    if not os.path.exists(args.target):
        raise SystemExit(f"no such db: {args.target}")
    from drand_tpu_torch.chain.recovery import repair_store, scan_store
    from drand_tpu_torch.chain.store import SqliteStore
    store = SqliteStore(args.target)
    try:
        report = await scan_store(store, None, beacon_id=args.beacon_id)
        summary = None
        if args.repair and not report.ok:
            summary = repair_store(store, report)
        d = report.to_dict()
        if args.json_out:
            d["repair"] = summary
            print(json.dumps(d))
        else:
            print(f"scanned {report.scanned} rows "
                  f"(rounds {report.first_round}..{report.tip_round}) "
                  f"in {report.elapsed_s:.3f}s")
            for k in ("corrupt", "missing", "unlinked", "bad_sigs"):
                if d[k]:
                    print(f"  {k}: {d[k]}")
            if report.ok:
                print("chain OK")
            elif summary is not None:
                print(f"repaired: quarantined "
                      f"{summary['quarantined']} damaged + "
                      f"{summary['truncated']} rolled-back rows; "
                      f"tip now {summary['verified_tip']} "
                      f"(re-sync the suffix from peers)")
            else:
                print(f"DAMAGE FOUND (verified prefix ends at "
                      f"{report.verified_tip}); run with --repair "
                      f"to quarantine and roll back")
    finally:
        store.close()
    return 0 if report.ok else 1


async def cmd_objectsync(args) -> int:
    """One-shot publish of the sealed segments of a chain database,
    verify-then-commit sync of a database from published objects, or the
    manifest's status."""
    from drand_tpu_torch import objectsync as osync
    backend = osync.FilesystemBackend(args.dir)
    if args.action == "status":
        try:
            m = osync.Manifest.from_json(
                await backend.get(osync.MANIFEST_NAME))
        except osync.ObjectNotFound:
            print(json.dumps({"backend": backend.describe(),
                              "manifest": None}))
            return 0
        print(json.dumps({"backend": backend.describe(),
                          "chain_hash": m.chain_hash, "scheme": m.scheme_id,
                          "segment_rounds": m.segment_rounds,
                          "segments": len(m.segments), "tip": m.tip},
                         indent=1))
        return 0
    if not args.db or not args.chain_hash:
        raise SystemExit(
            f"objectsync {args.action} needs --db and --chain-hash")
    from drand_tpu_torch.chain.beacon import Beacon
    from drand_tpu_torch.chain.scheme import scheme_by_id
    from drand_tpu_torch.chain.store import (AppendStore, BeaconNotFound,
                                             SchemeStore, SqliteStore)
    scheme = scheme_by_id(args.scheme or None)
    chain_hash = bytes.fromhex(args.chain_hash)
    if args.action == "publish":
        store = SqliteStore(args.db)
        try:
            pub = osync.ObjectPublisher(
                store, backend, chain_hash=chain_hash, scheme_id=scheme.id,
                segment_rounds=(args.segment_rounds
                                or osync.DEFAULT_SEGMENT_ROUNDS))
            await pub.load_manifest()
            published = await pub.publish_sealed()
            snap = pub.snapshot()
            snap["published_now"] = published
            print(json.dumps(snap, indent=1))
        finally:
            store.close()
        return 1 if pub.last_error else 0
    # sync: every fetched segment verified against the local anchor
    # before it is committed; the object store is untrusted
    if not args.public_key:
        raise SystemExit("objectsync sync needs --public-key")
    base = SqliteStore(args.db)
    store = SchemeStore(AppendStore(base), scheme.decouple_prev_sig)
    try:
        try:
            store.last()
        except BeaconNotFound:
            if not args.genesis_seed:
                raise SystemExit("empty store: pass --genesis-seed to "
                                 "anchor round 0")
            store.put(Beacon(round=0,
                             signature=bytes.fromhex(args.genesis_seed)))
        from drand_tpu_torch.chain.verify import ChainVerifier
        verifier = ChainVerifier(scheme, bytes.fromhex(args.public_key),
                                 device=args.device)
        client = osync.ObjectSyncClient(backend, store, verifier,
                                        chain_hash=chain_hash)
        result = await client.sync(up_to=args.up_to)
        out = result.to_dict()
        out["stats"] = dict(client.stats)
        print(json.dumps(out, indent=1))
    finally:
        base.close()
    return 0 if result.ok else 1


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    commands = {"objectsync": cmd_objectsync, "sync": cmd_sync,
                "start": cmd_start, "generate-keypair": cmd_generate_keypair,
                "share": cmd_share, "show": cmd_show, "util": cmd_fsck}
    return asyncio.run(commands[args.command](args))


if __name__ == "__main__":
    sys.exit(main())
