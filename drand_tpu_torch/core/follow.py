"""Following a chain from peers, and checking a stored one against them
(counterpart of `drand_tpu/core/follow.py` and of `StartCheckChain` in
`drand_tpu/core/control.py`, drand `core/drand_beacon_control.go`).

The chain info is fetched from the peers and checked against the pinned
chain hash; the store is the one under the db folder (the full decorator
stack of `chain.store.new_chain_store`, genesis seeded when empty); a
`SyncManager` over those peers then catches it up (`follow_chain`) or
verifies and repairs it (`check_chain`), verifying on the
`ChainVerifier`'s device.  drand_tpu's daemon hands these its peers,
folder and clock; the port has no daemon yet, so the caller passes them.
"""

from __future__ import annotations

import asyncio
import os
from dataclasses import dataclass

from drand_tpu_torch.beacon.sync_manager import SyncManager, SyncRequest
from drand_tpu_torch.chain.beacon import genesis_beacon
from drand_tpu_torch.chain.info import Info
from drand_tpu_torch.chain.scheme import scheme_by_id
from drand_tpu_torch.chain.store import BeaconNotFound, new_chain_store
from drand_tpu_torch.chain.time import current_round
from drand_tpu_torch.chain.verify import ChainVerifier
from drand_tpu_torch.common import DEFAULT_BEACON_ID
from drand_tpu_torch.core import convert
from drand_tpu_torch.net.client import (GrpcBeaconNetwork, Peer,
                                        make_metadata)
from drand_tpu_torch.protogen import drand_pb2

DB_NAME = "drand.db"


class FollowStalled(RuntimeError):
    """The sync ended short of its target."""


@dataclass(frozen=True)
class _FollowGroup:
    period: int
    genesis_time: int
    scheme_id: str


async def chain_info_from_peers(peers, addresses, beacon_id: str,
                                expected_hash: bytes | None = None) -> Info:
    """Ask each address for the chain info until one answers with the
    expected hash (any hash when none is pinned)."""
    last_exc = None
    for addr in addresses:
        try:
            pkt = await peers.public(addr).ChainInfo(
                drand_pb2.ChainInfoRequest(metadata=make_metadata(beacon_id)),
                timeout=10.0)
            info = convert.info_from_proto(pkt)
            if expected_hash and info.hash() != expected_hash:
                raise ValueError(f"chain info hash mismatch from {addr}")
            return info
        except Exception as exc:
            last_exc = exc
    raise RuntimeError(f"no peer returned usable chain info: {last_exc}")


def open_follow_store(db_folder: str, info: Info):
    """The chain store of `info` at `db_folder`/drand.db, genesis seeded
    when it is empty."""
    os.makedirs(db_folder, mode=0o700, exist_ok=True)
    group = _FollowGroup(info.period, info.genesis_time, info.scheme_id)
    store = new_chain_store(os.path.join(db_folder, DB_NAME), group)
    try:
        store.last()
    except BeaconNotFound:
        store.put(genesis_beacon(info.genesis_seed))
    return store, group


def _manager(peers, addresses, store, group, info, clock, beacon_id,
             device) -> SyncManager:
    verifier = ChainVerifier(scheme_by_id(info.scheme_id), info.public_key,
                             beacon_id=beacon_id, device=device)
    return SyncManager(store, group, verifier,
                       GrpcBeaconNetwork(peers, beacon_id),
                       [Peer(a) for a in addresses], clock,
                       insecure_store=store.insecure)


async def follow_chain(peers, addresses, db_folder: str, clock,
                       beacon_id: str = DEFAULT_BEACON_ID,
                       chain_hash: bytes = b"", up_to: int = 0,
                       device=None, on_manager=None):
    """Async generator of (current, target) progress pairs.

    peers: a `net.client.PeerClients`; addresses: the peers' gRPC
    addresses; clock: `now()` in seconds; chain_hash: the pinned chain
    hash (empty: trust the first answer); up_to: the target round (0:
    the current round by the clock, and the stream is followed past it
    until it stalls); device: the verifier's device (None: the current
    CUDA device); on_manager: called with the SyncManager before it
    starts.  Raises FollowStalled when the sync ends short of the
    target."""
    addresses = list(addresses)
    if not addresses:
        raise ValueError("follow_chain needs at least one peer")
    info = await chain_info_from_peers(peers, addresses, beacon_id,
                                       chain_hash or None)
    store, group = open_follow_store(db_folder, info)
    try:
        sm = _manager(peers, addresses, store, group, info, clock,
                      beacon_id, device)
        if on_manager is not None:
            on_manager(sm)
        target = up_to or current_round(clock.now(), info.period,
                                        info.genesis_time)
        q: asyncio.Queue = asyncio.Queue()
        sm.on_progress = lambda cur, tgt: q.put_nowait((cur, target))
        yield 0, target
        task = asyncio.ensure_future(
            sm.sync(SyncRequest(from_round=1, up_to=up_to)))
        try:
            while not task.done():
                try:
                    yield await asyncio.wait_for(q.get(), 0.5)
                except asyncio.TimeoutError:
                    continue
        finally:
            if not task.done():
                task.cancel()
                await asyncio.gather(task, return_exceptions=True)
        while not q.empty():
            yield q.get_nowait()
        ok = task.result()
        last = store.last()
        yield last.round, target
        if not ok and last.round < target:
            raise FollowStalled(
                f"follow stalled at round {last.round}/{target}")
    finally:
        store.close()


async def check_chain(peers, addresses, db_folder: str, clock,
                      beacon_id: str = DEFAULT_BEACON_ID,
                      chain_hash: bytes = b"", up_to: int = 0, device=None,
                      on_manager=None) -> dict:
    """drand's check-chain on the store under `db_folder`: every stored
    round up to `up_to` (0: the tip) verified by `check_past_beacons`,
    then the faulty ones fetched again from the peers and overwritten by
    `correct_past_beacons`.  Returns {"ok": all repaired, "synced_to":
    the tip, "target", "faulty", "fixed"}."""
    info = await chain_info_from_peers(peers, list(addresses), beacon_id,
                                       chain_hash or None)
    store, group = open_follow_store(db_folder, info)
    try:
        sm = _manager(peers, addresses, store, group, info, clock,
                      beacon_id, device)
        if on_manager is not None:
            on_manager(sm)
        faulty = await asyncio.to_thread(sm.check_past_beacons,
                                         up_to or None)
        fixed = await sm.correct_past_beacons(faulty) if faulty else 0
        return {"ok": fixed == len(faulty), "synced_to": store.last().round,
                "target": up_to or store.last().round, "faulty": faulty,
                "fixed": fixed}
    finally:
        store.close()
