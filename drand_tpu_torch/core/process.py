"""One beacon chain of a node (counterpart of `drand_tpu/core/process.py`
`BeaconProcess`, drand `core/drand_beacon.go`).

What a node serves of one chain store and its `Info` is one class,
`_Serving`: the SyncChain source with its live tail (a callback on the
CallbackStore hands each newly stored beacon to every live subscriber's
queue), the chain info and the store's status.  `ServingProcess` serves
a store on its own (a follower's peer).

`BeaconProcess` serves the store of its engine: the key pair, group and share loaded from
the key store, and the engine over them (`_build_engine`): the chain
store under the beacon folder (genesis put when it is empty), the
`ChainVerifier`, the aggregating `ChainStore`, the `Handler` and a
`SyncManager` over the other nodes, all on the configured device.
`start` runs the startup integrity scan (`chain.recovery.
startup_recovery`, full BLS through the verifier), then the sync
manager and the handler.  While a DKG runs (`core/dkg_runner.py`) it
holds the ceremony's state: the leader's `setup_manager`, a
participant's `setup_receiver`, the echo broadcast `dkg_board` and the
`dkg_status` that outlives it; a process with a key pair alone waits
for a DKG, whose `set_group` builds the engine.  drand_tpu's response
cache, metrics, health sink, objectsync publisher, environment switches
and reshare `transition` are not ported.
"""

from __future__ import annotations

import asyncio
import logging
import os

from drand_tpu_torch.beacon.chain import ChainStore, PartialPacket
from drand_tpu_torch.beacon.node import Handler, HandlerConfig
from drand_tpu_torch.beacon.sync_manager import SyncManager, serve_sync_chain
from drand_tpu_torch.chain.beacon import genesis_beacon
from drand_tpu_torch.chain.info import Info
from drand_tpu_torch.chain.recovery import startup_recovery
from drand_tpu_torch.chain.scheme import scheme_by_id
from drand_tpu_torch.chain.store import (BeaconNotFound, StoreError,
                                         new_chain_store)
from drand_tpu_torch.chain.verify import ChainVerifier
from drand_tpu_torch.common import canonical_beacon_id
from drand_tpu_torch.net.client import GrpcBeaconNetwork, PeerClients

log = logging.getLogger("drand_tpu_torch.core")


class _Serving:
    """The serving side of a chain: the live fan-out, the SyncChain
    source, the chain info and the status.  `_serve` attaches the store
    and its `Info`, and is the only place that does."""

    def __init__(self):
        self._live_queues: list[tuple[asyncio.Queue,
                                      asyncio.AbstractEventLoop]] = []
        self._store = None
        self.info: Info | None = None
        self._started = False       # a beacon engine runs

    def _serve(self, store, info: Info) -> None:
        self._store = store
        self.info = info
        self.beacon_id = canonical_beacon_id(info.beacon_id)
        store.add_callback("serve-live", self._fanout_live)

    def _fanout_live(self, beacon) -> None:
        """Runs on the CallbackStore's pool thread: an asyncio queue is
        not thread-safe, so each put goes through the subscriber's loop
        (a bare put_nowait from here can leave the loop's `await q.get()`
        asleep)."""
        for q, loop in list(self._live_queues):
            try:
                loop.call_soon_threadsafe(self._offer, q, beacon)
            except RuntimeError:
                pass                    # the subscriber's loop is closed

    @staticmethod
    def _offer(q, beacon) -> None:
        try:
            q.put_nowait(beacon)
        except asyncio.QueueFull:
            pass

    def subscribe_live(self) -> asyncio.Queue:
        q: asyncio.Queue = asyncio.Queue(maxsize=64)
        self._live_queues.append((q, asyncio.get_running_loop()))
        return q

    def unsubscribe_live(self, q) -> None:
        self._live_queues = [(qq, lp) for qq, lp in self._live_queues
                             if qq is not q]

    def sync_chain_source(self, from_round: int, chunk_size: int):
        """The SyncChain stream from `from_round`: stored rounds (packed
        runs of at most chunk_size when chunk_size > 0), then each beacon
        stored later."""
        live = self.subscribe_live()
        return self._unsubscribing(serve_sync_chain(
            self._store, from_round, live_queue=live, chunk_size=chunk_size),
            live)

    async def _unsubscribing(self, gen, q):
        try:
            async for item in gen:
                yield item
        finally:
            self.unsubscribe_live(q)
            await gen.aclose()

    def chain_info(self) -> Info:
        return self.info

    def status(self) -> dict:
        """The chain store's state; `is_running`: a beacon engine runs."""
        st = {"is_running": self._started, "is_serving": True,
              "last_round": 0, "length": 0, "is_empty": True}
        try:
            last = self._store.last()
            st.update(last_round=last.round, length=len(self._store),
                      is_empty=False)
        except Exception:
            pass
        return st


class ServingProcess(_Serving):
    """One chain store and its `Info` served on their own (a follower's
    peer): no engine, so `status` reports `is_running` false."""

    def __init__(self, store, info: Info):
        super().__init__()
        self._serve(store, info)


class BeaconProcess(_Serving):
    """One beacon chain of a daemon: its key material and engine; the
    engine's store is served from `_build_engine` on."""

    def __init__(self, beacon_id: str, config, key_store,
                 peers: PeerClients | None = None):
        super().__init__()
        self.beacon_id = beacon_id
        self.config = config
        self.key_store = key_store
        self.peers = peers or PeerClients()
        self.network = GrpcBeaconNetwork(self.peers, beacon_id)
        self.keypair = None
        self.group = None
        self.share = None
        self.verifier: ChainVerifier | None = None
        self.chain_store: ChainStore | None = None
        self.handler: Handler | None = None
        self.sync_manager: SyncManager | None = None
        self.integrity_report = None  # the last startup scan's report
        self._pending_repair = None   # (from_round, up_to) to sync again
        self._engine_closed = False
        # DKG state, set while a ceremony runs
        self.setup_manager = None     # the leader's collector
        self.setup_receiver = None    # a participant's wait for the group
        self.dkg_board = None         # the echo broadcast
        self.dkg_status = None        # CeremonyStatus, kept after the board

    # -- state from disk --------------------------------------------------------

    def load_keypair(self):
        self.keypair = self.key_store.load_key_pair()
        return self.keypair

    def load(self) -> bool:
        """The key pair, group and share from disk; True when the process
        has a group and so a chain to run."""
        self.load_keypair()
        if not self.key_store.has_group():
            return False
        self.group = self.key_store.load_group()
        if self.key_store.has_share():
            self.share = self.key_store.load_share()
        self._build_engine()
        return True

    def set_group(self, group, share) -> None:
        """Install a new group and share (a DKG's result) and build the
        engine over them."""
        self.group = group
        self.share = share
        self.key_store.save_group(group)
        if share is not None:
            self.key_store.save_share(share)
        self._build_engine()

    # -- the engine ---------------------------------------------------------------

    def db_path(self) -> str:
        folder = os.path.join(self.config.multibeacon_folder, self.beacon_id,
                              "db")
        os.makedirs(folder, mode=0o700, exist_ok=True)
        return os.path.join(folder, "drand.db")

    def _build_engine(self) -> None:
        self._engine_closed = False
        group, device = self.group, self.config.device
        self.verifier = ChainVerifier(scheme_by_id(group.scheme_id),
                                      group.public_key.key_bytes(),
                                      beacon_id=self.beacon_id, device=device)
        store = new_chain_store(self.db_path(), group)
        try:
            store.last()
        except BeaconNotFound:
            store.put(genesis_beacon(group.get_genesis_seed()))
        except StoreError:
            pass    # a damaged tip row: the startup scan deals with it
        self._serve(store, group.chain_info())
        self.chain_store = ChainStore(store, group, self.share, self.verifier,
                                      device=device)
        conf = HandlerConfig(group=group, share=self.share,
                             public_identity=self.keypair.public,
                             clock=self.config.clock)
        self.handler = Handler(conf, self.chain_store, self.network,
                               self.verifier)
        others = [n for n in group.nodes
                  if n.address != self.keypair.public.address]
        self.sync_manager = SyncManager(store, group, self.verifier,
                                        self.network, others,
                                        self.config.clock,
                                        insecure_store=store.insecure)
        self.handler.on_sync_needed = self.sync_manager.request_sync

    async def start(self, catchup: bool = False) -> None:
        if self._started or self.handler is None:
            return
        if self._engine_closed:
            self._build_engine()    # a stopped engine closed its store
        self._pending_repair = None
        await self._startup_integrity()
        self._started = True
        self.sync_manager.start()
        if self._pending_repair is not None:
            # the rolled-back rounds come back from the peers
            self.sync_manager.request_sync(*self._pending_repair)
        if catchup:
            await self.handler.catchup()
        else:
            await self.handler.start()

    async def _startup_integrity(self) -> None:
        """Scan the stored chain before serving it; on damage, quarantine
        and roll back to the verified prefix, build the engine again (the
        ChainStore keeps the old tip) and queue a sync of the rolled-back
        rounds."""
        base = self._store.insecure
        if await asyncio.to_thread(len, base) <= 1:
            return                  # empty or genesis only
        report, summary = await startup_recovery(base, self.verifier,
                                                 beacon_id=self.beacon_id)
        self.integrity_report = report
        if summary is None:
            return
        self._teardown_engine()
        self._build_engine()
        self._pending_repair = (report.verified_tip + 1, report.tip_round)

    def _teardown_engine(self) -> None:
        """Stop the handler (its ChainStore closes the store) and the sync
        manager; each step best effort."""
        for part in (self.handler, self.sync_manager):
            if part is not None:
                try:
                    part.stop()
                except Exception:
                    log.exception("%s: engine teardown", self.beacon_id)

    def stop(self) -> None:
        self._teardown_engine()
        self._started = False
        self._engine_closed = True

    # -- what the services call ---------------------------------------------------

    async def process_partial(self, round_: int, previous_sig: bytes,
                              partial_sig: bytes) -> None:
        if self.handler is None:
            raise RuntimeError("beacon not running")
        await self.handler.process_partial(PartialPacket(
            round=round_, previous_signature=previous_sig,
            partial_sig=partial_sig, beacon_id=self.beacon_id))

    def chain_info(self) -> Info:
        if self.info is None:
            raise RuntimeError("no group")
        return self.info
