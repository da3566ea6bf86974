"""The aggregating chain store (counterpart of `drand_tpu/beacon/chain.py`,
drand `chain/beacon/chain.go`): verified partials queue into one
aggregation task, which caches them by (round, previous signature) and,
once a round holds t of them and extends the chain, recovers the group
signature, verifies it and appends it.

Recovery and the check of the recovered signature run in the shared
crypto worker thread (`crypto_backend.run_in_crypto_thread`): the native
combination and the native verify, never on the event loop.  The backend
comes from `make_backend` on the engine's device.  drand_tpu's
participation feed (`on_recovered`), its serve-cache hook
(`on_group_update`), `update_group` (a reshare) and its tracing span are
not ported.
"""

from __future__ import annotations

import asyncio
import logging
import threading
from dataclasses import dataclass

from drand_tpu_torch.beacon.cache import PartialCache
from drand_tpu_torch.beacon.crypto_backend import (make_backend,
                                                   run_in_crypto_thread)
from drand_tpu_torch.chain.beacon import Beacon
from drand_tpu_torch.chain.store import StoreError
from drand_tpu_torch.crypto import tbls

log = logging.getLogger("drand_tpu_torch.beacon")


@dataclass
class PartialPacket:
    """A partial beacon as the wire carries it (PartialBeaconPacket)."""
    round: int
    previous_signature: bytes
    partial_sig: bytes          # BE16 index || compressed G2 signature
    beacon_id: str = "default"

    @property
    def index(self) -> int:
        return tbls.index_of(self.partial_sig)


class ChainStore:
    """A chain store with the partial aggregator on top.

    store: a CallbackStore (the tip is tracked by a tail callback);
    group: a key.Group; share: this node's key.Share (None for a node
    without one); verifier: the chain's ChainVerifier; device: the
    backend's device (a CUDA device: the card checks partials; "cpu":
    the host tier)."""

    def __init__(self, store, group, share, verifier, device=None):
        self.store = store
        self.group = group
        self.share = share
        self.verifier = verifier
        self.cache = PartialCache()
        # fires for the beacons this node aggregated, not the synced ones:
        # the handler's catch-up fast-forward
        self.on_aggregated = None
        self._queue: asyncio.Queue[PartialPacket] = asyncio.Queue(maxsize=1000)
        self._task: asyncio.Task | None = None
        pub_poly = group.public_key.pub_poly() if group.public_key else None
        self.backend = (make_backend(pub_poly, group.threshold, group.size,
                                     device)
                        if pub_poly is not None else None)
        # the tip's round, kept in memory so the handler's round window
        # reads no sqlite on the event loop: a monotonic max, fed on the
        # committing thread by a tail callback (sync-applied commits too)
        self._tip_lock = threading.Lock()
        try:
            self._tip_round = self.store.last().round
        except Exception:
            self._tip_round = -1
        self._tip_cb_id = f"chainstore-tip-{id(self):x}"
        self.store.add_tail_callback(self._tip_cb_id,
                                     lambda b: self._note_tip(b.round))

    def start(self):
        if self._task is None:
            self._task = asyncio.get_running_loop().create_task(
                self._aggregate())

    def stop(self):
        if self._task is not None:
            self._task.cancel()
            self._task = None
        self.store.remove_callback(self._tip_cb_id)
        self.store.close()

    async def new_valid_partial(self, packet: PartialPacket) -> None:
        """Queue a verified partial for aggregation."""
        await self._queue.put(packet)

    def last(self) -> Beacon:
        return self.store.last()

    def _note_tip(self, round_: int) -> None:
        # the event loop and the store's committing threads both get
        # here; the lock keeps the max monotonic
        with self._tip_lock:
            if round_ <= self._tip_round:
                return
            self._tip_round = round_
        # a settled round's partials are dead: flush on every advance,
        # sync-applied commits included
        self.cache.flush_rounds(round_)

    def tip_round(self) -> int:
        """The tip's round (-1 before genesis), without a store read."""
        return self._tip_round

    async def _aggregate(self) -> None:
        thr = self.group.threshold
        while True:
            packet = await self._queue.get()
            if packet.round <= self.tip_round():
                # settled while it sat in the queue: caching it would
                # strand it (no later append flushes a round behind the
                # tip); no await lies between this check and the append
                continue
            rc = self.cache.append(packet.round, packet.previous_signature,
                                   packet.index,
                                   tbls.sig_of(packet.partial_sig))
            if rc is None or len(rc) < thr:
                continue
            try:
                last = self.store.last()
            except Exception:
                continue
            if packet.round != last.round + 1:
                continue            # too old or too new: sync's business
            try:
                beacon = await self._recover(packet.round,
                                             packet.previous_signature, rc)
            except Exception as exc:
                log.warning("recovery failed round %d: %s", packet.round, exc)
                continue
            self.try_append(beacon)

    async def _recover(self, round_: int, prev_sig: bytes, rc) -> Beacon:
        """Lagrange recovery and the check of the recovered signature
        (the partials were verified on receipt), in the crypto thread."""
        msg = self.verifier.digest_message(round_, prev_sig)
        partials = [idx.to_bytes(2, "big") + sig for idx, sig in rc.partials()]
        full = await run_in_crypto_thread(self.backend.recover, msg, partials)
        beacon = Beacon(round=round_, signature=full, previous_sig=prev_sig)
        if not await run_in_crypto_thread(self.verifier.verify_beacon, beacon):
            raise ValueError("recovered signature failed verification")
        log.debug("round %d: group signature recovered from %d partials",
                  round_, len(partials))
        return beacon

    def try_append(self, beacon: Beacon) -> bool:
        """Append when the beacon extends the chain; the tail callback has
        moved the tip and flushed the cache by the time put returns."""
        try:
            self.store.put(beacon)
        except StoreError as exc:
            log.debug("append rejected round %d: %s", beacon.round, exc)
            return False
        if self.on_aggregated is not None:
            try:
                self.on_aggregated(beacon)
            except Exception:
                pass
        return True
