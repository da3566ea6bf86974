"""The beacon Handler: one chain's t-of-n round loop (counterpart of
`drand_tpu/beacon/node.py`, drand `chain/beacon/node.go`).

At each tick it signs this node's partial for the next round, hands it
to its own aggregator and sends it to every other node; it checks each
incoming partial (the round window, the signer's index, the signature)
and passes the valid ones to the aggregator; it asks for a sync when the
chain has a gap; and a chain that halted recovers at the group's
catch-up period instead of one round a period.

Partials are checked in batches off the event loop
(`AsyncPartialVerifier`): on a device backend a window of WINDOW_DEVICE_S
and at most BATCH_DEVICE partials a call, on the host backend no window
and at most BATCH_HOST (what drand_tpu takes by default from its
environment).

Left out of drand_tpu's Handler on purpose: the participation ledger (an
observability book; a partial for a settled round is dropped unchecked),
tracing spans, chaos failpoints, the resilience deadline on a send, and
`transition` (a reshare).
"""

from __future__ import annotations

import asyncio
import logging
from dataclasses import dataclass
from typing import Optional

from drand_tpu_torch.beacon.chain import ChainStore, PartialPacket
from drand_tpu_torch.beacon.clock import Clock, SystemClock
from drand_tpu_torch.beacon.crypto_backend import AsyncPartialVerifier
from drand_tpu_torch.beacon.ticker import Ticker
from drand_tpu_torch.chain.beacon import Beacon, genesis_beacon
from drand_tpu_torch.crypto import tbls

log = logging.getLogger("drand_tpu_torch.beacon")

WINDOW_DEVICE_S = 0.02
BATCH_DEVICE = 256
WINDOW_HOST_S = 0.0
BATCH_HOST = 64


class BeaconNetwork:
    """What the handler sends through (drand `net.ProtocolClient`): the
    gRPC transport (`net.client.GrpcBeaconNetwork`) and in-process test
    transports implement it."""

    async def send_partial(self, node, packet: PartialPacket) -> None:
        raise NotImplementedError

    async def sync_chain(self, node, from_round: int):
        """An async iterator of Beacons from `from_round`."""
        raise NotImplementedError
        yield  # pragma: no cover


@dataclass
class HandlerConfig:
    group: object               # key.Group
    share: object               # key.Share
    public_identity: object     # key.Identity of this node
    clock: Clock = None


class Handler:
    """One beacon chain's protocol engine."""

    def __init__(self, conf: HandlerConfig, chain_store: ChainStore,
                 network: BeaconNetwork, verifier):
        self.conf = conf
        self.group = conf.group
        self.share = conf.share
        self.clock = conf.clock or SystemClock()
        self.chain = chain_store
        self.net = network
        self.verifier = verifier
        self.ticker = Ticker(self.clock, self.group.period,
                             self.group.genesis_time)
        self.index = self.share.share_index() if self.share else -1
        self._addr = conf.public_identity.address
        self._running = False
        self._task: asyncio.Task | None = None
        # the fan-out and fast-forward tasks, held (the loop keeps only
        # weak references) and cancelled on stop
        self._bg_tasks: set = set()
        self._stop_round: Optional[int] = None
        self.on_sync_needed = None       # callback(from_round)
        backend = chain_store.backend
        if backend is None:
            self.partials = None
        elif backend.name == "device":
            self.partials = AsyncPartialVerifier(
                backend, max_delay=WINDOW_DEVICE_S, max_batch=BATCH_DEVICE)
        else:
            self.partials = AsyncPartialVerifier(
                backend, max_delay=WINDOW_HOST_S, max_batch=BATCH_HOST)
        chain_store.on_aggregated = self._on_aggregated

    # -- lifecycle ------------------------------------------------------------

    async def start(self) -> None:
        """A fresh start, before genesis."""
        if self.clock.now() > self.group.genesis_time:
            raise RuntimeError("genesis already passed; use catchup")
        self._launch()

    async def catchup(self) -> None:
        """Rejoin a running chain: the first tick finds the gap and asks
        for a sync."""
        self._launch()

    def _spawn(self, coro):
        task = asyncio.get_running_loop().create_task(coro)
        self._bg_tasks.add(task)
        task.add_done_callback(self._bg_tasks.discard)
        return task

    def stop(self) -> None:
        self._running = False
        self.ticker.stop()
        if self._task is not None:
            self._task.cancel()
            self._task = None
        for t in list(self._bg_tasks):
            t.cancel()
        self._bg_tasks.clear()
        if self.partials is not None:
            self.partials.stop()
        self.chain.stop()

    def stop_at(self, round_: int) -> None:
        """Produce no round after `round_`."""
        self._stop_round = round_

    def _launch(self) -> None:
        if self._running:
            return
        self._running = True
        self.chain.start()
        self.ticker.start()
        self._task = asyncio.get_running_loop().create_task(self._run())

    # -- incoming partials ----------------------------------------------------

    async def process_partial(self, packet: PartialPacket) -> None:
        current = self.ticker.current_round()
        # a round more than one past the clock, or one the chain has
        # settled, is dropped unchecked: a replayed old round would pass
        # the check and spend its signer's cache budget
        if packet.round > current + 1:
            log.debug("%s: partial for future round %d (current %d)",
                      self._addr, packet.round, current)
            return
        tip = self.chain.tip_round()
        if packet.round <= tip:
            log.debug("%s: partial for settled round %d (tip %d)",
                      self._addr, packet.round, tip)
            return
        idx = packet.index
        if idx == self.index:
            # our own partial reaches the aggregator directly; an echo
            # from the network is not processed again
            return
        if self.group.node(idx) is None:
            return
        msg = self.verifier.digest_message(packet.round,
                                           packet.previous_signature)
        if self.partials is None or \
                not await self.partials.verify(msg, packet.partial_sig):
            log.warning("%s: invalid partial from index %d round %d",
                        self._addr, idx, packet.round)
            return
        await self.chain.new_valid_partial(packet)

    # -- the run loop ---------------------------------------------------------

    async def _run(self) -> None:
        ticks = self.ticker.channel()
        while self._running:
            info = await ticks.get()
            if self._stop_round is not None and info.round > self._stop_round:
                log.info("%s: reached stop round %d", self._addr,
                         self._stop_round)
                self._running = False
                return
            try:
                last = self.chain.last()
            except Exception:
                # no genesis yet: insert it at the first tick
                last = genesis_beacon(self.group.get_genesis_seed())
                self.chain.store.put(last)
            if last.round + 1 < info.round:
                log.info("%s: gap (last %d, tick %d): sync", self._addr,
                         last.round, info.round)
                if self.on_sync_needed is not None:
                    try:
                        self.on_sync_needed(last.round + 1)
                    except Exception:
                        pass
                # and broadcast for the round after our tip all the same
            await self.broadcast_next_partial(info.round, last)

    # -- the catch-up fast-forward --------------------------------------------

    def _on_aggregated(self, beacon: Beacon) -> None:
        """An aggregated append that is still behind the clock means the
        chain halted and is recovering: the next round's partial goes out
        after the catch-up period, not at the next tick."""
        if not self._running or self.share is None:
            return
        if beacon.round >= self.ticker.current_round():
            return
        if self._stop_round is not None and beacon.round + 1 > self._stop_round:
            return
        self._spawn(self._catchup_broadcast())

    async def _catchup_broadcast(self) -> None:
        await self.clock.sleep(self.group.catchup_period)
        if not self._running:
            return
        try:
            last = self.chain.last()
        except Exception:
            return
        # on the fresh tip: a sync append during the sleep moves it, and a
        # synced beacon schedules no fast-forward of its own
        current = self.ticker.current_round()
        if last.round >= current:
            return      # caught up: the ticks take over
        if self._stop_round is not None and last.round + 1 > self._stop_round:
            return
        await self.broadcast_next_partial(current, last)

    async def broadcast_next_partial(self, round_: int, last: Beacon) -> None:
        """Sign this node's partial and send it to every other node
        without waiting for the sends."""
        if self.share is None:
            return
        decoupled = self.verifier.scheme.decouple_prev_sig
        prev_sig = b"" if decoupled else last.signature
        target = last.round + 1
        if round_ == last.round:
            # the tip is already the tick's round (a clock shift, or a
            # fast-forward that landed it early): sign that round again,
            # not the next one, which the network could then aggregate a
            # period early
            target = last.round
            if not decoupled:
                prev_sig = last.previous_sig
        msg = self.verifier.digest_message(target, prev_sig)
        psig = tbls.sign_partial(self.share.pri_share, msg)
        packet = PartialPacket(round=target, previous_signature=prev_sig,
                               partial_sig=psig,
                               beacon_id=self.group.beacon_id)
        await self.chain.new_valid_partial(packet)
        for node in self.group.nodes:
            if node.address != self._addr:
                self._spawn(self._send_one(node, packet))

    async def _send_one(self, node, packet: PartialPacket) -> None:
        try:
            await self.net.send_partial(node, packet)
        except Exception as exc:
            log.debug("%s: send to %s failed: %s", self._addr, node.address,
                      exc)
