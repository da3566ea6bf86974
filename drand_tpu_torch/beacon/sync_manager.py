"""Catch-up sync from peers (counterpart of
`drand_tpu/beacon/sync_manager.py`, drand `chain/beacon/sync_manager.go`).

Follower side: sync requests, shuffled peer order, a stream declared
stalled after STALL_FACTOR periods without a beacon.  Where drand verifies
each streamed beacon in turn, the stream's items are gathered into
contiguous segments and each segment is verified in one batched call of
the port's `ChainVerifier` (on its device: a segment of more than 32
rounds is one card batch) before anything of it is stored.  The stages
run as a pipeline:

    fetch (event loop) -> pack/dispatch (worker thread)
                       -> settle/commit (worker thread)

so segment k + 1 is issued while segment k resolves and commits.

Also the local check and repair pair, `check_past_beacons` (every stored
round verified in segments, the faulty rounds returned) and
`correct_past_beacons` (those rounds fetched again from peers, verified
and written through the store's undecorated base), and the serving side,
`serve_sync_chain`.

A beacon engine drives the manager through its request queue:
`request_sync(from_round)` (the handler's gap callback) queues a
request without blocking, and the task `start` launches runs each in
turn through `sync`; a follower awaits `sync` itself.

drand_tpu's breaker-ranked, hedged peer order (its `resilience` hub), its
chaos failpoints, its stage metrics and `snapshot` are not ported: peers
are tried in plain shuffled order.  The port reads no environment: the
pipeline depth is the constant PIPELINE_DEPTH.
"""

from __future__ import annotations

import asyncio
import logging
import random
import time
from dataclasses import dataclass

import numpy as np

from drand_tpu_torch.chain.beacon import Beacon
from drand_tpu_torch.chain.segment import PackedBeacons, pack_rows
from drand_tpu_torch.chain.store import BeaconNotFound, StoreError

log = logging.getLogger("drand_tpu_torch.sync")

SYNC_CHUNK = 512          # rounds a segment on the live tail
SYNC_CHUNK_MAX = 16384    # rounds a segment on a deep backlog
SYNC_CHUNK_GROWTH = 32    # 512 -> 16384 in one step
STALL_FACTOR = 2          # renew after STALL_FACTOR periods with no beacon
PIPELINE_DEPTH = 2        # segments handed on between two stages


def _item_span(item) -> tuple[int, int, int]:
    """(first round, last round, rounds) of a stream item: a Beacon or a
    PackedBeacons run."""
    if isinstance(item, PackedBeacons):
        return item.start_round, item.end_round, len(item)
    return item.round, item.round, 1


def _item_tail_sig(item) -> bytes:
    return item.tail_sig if isinstance(item, PackedBeacons) \
        else item.signature


@dataclass
class SyncRequest:
    from_round: int
    up_to: int = 0            # 0: to the peer's head, then follow


class _SegmentPipeline:
    """One segment in flight: `record` settles the previous segment, then
    keeps the new (segment, resolver) pair, whose work the caller issued
    first; `settle` resolves what is in flight.  `on_settled(segment,
    ok) -> bool` says what settling means; its False stops the caller.

    When settling fails, the new segment's resolver is dropped unresolved:
    its device work finishes on the stream and its tensors are freed when
    the closure is collected."""

    def __init__(self, on_settled):
        self._on_settled = on_settled
        self._pending = None

    def record(self, segment, resolver) -> bool:
        if not self.settle():
            return False
        self._pending = (segment, resolver)
        return True

    def settle(self) -> bool:
        if self._pending is None:
            return True
        seg, resolve = self._pending
        self._pending = None
        return self._on_settled(seg, np.asarray(resolve()))


class _CatchupPipeline:
    """The pack/dispatch and settle/commit stages of a catch-up.

    The fetch stage (`SyncManager._try_node`) hands each flushed run of
    stream items through a bounded queue to the pack task, which merges
    it into one segment and issues its verify in a worker thread; the
    settle task resolves each segment's verdicts and commits it through
    `store.put_many` in a worker thread, in segment order.  The contract:

      - a segment's beacons reach the store only after it verified;
      - a failed segment commits nothing of itself or of later segments
        (they are dropped, not settled);
      - a dispatch or commit error is raised to the caller once both
        stages have drained.

    Only the pack stage issues device work; resolving a segment copies
    its verdicts to the host and launches nothing."""

    _CLOSE = object()

    def __init__(self, manager, up_to: int):
        self.m = manager
        self.up_to = up_to
        self.got_any = False
        self.failure = False                       # a segment failed
        self.error: BaseException | None = None    # dispatch/commit error
        self._q_verify: asyncio.Queue = asyncio.Queue(maxsize=PIPELINE_DEPTH)
        self._q_commit: asyncio.Queue = asyncio.Queue(maxsize=PIPELINE_DEPTH)
        self._tasks: list[asyncio.Task] = []

    def start(self) -> None:
        loop = asyncio.get_running_loop()
        self._tasks = [loop.create_task(self._pack_loop()),
                       loop.create_task(self._settle_loop())]

    @property
    def broken(self) -> bool:
        return self.failure or self.error is not None

    async def submit(self, items: list, anchor_sig: bytes) -> None:
        """Hand a flushed run to the pack stage; a full queue holds the
        fetch loop back."""
        await self._q_verify.put((items, anchor_sig))

    async def close(self) -> None:
        """Drain both stages (every segment in flight that verifies is
        committed) and reap the tasks."""
        await self._q_verify.put(self._CLOSE)
        await asyncio.gather(*self._tasks, return_exceptions=True)

    # -- pack/dispatch ------------------------------------------------------

    @staticmethod
    def _coalesce(items: list, anchor_sig: bytes):
        """Merge a run of stream items into one segment: a list of
        Beacons (per-beacon wire) or one PackedBeacons (chunked wire); a
        mixed run becomes Beacons, linked from the anchor."""
        if all(isinstance(i, Beacon) for i in items):
            return items
        if len(items) == 1:
            return items[0]
        if (all(isinstance(i, PackedBeacons) for i in items)
                and len({i.sig_len for i in items}) == 1
                and len({i.chained for i in items}) == 1):
            return PackedBeacons(start_round=items[0].start_round,
                                 sigs=np.concatenate([i.sigs for i in items]),
                                 first_prev=items[0].first_prev,
                                 chained=items[0].chained)
        out: list[Beacon] = []
        prev = anchor_sig
        for it in items:
            if isinstance(it, Beacon):
                out.append(it)
                prev = it.signature
            else:
                out.extend(it.beacons(anchor_sig=prev))
                prev = it.tail_sig
        return out

    def _dispatch(self, items: list, anchor_sig: bytes):
        seg = self._coalesce(items, anchor_sig)
        if isinstance(seg, list):
            resolver = self.m.verifier.verify_chain_segment_async(
                seg, anchor_sig)
        else:
            resolver = self.m.verifier.verify_packed_segment_async(
                seg, anchor_sig)
        return seg, resolver

    async def _pack_loop(self) -> None:
        while True:
            item = await self._q_verify.get()
            if item is self._CLOSE:
                await self._q_commit.put(self._CLOSE)
                return
            if self.broken:
                continue                     # drain and drop
            items, anchor_sig = item
            t0 = time.perf_counter()
            try:
                seg, resolver = await asyncio.to_thread(
                    self._dispatch, items, anchor_sig)
            except BaseException as exc:  # noqa: BLE001 - the stage drains
                self.error = exc
                continue
            self.m.stats["pack_s"] += time.perf_counter() - t0
            await self._q_commit.put((seg, anchor_sig, resolver))

    # -- settle/commit ------------------------------------------------------

    def _commit(self, seg, anchor_sig: bytes) -> int:
        beacons = seg if isinstance(seg, list) \
            else seg.beacons(anchor_sig=anchor_sig)
        self.m.store.put_many(beacons)
        return len(beacons)

    async def _settle_loop(self) -> None:
        while True:
            item = await self._q_commit.get()
            if item is self._CLOSE:
                return
            if self.broken:
                continue
            seg, anchor_sig, resolver = item
            t0 = time.perf_counter()
            try:
                ok = np.asarray(await asyncio.to_thread(resolver))
            except BaseException as exc:  # noqa: BLE001
                self.error = exc
                continue
            self.m.stats["verify_s"] += time.perf_counter() - t0
            if not bool(np.all(ok)):
                if isinstance(seg, list):
                    bad = [seg[i].round for i in np.nonzero(~ok)[0][:5]]
                else:
                    bad = [int(seg.start_round + i)
                           for i in np.nonzero(~ok)[0][:5]]
                log.warning("segment verify failed at rounds %s", bad)
                self.failure = True
                continue
            t0 = time.perf_counter()
            try:
                n = await asyncio.to_thread(self._commit, seg, anchor_sig)
            except BaseException as exc:  # noqa: BLE001
                self.error = exc
                continue
            self.m.stats["commit_s"] += time.perf_counter() - t0
            self.m.stats["segments"] += 1
            self.m.stats["rounds"] += n
            self.got_any = True
            last_round = seg[-1].round if isinstance(seg, list) \
                else seg.end_round
            if self.m.on_progress is not None:
                self.m.on_progress(last_round, self.up_to)


class SyncManager:
    def __init__(self, store, group, verifier, network, nodes, clock,
                 insecure_store):
        """store: the decorated chain store commits go through; group:
        anything with `period` (seconds); verifier: the port's
        ChainVerifier; network: a BeaconNetwork (`sync_chain(peer,
        from_round)`, an async iterator of Beacon or PackedBeacons
        items); nodes: the peers, each with an `address`; clock: `now()`
        in seconds; insecure_store: the undecorated store that
        `correct_past_beacons` overwrites repaired rounds through."""
        self.store = store
        self.group = group
        self.verifier = verifier
        self.net = network
        self.nodes = nodes
        self.clock = clock
        self.insecure_store = insecure_store
        self.on_progress = None        # callback(round, target)
        # host seconds of each stage, and what was committed
        self.stats = {"fetch_s": 0.0, "pack_s": 0.0, "verify_s": 0.0,
                      "commit_s": 0.0, "segments": 0, "rounds": 0}
        # sync requests are hints (each sync reads the live tip), so a
        # backlog past this bound is dropped
        self._queue: asyncio.Queue[SyncRequest] = asyncio.Queue(maxsize=64)
        self._task: asyncio.Task | None = None

    def start(self) -> None:
        if self._task is None:
            self._task = asyncio.get_running_loop().create_task(self._loop())

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None

    def request_sync(self, from_round: int, up_to: int = 0) -> None:
        try:
            self._queue.put_nowait(SyncRequest(from_round, up_to))
        except asyncio.QueueFull:
            pass

    async def _loop(self) -> None:
        while True:
            req = await self._queue.get()
            try:
                await self.sync(req)
            except Exception as exc:
                log.warning("sync failed: %s", exc)

    async def sync(self, req: SyncRequest) -> bool:
        """Try the peers in shuffled order until one stream commits
        something and ends without a failed segment."""
        peers = list(self.nodes)
        random.shuffle(peers)
        for peer in peers:
            try:
                ok = await self._try_node(peer, req)
            except Exception as exc:
                log.debug("peer %s sync error: %s",
                          getattr(peer, "address", peer), exc)
                continue
            if ok:
                return True
        return False

    async def _try_node(self, peer, req: SyncRequest) -> bool:
        """Consume one peer's stream: this coroutine is the fetch stage.
        It checks each item's contiguity and hands full runs to a
        _CatchupPipeline.  A run is flushed when it holds `chunk_target`
        rounds, which starts at SYNC_CHUNK and grows by SYNC_CHUNK_GROWTH
        up to SYNC_CHUNK_MAX while the stream keeps runs full, and drops
        back to SYNC_CHUNK when the stream idles (the head of the chain).
        A stream that delivers nothing for STALL_FACTOR periods ends the
        try."""
        try:
            last = self.store.last()
        except BeaconNotFound:
            return False
        from_round = max(req.from_round, last.round + 1)
        # the anchor moves to a run's tail when it is flushed: a failed
        # segment stops everything after it, so that is safe
        anchor_round, anchor_sig = last.round, last.signature
        buffer: list = []
        buffered = 0
        chunk_target = SYNC_CHUNK
        pipe = _CatchupPipeline(self, req.up_to)
        pipe.start()

        async def flush() -> None:
            nonlocal anchor_round, anchor_sig, buffered
            if not buffer:
                return
            seg = list(buffer)
            buffer.clear()
            buffered = 0
            sig = anchor_sig
            anchor_round, anchor_sig = (_item_span(seg[-1])[1],
                                        _item_tail_sig(seg[-1]))
            await pipe.submit(seg, sig)

        gen = self.net.sync_chain(peer, from_round)
        stream = gen.__aiter__()
        idle_s = 0.5
        stall_at = self.clock.now() + STALL_FACTOR * self.group.period
        # one pending read is kept across idle windows: cancelling a gRPC
        # stream's __anext__ (as asyncio.wait_for would) cancels the call
        pending: asyncio.Future | None = None
        try:
            while not pipe.broken:
                if pending is None:
                    pending = asyncio.ensure_future(stream.__anext__())
                t0 = time.perf_counter()
                done, _ = await asyncio.wait({pending}, timeout=idle_s)
                self.stats["fetch_s"] += time.perf_counter() - t0
                if not done:
                    # idle at the head: land what is buffered, back to
                    # the small chunk
                    chunk_target = SYNC_CHUNK
                    await flush()
                    if self.clock.now() >= stall_at:
                        log.debug("sync stream from %s stalled; renewing",
                                  getattr(peer, "address", peer))
                        break
                    continue
                try:
                    item = pending.result()
                except StopAsyncIteration:
                    pending = None
                    break
                pending = None
                stall_at = self.clock.now() + STALL_FACTOR * self.group.period
                first_r, last_r, n = _item_span(item)
                expected = (_item_span(buffer[-1])[1] + 1 if buffer
                            else anchor_round + 1)
                if first_r != expected:
                    # out of order: flush; give up on the peer unless the
                    # item starts right past the anchor
                    await flush()
                    if first_r != anchor_round + 1:
                        break
                buffer.append(item)
                buffered += n
                if req.up_to and last_r >= req.up_to:
                    if isinstance(item, PackedBeacons) \
                            and last_r > req.up_to:
                        # nothing past the target reaches the store
                        buffer[-1] = item.truncate(req.up_to)
                        buffered -= last_r - req.up_to
                    break
                if buffered >= chunk_target:
                    await flush()
                    chunk_target = min(chunk_target * SYNC_CHUNK_GROWTH,
                                       SYNC_CHUNK_MAX)
            if not pipe.broken:
                await flush()
        finally:
            # segments in flight were issued against a verified anchor:
            # a dropped stream still commits them
            if pending is not None:
                pending.cancel()
            try:
                await pipe.close()
            except Exception:
                log.exception("draining the catch-up pipeline failed")
            aclose = getattr(gen, "aclose", None)
            if aclose is not None:
                try:
                    await aclose()
                except Exception:
                    pass
        if pipe.error is not None:
            raise pipe.error
        if pipe.failure:
            return False
        return pipe.got_any

    # -- local check and repair ---------------------------------------------

    def check_past_beacons(self, up_to: int | None = None) -> list[int]:
        """Verify every stored round up to `up_to` (the tip by default) in
        segments of SYNC_CHUNK, segment k + 1 issued before segment k
        resolves; returns the faulty rounds."""
        faulty: list[int] = []
        try:
            last = self.store.last()
        except BeaconNotFound:
            return faulty
        top = min(up_to or last.round, last.round)
        prev = None
        chunk: list[Beacon] = []

        def note_faulty(seg, ok) -> bool:
            faulty.extend(seg[i].round for i in np.nonzero(~ok)[0])
            return True                      # scan on past bad rounds

        pipeline = _SegmentPipeline(note_faulty)

        def dispatch(seg, anchor):
            anchor_sig = anchor.signature if anchor is not None else b""
            pipeline.record(seg, self.verifier.verify_chain_segment_async(
                seg, anchor_sig))

        for beacon in self.store.iter_range(0):
            if beacon.round == 0:
                prev = beacon
                continue
            if beacon.round > top:
                break
            chunk.append(beacon)
            if len(chunk) >= SYNC_CHUNK:
                dispatch(chunk, prev)
                prev = chunk[-1]
                chunk = []
        if chunk:
            dispatch(chunk, prev)
        pipeline.settle()
        return faulty

    async def correct_past_beacons(self, faulty: list[int]) -> int:
        """Fetch the faulty rounds again from the peers, verify each and
        overwrite it; returns how many were fixed."""
        fixed = 0
        if not faulty:
            return 0
        peers = list(self.nodes)
        random.shuffle(peers)
        want = set(faulty)
        for peer in peers:
            if not want:
                break
            try:
                done = False
                async for item in self.net.sync_chain(peer, min(want)):
                    # a chunked run is taken apart with the server's
                    # advisory prev: a lie fails the verify below
                    beacons = item.beacons() \
                        if isinstance(item, PackedBeacons) else [item]
                    for beacon in beacons:
                        if beacon.round in want:
                            if self.verifier.verify_beacons([beacon])[0]:
                                self.insecure_store.put(beacon)
                                want.discard(beacon.round)
                                fixed += 1
                        if beacon.round >= max(faulty):
                            done = True
                            break
                    if done:
                        break
            except Exception:
                continue
        return fixed


async def serve_sync_chain(store, from_round: int, live_queue=None,
                           chunk_size: int = 0):
    """Serving side of SyncChain: the stored rounds from `from_round`,
    then, with a `live_queue`, each beacon stored after them.

    With chunk_size > 0 (a client that takes chunks) the stored rounds go
    out as PackedBeacons runs of at most chunk_size, read with
    `read_fields` in a worker thread; a store without `read_fields`, and
    the live tail, send one Beacon an item.  A damaged stored row ends
    the stream after the good rows before it, so the client renews
    against another peer."""
    last_sent = from_round - 1
    reader = getattr(store, "read_fields", None) if chunk_size > 0 else None
    if reader is not None:
        next_round = from_round
        while True:
            try:
                rows = await asyncio.to_thread(reader, next_round, chunk_size)
            except StoreError as exc:
                bad = getattr(exc, "round", None)
                rows = []
                if bad is not None and bad > next_round:
                    try:
                        rows = await asyncio.to_thread(
                            reader, next_round, bad - next_round)
                    except StoreError:
                        rows = []
                log.warning("serve: corrupt row at round %s; ending the "
                            "stream after the last good round", bad)
                for item in pack_rows(rows, max_chunk=chunk_size):
                    yield item
                return
            if not rows:
                break
            for item in pack_rows(rows, max_chunk=chunk_size):
                last_sent = item.end_round \
                    if isinstance(item, PackedBeacons) else item.round
                yield item
            next_round = rows[-1][0] + 1
    else:
        try:
            for beacon in store.iter_range(from_round):
                last_sent = beacon.round
                yield beacon
        except StoreError as exc:
            log.warning("serve: store error mid-stream (%s); ending the "
                        "stream at round %d", exc, last_sent)
            return
    if live_queue is not None:
        while True:
            beacon = await live_queue.get()
            if beacon.round > last_sent:
                last_sent = beacon.round
                yield beacon
