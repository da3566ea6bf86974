"""What a node serves of one chain (counterpart of the serving part of
`drand_tpu/core/process.py` `BeaconProcess`): the SyncChain source with
its live tail, the chain info and the store's status.

`ServingProcess` holds one chain store and its `Info`; it has no beacon
engine, partials or DKG (the port has no daemon yet).  It registers a
callback on its CallbackStore that hands each newly stored beacon to
every live subscriber's queue.
"""

from __future__ import annotations

import asyncio

from drand_tpu_torch.beacon.sync_manager import serve_sync_chain
from drand_tpu_torch.chain.info import Info
from drand_tpu_torch.common import canonical_beacon_id


class ServingProcess:
    def __init__(self, store, info: Info):
        self._store = store
        self.info = info
        self.beacon_id = canonical_beacon_id(info.beacon_id)
        self._live_queues: list[tuple[asyncio.Queue, asyncio.AbstractEventLoop]] = []
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
        """The chain store's state; `is_running` is False: no beacon
        engine runs here."""
        st = {"is_running": False, "is_serving": True, "last_round": 0,
              "length": 0, "is_empty": True}
        try:
            last = self._store.last()
            st.update(last_round=last.round, length=len(self._store),
                      is_empty=False)
        except Exception:
            pass
        return st
