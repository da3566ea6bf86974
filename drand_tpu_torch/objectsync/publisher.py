"""Segment publisher of the objectsync tier (counterpart of
`drand_tpu/objectsync/publisher.py`).

`ObjectPublisher` keeps an object backend holding a chain store's rows as
sealed, content-addressed segment objects plus the one mutable manifest.
A segment is published only when sealed (a full ``segment_rounds`` run
exists past the last published one), so every object is immutable.

`publish_sealed` is the one-shot drive (the CLI's `objectsync publish`):
rows are read with ``read_fields`` (no Beacon made) in a worker thread,
objects written through the async ObjectStore seam.  The live drive,
`start`/`stop`, registers a tail callback on a `chain.store.CallbackStore`
(called on the committing thread: it notes the tip and wakes the loop)
and runs a publish loop on the event loop; a store without the callback
seam is published on demand only.

Restart is idempotent: the manifest is the durable cursor.  The publisher
reads it back, checks the chain's identity and resumes at ``tip + 1``; a
re-put of a published object writes the same bytes to the same name.  A
damaged local row (`CorruptRowError` from the store) stops publishing at
the verified prefix and shows in `snapshot()`; the publisher never ships
bytes it could not read cleanly.  No metrics.
"""

from __future__ import annotations

import asyncio
import logging

from drand_tpu_torch.chain.store import StoreError
from drand_tpu_torch.objectsync import format as ofmt
from drand_tpu_torch.objectsync.backends import ObjectNotFound, ObjectStore

log = logging.getLogger("drand_tpu_torch.objectsync")

_CB_ID = "objectsync-pub"


class PublisherError(Exception):
    pass


class ObjectPublisher:
    def __init__(self, store, backend: ObjectStore, chain_hash: bytes,
                 scheme_id: str,
                 segment_rounds: int = ofmt.DEFAULT_SEGMENT_ROUNDS):
        """store: anything with ``read_fields`` (a decorated chain store or
        a bare SqliteStore); backend: the ObjectStore seam;
        chain_hash/scheme_id: the published chain's identity, pinned into
        every object and the manifest."""
        self.store = store
        self.backend = backend
        self.chain_hash = chain_hash
        self.scheme_id = scheme_id
        self.segment_rounds = segment_rounds
        self.manifest: ofmt.Manifest | None = None
        self.last_error: str = ""
        self._tip = 0                 # the freshest committed round seen
        self._wake = asyncio.Event()
        self._task: asyncio.Task | None = None
        self._attached = False

    # -- store hook (committing thread; stays O(1)) -------------------------

    def attach(self) -> None:
        """Register the tail callback; a store without the callback seam
        (a bare or decorated SqliteStore) is skipped: ``publish_sealed``
        publishes it on demand."""
        if self._attached or not hasattr(self.store, "add_tail_callback"):
            return
        loop = asyncio.get_running_loop()

        def note_tail(beacon) -> None:
            self._tip = max(self._tip, beacon.round)
            try:
                loop.call_soon_threadsafe(self._wake.set)
            except RuntimeError:
                pass                     # the loop closed at shutdown
        self.store.add_tail_callback(_CB_ID, note_tail)
        self._attached = True

    def detach(self) -> None:
        if self._attached:
            self.store.remove_callback(_CB_ID)
            self._attached = False

    # -- live drive ---------------------------------------------------------

    async def start(self) -> None:
        """Attach, read the manifest back and start the publish loop: it
        publishes what is sealed, then waits for the next commit."""
        self.attach()
        await self.load_manifest()
        if self._task is None:
            self._task = asyncio.get_running_loop().create_task(self._run())

    def cancel(self) -> None:
        """Detach and cancel the loop without waiting for it."""
        self.detach()
        if self._task is not None:
            self._task.cancel()
            self._task = None

    async def stop(self) -> None:
        task = self._task
        self.cancel()
        if task is not None:
            try:
                await task
            except (asyncio.CancelledError, Exception):
                pass

    async def _run(self) -> None:
        while True:
            try:
                await self.publish_sealed()
            except asyncio.CancelledError:
                raise
            except Exception as exc:
                # a failed backend write is retried at the next commit;
                # the snapshot shows the error until then
                self.last_error = str(exc)
                log.warning("objectsync publish failed: %s", exc)
            await self._wake.wait()
            self._wake.clear()

    # -- manifest cursor ----------------------------------------------------

    async def load_manifest(self) -> ofmt.Manifest:
        """Read the durable cursor back from the backend; a fresh backend
        starts an empty manifest.  A manifest for a DIFFERENT chain is a
        hard error — never interleave two chains in one prefix."""
        try:
            body = await self.backend.get(ofmt.MANIFEST_NAME)
            m = ofmt.Manifest.from_json(body)
        except ObjectNotFound:
            m = ofmt.Manifest(chain_hash=self.chain_hash.hex(),
                              scheme_id=self.scheme_id,
                              segment_rounds=self.segment_rounds)
        if m.chain_hash != self.chain_hash.hex():
            raise PublisherError(
                f"backend holds manifest for chain {m.chain_hash}, "
                f"publishing {self.chain_hash.hex()}")
        if m.segment_rounds != self.segment_rounds:
            # the cursor wins: changing segment size mid-chain would
            # break the contiguity every published object commits to
            log.warning("objectsync: manifest pins segment_rounds=%d "
                        "(configured %d); keeping the manifest's",
                        m.segment_rounds, self.segment_rounds)
            self.segment_rounds = m.segment_rounds
        self.manifest = m
        return m

    # -- publishing ---------------------------------------------------------

    async def publish_sealed(self) -> int:
        """Publish every currently-sealed segment; returns how many
        objects were written.  Idempotent and resumable at any point:
        object writes are content-addressed, and the manifest is only
        advanced AFTER its segment object is durably in the backend."""
        if self.manifest is None:
            await self.load_manifest()
        m = self.manifest
        published = 0
        while True:
            start = m.next_start()
            try:
                rows = await asyncio.to_thread(
                    self.store.read_fields, start, self.segment_rounds)
            except StoreError as exc:
                # damaged local row: stop at the verified prefix — never
                # publish bytes we could not read cleanly
                self.last_error = f"store read stopped publishing: {exc}"
                log.warning("objectsync: %s", self.last_error)
                break
            if (len(rows) < self.segment_rounds
                    or rows[0][0] != start
                    or rows[-1][0] != start + self.segment_rounds - 1):
                break                      # not sealed yet (or a gap)
            blob = ofmt.encode_segment(self.chain_hash, self.scheme_id,
                                       rows)
            hash_hex = ofmt.content_hash(blob)
            name = ofmt.object_name(start, hash_hex, m.template)
            await self.backend.put(name, blob)
            m.append(ofmt.ManifestEntry(start=start,
                                        count=self.segment_rounds,
                                        hash=hash_hex, name=name))
            await self.backend.put(ofmt.MANIFEST_NAME, m.to_json())
            published += 1
            self.last_error = ""
            log.info("objectsync: published rounds %d..%d as %s",
                     start, m.tip, name)
        return published

    def _store_tip(self) -> int:
        if self._tip:
            return self._tip
        try:
            return self.store.last().round
        except Exception:
            return 0

    # -- observability ------------------------------------------------------

    def snapshot(self) -> dict:
        """Point-in-time publisher state (the CLI's `publish` output)."""
        m = self.manifest
        tip = self._store_tip()
        published_tip = m.tip if m else 0
        return {
            "backend": self.backend.describe(),
            "segment_rounds": self.segment_rounds,
            "published_segments": len(m.segments) if m else 0,
            "published_tip": published_tip,
            "store_tip": tip,
            "lag_rounds": max(tip - published_tip, 0),
            "attached": self._attached,
            "last_error": self.last_error,
        }
