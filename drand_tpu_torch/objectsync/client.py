"""Verify-then-commit sync from published segment objects (counterpart of
`drand_tpu/objectsync/client.py`).

`ObjectSyncClient` catches a store up from a backend: it fetches the
manifest, then each needed segment, verifies it locally and commits it in
one transaction.  Object contents are never believed:

  - the content hash pinned in the manifest must match the fetched bytes
    (truncation, bit-rot or a stale cache are caught before any crypto);
  - every row is verified through
    `ChainVerifier.verify_packed_segment_async` against the previous
    column built from the client's own chain anchor, so a segment whose
    linkage or signatures lie fails as a whole (a segment of more than 32
    rounds is one batch on the verifier's device, a shorter one verifies
    on the host);
  - commits go through the store's `put_many` (one transaction), so a
    failed segment commits nothing of itself or of later ones.

Commits follow the manifest's order; fetches run ahead through a small
prefetch window.  Any failure (fetch, decode, hash, verify, commit) stops
the sync at the last verified segment boundary: the store holds exactly
a verified prefix.  drand_tpu's retry hub (its `resilience` argument) is
not ported: a fetch is tried once.
"""

from __future__ import annotations

import asyncio
import logging
import time

import numpy as np

from drand_tpu_torch.chain.segment import PackedBeacons
from drand_tpu_torch.chain.store import BeaconNotFound
from drand_tpu_torch.objectsync import format as ofmt
from drand_tpu_torch.objectsync.backends import ObjectStore

log = logging.getLogger("drand_tpu_torch.objectsync")

PREFETCH_DEPTH = 2     # segments fetched ahead of the verify/commit head


class ObjectSyncError(Exception):
    pass


class CorruptObjectError(ObjectSyncError):
    """An object whose bytes do not match its manifest content hash, or
    that fails structural decode: damaged in storage or in transit."""


class SyncResult:
    def __init__(self, ok: bool, synced_to: int, segments: int,
                 rounds: int, error: str = ""):
        self.ok = ok
        self.synced_to = synced_to
        self.segments = segments
        self.rounds = rounds
        self.error = error

    def to_dict(self) -> dict:
        return {"ok": self.ok, "synced_to": self.synced_to,
                "segments": self.segments, "rounds": self.rounds,
                "error": self.error}


class ObjectSyncClient:
    def __init__(self, backend: ObjectStore, store, verifier,
                 chain_hash: bytes | None = None):
        """backend: where the objects live; store: the decorated chain
        store to commit through; verifier: the port's ChainVerifier of the
        pinned chain; chain_hash: the trust root, so a manifest or segment
        of another chain is refused before any commit."""
        self.backend = backend
        self.store = store
        self.verifier = verifier
        self.chain_hash = chain_hash
        # host seconds of each stage and what was committed
        self.stats = {"fetch_s": 0.0, "verify_s": 0.0, "commit_s": 0.0,
                      "segments": 0, "rounds": 0}

    async def manifest(self) -> ofmt.Manifest:
        m = ofmt.Manifest.from_json(await self.backend.get(ofmt.MANIFEST_NAME))
        if self.chain_hash is not None \
                and m.chain_hash != self.chain_hash.hex():
            raise ObjectSyncError(
                f"manifest is for chain {m.chain_hash}, pinned "
                f"{self.chain_hash.hex()}")
        return m

    async def _fetch_segment(self, entry: ofmt.ManifestEntry) -> bytes:
        t0 = time.perf_counter()
        data = await self.backend.get(entry.name)
        self.stats["fetch_s"] += time.perf_counter() - t0
        if ofmt.content_hash(data) != entry.hash:
            raise CorruptObjectError(
                f"object {entry.name}: content hash mismatch "
                f"({len(data)} bytes)")
        return data

    def _packed(self, entry: ofmt.ManifestEntry, data: bytes,
                skip_to: int) -> PackedBeacons | None:
        """Decode one segment and check it against its manifest entry,
        dropping rounds at or below `skip_to` (a segment partly behind the
        local tip); None when nothing is left.  The object's own previous
        column is discarded: linkage is rebuilt from the caller's
        anchor."""
        seg = ofmt.decode_segment(data)
        if self.chain_hash is not None and seg.chain_hash != self.chain_hash:
            raise CorruptObjectError(
                f"object {entry.name}: wrong chain {seg.chain_hash.hex()}")
        if seg.start_round != entry.start or seg.count != entry.count:
            raise CorruptObjectError(
                f"object {entry.name}: covers {seg.start_round}+"
                f"{seg.count}, manifest says {entry.start}+{entry.count}")
        rows = seg.rows
        if skip_to >= seg.start_round:
            rows = rows[skip_to - seg.start_round + 1:]
        if not rows:
            return None
        sig_len = len(rows[0][1])
        if any(len(sig) != sig_len for (_, sig, _) in rows):
            raise CorruptObjectError(
                f"object {entry.name}: non-uniform signature lengths")
        sigs = np.frombuffer(b"".join(sig for (_, sig, _) in rows),
                             dtype=np.uint8).reshape(len(rows), sig_len)
        return PackedBeacons(
            start_round=rows[0][0], sigs=sigs,
            chained=not self.verifier.scheme.decouple_prev_sig)

    async def sync(self, up_to: int = 0) -> SyncResult:
        """Catch the local store up from the backend, up to round `up_to`
        (0: the whole manifest).  Returns instead of raising on a poisoned
        object: the caller reads ``ok`` and ``error``, and the store holds
        exactly the verified prefix."""
        try:
            last = self.store.last()
        except BeaconNotFound:
            return SyncResult(False, -1, 0, 0,
                              "store has no anchor (seed genesis first)")
        try:
            m = await self.manifest()
        except Exception as exc:
            return SyncResult(False, last.round, 0, 0,
                              f"manifest fetch failed: {exc}")
        todo = [e for e in m.segments
                if e.end > last.round and (not up_to or e.start <= up_to)]
        anchor_round, anchor_sig = last.round, last.signature
        segments = rounds = 0
        # fetches for segments k..k+depth run while segment k verifies and
        # commits; commits stay in manifest order
        tasks: list[asyncio.Task] = [
            asyncio.ensure_future(self._fetch_segment(e))
            for e in todo[:PREFETCH_DEPTH]]
        error = ""
        try:
            for i, entry in enumerate(todo):
                nxt = i + PREFETCH_DEPTH
                if nxt < len(todo):
                    tasks.append(asyncio.ensure_future(
                        self._fetch_segment(todo[nxt])))
                try:
                    data = await tasks[i]
                    packed = self._packed(entry, data, anchor_round)
                except Exception as exc:
                    error = f"segment {entry.name}: {exc}"
                    break
                if packed is None:
                    continue               # wholly behind the local tip
                if up_to and packed.end_round > up_to:
                    if up_to < packed.start_round:
                        break
                    packed = packed.truncate(up_to)
                t0 = time.perf_counter()
                try:
                    resolver = self.verifier.verify_packed_segment_async(
                        packed, anchor_sig)
                    ok = np.asarray(await asyncio.to_thread(resolver))
                except Exception as exc:
                    error = f"segment {entry.name}: verify error: {exc}"
                    break
                self.stats["verify_s"] += time.perf_counter() - t0
                if not bool(np.all(ok)):
                    bad = [int(packed.start_round + j)
                           for j in np.nonzero(~ok)[0][:5]]
                    error = (f"segment {entry.name}: verification failed "
                             f"at rounds {bad}")
                    break
                t0 = time.perf_counter()
                beacons = packed.beacons(anchor_sig=anchor_sig)
                try:
                    await asyncio.to_thread(self.store.put_many, beacons)
                except Exception as exc:
                    error = f"segment {entry.name}: commit failed: {exc}"
                    break
                self.stats["commit_s"] += time.perf_counter() - t0
                self.stats["segments"] += 1
                self.stats["rounds"] += len(beacons)
                segments += 1
                rounds += len(beacons)
                anchor_round = packed.end_round
                anchor_sig = packed.tail_sig
                if up_to and anchor_round >= up_to:
                    break
        finally:
            for t in tasks:
                if not t.done():
                    t.cancel()
            # reap the cancellations so nothing leaks into the caller's loop
            await asyncio.gather(*tasks, return_exceptions=True)
        if error:
            log.warning("objectsync client stopped at round %d: %s",
                        anchor_round, error)
        return SyncResult(not error, anchor_round, segments, rounds, error)
