"""Dispatch feed: one record per batched dispatch (counterpart of
`drand_tpu/profiling/dispatch.py`, without its metrics and tracing).

A batched seam pads the requested work up to a bucket
(`verify.py` `bucket`); each record keeps the requested n, the bucket,
the fill ratio, the padding rounds and the seconds the call took, in a
bounded ring.

Seams:
  verify     Verifier.verify_batch_async (catch-up and scan batches)
  partials   DeviceBackend.verify_partials (partial signatures in arrival
             order, beacon/crypto_backend.py)
  rounds     DeviceBackend.verify_partials_rounds (rounds-major partials)

Recording is O(1), lock-guarded and never raises into the caller.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass


@dataclass
class DispatchRecord:
    """One batched dispatch through a padded seam."""
    seam: str
    n: int                      # rounds (partials) actually requested
    bucket: int                 # padded size the kernels saw
    device_s: float             # seconds from dispatch through resolve
    wall: float = 0.0           # wall-clock stamp (for correlation only)

    @property
    def fill_ratio(self) -> float:
        return (self.n / self.bucket) if self.bucket > 0 else 0.0

    @property
    def padding_rounds(self) -> int:
        return max(self.bucket - self.n, 0)

    def to_dict(self) -> dict:
        return {
            "seam": self.seam, "n": self.n, "bucket": self.bucket,
            "fill_ratio": round(self.fill_ratio, 4),
            "padding_rounds": self.padding_rounds,
            "device_s": round(self.device_s, 9),
            "wall": round(self.wall, 6),
        }


class DispatchRecorder:
    """Bounded ring of DispatchRecords; thread-safe (records land from
    resolvers in worker threads)."""

    def __init__(self, maxlen: int = 2048):
        self._ring: deque[DispatchRecord] = deque(maxlen=maxlen)
        self._lock = threading.Lock()

    def record(self, seam: str, n: int, bucket: int,
               device_s: float) -> DispatchRecord:
        rec = DispatchRecord(seam=seam, n=int(n), bucket=int(bucket),
                             device_s=float(device_s), wall=time.time())
        with self._lock:
            self._ring.append(rec)
        return rec

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def records(self, seam: str | None = None) -> list[DispatchRecord]:
        with self._lock:
            recs = list(self._ring)
        return [r for r in recs if seam is None or r.seam == seam]

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()


DISPATCH = DispatchRecorder()


def record_dispatch(seam: str, n: int, bucket: int, device_s: float) -> None:
    """Record one dispatch in DISPATCH; never raises."""
    try:
        DISPATCH.record(seam, n, bucket, device_s)
    except Exception:
        pass


class timed_dispatch:
    """Context manager timing one call for a seam:

        with timed_dispatch("verify", n=n, bucket=m):
            ok = kernel(...)
    """

    def __init__(self, seam: str, n: int, bucket: int):
        self.seam = seam
        self.n = n
        self.bucket = bucket
        self._t0 = 0.0
        self.device_s = 0.0

    def __enter__(self) -> "timed_dispatch":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.device_s = time.perf_counter() - self._t0
        record_dispatch(self.seam, self.n, self.bucket, self.device_s)
