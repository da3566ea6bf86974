"""The chain store: sqlite, its read-and-repair side, and the decorators a
sync commits through (counterpart of `drand_tpu/chain/store.py`
`SqliteStore`, `StoreDecorator`, `AppendStore`, `SchemeStore`,
`DiscrepancyStore`, `CallbackStore` and `new_chain_store`).

The same two tables as `drand_tpu`'s store,

    beacons    (round INTEGER PRIMARY KEY, data BLOB NOT NULL)
    quarantine (round INTEGER PRIMARY KEY, data BLOB, reason TEXT)

with rows in `chain/codec.py`'s layout, so a database written by either
package opens in the other.  WAL journaling at `synchronous=NORMAL`: one
transaction a commit, atomic across a process kill.  Rows that fail to
decode on the way out raise `CorruptRowError` with their round; the
quarantine table keeps damaged and rolled-back rows, nothing is
silently deleted.
"""

from __future__ import annotations

import os
import sqlite3
import threading
import time as _time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Optional

from drand_tpu_torch.chain import codec as row_codec
from drand_tpu_torch.chain.beacon import Beacon
from drand_tpu_torch.chain.time import time_of_round

# rows fetched per sqlite call on a deep scan (iter_range)
_FETCH_BATCH = 1024


class StoreError(Exception):
    pass


class BeaconNotFound(StoreError):
    pass


class CorruptRowError(StoreError):
    """A stored row failed to decode (torn write, bit-rot) or decoded to a
    beacon whose round disagrees with its key; carries the round."""

    def __init__(self, round_: int, detail: str):
        super().__init__(f"corrupt row at round {round_}: {detail}")
        self.round = round_
        self.detail = detail


class Store:
    """Abstract store interface (drand `chain/store.go`).  `put_many`
    commits a verified segment; the default loops `put`."""

    def put(self, beacon: Beacon) -> None:
        raise NotImplementedError

    def put_many(self, beacons) -> None:
        for b in beacons:
            self.put(b)

    def last(self) -> Beacon:
        raise NotImplementedError

    def get(self, round_: int) -> Beacon:
        raise NotImplementedError

    def delete(self, round_: int) -> None:
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError

    def cursor(self) -> "Cursor":
        raise NotImplementedError

    def close(self) -> None:
        pass

    def save_to(self, path: str) -> None:
        raise NotImplementedError


class Cursor:
    """Iteration over rounds (drand `chain/store.go`)."""

    def __init__(self, store: "SqliteStore"):
        self._store = store

    def first(self) -> Optional[Beacon]:
        return self._store._edge("ASC")

    def last(self) -> Optional[Beacon]:
        return self._store._edge("DESC")

    def seek(self, round_: int) -> Optional[Beacon]:
        try:
            return self._store.get(round_)
        except BeaconNotFound:
            return None

    def iter_from(self, round_: int) -> Iterator[Beacon]:
        yield from self._store.iter_range(round_)


class SqliteStore(Store):
    """The physical store: one sqlite file, one connection a thread.
    `codec` picks the row writer ('binary' or the legacy 'json'); reads
    take both."""

    def __init__(self, path: str, codec: str = "binary"):
        self.path = path
        if os.path.dirname(path):
            os.makedirs(os.path.dirname(path), exist_ok=True)
        self._local = threading.local()
        self._lock = threading.Lock()
        self._encode = row_codec.make_encoder(codec)
        conn = self._conn()
        with conn:
            conn.execute(
                "CREATE TABLE IF NOT EXISTS beacons ("
                "round INTEGER PRIMARY KEY, data BLOB NOT NULL)")
            conn.execute(
                "CREATE TABLE IF NOT EXISTS quarantine ("
                "round INTEGER PRIMARY KEY, data BLOB, reason TEXT)")

    def _conn(self) -> sqlite3.Connection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = sqlite3.connect(self.path, timeout=30)
            conn.execute("PRAGMA journal_mode=WAL")
            conn.execute("PRAGMA synchronous=NORMAL")
            self._local.conn = conn
        return conn

    @staticmethod
    def _decode_row(round_: int, data: bytes) -> Beacon:
        """Decode one stored row, its decoded round checked against the
        row's key."""
        try:
            b = row_codec.decode_beacon(data)
        except row_codec.CodecError as exc:
            raise CorruptRowError(round_, str(exc)) from exc
        if b.round != round_:
            raise CorruptRowError(
                round_, f"row decodes to round {b.round}")
        return b

    def put(self, beacon: Beacon) -> None:
        with self._conn() as conn:
            conn.execute(
                "INSERT OR REPLACE INTO beacons (round, data) VALUES (?, ?)",
                (beacon.round, self._encode(beacon)))

    def put_many(self, beacons) -> None:
        """One transaction for a whole segment."""
        enc = self._encode
        with self._conn() as conn:
            conn.executemany(
                "INSERT OR REPLACE INTO beacons (round, data) VALUES (?, ?)",
                [(b.round, enc(b)) for b in beacons])

    def last(self) -> Beacon:
        row = self._conn().execute(
            "SELECT round, data FROM beacons "
            "ORDER BY round DESC LIMIT 1").fetchone()
        if row is None:
            raise BeaconNotFound("empty store")
        return self._decode_row(row[0], row[1])

    def get(self, round_: int) -> Beacon:
        row = self._conn().execute(
            "SELECT data FROM beacons WHERE round = ?", (round_,)).fetchone()
        if row is None:
            raise BeaconNotFound(f"round {round_} not stored")
        return self._decode_row(round_, row[0])

    def delete(self, round_: int) -> None:
        with self._conn() as conn:
            conn.execute("DELETE FROM beacons WHERE round = ?", (round_,))

    def __len__(self) -> int:
        return self._conn().execute(
            "SELECT COUNT(*) FROM beacons").fetchone()[0]

    def _edge(self, order: str) -> Optional[Beacon]:
        row = self._conn().execute(
            f"SELECT round, data FROM beacons "
            f"ORDER BY round {order} LIMIT 1").fetchone()
        return self._decode_row(row[0], row[1]) if row else None

    def iter_range(self, start_round: int,
                   limit: int | None = None) -> Iterator[Beacon]:
        q = "SELECT round, data FROM beacons WHERE round >= ? ORDER BY round ASC"
        args: tuple = (start_round,)
        if limit is not None:
            q += " LIMIT ?"
            args = (start_round, limit)
        cur = self._conn().execute(q, args)
        while True:
            rows = cur.fetchmany(_FETCH_BATCH)
            if not rows:
                return
            for (r, data) in rows:
                yield self._decode_row(r, data)

    def read_fields(self, start_round: int,
                    limit: int) -> list[tuple[int, bytes, bytes]]:
        """Up to `limit` (round, sig, prev) tuples from `start_round` in one
        query, no Beacon made.  A damaged row raises CorruptRowError with
        its round."""
        rows = self._conn().execute(
            "SELECT round, data FROM beacons WHERE round >= ? "
            "ORDER BY round ASC LIMIT ?", (start_round, limit)).fetchall()
        out = []
        for (r, data) in rows:
            try:
                fields = row_codec.decode_fields(data)
            except row_codec.CodecError as exc:
                raise CorruptRowError(r, str(exc)) from exc
            if fields[0] != r:
                raise CorruptRowError(r, f"row decodes to round {fields[0]}")
            out.append(fields)
        return out

    # -- recovery surface (chain/recovery.py) --------------------------------

    def raw_rows(self, start_round: int,
                 limit: int) -> list[tuple[int, bytes]]:
        """Stored (round, blob) pairs, not decoded: the integrity scan's
        feed, which must see damaged rows."""
        return [(r, bytes(d)) for (r, d) in self._conn().execute(
            "SELECT round, data FROM beacons WHERE round >= ? "
            "ORDER BY round ASC LIMIT ?", (start_round, limit)).fetchall()]

    def quarantine_rounds(self, rounds, reason: str) -> int:
        """Move the given rounds from the live chain into the quarantine
        table in one transaction; returns how many rows moved."""
        rounds = sorted(set(rounds))
        if not rounds:
            return 0
        moved = 0
        with self._conn() as conn:
            for r in rounds:
                cur = conn.execute(
                    "INSERT OR REPLACE INTO quarantine (round, data, reason) "
                    "SELECT round, data, ? FROM beacons WHERE round = ?",
                    (reason, r))
                moved += cur.rowcount
                conn.execute("DELETE FROM beacons WHERE round = ?", (r,))
        return moved

    def truncate_after(self, round_: int, reason: str) -> int:
        """Roll the tip back to `round_`: every live row above it moves to
        quarantine.  Returns how many rows moved."""
        with self._conn() as conn:
            cur = conn.execute(
                "INSERT OR REPLACE INTO quarantine (round, data, reason) "
                "SELECT round, data, ? FROM beacons WHERE round > ?",
                (reason, round_))
            moved = cur.rowcount
            conn.execute("DELETE FROM beacons WHERE round > ?", (round_,))
        return moved

    def quarantined(self) -> list[tuple[int, str]]:
        """(round, reason) of every quarantined row, ascending."""
        return [(r, reason or "") for (r, reason) in self._conn().execute(
            "SELECT round, reason FROM quarantine ORDER BY round ASC")]

    def quarantined_rows(self) -> list[tuple[int, bytes, str]]:
        """(round, data, reason) of every quarantined row, ascending."""
        return [(r, bytes(d) if d is not None else b"", reason or "")
                for (r, d, reason) in self._conn().execute(
                    "SELECT round, data, reason FROM quarantine "
                    "ORDER BY round ASC")]

    def cursor(self) -> Cursor:
        return Cursor(self)

    def save_to(self, path: str) -> None:
        """Hot backup: written to a temporary file beside `path`, then
        os.replace()d into place, so a crash never leaves half a
        database at `path`."""
        tmp = f"{path}.tmp.{os.getpid()}"
        dst = sqlite3.connect(tmp)
        try:
            with self._lock:
                self._conn().backup(dst)
            dst.close()
            os.replace(tmp, path)
        except BaseException:
            dst.close()
            if os.path.exists(tmp):
                os.remove(tmp)
            raise

    def close(self) -> None:
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            conn.close()
            self._local.conn = None


class StoreDecorator(Store):
    """A store that forwards every call to `inner`; the decorators below
    override what they check (drand `chain/store.go`)."""

    def __init__(self, inner: Store):
        self.inner = inner

    def _last_or_none(self) -> Optional[Beacon]:
        try:
            return self.inner.last()
        except BeaconNotFound:
            return None

    def put(self, beacon: Beacon) -> None:
        self.inner.put(beacon)

    def last(self) -> Beacon:
        return self.inner.last()

    def get(self, round_: int) -> Beacon:
        return self.inner.get(round_)

    def delete(self, round_: int) -> None:
        self.inner.delete(round_)

    def __len__(self) -> int:
        return len(self.inner)

    def cursor(self) -> Cursor:
        return self.inner.cursor()

    def close(self) -> None:
        self.inner.close()

    def save_to(self, path: str) -> None:
        self.inner.save_to(path)

    def iter_range(self, start_round: int, limit=None):
        return self.inner.iter_range(start_round, limit)

    def read_fields(self, start_round: int, limit: int):
        return self.inner.read_fields(start_round, limit)

    def put_many(self, beacons) -> None:
        self.inner.put_many(beacons)


class AppendStore(StoreDecorator):
    """Only round = last + 1 may be appended (drand `chain/store.go`
    appendStore); a re-put of the stored head is a no-op."""

    def __init__(self, inner: Store):
        super().__init__(inner)
        self._lock = threading.Lock()

    def put(self, beacon: Beacon) -> None:
        with self._lock:
            last = self._last_or_none()
            if last is not None:
                if beacon.round == last.round and beacon.equal(last):
                    return  # idempotent re-put
                if beacon.round != last.round + 1:
                    raise StoreError(f"non-appendable round {beacon.round} "
                                     f"after {last.round}")
            self.inner.put(beacon)

    def put_many(self, beacons) -> None:
        """The same rule with one last() query: the segment must be
        contiguous and follow the stored head.  Re-puts of the head, or of
        the beacon just before inside the segment, are skipped as `put`
        skips them."""
        beacons = list(beacons)
        if not beacons:
            return
        with self._lock:
            prev = self._last_or_none()
            keep = []
            for b in beacons:
                if prev is not None and b.round == prev.round \
                        and b.equal(prev):
                    continue       # idempotent re-put
                if prev is not None and b.round != prev.round + 1:
                    raise StoreError(
                        f"non-appendable round {b.round} after {prev.round}")
                keep.append(b)
                prev = b
            self.inner.put_many(keep)


class SchemeStore(StoreDecorator):
    """The scheme's rules (drand `chain/store.go` schemeStore): unchained
    schemes store no previous signature; a chained beacon that follows the
    stored head must carry the head's signature as its previous one."""

    def __init__(self, inner: Store, decouple_prev_sig: bool):
        super().__init__(inner)
        self.decouple = decouple_prev_sig

    def put(self, beacon: Beacon) -> None:
        if self.decouple:
            beacon = Beacon(round=beacon.round, signature=beacon.signature)
        else:
            last = self._last_or_none()
            if last is not None and beacon.round == last.round + 1 \
                    and beacon.previous_sig != last.signature:
                raise StoreError(f"round {beacon.round} previous-sig does "
                                 "not link to chain")
        self.inner.put(beacon)

    def put_many(self, beacons) -> None:
        beacons = list(beacons)
        if not beacons:
            return
        if self.decouple:
            self.inner.put_many([Beacon(round=b.round, signature=b.signature)
                                 for b in beacons])
            return
        prev = self._last_or_none()
        for b in beacons:
            if prev is not None and b.round == prev.round + 1 \
                    and b.previous_sig != prev.signature:
                raise StoreError(
                    f"round {b.round} previous-sig does not link to chain")
            prev = b
        self.inner.put_many(beacons)


class DiscrepancyStore(StoreDecorator):
    """Reports a beacon's latency, now less the round's expected time, in
    milliseconds, through `on_latency(round, ms)` on every put (drand
    `chain/store.go` discrepancyStore); a segment's `put_many` reports its
    head only, and its size through `on_segment(n)`."""

    def __init__(self, inner: Store, group, clock=None, on_latency=None,
                 on_segment=None):
        super().__init__(inner)
        self.group = group
        self.clock = clock or _time.time
        self.on_latency = on_latency
        self.on_segment = on_segment

    def _latency(self, beacon: Beacon) -> None:
        expected = time_of_round(self.group.period, self.group.genesis_time,
                                 beacon.round)
        self.on_latency(beacon.round, (self.clock() - expected) * 1000.0)

    def put(self, beacon: Beacon) -> None:
        self.inner.put(beacon)
        if self.on_latency is not None:
            self._latency(beacon)

    def put_many(self, beacons) -> None:
        beacons = list(beacons)
        self.inner.put_many(beacons)
        if self.on_segment is not None and beacons:
            self.on_segment(len(beacons))
        if self.on_latency is not None and beacons:
            self._latency(beacons[-1])


class CallbackStore(StoreDecorator):
    """Hands every stored beacon to registered callbacks on a worker pool
    (drand `chain/store.go` callbackStore), so a callback never blocks the
    append path.  Two kinds:

      - `add_callback`: each beacon, in round order of submission (a
        segment's beacons as FANOUT_CHUNK-sized slices, one pool task a
        slice);
      - `add_tail_callback`: the last beacon of each commit, called on the
        committing thread (cheap bookkeeping such as a tip).

    A callback that raises is ignored.  drand_tpu's segment callbacks
    (`add_segment_callback`) have no caller in the port."""

    FANOUT_CHUNK = 512

    def __init__(self, inner: Store, workers: int | None = None):
        super().__init__(inner)
        self._cbs: dict[str, Callable[[Beacon], None]] = {}
        self._tail_cbs: dict[str, Callable[[Beacon], None]] = {}
        self._lock = threading.Lock()
        self._pool = ThreadPoolExecutor(
            max_workers=workers or min(8, (os.cpu_count() or 2)))

    def add_callback(self, cb_id: str, cb: Callable[[Beacon], None]) -> None:
        with self._lock:
            self._cbs[cb_id] = cb

    def add_tail_callback(self, cb_id: str,
                          cb: Callable[[Beacon], None]) -> None:
        with self._lock:
            self._tail_cbs[cb_id] = cb

    def remove_callback(self, cb_id: str) -> None:
        with self._lock:
            self._cbs.pop(cb_id, None)
            self._tail_cbs.pop(cb_id, None)

    def _registered(self):
        with self._lock:
            return list(self._cbs.values()), list(self._tail_cbs.values())

    def put(self, beacon: Beacon) -> None:
        self.inner.put(beacon)
        cbs, tails = self._registered()
        for cb in cbs:
            self._pool.submit(self._safe, cb, beacon)
        for cb in tails:
            self._safe(cb, beacon)

    def put_many(self, beacons) -> None:
        beacons = list(beacons)
        self.inner.put_many(beacons)
        if not beacons:
            return
        cbs, tails = self._registered()
        for cb in cbs:
            for i in range(0, len(beacons), self.FANOUT_CHUNK):
                self._pool.submit(self._safe_many, cb,
                                  beacons[i:i + self.FANOUT_CHUNK])
        for cb in tails:
            self._safe(cb, beacons[-1])

    @staticmethod
    def _safe(cb, arg) -> None:
        try:
            cb(arg)
        except Exception:
            pass

    @staticmethod
    def _safe_many(cb, beacons) -> None:
        for b in beacons:
            try:
                cb(b)
            except Exception:
                pass

    def close(self) -> None:
        self._pool.shutdown(wait=False)
        self.inner.close()


def new_chain_store(db_path: str, group, workers=None) -> CallbackStore:
    """The full stack CallbackStore(DiscrepancyStore(SchemeStore(
    AppendStore(SqliteStore)))) (drand `chain/beacon/chain.go`).  `group`
    gives `period`, `genesis_time` and `scheme_id`.  `.insecure` on the
    result is the bare SqliteStore, which repairs write through.  The
    DiscrepancyStore reports nothing: the latency and segment metrics it
    feeds in drand_tpu are not ported."""
    from drand_tpu_torch.chain.scheme import scheme_by_id
    scheme = scheme_by_id(group.scheme_id)
    base = SqliteStore(db_path)
    stack = SchemeStore(AppendStore(base), scheme.decouple_prev_sig)
    stack = DiscrepancyStore(stack, group)
    out = CallbackStore(stack, workers=workers)
    out.insecure = base
    return out
