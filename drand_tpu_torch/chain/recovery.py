"""Startup integrity scan and repair of the chain store (counterpart of
`drand_tpu/chain/recovery.py`).

  `scan_store`       one streaming pass over the stored chain: each row
                     decoded (a torn or rotted row is reported, the scan
                     goes on), round contiguity, chained `previous_sig`
                     linkage and, when a verifier is given, every
                     signature through `ChainVerifier`'s batched check
                     (`verify_packed_segment_async`, on the card) in
                     segments of `segment_rounds`.  -> `IntegrityReport`
  `repair_store`     damaged rounds to the quarantine table, the tip
                     rolled back to the last verified prefix.
  `startup_recovery` the scan and, if damage was found, the repair: what
                     a node runs at boot.

With `verifier=None` only the structural checks run (`util fsck`): this
module loads no kernel module by itself.
"""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass, field

import numpy as np

from drand_tpu_torch.chain import codec as row_codec
from drand_tpu_torch.chain.beacon import GENESIS_ROUND
from drand_tpu_torch.chain.segment import PackedBeacons, pack_rows

log = logging.getLogger("drand_tpu_torch.chain.recovery")

# stored rounds per batched verify: the largest verify bucket
SCAN_SEGMENT_ROUNDS = 16384
# raw rows fetched per sqlite call
SCAN_READ_BATCH = 4096


@dataclass
class IntegrityReport:
    """Outcome of one integrity scan.

    `verified_tip` is the last round of the longest clean prefix: every
    round at or below it decoded, is contiguous from the first stored
    round, links to its predecessor and (when `verify_checked`) carries a
    valid BLS signature.  -1 means no clean prefix (an empty store, or
    damage at the first row)."""

    beacon_id: str = ""
    path: str = ""
    scanned: int = 0                 # rows examined
    first_round: int = -1            # first stored round (-1 if empty)
    tip_round: int = -1              # last stored round (-1 if empty)
    verified_tip: int = -1
    corrupt: list[int] = field(default_factory=list)      # decode failures
    missing: list[tuple[int, int]] = field(default_factory=list)  # gaps
    unlinked: list[int] = field(default_factory=list)     # prev-sig breaks
    bad_sigs: list[int] = field(default_factory=list)     # BLS failures
    verify_checked: bool = False     # the BLS stage ran
    elapsed_s: float = 0.0

    @property
    def ok(self) -> bool:
        return not (self.corrupt or self.missing or self.unlinked
                    or self.bad_sigs)

    @property
    def damaged_rounds(self) -> list[int]:
        """Every round that must leave the live chain; missing ranges have
        no rows to move."""
        return sorted(set(self.corrupt) | set(self.unlinked)
                      | set(self.bad_sigs))

    def to_dict(self) -> dict:
        return {
            "beacon_id": self.beacon_id,
            "path": self.path,
            "ok": self.ok,
            "scanned": self.scanned,
            "first_round": self.first_round,
            "tip_round": self.tip_round,
            "verified_tip": self.verified_tip,
            "corrupt": list(self.corrupt),
            "missing": [[a, b] for (a, b) in self.missing],
            "unlinked": list(self.unlinked),
            "bad_sigs": list(self.bad_sigs),
            "verify_checked": self.verify_checked,
            "elapsed_s": round(self.elapsed_s, 6),
        }


async def scan_store(store, verifier=None, *, beacon_id: str = "",
                     segment_rounds: int = SCAN_SEGMENT_ROUNDS,
                     read_batch: int = SCAN_READ_BATCH) -> IntegrityReport:
    """One streaming pass over the stored chain -> IntegrityReport.

    `store` is a SqliteStore (its `raw_rows` feed shows damaged blobs).
    With `verifier=None` only the structural checks run; with a
    ChainVerifier the good rows also go through its batched check in
    `segment_rounds` segments.  Every sqlite read and verify runs in a
    worker thread, so the event loop stays live."""
    t0 = time.perf_counter()
    report = IntegrityReport(beacon_id=beacon_id,
                             path=getattr(store, "path", ""),
                             verify_checked=verifier is not None)
    expected: int | None = None      # next contiguous round
    prev_good: tuple[int, bytes] | None = None   # (round, sig), last good row
    pending: list[tuple[int, bytes, bytes]] = []  # BLS backlog (r, sig, prev)

    async def flush_bls() -> None:
        if verifier is None or not pending:
            return
        singles: list = []
        for item in pack_rows(pending, max_chunk=segment_rounds):
            if isinstance(item, PackedBeacons):
                # anchored on the run's own stored prev: the linkage to the
                # real predecessor was judged structurally, so the batch
                # checks the signatures over exactly the stored bytes
                ok = await asyncio.to_thread(
                    lambda it=item: np.asarray(
                        verifier.verify_packed_segment_async(
                            it, it.first_prev)()))
                for i in np.nonzero(~ok)[0]:
                    report.bad_sigs.append(int(item.start_round + int(i)))
            else:
                singles.append(item)
        if singles:
            ok = np.asarray(await asyncio.to_thread(
                verifier.verify_beacons, singles))
            for b, good in zip(singles, ok):
                if not bool(good):
                    report.bad_sigs.append(b.round)
        pending.clear()

    next_round = GENESIS_ROUND
    while True:
        rows = await asyncio.to_thread(store.raw_rows, next_round, read_batch)
        if not rows:
            break
        for r, blob in rows:
            report.scanned += 1
            if report.first_round < 0:
                report.first_round = r
            report.tip_round = r
            if expected is not None and r > expected:
                report.missing.append((expected, r - 1))
            expected = r + 1
            try:
                decoded_round, sig, prev = row_codec.decode_fields(blob)
                if decoded_round != r:
                    raise row_codec.CodecError(
                        f"row decodes to round {decoded_round}")
            except row_codec.CodecError:
                report.corrupt.append(r)
                prev_good = None
                continue
            if prev and prev_good is not None and prev_good[0] == r - 1 \
                    and prev != prev_good[1]:
                # the stored prev contradicts the predecessor's sig: the
                # damage is this row's (its sig may still be the chain's,
                # so it stays the anchor of r + 1)
                report.unlinked.append(r)
                prev_good = (r, sig)
                continue
            prev_good = (r, sig)
            if r != GENESIS_ROUND:       # genesis is an anchor, not a sig
                pending.append((r, sig, prev))
            if len(pending) >= segment_rounds:
                await flush_bls()
        next_round = rows[-1][0] + 1
    await flush_bls()

    problems = (report.corrupt + report.unlinked + report.bad_sigs
                + [a for (a, _) in report.missing])
    if report.scanned == 0:
        report.verified_tip = -1
    elif problems:
        report.verified_tip = min(problems) - 1
    else:
        report.verified_tip = report.tip_round
    report.elapsed_s = time.perf_counter() - t0
    return report


def repair_store(store, report: IntegrityReport) -> dict:
    """Quarantine and roll back (blocking; call it off the event loop).

    Damaged rounds move to the quarantine table under their category's
    reason, then every live row past `verified_tip` too: the suffix above
    the verified prefix has lost its anchor.  Returns a summary."""
    moved = 0
    for rounds, reason in ((report.corrupt, "corrupt-row"),
                           (report.unlinked, "unlinked-prev-sig"),
                           (report.bad_sigs, "bad-signature")):
        if rounds:
            moved += store.quarantine_rounds(rounds, reason)
    truncated = store.truncate_after(report.verified_tip,
                                     "rollback-past-verified-prefix")
    if moved + truncated:
        log.warning("store repair: quarantined %d damaged + %d rolled-back "
                    "rows; tip now %d", moved, truncated,
                    report.verified_tip)
    return {"quarantined": moved, "truncated": truncated,
            "verified_tip": report.verified_tip}


async def startup_recovery(store, verifier, *, beacon_id: str = "",
                           segment_rounds: int = SCAN_SEGMENT_ROUNDS,
                           ) -> tuple[IntegrityReport, dict | None]:
    """The boot-time scan and, if damage was found, the repair.  Returns
    (report, the repair's summary or None).  The caller owns what follows
    a repair: re-syncing (verified_tip + 1 .. old tip) from peers."""
    report = await scan_store(store, verifier, beacon_id=beacon_id,
                              segment_rounds=segment_rounds)
    if report.ok:
        log.info("store integrity: %d rows clean, tip %d (%.3fs%s)",
                 report.scanned, report.tip_round, report.elapsed_s,
                 "" if report.verify_checked else ", structural only")
        return report, None
    log.warning(
        "store integrity: damage found: %d corrupt, %d unlinked, %d bad "
        "sigs, %d missing ranges; verified prefix ends at %d",
        len(report.corrupt), len(report.unlinked), len(report.bad_sigs),
        len(report.missing), report.verified_tip)
    summary = await asyncio.to_thread(repair_store, store, report)
    return report, summary
