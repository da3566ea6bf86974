"""Packed beacon segments (counterpart of `drand_tpu/chain/segment.py`).

A `PackedBeacons` is a contiguous run of rounds as one object: a
(count, sig_len) uint8 matrix of signatures and the run's range, the
verifier's batch layout.  For chained schemes the previous-signature
column is implicit: row i's prev is row i-1's sig, and the first row
links to the anchor the consumer holds (`first_prev` is only advisory).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from drand_tpu_torch.chain.beacon import Beacon

# the most beacons `pack_rows` puts in one run unless told otherwise
WIRE_CHUNK_DEFAULT = 512


@dataclass
class PackedBeacons:
    """The rounds [start_round, start_round + len) with row-major packed
    signatures: sigs has shape (count, sig_len), dtype uint8, rows in
    round order."""
    start_round: int
    sigs: np.ndarray
    first_prev: bytes = b""
    chained: bool = True

    def __len__(self) -> int:
        return int(self.sigs.shape[0])

    @property
    def end_round(self) -> int:
        """Last round of the run (inclusive)."""
        return self.start_round + len(self) - 1

    @property
    def sig_len(self) -> int:
        return int(self.sigs.shape[1])

    @property
    def tail_sig(self) -> bytes:
        return self.sigs[-1].tobytes()

    def rounds(self) -> np.ndarray:
        return np.arange(self.start_round, self.start_round + len(self),
                         dtype=np.uint64)

    def truncate(self, up_to: int) -> "PackedBeacons":
        """The prefix with rounds <= up_to (the caller checks it is not
        empty)."""
        keep = up_to - self.start_round + 1
        return PackedBeacons(start_round=self.start_round,
                             sigs=self.sigs[:keep],
                             first_prev=self.first_prev,
                             chained=self.chained)

    def beacons(self, anchor_sig: bytes | None = None) -> list[Beacon]:
        """One Beacon a round.  A chained run rebuilds its prev column from
        the anchor and its own rows; anchor_sig, where given, stands in for
        first_prev."""
        rows = [row.tobytes() for row in self.sigs]
        if not self.chained:
            return [Beacon(round=self.start_round + i, signature=s)
                    for i, s in enumerate(rows)]
        prev = anchor_sig if anchor_sig is not None else self.first_prev
        out = []
        for i, s in enumerate(rows):
            out.append(Beacon(round=self.start_round + i, signature=s,
                              previous_sig=prev))
            prev = s
        return out


def pack_rows(rows: list[tuple[int, bytes, bytes]],
              max_chunk: int = WIRE_CHUNK_DEFAULT):
    """Group raw store rows (round, sig, prev) into items.

    Yields a PackedBeacons for each run of at least 2 contiguous rounds of
    one signature length whose linkage holds (each prev equals the
    preceding sig, or every prev is empty: the unchained schemes), and a
    bare Beacon for every other row (an irregular genesis row, a row that
    does not chain onto its neighbour).  Packing never invents linkage.
    """
    i, n = 0, len(rows)
    while i < n:
        round_, sig, prev = rows[i]
        chained = bool(prev)
        j = i + 1
        want_prev = sig
        while (j < n and j - i < max_chunk
               and rows[j][0] == rows[j - 1][0] + 1
               and len(rows[j][1]) == len(sig)
               and (rows[j][2] == want_prev if chained
                    else not rows[j][2])):
            want_prev = rows[j][1]
            j += 1
        if j - i >= 2:
            sigs = np.frombuffer(b"".join(r[1] for r in rows[i:j]),
                                 dtype=np.uint8)
            yield PackedBeacons(
                start_round=round_,
                sigs=sigs.reshape(j - i, len(sig)),
                first_prev=prev, chained=chained)
        else:
            yield Beacon(round=round_, signature=sig, previous_sig=prev)
        i = j
