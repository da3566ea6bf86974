"""The partial-signature cache (counterpart of `drand_tpu/beacon/cache.py`,
drand `chain/beacon/cache.go`): partials by (round, previous signature),
one a signer index, at most MAX_PARTIALS_PER_NODE a round and as many
cached rounds a signer; `flush_rounds` drops the rounds the chain has
settled.  `append` runs on the event loop, `flush_rounds` also on the
store's committing thread, so every access takes the lock.  drand_tpu's
asyncio sanitizer hooks are not ported."""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

MAX_PARTIALS_PER_NODE = 100


@dataclass
class _RoundCache:
    round: int
    prev_sig: bytes
    sigs: dict[int, bytes] = field(default_factory=dict)  # index -> sig

    def append(self, index: int, sig: bytes) -> bool:
        if index in self.sigs or len(self.sigs) >= MAX_PARTIALS_PER_NODE:
            return False
        self.sigs[index] = sig
        return True

    def __len__(self) -> int:
        return len(self.sigs)

    def partials(self) -> list[tuple[int, bytes]]:
        return sorted(self.sigs.items())


class PartialCache:
    def __init__(self):
        self._mu = threading.Lock()
        self._rounds: dict[tuple[int, bytes], _RoundCache] = {}
        # distinct (round, prev) slots a signer occupies
        self._per_signer: dict[int, int] = {}

    def append(self, round_: int, prev_sig: bytes, index: int,
               sig: bytes) -> "_RoundCache | None":
        """The round's cache with the partial added (a duplicate index
        leaves it as it was); None when the signer may open no more
        slots."""
        with self._mu:
            key = (round_, prev_sig)
            rc = self._rounds.get(key)
            if rc is None:
                if self._per_signer.get(index, 0) >= MAX_PARTIALS_PER_NODE:
                    return None
                rc = _RoundCache(round_, prev_sig)
                self._rounds[key] = rc
            if rc.append(index, sig):
                self._per_signer[index] = self._per_signer.get(index, 0) + 1
            return rc

    def get(self, round_: int, prev_sig: bytes) -> "_RoundCache | None":
        with self._mu:
            return self._rounds.get((round_, prev_sig))

    def rounds(self) -> list[int]:
        with self._mu:
            return [r for r, _ in self._rounds]

    def flush_rounds(self, upto_round: int) -> None:
        """Drop every cached round <= upto_round."""
        with self._mu:
            for key in [k for k in self._rounds if k[0] <= upto_round]:
                rc = self._rounds.pop(key)
                for idx in rc.sigs:
                    n = self._per_signer.get(idx, 1) - 1
                    if n <= 0:
                        self._per_signer.pop(idx, None)
                    else:
                        self._per_signer[idx] = n

    def __len__(self) -> int:
        with self._mu:
            return len(self._rounds)
