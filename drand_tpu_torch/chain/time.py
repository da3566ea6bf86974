"""Round <-> time arithmetic (counterpart of `drand_tpu/chain/time.py`,
drand `chain/time.go`).

Round 1 is produced at the genesis time, round r at genesis + (r - 1) *
period; before genesis the current round is 0.
"""

from __future__ import annotations

MAX_ROUND = (1 << 63) - 1


def current_round(now: float, period: float, genesis: float) -> int:
    """The round that should be produced at or before `now`; 0 before
    genesis."""
    next_r, _ = next_round_at(now, period, genesis)
    return max(next_r - 1, 0)


def next_round_at(now: float, period: float,
                  genesis: float) -> tuple[int, float]:
    """(the next round, its production time)."""
    if now < genesis:
        return 1, genesis
    next_r = int((now - genesis) // period) + 2
    return next_r, genesis + (next_r - 1) * period


def time_of_round(period: float, genesis: float, round_: int) -> float:
    """Production time of a round; genesis for round 0 and for a round
    past MAX_ROUND."""
    if round_ <= 0 or round_ > MAX_ROUND:
        return genesis
    return genesis + (round_ - 1) * period
