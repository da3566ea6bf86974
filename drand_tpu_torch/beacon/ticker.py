"""The genesis-anchored round ticker (counterpart of
`drand_tpu/beacon/ticker.py`, drand `chain/beacon/ticker.go`): it sleeps
to the next round's time, then hands (round, time) to every subscriber's
queue without blocking; a full queue drops the tick.  drand_tpu's chaos
failpoint is not ported."""

from __future__ import annotations

import asyncio
from dataclasses import dataclass

from drand_tpu_torch.beacon.clock import Clock
from drand_tpu_torch.chain.time import current_round, next_round_at


@dataclass(frozen=True)
class RoundInfo:
    round: int
    time: float


class Ticker:
    def __init__(self, clock: Clock, period: float, genesis: float):
        self.clock = clock
        self.period = period
        self.genesis = genesis
        self._subs: list[asyncio.Queue] = []
        self._task: asyncio.Task | None = None
        self._stopped = False

    def channel(self, maxsize: int = 16) -> asyncio.Queue:
        q: asyncio.Queue = asyncio.Queue(maxsize=maxsize)
        self._subs.append(q)
        return q

    def current_round(self) -> int:
        return current_round(self.clock.now(), self.period, self.genesis)

    def start(self) -> None:
        if self._task is None:
            self._task = asyncio.get_running_loop().create_task(self._run())

    def stop(self) -> None:
        self._stopped = True
        if self._task is not None:
            self._task.cancel()
            self._task = None

    async def _run(self) -> None:
        while not self._stopped:
            now = self.clock.now()
            next_r, next_t = next_round_at(now, self.period, self.genesis)
            if now < self.genesis:
                next_r, next_t = 1, self.genesis
            await self.clock.sleep_until(next_t)
            info = RoundInfo(round=next_r, time=next_t)
            for q in self._subs:
                try:
                    q.put_nowait(info)
                except asyncio.QueueFull:
                    pass
