"""Injectable clocks (counterpart of `drand_tpu/beacon/clock.py`, drand's
clockwork clocks): `SystemClock` is the wall clock under the event loop;
`FakeClock` moves only when it is advanced, and wakes the sleepers whose
deadline it passes, so a multi-round test runs in the time its work
takes."""

from __future__ import annotations

import asyncio
import heapq
import time as _time


class Clock:
    def now(self) -> float:
        raise NotImplementedError

    async def sleep(self, seconds: float) -> None:
        raise NotImplementedError

    async def sleep_until(self, t: float) -> None:
        delta = t - self.now()
        if delta > 0:
            await self.sleep(delta)


class SystemClock(Clock):
    def now(self) -> float:
        return _time.time()

    async def sleep(self, seconds: float) -> None:
        await asyncio.sleep(max(seconds, 0))


class FakeClock(Clock):
    """Time moves only through `advance` and `set_time`, which wake each
    sleeper whose deadline is reached, in deadline order, and yield to
    the event loop so that the woken tasks run before they return."""

    def __init__(self, start: float = 1_600_000_000.0):
        self._now = start
        self._sleepers: list[tuple[float, int, asyncio.Future]] = []
        self._seq = 0

    def now(self) -> float:
        return self._now

    async def sleep(self, seconds: float) -> None:
        if seconds <= 0:
            await asyncio.sleep(0)
            return
        fut = asyncio.get_running_loop().create_future()
        self._seq += 1
        heapq.heappush(self._sleepers, (self._now + seconds, self._seq, fut))
        await fut

    async def advance(self, seconds: float, steps: int = 50) -> None:
        await self.set_time(self._now + seconds, steps)

    async def set_time(self, t: float, steps: int = 50) -> None:
        while self._sleepers and self._sleepers[0][0] <= t:
            deadline, _, fut = heapq.heappop(self._sleepers)
            self._now = max(self._now, deadline)
            if not fut.done():
                fut.set_result(None)
            for _ in range(steps):
                await asyncio.sleep(0)
        self._now = max(self._now, t)
        for _ in range(steps):
            await asyncio.sleep(0)
