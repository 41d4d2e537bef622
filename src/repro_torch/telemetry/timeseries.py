"""Ring-buffer time series: the step-resolved view of the serving stack.

``TimeSeriesSampler`` is driven once per scheduler step (the cluster's
virtual clock tick): every registered source callback is evaluated and
its value appended to a fixed-capacity ring buffer, so memory stays
bounded however long the cluster runs.  The autoscaler reads windowed
aggregates from these series; the JSONL step tracer snapshots the same
row per step.

Wall-clock export mode (``wall_clock=True``): every push additionally
records the REAL host timestamp in a parallel ring (``sampler.wall``),
so a serving gateway — where steps happen at actual wall times — can
export the same series against real time while the virtual-time rings
(and everything computed from them) stay byte-for-byte identical to an
in-process run.  Values are never affected by the mode; only the extra
timestamps are.
"""
from __future__ import annotations

import math
import time
from typing import Callable, Optional


class RingBuffer:
    """Fixed-capacity (time, value) ring: O(1) push, ordered readout."""

    __slots__ = ("capacity", "_t", "_v", "_head", "_n")

    def __init__(self, capacity: int = 512):
        if capacity <= 0:
            raise ValueError("ring capacity must be positive")
        self.capacity = capacity
        self._t = [0.0] * capacity
        self._v = [0.0] * capacity
        self._head = 0        # next write position
        self._n = 0

    def __len__(self) -> int:
        return self._n

    def push(self, t: float, v: float) -> None:
        self._t[self._head] = float(t)
        self._v[self._head] = float(v)
        self._head = (self._head + 1) % self.capacity
        self._n = min(self._n + 1, self.capacity)

    def items(self) -> list[tuple[float, float]]:
        """Samples oldest-first (wraparound unrolled)."""
        start = (self._head - self._n) % self.capacity
        return [(self._t[(start + i) % self.capacity],
                 self._v[(start + i) % self.capacity])
                for i in range(self._n)]

    def values(self) -> list[float]:
        return [v for _, v in self.items()]

    def last(self) -> Optional[tuple[float, float]]:
        if self._n == 0:
            return None
        i = (self._head - 1) % self.capacity
        return self._t[i], self._v[i]

    def window_mean(self, k: int) -> float:
        """Mean of the most recent ``k`` samples (NaN when empty)."""
        if self._n == 0:
            return math.nan
        k = min(k, self._n)
        start = (self._head - k) % self.capacity
        return sum(self._v[(start + i) % self.capacity]
                   for i in range(k)) / k

    def window_max(self, k: int) -> float:
        if self._n == 0:
            return math.nan
        k = min(k, self._n)
        start = (self._head - k) % self.capacity
        return max(self._v[(start + i) % self.capacity] for i in range(k))


class TimeSeriesSampler:
    """Named ring-buffer series fed by source callbacks once per step.

    ``add_source(name, fn)`` registers a zero-arg callable evaluated at
    every ``sample(now)``; series can also be pushed directly
    (``push(name, t, v)``) for values only known at event time."""

    def __init__(self, capacity: int = 512, wall_clock: bool = False,
                 clock: Callable[[], float] = time.time):
        self.capacity = capacity
        self.series: dict[str, RingBuffer] = {}
        # wall-clock mode: parallel rings keyed by the same series names,
        # timestamped by ``clock()`` at push time (values identical)
        self.wall_clock = wall_clock
        self.wall: dict[str, RingBuffer] = {}
        self._clock = clock
        self._sources: dict[str, Callable[[], float]] = {}
        self.n_samples = 0

    def add_source(self, name: str, fn: Callable[[], float]) -> None:
        self._sources[name] = fn
        self.series.setdefault(name, RingBuffer(self.capacity))

    def push(self, name: str, t: float, v: float) -> None:
        self.series.setdefault(name, RingBuffer(self.capacity)).push(t, v)
        if self.wall_clock:
            self.wall.setdefault(name, RingBuffer(self.capacity)).push(
                self._clock(), v)

    def sample(self, now: float) -> dict[str, float]:
        """Evaluate every source at virtual time ``now``; returns the
        sampled row (also appended to the ring buffers)."""
        row = {}
        for name, fn in self._sources.items():
            v = float(fn())
            self.push(name, now, v)
            row[name] = v
        self.n_samples += 1
        return row

    def last_time(self, name: str) -> Optional[float]:
        """Timestamp of the latest sample of ``name`` in the exported
        time base: wall-clock when enabled, virtual otherwise."""
        buf = self.wall.get(name) if self.wall_clock \
            else self.series.get(name)
        if buf is None:
            return None
        last = buf.last()
        return None if last is None else last[0]

    def get(self, name: str) -> RingBuffer:
        return self.series.setdefault(name, RingBuffer(self.capacity))
