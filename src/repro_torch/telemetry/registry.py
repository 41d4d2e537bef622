"""Dependency-free metrics registry: labeled counters, gauges, and
fixed-bucket histograms with percentile readout.

The registry is the single source every exporter reads
(``telemetry/exporters.py`` renders Prometheus text exposition from
``MetricsRegistry.collect()``) and every instrument writes
(``telemetry/instruments.py`` binds children once and increments them on
the hot path).

Design constraints, in order:

* **Zero overhead when disabled.**  A disabled registry hands out one
  shared ``_NOOP`` child whose methods are empty; call sites that cache
  the child (the instruments all do) pay a single attribute call per
  event and nothing else.  ``REPRO_METRICS`` flips the process-wide
  default (read per registry construction, so tests can monkeypatch).
* **No third-party deps.**  The Prometheus client library is not in the
  image; this module reimplements the exposition-relevant subset
  (counter/gauge/histogram with ``le`` buckets, ``_sum``/``_count``).
* **Pull-friendly counters.**  The engine/kv layers keep their own
  cumulative counters; ``Counter.set_total`` lets the per-step sampler
  mirror them into the registry without double bookkeeping (the source
  is monotonic, so the exposition stays a valid counter).
"""
from __future__ import annotations

import bisect
import math
import os
import threading
from typing import Iterable, Optional, Sequence


def metrics_enabled(default: bool = False) -> bool:
    """Process-wide default for ``MetricsRegistry(enabled=None)``:
    ``REPRO_METRICS`` set truthy turns telemetry on everywhere a caller
    did not decide explicitly (the CI metrics matrix leg)."""
    v = os.environ.get("REPRO_METRICS")
    if v is None:
        return default
    return v.lower() not in ("", "0", "false", "off")


# Default latency buckets (seconds): 1 ms .. 60 s, roughly log-spaced.
LATENCY_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


class _Noop:
    """Shared do-nothing child handed out by disabled registries."""

    __slots__ = ()

    def inc(self, v: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def set_total(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass


_NOOP = _Noop()


class _Child:
    """One (metric, label values) time series."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0


class _CounterChild(_Child):
    __slots__ = ()

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError("counters only go up")
        self.value += v

    def set_total(self, v: float) -> None:
        """Mirror an externally maintained cumulative counter (engine /
        kv counters).  The exposition stays monotone because the source
        is; regressions raise so a buggy pull is loud, not silent."""
        if v + 1e-9 < self.value:
            raise ValueError(
                f"counter total went backwards: {self.value} -> {v}")
        self.value = float(v)


class _GaugeChild(_Child):
    __slots__ = ()

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, v: float = 1.0) -> None:
        self.value += v


class _HistogramChild:
    """Fixed-bucket histogram: counts per upper bound + sum + count.

    ``quantile(q)`` reads a percentile back out by linear interpolation
    inside the bucket that crosses rank ``q`` (the standard
    ``histogram_quantile`` estimate): exact to bucket resolution, which
    tests assert against a numpy reference.
    """

    __slots__ = ("bounds", "counts", "sum", "count", "_lo", "_hi")

    def __init__(self, bounds: Sequence[float]):
        self.bounds = tuple(bounds)          # ascending upper bounds
        self.counts = [0] * (len(self.bounds) + 1)   # +inf overflow
        self.sum = 0.0
        self.count = 0
        self._lo = math.inf                  # observed min/max tighten
        self._hi = -math.inf                 # the edge-bucket estimates

    def observe(self, v: float) -> None:
        v = float(v)
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.sum += v
        self.count += 1
        self._lo = min(self._lo, v)
        self._hi = max(self._hi, v)

    def quantile(self, q: float) -> float:
        """Estimated q-quantile (q in [0, 1]); NaN when empty."""
        if self.count == 0:
            return math.nan
        rank = q * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if seen + c >= rank:
                lo = self.bounds[i - 1] if i > 0 else self._lo
                hi = self.bounds[i] if i < len(self.bounds) else self._hi
                lo = max(lo, self._lo)      # observed extrema tighten the
                hi = min(hi, self._hi)      # edge-bucket estimates
                if hi <= lo:
                    return hi
                frac = (rank - seen) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
            seen += c
        return self._hi

    def percentiles(self, qs=(0.5, 0.9, 0.99)) -> dict[float, float]:
        return {q: self.quantile(q) for q in qs}


class Metric:
    """A named metric family; ``labels(**kv)`` returns (and caches) the
    child bound to those label values."""

    kind = "untyped"
    _child_cls: type = _Child

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = (),
                 registry: Optional["MetricsRegistry"] = None, **kw):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._kw = kw
        self._children: dict[tuple, object] = {}
        self._enabled = registry.enabled if registry is not None else True
        self._lock = threading.Lock()

    def _make_child(self):
        return self._child_cls(**self._kw)

    def labels(self, **kv):
        if not self._enabled:
            return _NOOP
        if set(kv) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, "
                f"got {tuple(kv)}")
        key = tuple(str(kv[k]) for k in self.labelnames)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.setdefault(key, self._make_child())
        return child

    @property
    def default(self):
        """The unlabeled child (metrics declared with no labelnames)."""
        return self.labels()

    def samples(self) -> Iterable[tuple[dict, object]]:
        """Yield (label dict, child) per live time series."""
        for key, child in sorted(self._children.items()):
            yield dict(zip(self.labelnames, key)), child

    # convenience pass-throughs for label-less metrics
    def inc(self, v: float = 1.0) -> None:
        self.labels().inc(v)

    def set(self, v: float) -> None:
        self.labels().set(v)

    def set_total(self, v: float) -> None:
        self.labels().set_total(v)

    def observe(self, v: float) -> None:
        self.labels().observe(v)


class Counter(Metric):
    kind = "counter"
    _child_cls = _CounterChild


class Gauge(Metric):
    kind = "gauge"
    _child_cls = _GaugeChild


class Histogram(Metric):
    kind = "histogram"
    _child_cls = _HistogramChild

    def __init__(self, name, help, labelnames=(), registry=None,
                 buckets: Sequence[float] = LATENCY_BUCKETS):
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds:
            raise ValueError("histogram needs at least one bucket bound")
        super().__init__(name, help, labelnames, registry=registry,
                         bounds=bounds)


class MetricsRegistry:
    """Holds every metric family of one serving stack (cluster, replica
    set, benchmark run).  ``enabled=None`` defers to ``REPRO_METRICS``;
    a disabled registry still registers names (exporters render an empty
    but well-formed exposition) while all children no-op."""

    def __init__(self, enabled: Optional[bool] = None):
        self.enabled = metrics_enabled() if enabled is None else enabled
        self._metrics: dict[str, Metric] = {}

    def _register(self, cls, name, help, labelnames, **kw) -> Metric:
        m = self._metrics.get(name)
        if m is not None:
            if type(m) is not cls or m.labelnames != tuple(labelnames):
                raise ValueError(f"metric {name} re-registered with a "
                                 "different type or label schema")
            return m
        m = cls(name, help, labelnames, registry=self, **kw)
        self._metrics[name] = m
        return m

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._register(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._register(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = LATENCY_BUCKETS) -> Histogram:
        return self._register(Histogram, name, help, labelnames,
                              buckets=buckets)

    def get(self, name: str) -> Optional[Metric]:
        return self._metrics.get(name)

    def collect(self) -> Iterable[Metric]:
        for name in sorted(self._metrics):
            yield self._metrics[name]
