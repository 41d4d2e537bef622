"""Telemetry exporters: Prometheus text exposition and a JSONL step
tracer with span-style timing hooks.

``prometheus_text`` renders a ``MetricsRegistry`` in the Prometheus text
exposition format (``# HELP`` / ``# TYPE`` headers, ``le``-labeled
histogram buckets with ``_sum``/``_count``); ``parse_prometheus`` is the
matching minimal parser used by tests and the dashboard tooling, so the
round trip is covered in-repo without a client-library dependency.

``StepTracer`` writes one JSON object per line: ``step`` records (the
per-step sampler row) and ``span`` records (wall-clock timing around
plan / prefill / decode / verify, via the ``span`` context manager).
With ``REPRO_TORCH_TRACE=1`` each span additionally opens a
``torch.profiler.record_function`` range so ``torch.profiler`` traces
carry the same labels.

This module is ``repro/telemetry/exporters.py`` with its imports
rewritten; the reference's ``REPRO_JAX_TRACE`` annotation became the
PyTorch range above.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import time
from typing import Optional, TextIO

from repro_torch.telemetry.registry import (Histogram, MetricsRegistry,
                                            _HistogramChild)


def _fmt(v: float) -> str:
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _labels(kv: dict) -> str:
    if not kv:
        return ""
    inner = ",".join(f'{k}="{_escape(str(v))}"' for k, v in kv.items())
    return "{" + inner + "}"


def _escape(s: str) -> str:
    return s.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def prometheus_text(registry: MetricsRegistry) -> str:
    """Render the registry in Prometheus text exposition format."""
    out: list[str] = []
    for m in registry.collect():
        out.append(f"# HELP {m.name} {_escape(m.help)}")
        out.append(f"# TYPE {m.name} {m.kind}")
        if isinstance(m, Histogram):
            for lv, child in m.samples():
                cum = 0
                for bound, c in zip(child.bounds, child.counts):
                    cum += c
                    out.append(f"{m.name}_bucket"
                               f"{_labels({**lv, 'le': _fmt(bound)})}"
                               f" {cum}")
                out.append(f"{m.name}_bucket"
                           f"{_labels({**lv, 'le': '+Inf'})} {child.count}")
                out.append(f"{m.name}_sum{_labels(lv)} {_fmt(child.sum)}")
                out.append(f"{m.name}_count{_labels(lv)} {child.count}")
        else:
            for lv, child in m.samples():
                out.append(f"{m.name}{_labels(lv)} {_fmt(child.value)}")
    return "\n".join(out) + "\n"


def timeseries_prometheus_text(sampler, name: str = "repro_step_series"
                               ) -> str:
    """Render the latest sample of every step time series as gauges:
    ``repro_step_series{series="..."}`` carries the value and
    ``repro_step_series_timestamp{series="..."}`` the timestamp of that
    sample in the sampler's exported time base — virtual seconds by
    default, wall-clock epoch seconds when the sampler was built with
    ``wall_clock=True`` (the serving-gateway mode).  Values are
    identical across the two modes by construction; only the timestamp
    series differs."""
    if not sampler.series:
        return ""
    out = [f"# HELP {name} latest value per step time series",
           f"# TYPE {name} gauge"]
    rows = []
    for sname in sorted(sampler.series):
        last = sampler.series[sname].last()
        if last is None:
            continue
        out.append(f"{name}{_labels({'series': sname})} {_fmt(last[1])}")
        t = sampler.last_time(sname) if hasattr(sampler, "last_time") \
            else last[0]
        rows.append((sname, t))
    out.append(f"# HELP {name}_timestamp sample time of the latest value "
               f"(virtual seconds, or wall-clock epoch in wall mode)")
    out.append(f"# TYPE {name}_timestamp gauge")
    for sname, t in rows:
        out.append(f"{name}_timestamp{_labels({'series': sname})} "
                   f"{_fmt(t if t is not None else math.nan)}")
    return "\n".join(out) + "\n"


def parse_prometheus(text: str) -> dict[tuple[str, tuple], float]:
    """Parse a text exposition back into ``{(name, ((label, value),
    ...)): value}``.  Minimal by design (no exemplars, no timestamps) —
    enough for the e2e consistency tests and the dashboard tooling."""
    out: dict[tuple[str, tuple], float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        head, _, val = line.rpartition(" ")
        if "{" in head:
            name, _, rest = head.partition("{")
            body = rest.rsplit("}", 1)[0]
            labels = []
            for part in _split_labels(body):
                k, _, v = part.partition("=")
                labels.append((k, v.strip('"')
                               .replace('\\"', '"')
                               .replace("\\n", "\n")
                               .replace("\\\\", "\\")))
            key = (name, tuple(sorted(labels)))
        else:
            key = (head, ())
        out[key] = float(val)
    return out


def _split_labels(body: str) -> list[str]:
    """Split 'a="x",b="y,z"' on commas outside quotes."""
    parts, cur, quoted, escaped = [], [], False, False
    for ch in body:
        if escaped:
            cur.append(ch)
            escaped = False
            continue
        if ch == "\\":
            cur.append(ch)
            escaped = True
            continue
        if ch == '"':
            quoted = not quoted
        if ch == "," and not quoted:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if cur:
        parts.append("".join(cur))
    return [p for p in parts if p]


def quantile_from_exposition(samples: dict, name: str, q: float,
                             **labels) -> float:
    """``histogram_quantile`` over a parsed exposition: estimate the
    q-quantile of histogram ``name`` restricted to ``labels``."""
    want = tuple(sorted((k, str(v)) for k, v in labels.items()))
    buckets: list[tuple[float, float]] = []
    for (n, lv), v in samples.items():
        if n != name + "_bucket":
            continue
        d = dict(lv)
        le = d.pop("le")
        if tuple(sorted(d.items())) != want:
            continue
        buckets.append((math.inf if le == "+Inf" else float(le), v))
    if not buckets:
        return math.nan
    buckets.sort()
    total = buckets[-1][1]
    if total == 0:
        return math.nan
    rank = q * total
    prev_bound, prev_cum = 0.0, 0.0
    for bound, cum in buckets:
        if cum >= rank:
            if math.isinf(bound):
                return prev_bound
            if cum == prev_cum:
                return bound
            frac = (rank - prev_cum) / (cum - prev_cum)
            return prev_bound + (bound - prev_bound) * frac
        prev_bound, prev_cum = bound, cum
    return buckets[-1][0]


def _torch_trace_enabled() -> bool:
    return os.environ.get("REPRO_TORCH_TRACE", "").lower() in (
        "1", "true", "on", "yes")


class StepTracer:
    """JSONL step trace: one JSON object per line.

    Records are dicts with a ``kind`` field: ``"step"`` rows snapshot
    the per-step sampler output, ``"span"`` rows time named phases
    (plan / prefill / decode / verify) in wall-clock seconds.  Lines are
    buffered in memory (bounded) and optionally streamed to ``path``;
    ``dump()`` returns the full JSONL blob for tests and benchmarks.
    """

    def __init__(self, path: Optional[str] = None, max_lines: int = 100_000,
                 enabled: bool = True):
        self.enabled = enabled
        self.lines: list[str] = []
        self.max_lines = max_lines
        self.dropped = 0
        self._fh: Optional[TextIO] = None
        if path is not None and enabled:
            self._fh = open(path, "w")
        self._torch_trace = _torch_trace_enabled()

    def emit(self, record: dict) -> None:
        if not self.enabled:
            return
        line = json.dumps(record, separators=(",", ":"), sort_keys=True)
        if len(self.lines) < self.max_lines:
            self.lines.append(line)
        else:
            self.dropped += 1     # bounded memory; file keeps streaming
        if self._fh is not None:
            self._fh.write(line + "\n")

    def step(self, step: int, now: float, row: dict) -> None:
        self.emit({"kind": "step", "step": step, "t": round(now, 6), **row})

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        """Time a phase; emits a ``span`` record with wall-clock ``dur``.
        No-op (zero records, near-zero cost) when disabled."""
        if not self.enabled:
            yield
            return
        ctx = contextlib.nullcontext()
        if self._torch_trace:
            import torch
            ctx = torch.profiler.record_function(name)
        t0 = time.perf_counter()
        with ctx:
            yield
        self.emit({"kind": "span", "name": name,
                   "dur": time.perf_counter() - t0, **attrs})

    def records(self, kind: Optional[str] = None) -> list[dict]:
        recs = [json.loads(line) for line in self.lines]
        if kind is not None:
            recs = [r for r in recs if r.get("kind") == kind]
        return recs

    def dump(self) -> str:
        return "\n".join(self.lines) + ("\n" if self.lines else "")

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


def histogram_percentiles(m: Histogram, qs=(0.5, 0.9, 0.99)
                          ) -> dict[str, dict[float, float]]:
    """Readable percentile summary per labeled child of a histogram."""
    out = {}
    for lv, child in m.samples():
        assert isinstance(child, _HistogramChild)
        key = ",".join(f"{k}={v}" for k, v in lv.items()) or "_"
        out[key] = child.percentiles(qs)
    return out
