"""Instrumentation bindings: the metric families of the serving stack
and the per-step sampling glue.

``ClusterTelemetry`` owns one ``MetricsRegistry`` + ``TimeSeriesSampler``
+ ``StepTracer`` per cluster (or single-replica frontend) and hands each
``ReplicaDriver`` a ``ReplicaTelemetry`` with its metric children
pre-bound, so hot-path recording is one cached attribute call per event.
The metric name / label schema is documented in docs/ARCHITECTURE.md
("Telemetry & autoscaling") — exporters, dashboards and tests all key on
the names defined HERE.

Time base: request-facing latencies (TTFT, TPOT) and the step series are
in **virtual seconds** (the planner's deterministic clock); ``span``
records and plan latency are **wall-clock** (they measure real host/
device work).
"""
from __future__ import annotations

import math
import time
from collections import deque
from typing import Optional

from repro_torch.core.request import Request
from repro_torch.core.slo import StageKind
from repro_torch.telemetry.exporters import StepTracer, prometheus_text
from repro_torch.telemetry.registry import MetricsRegistry, metrics_enabled
from repro_torch.telemetry.timeseries import TimeSeriesSampler

# TTFT in virtual seconds; TPOT per token.  Buckets chosen to straddle
# the paper's SLO tiers (8 ms spec TPOT .. 100 ms loose TPOT; TTFT in
# the tenths-to-seconds range at reproduction scale).
TTFT_BUCKETS = (0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)
TPOT_BUCKETS = (0.002, 0.004, 0.008, 0.016, 0.025, 0.05, 0.075, 0.1,
                0.15, 0.25, 0.5)
PLAN_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.002, 0.005, 0.01,
                0.025, 0.05, 0.1)


def slo_class_of(req: Request) -> str:
    """Stable SLO-class label for a request: its tightest decode TPOT
    (the value the DP planner tiers on), or ``prefill-only``."""
    t = req.tightest_tpot()
    return "prefill-only" if t is None else f"tpot={t:g}"


class ReplicaTelemetry:
    """Per-replica metric children, pre-bound at construction so the
    driver's hot loop pays one method call per event."""

    def __init__(self, registry: MetricsRegistry, replica: int,
                 tracer: Optional[StepTracer] = None,
                 cluster: Optional["ClusterTelemetry"] = None):
        self.registry = registry
        self.replica = str(replica)
        self.tracer = tracer
        self.cluster = cluster
        r = registry
        rep = dict(replica=self.replica)
        self._verdicts = r.counter(
            "repro_admission_verdicts_total",
            "DP admission outcomes per scheduler invocation",
            ("replica", "slo_class", "verdict"))
        self.plan_latency = r.histogram(
            "repro_plan_latency_seconds",
            "wall-clock DP planning latency per scheduler invocation",
            ("replica",), buckets=PLAN_BUCKETS).labels(**rep)
        self._planned = {
            kind: r.counter(
                "repro_planned_tokens_total",
                "tokens the planner scheduled into batches",
                ("replica", "kind")).labels(**rep, kind=kind.value)
            for kind in StageKind}
        self._delivered = {
            kind: r.counter(
                "repro_delivered_tokens_total",
                "tokens the engine actually executed/emitted",
                ("replica", "kind")).labels(**rep, kind=kind.value)
            for kind in StageKind}
        self._ttft = r.histogram(
            "repro_ttft_seconds",
            "time to first token (virtual seconds) per SLO class",
            ("slo_class",), buckets=TTFT_BUCKETS)
        self._tpot = r.histogram(
            "repro_tpot_seconds",
            "mean per-token decode latency (virtual seconds) per "
            "SLO class and decode stage",
            ("slo_class",), buckets=TPOT_BUCKETS)
        self._finished = r.counter(
            "repro_requests_finished_total",
            "terminal requests per SLO class and attainment outcome",
            ("replica", "slo_class", "attained"))
        self.preemptions = r.counter(
            "repro_preemptions_total",
            "best-effort victims preempted for page pressure",
            ("replica",)).labels(**rep)
        self.best_effort = r.counter(
            "repro_best_effort_total",
            "requests demoted to the best-effort tier",
            ("replica",)).labels(**rep)

    # ------------------------------------------------------------------ #
    def on_plan(self, wall_seconds: float, admitted, declined,
                deferred) -> None:
        self.plan_latency.observe(wall_seconds)
        for verdict, reqs in (("admitted", admitted),
                              ("declined", declined),
                              ("deferred", deferred)):
            for req in reqs:
                self._verdicts.labels(
                    replica=self.replica, slo_class=slo_class_of(req),
                    verdict=verdict).inc()

    def on_batch_planned(self, batch) -> None:
        for e in batch.entries:
            self._planned[e.kind].inc(e.n_tokens)

    def on_delivered(self, kind: StageKind, n_tokens: int) -> None:
        if n_tokens:
            self._delivered[kind].inc(n_tokens)

    def on_finish(self, req: Request, attained: bool) -> None:
        """Record the terminal outcome + latency observations of a
        finished request (virtual-time TTFT per prefill stage boundary,
        mean TPOT per decode stage)."""
        cls = slo_class_of(req)
        self._finished.labels(replica=self.replica, slo_class=cls,
                              attained=str(bool(attained)).lower()).inc()
        if req.stage_complete_times:
            first = req.stage_complete_times[0]
            if req.stages[0].kind == StageKind.PREFILL:
                self._ttft.labels(slo_class=cls).observe(
                    max(first - req.arrival, 0.0))
        start = req.arrival
        cursor = 0
        for idx, s in enumerate(req.stages):
            if idx >= len(req.stage_complete_times):
                break
            end = req.stage_complete_times[idx]
            if s.kind == StageKind.DECODE and s.length > 0:
                times = req.token_times[cursor:cursor + s.length]
                cursor += s.length
                if times:
                    self._tpot.labels(slo_class=cls).observe(
                        max(times[-1] - start, 0.0) / len(times))
            start = end
        if self.cluster is not None:
            self.cluster.note_finish(cls, attained)

    def on_drop(self, req: Request) -> None:
        self._finished.labels(replica=self.replica,
                              slo_class=slo_class_of(req),
                              attained="false").inc()
        if self.cluster is not None:
            self.cluster.note_finish(slo_class_of(req), False)


class ClusterTelemetry:
    """One telemetry hub per cluster: registry + ring-buffer sampler +
    step tracer, plus windowed per-class attainment the autoscaler
    consumes.  ``enabled=None`` defers to ``REPRO_METRICS``."""

    def __init__(self, enabled: Optional[bool] = None,
                 capacity: int = 1024, trace_path: Optional[str] = None,
                 window: int = 32, wall_clock: bool = False):
        self.enabled = metrics_enabled() if enabled is None else enabled
        self.registry = MetricsRegistry(enabled=self.enabled)
        # wall_clock=True (the serving-gateway mode): the step series
        # additionally record real host timestamps — see timeseries.py
        self.sampler = TimeSeriesSampler(capacity=capacity,
                                         wall_clock=wall_clock)
        self.tracer = StepTracer(path=trace_path, enabled=self.enabled)
        self.window = window
        self._recent: dict[str, deque] = {}    # class -> attained deque
        self._replicas: dict[int, ReplicaTelemetry] = {}
        self._step = 0
        r = self.registry
        self.g_replicas = r.gauge(
            "repro_replicas", "live replica count (autoscaler-controlled)")
        self.g_draining = r.gauge(
            "repro_replicas_draining", "replicas draining toward removal")
        self.g_pages = r.gauge(
            "repro_page_occupancy_ratio",
            "mapped pages / pool pages per replica", ("replica",))
        self.g_queue = r.gauge(
            "repro_queue_depth",
            "requests queued (new + best-effort) per replica", ("replica",))
        self.g_budget = r.gauge(
            "repro_budget_used_ratio",
            "shared page budget used / total")
        self.g_attain = r.gauge(
            "repro_attainment_ratio",
            "cumulative SLO attainment per class", ("slo_class",))
        self.g_attain_win = r.gauge(
            "repro_attainment_window_ratio",
            "windowed SLO attainment per class (autoscaler signal)",
            ("slo_class",))
        self.c_engine = r.counter(
            "repro_engine_events_total",
            "cumulative engine/kv counters, mirrored per step "
            "(prefill_calls, decode_calls, spec tokens, cow_copies, ...)",
            ("replica", "event"))
        self.c_routing = r.counter(
            "repro_routing_total",
            "cluster routing outcomes",
            ("outcome",))

    # ------------------------------------------------------------------ #
    def replica(self, idx: int) -> ReplicaTelemetry:
        rt = self._replicas.get(idx)
        if rt is None:
            rt = ReplicaTelemetry(self.registry, idx, tracer=self.tracer,
                                  cluster=self)
            self._replicas[idx] = rt
        return rt

    def note_finish(self, cls: str, attained: bool) -> None:
        dq = self._recent.get(cls)
        if dq is None:
            dq = self._recent[cls] = deque(maxlen=self.window)
        dq.append(1.0 if attained else 0.0)

    def windowed_attainment(self) -> dict[str, float]:
        """Per-class attainment over the last ``window`` terminal
        requests — the autoscaler's demand signal."""
        return {cls: sum(dq) / len(dq)
                for cls, dq in self._recent.items() if dq}

    def min_windowed_attainment(self) -> float:
        w = self.windowed_attainment()
        return min(w.values()) if w else math.nan

    # ------------------------------------------------------------------ #
    _ENGINE_EVENTS = ("prefill_calls", "decode_calls", "decode_tokens",
                      "preemptions", "prefix_hit_tokens",
                      "spec_accepted_tokens", "spec_drafted_tokens")
    _KV_EVENTS = ("cow_copies", "prefix_evictions", "partial_hit_tokens",
                  "partial_head_copies", "spilled_pages",
                  "prefetched_pages", "host_evictions",
                  "spilled_hit_tokens")

    def on_step(self, cluster, now: float, n_exec: int) -> None:
        """One sampling tick, driven per cluster step: refresh gauges
        from live state, mirror cumulative engine/kv counters, push the
        ring-buffer row, and emit the JSONL step record."""
        if not self.enabled:
            return
        drivers = cluster.drivers
        draining = getattr(cluster, "draining", set())
        self.g_replicas.set(len(drivers))
        self.g_draining.set(len(draining))
        occs, queues = [], []
        for d in drivers:
            kv = d.engine.kv
            occ = kv.used_pages / max(kv.total_pages, 1)
            q = len(d.new_q) + len(d.be)
            occs.append(occ)
            queues.append(q)
            rep = str(d.idx)
            self.g_pages.labels(replica=rep).set(occ)
            self.g_queue.labels(replica=rep).set(q)
            for ev in self._ENGINE_EVENTS:
                self.c_engine.labels(replica=rep, event=ev).set_total(
                    d.engine.counters[ev])
            for ev in self._KV_EVENTS:
                self.c_engine.labels(replica=rep, event=ev).set_total(
                    getattr(kv, ev))
        budget = getattr(cluster, "budget", None)
        b_ratio = (budget.used / max(budget.total_pages, 1)
                   if budget is not None else 0.0)
        self.g_budget.set(b_ratio)
        stats = cluster.stats
        self.c_routing.labels(outcome="routed").set_total(
            getattr(stats, "routed", 0))
        self.c_routing.labels(outcome="affinity").set_total(
            getattr(stats, "affinity_routed", 0))
        self.c_routing.labels(outcome="best_effort").set_total(
            stats.best_effort)
        self.c_routing.labels(outcome="dropped").set_total(stats.dropped)
        self.c_routing.labels(outcome="placed_chains").set_total(
            getattr(stats, "placed_chains", 0))
        per_cls = self._per_class_cumulative()
        for cls, (fin, att) in per_cls.items():
            self.g_attain.labels(slo_class=cls).set(
                att / fin if fin else 0.0)
        win = self.windowed_attainment()
        for cls, v in win.items():
            self.g_attain_win.labels(slo_class=cls).set(v)

        backlog = len([p for p in getattr(cluster, "pending", ())
                       if p.req.arrival <= now])
        row = {
            "replicas": float(len(drivers)),
            "draining": float(len(draining)),
            "page_pressure": max(occs) if occs else 0.0,
            "budget_used_ratio": b_ratio,
            "queue_depth": float(sum(queues) + backlog),
            "n_exec": float(n_exec),
            "attained_total": float(stats.attained),
            "served_total": float(stats.served),
            # host spill tier (0 when off; ServingFrontend stats lack
            # the fields entirely, hence the getattr guards)
            "spilled_pages_total": float(
                getattr(stats, "spilled_pages", 0)),
            "prefetched_pages_total": float(
                getattr(stats, "prefetched_pages", 0)),
        }
        for cls, v in win.items():
            row[f"attain_win[{cls}]"] = v
        for name, v in row.items():
            self.sampler.push(name, now, v)
        self.sampler.n_samples += 1
        trace_row = dict(row)
        for cls, (fin, att) in per_cls.items():
            trace_row[f"attain[{cls}]"] = att / fin if fin else 0.0
        self.tracer.step(self._step, now, trace_row)
        self._step += 1

    def per_class_attainment(self) -> dict[str, float]:
        """Cumulative attainment fraction per SLO class (0.0 when a class
        has no terminal requests yet)."""
        return {cls: (att / fin if fin else 0.0)
                for cls, (fin, att) in self._per_class_cumulative().items()}

    def _per_class_cumulative(self) -> dict[str, tuple[int, int]]:
        """(finished, attained) per SLO class from the finished-requests
        counter — the source both the gauges and the e2e consistency
        tests read."""
        out: dict[str, list[int]] = {}
        m = self.registry.get("repro_requests_finished_total")
        if m is None:
            return {}
        for lv, child in m.samples():
            cls = lv["slo_class"]
            fin, att = out.setdefault(cls, [0, 0])
            out[cls][0] = fin + int(child.value)
            if lv["attained"] == "true":
                out[cls][1] = att + int(child.value)
        return {k: (v[0], v[1]) for k, v in out.items()}

    # ------------------------------------------------------------------ #
    def prometheus(self) -> str:
        return prometheus_text(self.registry)

    def close(self) -> None:
        self.tracer.close()


class PlanTimer:
    """Tiny wall-clock context used around ``scheduler.plan`` calls."""

    __slots__ = ("t0", "seconds")

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self.t0
        return False
