"""Attainment-driven autoscaler: closes the telemetry loop.

The scaler consumes the per-step time series ``ClusterTelemetry``
maintains — windowed per-SLO-class attainment (lagging signal), page
pressure and queue backlog (leading signals) — and grows or shrinks the
replica pool through ``ClusterFrontend.add_replica`` /
``drain_replica``.  Removal is graceful: a draining replica stops
receiving routed work, its in-flight requests are migrated to peers via
the existing preempt + drop/restore recompute-replay machinery, and the
driver is only dropped from the pool once idle.

Policy shape (classic serving-autoscaler hysteresis):

* **Scale up fast.**  Any one trigger — windowed attainment below
  ``attain_low``, page pressure above ``pressure_high``, or queued
  requests per replica above ``backlog_high`` — adds a replica after a
  short ``up_cooldown``.
* **Scale down slow.**  ALL quiet conditions must hold (attainment
  above ``attain_high``, pressure below ``pressure_low``, backlog per
  replica below ``backlog_low``) for ``down_patience`` consecutive
  steps, and only after ``down_cooldown`` since the last scaling action
  in either direction.  Asymmetric gates keep the pool from flapping
  around a threshold.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

from repro_torch.telemetry.instruments import ClusterTelemetry


@dataclass
class AutoscalerConfig:
    min_replicas: int = 1
    max_replicas: int = 4
    # lagging signal: windowed per-class attainment
    attain_low: float = 0.85      # any class below this -> scale up
    attain_high: float = 0.97     # every class above this -> may scale down
    # leading signals
    pressure_high: float = 0.90   # max replica page occupancy
    pressure_low: float = 0.45
    backlog_high: float = 4.0     # queued requests per live replica
    backlog_low: float = 0.5
    window: int = 8               # steps of series history per decision
    up_cooldown: float = 0.5      # virtual seconds between scale-ups
    down_cooldown: float = 3.0    # quiet time required before shrinking
    down_patience: int = 6        # consecutive quiet steps before shrinking
    min_finished: int = 4         # ignore attainment until this many done


@dataclass
class ScaleDecision:
    t: float
    action: str                   # "up" | "down" | "hold"
    reason: str
    replicas: int


@dataclass
class Autoscaler:
    """Drive with ``step(cluster, now)`` once per cluster step, after
    ``ClusterTelemetry.on_step`` has refreshed the series."""

    telemetry: ClusterTelemetry
    cfg: AutoscalerConfig = field(default_factory=AutoscalerConfig)
    decisions: list[ScaleDecision] = field(default_factory=list)
    _last_up: float = -math.inf
    _last_action: float = -math.inf
    _quiet_steps: int = 0

    def step(self, cluster, now: float) -> Optional[ScaleDecision]:
        cfg, tel = self.cfg, self.telemetry
        if not tel.enabled:
            return None
        live = len(cluster.drivers) - len(cluster.draining)
        pressure = tel.sampler.get("page_pressure").window_max(cfg.window)
        backlog = tel.sampler.get("queue_depth").window_mean(cfg.window)
        backlog_per = (backlog / max(live, 1)) if not math.isnan(backlog) \
            else math.nan
        attain = tel.windowed_attainment()
        n_finished = sum(len(dq) for dq in tel._recent.values())
        worst = min(attain.values()) if attain else math.nan

        up_reason = None
        if n_finished >= cfg.min_finished and not math.isnan(worst) \
                and worst < cfg.attain_low:
            up_reason = f"attainment {worst:.2f} < {cfg.attain_low}"
        elif not math.isnan(pressure) and pressure > cfg.pressure_high:
            up_reason = f"page pressure {pressure:.2f} > {cfg.pressure_high}"
        elif not math.isnan(backlog_per) and backlog_per > cfg.backlog_high:
            up_reason = (f"backlog/replica {backlog_per:.1f} > "
                         f"{cfg.backlog_high}")

        if up_reason is not None:
            self._quiet_steps = 0
            if live < cfg.max_replicas \
                    and now - self._last_up >= cfg.up_cooldown:
                cluster.add_replica()
                self._last_up = self._last_action = now
                return self._record(now, "up", up_reason, cluster)
            return None

        quiet = (
            (math.isnan(worst) or worst >= cfg.attain_high)
            and (math.isnan(pressure) or pressure < cfg.pressure_low)
            and (math.isnan(backlog_per) or backlog_per < cfg.backlog_low)
        )
        if not quiet:
            self._quiet_steps = 0
            return None
        self._quiet_steps += 1
        if (live > cfg.min_replicas
                and self._quiet_steps >= cfg.down_patience
                and now - self._last_action >= cfg.down_cooldown):
            idx = self._pick_victim(cluster)
            if idx is None:
                return None
            cluster.drain_replica(idx)
            self._last_action = now
            self._quiet_steps = 0
            return self._record(
                now, "down",
                f"quiet for {cfg.down_patience} steps "
                f"(attain>={cfg.attain_high}, pressure<{cfg.pressure_low})",
                cluster, drained=idx)
        return None

    def _pick_victim(self, cluster) -> Optional[int]:
        """Drain the non-draining replica with the least in-flight work
        (cheapest migration)."""
        best, best_load = None, math.inf
        for i, d in enumerate(cluster.drivers):
            if d.idx in cluster.draining:
                continue
            load = len(d.running) + len(d.new_q) + len(d.be)
            if load < best_load:
                best, best_load = i, load
        return best

    def _record(self, now: float, action: str, reason: str, cluster,
                drained: Optional[int] = None) -> ScaleDecision:
        dec = ScaleDecision(t=now, action=action, reason=reason,
                            replicas=len(cluster.drivers)
                            - len(cluster.draining))
        self.decisions.append(dec)
        self.telemetry.tracer.emit({
            "kind": "scale", "t": round(now, 6), "action": action,
            "reason": reason, "replicas": dec.replicas,
            **({"drained": drained} if drained is not None else {})})
        return dec
