"""Multi-stage request model and runtime lifecycle (paper §2.1, §3.1).

``Request`` carries the static description (arrival, stages, memory demand,
value) and the mutable serving state (current stage, tokens completed,
per-token timestamps) used by schedulers, the simulator, and the JAX engine.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional

from repro_torch.core.slo import StageKind, StageSpec, TPOT_WINDOW


class ServiceTier(enum.Enum):
    GUARANTEED = "guaranteed"   # admitted requests: SLOs guaranteed (§3.1)
    BEST_EFFORT = "best_effort"  # leftover-budget tier (§4.1)


class RequestState(enum.Enum):
    NEW = "new"
    RUNNING = "running"       # admitted, being served
    BEST_EFFORT = "best_effort"  # declined → best-effort service
    PREEMPTED = "preempted"   # BE request whose KV was discarded (§4.1)
    FINISHED = "finished"


@dataclasses.dataclass
class Request:
    rid: int
    arrival: float
    stages: list[StageSpec]
    value: float = 1.0
    # Memory demand in KV pages, filled by the engine/simulator from lengths.
    mem_units: int = 0

    # ---- runtime state ----
    state: RequestState = RequestState.NEW
    stage_idx: int = 0
    tokens_done: int = 0              # tokens completed in the current stage
    routing_hops: int = 0             # §4.2 sequential routing count
    # Timestamps: prefill completion per prefill stage, and one per decode token.
    stage_complete_times: list[float] = dataclasses.field(default_factory=list)
    token_times: list[float] = dataclasses.field(default_factory=list)
    prefill_deadlines: list[float] = dataclasses.field(default_factory=list)
    finish_time: Optional[float] = None
    # For best-effort preemption: generated tokens kept, KV discarded (§4.1).
    kv_resident: bool = False

    # ------------------------------------------------------------------ #
    def __post_init__(self):
        assert self.stages, "request needs at least one stage"

    @property
    def current_stage(self) -> StageSpec:
        return self.stages[self.stage_idx]

    @property
    def finished(self) -> bool:
        return self.state == RequestState.FINISHED

    @property
    def in_prefill(self) -> bool:
        return (not self.finished
                and self.current_stage.kind == StageKind.PREFILL)

    @property
    def in_decode(self) -> bool:
        return (not self.finished
                and self.current_stage.kind == StageKind.DECODE)

    @property
    def remaining_in_stage(self) -> int:
        return self.current_stage.length - self.tokens_done

    def total_prefill_tokens(self) -> int:
        return sum(s.length for s in self.stages if s.kind == StageKind.PREFILL)

    def total_decode_tokens(self) -> int:
        return sum(s.length for s in self.stages if s.kind == StageKind.DECODE)

    def total_tokens(self) -> int:
        return sum(s.length for s in self.stages)

    def tightest_tpot(self) -> Optional[float]:
        tiers = [s.slo.tpot for s in self.stages if s.kind == StageKind.DECODE]
        return min(tiers) if tiers else None

    # ------------------------------------------------------------------ #
    def advance(self, n_tokens: int, now: float) -> None:
        """Record ``n_tokens`` of progress on the current stage at time ``now``."""
        assert not self.finished
        stage = self.current_stage
        n_tokens = min(n_tokens, self.remaining_in_stage)
        if stage.kind == StageKind.DECODE:
            self.token_times.extend([now] * n_tokens)
        self.tokens_done += n_tokens
        while (not self.finished
               and self.tokens_done >= self.current_stage.length):
            self.tokens_done -= self.current_stage.length
            self.stage_complete_times.append(now)
            self.stage_idx += 1
            if self.stage_idx >= len(self.stages):
                self.state = RequestState.FINISHED
                self.finish_time = now
                self.stage_idx = len(self.stages) - 1
                break

    # ---------------------------- SLO accounting ---------------------- #
    def compute_prefill_deadlines(self, zero_load_time_fn, now: float = None
                                  ) -> list[float]:
        """Absolute deadline for each PREFILL stage.

        The deadline of the first prefill is relative to arrival; subsequent
        prefill stages (tool loops) are relative to the completion of the
        preceding stage (estimated from the stage SLOs when not yet known).
        """
        start = self.arrival
        ddls = []
        for s in self.stages:
            if s.kind == StageKind.PREFILL:
                d = start + s.slo.ttft_slowdown * zero_load_time_fn(s.length)
                ddls.append(d)
                start = d
            else:
                start = start + s.length * s.slo.tpot
        self.prefill_deadlines = ddls
        return ddls

    def slo_attained(self, zero_load_time_fn) -> bool:
        """A request's SLO is attained iff every stage's SLO is satisfied."""
        if not self.finished:
            return False
        stage_start = self.arrival
        tok_cursor = 0
        for idx, s in enumerate(self.stages):
            end = self.stage_complete_times[idx]
            if s.kind == StageKind.PREFILL:
                limit = s.slo.ttft_slowdown * zero_load_time_fn(s.length)
                if end - stage_start > limit + 1e-9:
                    return False
            else:
                times = self.token_times[tok_cursor:tok_cursor + s.length]
                tok_cursor += s.length
                if not _tpot_windows_ok(times, stage_start, s.slo.tpot):
                    return False
            stage_start = end
        return True


def _tpot_windows_ok(times: list[float], start: float, tpot: float) -> bool:
    """TPOT measured every ``TPOT_WINDOW`` tokens (paper §6 Metric)."""
    if not times:
        return True
    pts = [start] + list(times)
    w = TPOT_WINDOW
    for i in range(0, len(pts) - 1, w):
        j = min(i + w, len(pts) - 1)
        span = pts[j] - pts[i]
        if span > (j - i) * tpot + 1e-9:
            return False
    return True


# ------------------------- convenience builders ------------------------- #
def simple_request(rid: int, arrival: float, prompt: int, output: int,
                   ttft_slowdown: float, tpot: float, value: float = 1.0
                   ) -> Request:
    from repro_torch.core.slo import prefill_slo, decode_slo
    return Request(
        rid=rid, arrival=arrival, value=value,
        stages=[StageSpec(prefill_slo(ttft_slowdown), prompt),
                StageSpec(decode_slo(tpot), output)])
