"""SLO specifications for multi-stage LLM requests (paper Tables 1 & 3).

A request is a sequence of stages.  Prefill-like stages (prompt processing,
tool-result ingestion) carry a TTFT-style deadline expressed as a *slowdown*
over the zero-load execution time.  Decode-like stages (token generation,
thinking) carry a TPOT bound drawn from a small set of tiers
``TPOT_1 < TPOT_2 < ... < TPOT_L`` (paper §3.2.1).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class StageKind(enum.Enum):
    PREFILL = "prefill"
    DECODE = "decode"


# Paper Table 3: SLOs for different model configurations.
TIGHT_TTFT_SLOWDOWN = 3.0
LOOSE_TTFT_SLOWDOWN = 5.0
TIGHT_TPOT = 0.050  # seconds / token
LOOSE_TPOT = 0.100
# Below the single-batch weight-read floor of the reference 7B perf model
# (~11.5 ms at batch size 1): only speculative decoding can hold this pace (§3.2.3, Fig. 6).
SPEC_TPOT = 0.008

# TPOT is measured every TPOT_WINDOW tokens (paper §6, "we measure the TPOT
# every 10 tokens" — required for speculative decoding which emits bursts).
TPOT_WINDOW = 10


@dataclasses.dataclass(frozen=True)
class StageSLO:
    """SLO attached to one stage of a request."""

    kind: StageKind
    # For PREFILL stages: max slowdown of TTFT vs. zero-load prefill latency.
    ttft_slowdown: Optional[float] = None
    # For DECODE stages: max seconds per output token.
    tpot: Optional[float] = None

    def __post_init__(self):
        if self.kind == StageKind.PREFILL:
            assert self.ttft_slowdown is not None and self.ttft_slowdown >= 1.0
        else:
            assert self.tpot is not None and self.tpot > 0


def prefill_slo(slowdown: float) -> StageSLO:
    return StageSLO(StageKind.PREFILL, ttft_slowdown=slowdown)


def decode_slo(tpot: float) -> StageSLO:
    return StageSLO(StageKind.DECODE, tpot=tpot)


@dataclasses.dataclass(frozen=True)
class StageSpec:
    """One stage of a multi-stage request: its length (tokens) and its SLO."""

    slo: StageSLO
    length: int  # prompt tokens for PREFILL, output tokens for DECODE

    @property
    def kind(self) -> StageKind:
        return self.slo.kind


def tpot_tiers(stages_or_requests) -> list[float]:
    """Distinct decode TPOT tiers present, sorted tightest-first."""
    tiers = set()
    for item in stages_or_requests:
        stages = getattr(item, "stages", None) or [item]
        for s in stages:
            if s.kind == StageKind.DECODE:
                tiers.add(s.slo.tpot)
    return sorted(tiers)
