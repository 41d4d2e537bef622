"""Arrival-timestamped serving traces: the open-loop workload format.

A trace is a list of ``TraceEntry`` rows — each one request with its
absolute arrival offset, source scenario, SLO-tagged stages, and the
exact prompt token ids.  Pinning the prompt in the trace (rather than
letting each replica's rng invent one) is what makes open-loop replay
*conformance-testable*: the same trace driven through the HTTP/SSE
gateway and driven in-process against a fresh cluster must produce
bit-identical greedy token streams per entry.

``generate_trace`` samples the paper's six-scenario mix (Tables 1/2/4
via ``core/workload.py``) over one Poisson arrival process, with a
``time_scale`` knob that shrinks request lengths to CPU-executable
scale while keeping the arrival process and SLO structure intact.
Traces serialize to JSONL (``save_trace``/``load_trace`` round-trip
exactly), so a replayed experiment is a file, not a code path.

This module is ``repro/core/trace.py`` with its imports rewritten: the
same seed gives the same entries and the same file bytes.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.request import Request
from repro_torch.core.slo import StageSpec, prefill_slo, decode_slo
from repro_torch.core.workload import SCENARIOS, poisson_arrivals

# The paper's six serving scenarios (§6.1) — one trace carries them all.
SIX_SCENARIO_MIX = ("chatbot", "coder", "summarizer", "mixed", "toolllm",
                    "reasoning")


@dataclasses.dataclass(frozen=True)
class TraceEntry:
    """One request of an open-loop trace.  ``stages`` rows are
    ``(kind, length, slo)`` with ``slo`` the TTFT slowdown for prefill
    stages and the TPOT bound for decode stages."""

    rid: int
    arrival: float
    scenario: str
    stages: tuple[tuple[str, int, float], ...]
    prompt: tuple[int, ...]

    # ------------------------------------------------------------------ #
    def slo_class(self) -> str:
        """Label matching ``telemetry.instruments.slo_class_of``."""
        tiers = [s[2] for s in self.stages if s[0] == "decode"]
        return "prefill-only" if not tiers else f"tpot={min(tiers):g}"

    def total_tokens(self) -> int:
        return sum(s[1] for s in self.stages)

    def to_request(self, rid: Optional[int] = None) -> Request:
        """Materialize the ``Request`` (fresh runtime state every call —
        safe to drive the same trace through several clusters)."""
        stages = [StageSpec(prefill_slo(slo) if kind == "prefill"
                            else decode_slo(slo), length)
                  for kind, length, slo in self.stages]
        return Request(self.rid if rid is None else rid, self.arrival,
                       stages=stages)

    def to_payload(self) -> dict:
        """The gateway's ``POST /v1/generate`` JSON body."""
        stages = []
        for kind, length, slo in self.stages:
            row = {"kind": kind, "length": length}
            row["ttft_slowdown" if kind == "prefill" else "tpot"] = slo
            stages.append(row)
        return {"prompt": list(self.prompt), "stages": stages}

    def as_dict(self) -> dict:
        return {"rid": self.rid, "arrival": self.arrival,
                "scenario": self.scenario,
                "stages": [list(s) for s in self.stages],
                "prompt": list(self.prompt)}

    @classmethod
    def from_dict(cls, d: dict) -> "TraceEntry":
        return cls(rid=int(d["rid"]), arrival=float(d["arrival"]),
                   scenario=str(d["scenario"]),
                   stages=tuple((str(k), int(n), float(s))
                                for k, n, s in d["stages"]),
                   prompt=tuple(int(t) for t in d["prompt"]))


# ----------------------------- generation ------------------------------ #
def generate_trace(rate: float, duration: float, seed: int = 0,
                   mix: Sequence[str] = SIX_SCENARIO_MIX,
                   time_scale: float = 1.0,
                   max_stage_tokens: Optional[int] = None,
                   vocab: int = 512) -> list[TraceEntry]:
    """Sample an arrival-timestamped trace of the scenario ``mix``.

    One Poisson process at ``rate`` req/s spans all scenarios (each
    arrival draws its scenario uniformly from ``mix``), so classes
    interleave the way a multi-tenant frontend sees them.  ``time_scale``
    shrinks stage lengths (floor 4 tokens) and ``max_stage_tokens`` caps
    them, both WITHOUT touching arrivals or SLOs — the CPU-scale knob.
    Prompts are drawn per entry from the trace rng (ids in
    ``[1, vocab)``), so generation is reproducible from ``seed`` alone.
    """
    for name in mix:
        if name not in SCENARIOS:
            raise ValueError(f"unknown scenario {name!r}")
    rng = np.random.default_rng(seed)
    times = poisson_arrivals(rate, duration, rng)
    entries: list[TraceEntry] = []
    for rid, t in enumerate(times):
        name = mix[int(rng.integers(0, len(mix)))]
        req = SCENARIOS[name].build(rid, float(t), rng)
        stages = []
        for s in req.stages:
            n = max(4, int(round(s.length * time_scale)))
            if max_stage_tokens is not None:
                n = min(n, max_stage_tokens)
            slo = (s.slo.ttft_slowdown if s.kind.value == "prefill"
                   else s.slo.tpot)
            stages.append((s.kind.value, n, float(slo)))
        plen = stages[0][1] if stages[0][0] == "prefill" else 0
        prompt = tuple(int(x) for x in rng.integers(1, vocab, plen))
        entries.append(TraceEntry(rid=rid, arrival=float(t), scenario=name,
                                  stages=tuple(stages), prompt=prompt))
    return entries


# ---------------------------- serialization ---------------------------- #
def save_trace(entries: Sequence[TraceEntry], path: str) -> None:
    """One JSON object per line (JSONL)."""
    with open(path, "w") as fh:
        for e in entries:
            fh.write(json.dumps(e.as_dict(), sort_keys=True,
                                separators=(",", ":")) + "\n")


def load_trace(path: str) -> list[TraceEntry]:
    out = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                out.append(TraceEntry.from_dict(json.loads(line)))
    return out
