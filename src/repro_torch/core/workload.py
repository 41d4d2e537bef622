"""Workload scenarios (paper Tables 1, 2 & 4) and arrival processes (Fig. 8).

Six scenarios: ChatBot, Coder, Summarizer, Mixed, ToolLLM, Reasoning.
Request lengths follow log-normal fits to the paper's Table 4 statistics
(mean / P99 / std); arrivals follow either a stable Poisson process
(Azure-Chatting-like) or a bursty modulated-Poisson process
(Azure-Coding-like), matching Fig. 8's qualitative shapes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np

from repro_torch.core.request import Request
from repro_torch.core.slo import (StageSpec, prefill_slo, decode_slo,
                            TIGHT_TTFT_SLOWDOWN, LOOSE_TTFT_SLOWDOWN,
                            TIGHT_TPOT, LOOSE_TPOT, SPEC_TPOT)


# --------------------------- length sampling --------------------------- #
@dataclasses.dataclass(frozen=True)
class LengthDist:
    mean: float
    std: float

    def sample(self, rng: np.random.Generator, n: int = None):
        """Log-normal matched to (mean, std), clipped to >= 4 tokens."""
        m, s = self.mean, max(self.std, 1.0)
        sigma2 = math.log(1.0 + (s / m) ** 2)
        mu = math.log(m) - sigma2 / 2.0
        out = rng.lognormal(mu, math.sqrt(sigma2), size=n)
        return np.maximum(out, 4).astype(int)


# Table 4 statistics.
TABLE4 = {
    "chatbot":    dict(prompt=LengthDist(763, 424),  output=LengthDist(266, 160)),
    "coder":      dict(prompt=LengthDist(847, 617),  output=LengthDist(26, 47)),
    "summarizer": dict(prompt=LengthDist(1333, 444), output=LengthDist(202, 234)),
    "toolllm":    dict(prompt=LengthDist(690, 356),  output=LengthDist(116, 66)),
    "reasoning":  dict(prompt=LengthDist(127, 83),
                       thinking=LengthDist(4693, 1442),
                       output=LengthDist(803, 280)),
}


# ---------------------------- arrival processes ------------------------ #
def poisson_arrivals(rate: float, duration: float,
                     rng: np.random.Generator) -> np.ndarray:
    """Stable arrivals (Azure-Chatting, Fig. 8b)."""
    if rate <= 0:
        return np.array([])
    n = rng.poisson(rate * duration)
    return np.sort(rng.uniform(0.0, duration, size=n))


def bursty_arrivals(rate: float, duration: float, rng: np.random.Generator,
                    burst_factor: float = 4.0, burst_frac: float = 0.2,
                    period: float = 30.0) -> np.ndarray:
    """Bursty arrivals (Azure-Coding, Fig. 8a): on-off modulated Poisson.

    A fraction ``burst_frac`` of each period runs at ``burst_factor``× the
    base rate; the remainder runs at a reduced rate so the average is
    ``rate``.
    """
    lo_rate = rate * (1 - burst_factor * burst_frac) / max(1 - burst_frac, 1e-9)
    lo_rate = max(lo_rate, 0.0)
    hi_rate = rate * burst_factor
    times = []
    t = 0.0
    while t < duration:
        hi_end = min(t + burst_frac * period, duration)
        times.append(poisson_arrivals(hi_rate, hi_end - t, rng) + t)
        lo_end = min(t + period, duration)
        times.append(poisson_arrivals(lo_rate, lo_end - hi_end, rng) + hi_end)
        t += period
    return np.sort(np.concatenate(times)) if times else np.array([])


# ------------------------------ scenarios ------------------------------ #
@dataclasses.dataclass(frozen=True)
class Scenario:
    name: str
    bursty: bool
    build: Callable[[int, float, np.random.Generator], Request]
    spec_alpha: Optional[float] = 0.7   # draft acceptance (None = no drafter)


def _chatbot(rid, t, rng) -> Request:
    d = TABLE4["chatbot"]
    return Request(rid, t, stages=[
        StageSpec(prefill_slo(LOOSE_TTFT_SLOWDOWN), int(d["prompt"].sample(rng))),
        StageSpec(decode_slo(LOOSE_TPOT), int(d["output"].sample(rng)))])


def _coder(rid, t, rng) -> Request:
    d = TABLE4["coder"]
    return Request(rid, t, stages=[
        StageSpec(prefill_slo(LOOSE_TTFT_SLOWDOWN), int(d["prompt"].sample(rng))),
        StageSpec(decode_slo(TIGHT_TPOT), int(d["output"].sample(rng)))])


def _live_coder(rid, t, rng) -> Request:
    """Interactive completion at sub-floor TPOT: coder lengths, but the
    decode SLO sits below the single-batch weight-read floor, so the pace
    is only attainable speculatively (§3.2.3, Fig. 6) — the scenario that
    separates SLO-planned draft lengths from both fixed-``sl`` and
    AR-only serving."""
    d = TABLE4["coder"]
    return Request(rid, t, stages=[
        StageSpec(prefill_slo(LOOSE_TTFT_SLOWDOWN), int(d["prompt"].sample(rng))),
        StageSpec(decode_slo(SPEC_TPOT), int(d["output"].sample(rng)))])


def _summarizer(rid, t, rng) -> Request:
    d = TABLE4["summarizer"]
    return Request(rid, t, stages=[
        StageSpec(prefill_slo(TIGHT_TTFT_SLOWDOWN), int(d["prompt"].sample(rng))),
        StageSpec(decode_slo(LOOSE_TPOT), int(d["output"].sample(rng)))])


def _toolllm(rid, t, rng) -> Request:
    """Tool loop: 2.7 ± 1.1 prefill-decode pairs (Table 4 caption).
    Tool-loop stages are tight on both prefill and decode; the final
    response decodes at reading speed (Table 1)."""
    d = TABLE4["toolllm"]
    n_pairs = int(np.clip(round(rng.normal(2.7, 1.1)), 1, 6))
    stages = []
    for k in range(n_pairs):
        last = k == n_pairs - 1
        stages.append(StageSpec(
            prefill_slo(TIGHT_TTFT_SLOWDOWN), int(d["prompt"].sample(rng))))
        stages.append(StageSpec(
            decode_slo(LOOSE_TPOT if last else TIGHT_TPOT),
            int(d["output"].sample(rng))))
    return Request(rid, t, stages=stages)


def _reasoning(rid, t, rng) -> Request:
    d = TABLE4["reasoning"]
    return Request(rid, t, stages=[
        StageSpec(prefill_slo(TIGHT_TTFT_SLOWDOWN), int(d["prompt"].sample(rng))),
        StageSpec(decode_slo(TIGHT_TPOT), int(d["thinking"].sample(rng))),
        StageSpec(decode_slo(LOOSE_TPOT), int(d["output"].sample(rng)))])


def _mixed(rid, t, rng) -> Request:
    return [_chatbot, _coder, _summarizer][int(rng.integers(0, 3))](rid, t, rng)


def _live_mixed(rid, t, rng) -> Request:
    """Sub-floor completions sharing the pool with relaxed chat: the
    co-scheduling case where per-SLO-class draft lengths beat one fixed
    ``sl`` — drafting for the loose tier is pure token waste, while the
    tight tier cannot live without it."""
    return [_live_coder, _chatbot][int(rng.integers(0, 2))](rid, t, rng)


SCENARIOS = {
    "chatbot":    Scenario("chatbot", bursty=False, build=_chatbot),
    "coder":      Scenario("coder", bursty=True, build=_coder),
    "live-coder": Scenario("live-coder", bursty=True, build=_live_coder),
    "live-mixed": Scenario("live-mixed", bursty=False, build=_live_mixed),
    "summarizer": Scenario("summarizer", bursty=False, build=_summarizer),
    "mixed":      Scenario("mixed", bursty=False, build=_mixed),
    # ToolLLM and Reasoning run without a speculative model (paper §6.1).
    "toolllm":    Scenario("toolllm", bursty=True, build=_toolllm,
                           spec_alpha=None),
    "reasoning":  Scenario("reasoning", bursty=False, build=_reasoning,
                           spec_alpha=None),
}


def generate_workload(scenario: str, rate: float, duration: float,
                      seed: int = 0) -> list[Request]:
    sc = SCENARIOS[scenario]
    rng = np.random.default_rng(seed)
    arr_fn = bursty_arrivals if sc.bursty else poisson_arrivals
    times = arr_fn(rate, duration, rng)
    return [sc.build(i, float(t), rng) for i, t in enumerate(times)]
