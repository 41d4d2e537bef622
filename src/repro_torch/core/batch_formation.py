"""Batch formation with dynamic batch-size tuning (paper §3.2.2, Algorithm 2).

Given a planning horizon ``t`` and the set of decoding requests with their
TPOT SLOs, produce the list of batches that satisfies every decode SLO while
maximizing the leftover *prefill budget* — the PB*(t, n) solver of Eqn. 3.

Two entry points:
  * ``form_batches``   — the exact Algorithm 2 (EDF priority queue), used to
    materialize the final schedule.
  * ``pb_star_fluid``  — O(L) fluid-limit rate computation used inside the
    DP's transition enumeration (the DP only needs the total budget, not the
    batch list).  Exactness vs. form_batches is covered by tests.

Unlike Sarathi-Serve, which caps every batch globally at the tightest TPOT,
batch sizes here adapt to the *current* decoding set: the per-batch latency
target is the tightest TPOT among running requests and the batch is filled
to the largest token count the perf model allows within that latency.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Optional, Sequence

from repro_torch.core.batch import Batch
from repro_torch.core.perf_model import PerfModel
from repro_torch.core.slo import StageKind


@dataclasses.dataclass
class DecodeDemand:
    """One decoding request as seen by the budget solver."""
    rid: int
    tpot: float
    remaining: Optional[int] = None   # None = decode indefinitely (conservative)
    spec_len: int = 1                 # tokens verified per batch (spec decoding)


def form_batches(horizon: float, demands: Sequence[DecodeDemand],
                 perf: PerfModel, spec_step: int = 0,
                 ) -> tuple[list[Batch], bool]:
    """Algorithm 2.  Returns (batches, feasible).

    ``feasible`` is False when some decode deadline cannot be met even with
    the whole batch devoted to decode tokens — the caller (DP) must then
    reject the corresponding admission state.
    """
    demands = [d for d in demands if d.remaining is None or d.remaining > 0]
    if not demands:
        # No decode constraint: one big batch sized to the horizon.
        bs = perf.time2bs(horizon, spec_step=spec_step)
        if horizon <= 0 or bs <= 0:
            return [], True
        b = Batch(est_duration=horizon, prefill_budget=bs, spec_step=spec_step)
        return [b], True

    t0 = min(d.tpot * d.spec_len for d in demands)       # line 1
    n_batches = max(0, int(math.floor(horizon / t0 + 1e-9)))
    if n_batches == 0:
        return [], True

    remaining = {d.rid: (math.inf if d.remaining is None else d.remaining)
                 for d in demands}
    by_rid = {d.rid: d for d in demands}
    # (next deadline, rid); first token of a stage is due one TPOT-interval in.
    heap = [(d.tpot * d.spec_len, d.rid) for d in demands]
    heapq.heapify(heap)

    batches: list[Batch] = []
    feasible = True
    for i in range(n_batches):                            # line 6
        end = (i + 1) * t0
        budget = perf.time2bs(t0, spec_step=spec_step)    # line 7: dyn. tuning
        b = Batch(est_duration=t0, spec_step=spec_step)
        while heap and heap[0][0] <= end + 1e-9:          # EDF pops (lines 8-13)
            ddl, rid = heapq.heappop(heap)
            d = by_rid[rid]
            take = min(d.spec_len, remaining[rid])
            if take <= 0:
                continue
            if budget < take:
                feasible = False                          # deadline unmeetable
                heapq.heappush(heap, (ddl, rid))
                break
            b.add(rid, StageKind.DECODE, int(take))
            budget -= take
            remaining[rid] -= take
            if remaining[rid] > 0:
                heapq.heappush(heap, (ddl + d.tpot * d.spec_len, rid))
        b.prefill_budget = int(budget)
        batches.append(b)
    return batches, feasible


def pb_star_fluid(t: float, tier_counts: Sequence[int],
                  tiers: Sequence[float], perf: PerfModel,
                  spec_lens: Optional[Sequence[int]] = None) -> float:
    """Fluid-limit PB*(t, n) — max total prefill budget over interval ``t``
    while attaining decode SLOs for ``tier_counts[l]`` requests per tier.

    With autoregressive decoding every batch lasts t0 = min active TPOT and
    contains ~ n_l * t0/TPOT_l decode tokens per tier; with speculative
    decoding (spec_lens) each batch lasts min_l TPOT_l*sl_l and verifies sl_l
    tokens per tier-l request (§3.2.3).
    """
    assert len(tier_counts) == len(tiers)
    if t <= 0:
        return 0.0
    # spec_lens are DRAFT lengths: a verify processes sl+1 tokens and may
    # emit up to sl+1, so the per-batch latency allowance is tp*(sl+1)
    active = [(n, tp, (spec_lens[l] + 1 if spec_lens else 1))
              for l, (n, tp) in enumerate(zip(tier_counts, tiers)) if n > 0]
    if not active:
        spec_step = max(spec_lens) if spec_lens else 0
        return float(perf.time2bs(t, spec_step=spec_step))
    t0 = min(tp * se for (_, tp, se) in active)
    if t0 <= 0:
        return -math.inf
    spec_step = max(se - 1 for (_, _, se) in active) if spec_lens else 0
    per_batch = perf.time2bs(t0, spec_step=spec_step)
    decode_per_batch = sum(n * t0 / tp for (n, tp, _) in active)
    pb_rate = (per_batch - decode_per_batch) / t0
    if per_batch < decode_per_batch:
        return -math.inf                                  # infeasible state
    n_batches = math.floor(t / t0 + 1e-9)
    return pb_rate * n_batches * t0


def decode_feasible(tier_counts: Sequence[int], tiers: Sequence[float],
                    perf: PerfModel,
                    spec_lens: Optional[Sequence[int]] = None) -> bool:
    """Can the chip sustain these decode flows at all?"""
    return pb_star_fluid(max(tiers) if tiers else 1.0, tier_counts, tiers,
                         perf, spec_lens) >= 0.0
