"""Multi-SLO dynamic-programming admission / token-allocation (paper §3.2.1).

Implements the Appendix-C formulation: requests sorted by prefill deadline,
state ``pb[i, m, n_vec]`` = maximum prefill budget available at request i's
prefill deadline having accepted ``n_vec`` requests per TPOT tier within
``m`` memory units.  Instead of quantizing the (m, pb, value) dimensions we
keep, per (i, n_vec), a *Pareto frontier* of (mem_used ↓, pb ↑, value ↑)
triples — exact and far cheaper than the dense table.

Transition (Eqn. 5 / Appendix C):

    pb[i, ., n] = max_{j : pDDL_j < pDDL_i}
        pb[j, . - m_i, n - e_tier(i)] - p_i + PB*(pDDL_i - pDDL_j, n - e)

where PB* (Eqn. 3) is the batch-formation budget solver of §3.2.2
(``pb_star_fluid``), fed with the decode demand of running requests plus the
accepted-so-far new requests.

Running requests are *forced admissions* (§3.2.1 "Continuous Optimization"):
a chain may never skip one.  If no feasible chain contains all forced
requests (can happen after mis-speculation or bursty lateness) the DP is
re-run with the forced requests' budget constraint relaxed — they are kept,
tardiness accepted, mirroring the paper's guarantee that admitted requests
are never dropped.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

from repro_torch.core.batch_formation import pb_star_fluid
from repro_torch.core.perf_model import PerfModel
from repro_torch.core.request import Request

_EPS = 1e-9


@dataclasses.dataclass
class Candidate:
    """One prefill-stage request as seen by the admission DP."""
    req: Request
    ddl: float            # prefill deadline, relative to `now`
    p: int                # remaining prefill tokens
    m: int                # memory units demanded if admitted
    tier: int             # decode tier index after prefill (-1 = none)
    value: float = 1.0
    forced: bool = False  # running request: must be admitted


@dataclasses.dataclass
class AdmissionResult:
    accepted: list[Candidate]
    declined: list[Candidate]
    relaxed: bool                 # forced-request constraint was relaxed
    best_value: float
    tier_counts: tuple[int, ...]  # accepted new + forced, per tier


def _pareto_insert(frontier: list, entry: tuple) -> bool:
    """entry = (mem, pb, value, back).  Keep non-dominated entries.
    Dominance: mem <=, pb >=, value >= (strict somewhere)."""
    mem, pb, value, _ = entry
    for (m2, pb2, v2, _) in frontier:
        if m2 <= mem + _EPS and pb2 >= pb - _EPS and v2 >= value - _EPS:
            return False
    frontier[:] = [e for e in frontier
                   if not (mem <= e[0] + _EPS and pb >= e[1] - _EPS
                           and value >= e[2] - _EPS)]
    frontier.append(entry)
    return True


def dp_admission(cands: Sequence[Candidate], tiers: Sequence[float],
                 running_tier_counts: Sequence[int], mem_free: int,
                 perf: PerfModel, horizon: float,
                 spec_lens: Optional[Sequence[int]] = None,
                 relax_forced: bool = False) -> AdmissionResult:
    """Solve admission + budget feasibility for prefill-stage candidates.

    ``running_tier_counts`` — decode demand of requests already decoding
    (their SLOs are enforced inside every PB* evaluation).
    """
    L = len(tiers)
    run_counts = tuple(running_tier_counts)
    assert len(run_counts) == L
    cands = sorted(cands, key=lambda c: (c.ddl, not c.forced))
    K = len(cands)

    def pb_star(dt: float, new_counts: tuple[int, ...]) -> float:
        total = tuple(r + n for r, n in zip(run_counts, new_counts))
        return pb_star_fluid(dt, total, tiers, perf, spec_lens)

    zero = tuple([0] * L)
    # states[i][n_vec] = Pareto list of (mem, pb, value, back)
    # back = (j, n_vec_j, entry_index_j);  i = 0 is the virtual source at t=0.
    states: list[dict] = [dict() for _ in range(K + 1)]
    states[0][zero] = [(0, 0.0, 0.0, None)]
    ddl = [0.0] + [c.ddl for c in cands]
    pb_star_memo: dict = {}

    def pb_star_cached(dt: float, nv: tuple[int, ...]) -> float:
        key = (round(dt, 6), nv)
        v = pb_star_memo.get(key)
        if v is None:
            v = pb_star(dt, nv)
            pb_star_memo[key] = v
        return v

    for i in range(1, K + 1):
        c = cands[i - 1]
        tier_vec = zero if c.tier < 0 else tuple(
            1 if l == c.tier else 0 for l in range(L))
        for j in range(0, i):
            # a chain j -> i skips candidates j+1..i-1: none may be forced
            if any(cands[k - 1].forced for k in range(j + 1, i)):
                continue
            for nv, frontier in list(states[j].items()):
                dpb = pb_star_cached(max(0.0, ddl[i] - ddl[j]), nv)
                if dpb == -math.inf:
                    continue
                nv_new = tuple(a + b for a, b in zip(nv, tier_vec))
                for ei, (mem, pb, val, _) in enumerate(frontier):
                    mem_new = mem + c.m
                    if mem_new > mem_free:
                        continue
                    pb_new = pb + dpb - c.p
                    if pb_new < -_EPS:
                        if not (relax_forced and c.forced):
                            continue
                        pb_new = 0.0   # forced through despite deficit
                    entry = (mem_new, pb_new, val + c.value, (j, nv, ei))
                    _pareto_insert(states[i].setdefault(nv_new, []), entry)

    # ---- terminal selection ------------------------------------------- #
    last_forced = max((k + 1 for k, c in enumerate(cands) if c.forced),
                      default=0)
    best = None   # (value, pb, -mem, i, nv, ei)
    for i in range(0, K + 1):
        if i < last_forced:
            continue
        if any(cands[k - 1].forced for k in range(i + 1, K + 1)):
            continue
        for nv, frontier in states[i].items():
            # decode flows must stay sustainable beyond the last deadline
            if pb_star_cached(max(horizon - ddl[i], 0.0)
                              + max(tiers, default=1.0), nv) == -math.inf:
                continue
            for ei, (mem, pb, val, _) in enumerate(frontier):
                cand = (val, pb, -mem, i, nv, ei)
                if best is None or cand > best:
                    best = cand
    if best is None:
        if not relax_forced and any(c.forced for c in cands):
            return dp_admission(cands, tiers, running_tier_counts, mem_free,
                                perf, horizon, spec_lens, relax_forced=True)
        return AdmissionResult([], list(cands), relax_forced, 0.0, run_counts)

    # ---- backtrack ----------------------------------------------------- #
    _, _, _, i, nv, ei = best
    accepted_idx = []
    while i > 0:
        entry = states[i][nv][ei]
        accepted_idx.append(i - 1)
        back = entry[3]
        if back is None:
            break
        j, nv_j, ej = back
        i, nv, ei = j, nv_j, ej
    accepted_set = set(accepted_idx)
    accepted = [cands[k] for k in sorted(accepted_set)]
    declined = [cands[k] for k in range(K) if k not in accepted_set]
    total_counts = list(run_counts)
    for c in accepted:
        if c.tier >= 0:
            total_counts[c.tier] += 1
    return AdmissionResult(accepted, declined, relax_forced,
                           best[0], tuple(total_counts))
