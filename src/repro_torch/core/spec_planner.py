"""SLO-adaptive speculative decoding planner (paper §3.2.3, Appendix D).

Chooses per-TPOT-tier speculation lengths sl_{1:L} that maximize the prefill
token *throughput* left over after satisfying all decode SLOs:

    max_{sl}  prefillTpt = PrefillBgtPerBatch / BatchTime
    PrefillBgtPerBatch   = Time2BS(T(sl), sl) - sum_l n_l * sl_l
    BatchTime T(sl)      = min_l ( TPOT_l * Acc(sl_l) )

where Acc(sl) = (1 - alpha^(sl+1)) / (1 - alpha) is the expected number of
tokens emitted per verification step with acceptance rate alpha (Leviathan et
al.; the verified prefix plus the bonus token).

The search space is tiny (sl <= MAX_SPEC_LEN, L <= 3 tiers in practice), so we
enumerate exhaustively instead of using the paper's closed-form shortcut —
same optimum, simpler code, covered by tests against the closed form.

Acceptance rates are not a constant of the workload: they drift with prompt
domain and decode position (SpecServe).  ``AcceptanceEstimator`` keeps a
per-SLO-class EWMA of observed accept rates fed by the engine's verify
results; the scheduler reads it each planning round so draft lengths adapt
online.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Optional, Sequence, Union

from repro_torch.core.perf_model import PerfModel

MAX_SPEC_LEN = 8   # paper App. D: "maximum speculation decode lengths below 10"

Alpha = Union[float, Sequence[float]]   # scalar or per-tier acceptance rates


def acc_len(sl: int, alpha: float) -> float:
    """Expected tokens emitted per verify of ``sl`` drafted tokens."""
    if sl <= 0:
        return 1.0
    if alpha >= 1.0 - 1e-9:
        return float(sl + 1)
    return (1.0 - alpha ** (sl + 1)) / (1.0 - alpha)


@dataclasses.dataclass(frozen=True)
class SpecPlan:
    spec_lens: tuple[int, ...]       # drafted tokens per tier
    batch_time: float                # T(sl)
    prefill_budget_per_batch: float
    prefill_tpt: float

    @property
    def spec_step(self) -> int:
        return max(self.spec_lens) if self.spec_lens else 0


def _per_tier_alphas(alpha: Alpha, n_tiers: int) -> list[float]:
    """Normalize ``alpha`` (scalar or per-tier sequence) to one per tier."""
    if isinstance(alpha, (int, float)):
        return [float(alpha)] * n_tiers
    alphas = [float(a) for a in alpha]
    assert len(alphas) == n_tiers, (len(alphas), n_tiers)
    return alphas


def plan_speculation(tier_counts: Sequence[int], tiers: Sequence[float],
                     perf: PerfModel, alpha: Alpha,
                     max_sl: int = MAX_SPEC_LEN) -> Optional[SpecPlan]:
    """Optimal per-tier speculation lengths; None if no feasible plan.

    ``alpha`` may be a single acceptance rate or one per tier (the online
    per-SLO-class estimates from :class:`AcceptanceEstimator`).
    """
    assert len(tier_counts) == len(tiers)
    L = len(tiers)
    alphas = _per_tier_alphas(alpha, L)
    active = [l for l in range(L) if tier_counts[l] > 0]
    if not active:
        return SpecPlan(tuple([0] * L), 0.0, 0.0, math.inf)

    best: Optional[SpecPlan] = None
    choices = [range(0, max_sl + 1) if l in active else (0,)
               for l in range(L)]
    for sls in itertools.product(*choices):
        # Effective batch latency target: every tier-l request receives
        # Acc(sl_l) tokens per batch, so the batch must finish within
        # TPOT_l * Acc(sl_l); the binding tier is the min.
        T = min(tiers[l] * acc_len(sls[l], alphas[l]) for l in active)
        spec_step = max(sls[l] for l in active)
        cap = perf.time2bs(T, spec_step=spec_step)
        decode_toks = sum(tier_counts[l] * (sls[l] + 1) for l in active)
        pb = cap - decode_toks
        if pb < 0:
            continue
        tpt = pb / T if T > 0 else 0.0
        if best is None or tpt > best.prefill_tpt:
            best = SpecPlan(tuple(int(s) for s in sls), T, float(pb), tpt)
    return best


@dataclasses.dataclass(frozen=True)
class RequestSpecPlan:
    spec_lens: tuple[int, ...]       # drafted tokens per REQUEST
    batch_time: float
    prefill_budget_per_batch: float
    prefill_tpt: float

    @property
    def spec_step(self) -> int:
        return max(self.spec_lens) if self.spec_lens else 0


def plan_speculation_requests(tpots: Sequence[float],
                              alphas: Sequence[float], perf: PerfModel,
                              max_sl: int = MAX_SPEC_LEN
                              ) -> Optional[RequestSpecPlan]:
    """Per-request speculation lengths; None if no feasible plan.

    Finer than :func:`plan_speculation`: two requests in the same TPOT
    tier can still differ — dynamic SLO strengthening (§3.2.3) gives a
    fallen-behind request a tighter effective TPOT, and per-class alphas
    drift independently.  Rather than enumerating (max_sl+1)^R
    assignments, observe that for a fixed batch time T each request
    independently wants the MINIMAL sl_r with

        tpot_r * acc_len(sl_r, alpha_r) >= T

    (a longer draft only adds verify tokens and can only raise
    spec_step, shrinking the token budget at the same T), and the
    achievable batch times form the finite grid
    {tpot_r * acc_len(s, alpha_r)}.  Scanning that grid with minimal
    assignments dominates exhaustive enumeration — the property test
    checks this against brute force on small instances.
    """
    R = len(tpots)
    assert len(alphas) == R
    if R == 0:
        return RequestSpecPlan((), 0.0, 0.0, math.inf)
    cands = sorted({tpots[r] * acc_len(s, alphas[r])
                    for r in range(R) for s in range(max_sl + 1)})
    best: Optional[RequestSpecPlan] = None
    for T in cands:
        sls = []
        for r in range(R):
            sl = next((s for s in range(max_sl + 1)
                       if tpots[r] * acc_len(s, alphas[r]) >= T - 1e-12),
                      None)
            if sl is None:
                break
            sls.append(sl)
        if len(sls) < R:
            continue
        spec_step = max(sls)
        cap = perf.time2bs(T, spec_step=spec_step)
        pb = cap - sum(s + 1 for s in sls)
        if pb < 0:
            continue
        tpt = pb / T if T > 0 else 0.0
        if best is None or tpt > best.prefill_tpt:
            best = RequestSpecPlan(tuple(int(s) for s in sls), float(T),
                                   float(pb), tpt)
    return best


class AcceptanceEstimator:
    """Per-SLO-class EWMA of observed draft-acceptance rates.

    Keys are SLO-class identifiers (we key by the class's TPOT value, which
    is what the planner tiers on).  Each verify step contributes one sample
    ``accepted / drafted``, weighted by the number of drafted tokens so a
    sl=1 verify doesn't move the estimate as hard as a sl=8 one:

        a_hat <- a_hat * beta^drafted + rate * (1 - beta^drafted)

    Until a class has seen ``warmup`` drafted tokens the prior is returned —
    blending in noisy early samples would whipsaw the draft-length plan
    during the first few batches (SpecServe §4.2 makes the same argument).
    """

    def __init__(self, prior: float = 0.7, beta: float = 0.95,
                 warmup: int = 8):
        assert 0.0 <= prior <= 1.0 and 0.0 < beta < 1.0
        self.prior = float(prior)
        self.beta = float(beta)
        self.warmup = int(warmup)
        self._est: dict = {}       # class key -> EWMA estimate
        self._drafted: dict = {}   # class key -> total drafted tokens seen

    def observe(self, key, accepted: int, drafted: int) -> None:
        if drafted <= 0:
            return
        rate = min(max(accepted / drafted, 0.0), 1.0)
        w = self.beta ** drafted
        prev = self._est.get(key, self.prior)
        self._est[key] = prev * w + rate * (1.0 - w)
        self._drafted[key] = self._drafted.get(key, 0) + drafted

    def alpha(self, key) -> float:
        """Current estimate for a class; the prior until warmed up."""
        if self._drafted.get(key, 0) < self.warmup:
            return self.prior
        return self._est[key]

    def alphas(self, keys: Sequence) -> list[float]:
        return [self.alpha(k) for k in keys]

    def snapshot(self) -> dict:
        """Class -> (alpha, drafted) for logging/observability."""
        keys = set(self._est) | set(self._drafted)
        return {k: (self.alpha(k), self._drafted.get(k, 0)) for k in keys}


def strengthen_slo(tpot: float, tokens_behind: int, window: int = 10) -> float:
    """Dynamic SLO adjustment under speculation uncertainty (§3.2.3):
    a request that fell ``tokens_behind`` tokens behind its SLO gets a
    proportionally tightened TPOT for the next planning window."""
    if tokens_behind <= 0:
        return tpot
    return tpot * window / (window + tokens_behind)
