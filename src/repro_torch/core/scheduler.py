"""SLOs-Serve top-level scheduler (paper Algorithm 1 + §3.2).

``SLOsServeScheduler.plan(now, running, new, mem_free)`` performs one
scheduler invocation:

  1. build admission candidates (new requests + forced running prefills)
     and decode-demand tiers (running decodes, tightest-SLO upper bound
     for multi-decode-SLO requests, §3.2.1 "Multi-Decode SLOs"),
  2. solve admission + budget feasibility with the multi-SLO DP,
  3. materialize the batch schedule: chunked prefill into the per-batch
     prefill budget (EDF), dynamic batch-size tuning (Algorithm 2) and
     SLO-adaptive speculative decoding (§3.2.3).

Declined requests are returned for fallback handling (best-effort tier §4.1
or routing §4.2) by the caller.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
import os
from typing import Optional, Sequence

from repro_torch.core.batch import Batch
from repro_torch.core.dp_scheduler import Candidate, dp_admission
from repro_torch.core.perf_model import PerfModel
from repro_torch.core.request import Request
from repro_torch.core.slo import StageKind
from repro_torch.core.spec_planner import (AcceptanceEstimator, acc_len,
                                     plan_speculation,
                                     plan_speculation_requests,
                                     strengthen_slo)


def _default_spec_alpha() -> Optional[float]:
    """REPRO_SPEC_DECODE=1 flips the fleet-wide default to speculation ON
    with the standard 0.7 acceptance prior (CI spec matrix leg, mirroring
    REPRO_SHARE_PREFIX); unset/0 keeps autoregressive planning."""
    if os.environ.get("REPRO_SPEC_DECODE", "").lower() in ("1", "true",
                                                           "yes", "on"):
        return 0.7
    return None


@dataclasses.dataclass
class SchedulerConfig:
    horizon: float = 20.0            # planning window (s)
    page_size: int = 16              # tokens per KV page (memory unit)
    max_new_per_plan: int = 12       # DP tractability cap; overflow deferred
    max_planned_batches: int = 64    # replan at least this often
    prefill_only_latency: float = 0.05   # batch latency target w/o decodes
    # draft-acceptance prior; None = AR.  When an AcceptanceEstimator is
    # attached to the scheduler this is only the warmup prior — planning
    # uses the per-SLO-class online estimates.
    spec_alpha: Optional[float] = dataclasses.field(
        default_factory=_default_spec_alpha)
    spec_margin: float = 0.85            # TPOT headroom vs. emission variance
    min_batch_latency: float = 0.01      # floor when chasing tight TTFTs
    # real engines emit the first output token AT prefill completion, so
    # the decode stage needs one fewer planned token (simulator: False)
    prefill_emits_first_token: bool = False
    min_ddl_slack: float = 1e-3


@dataclasses.dataclass
class PlanResult:
    admitted: list[Request]
    declined: list[Request]
    deferred: list[Request]          # over the per-plan DP cap; retried next
    batches: list[Batch]
    relaxed: bool = False


@dataclasses.dataclass
class _DecodeJob:
    req: Request
    tpot: float
    tier: int
    remaining: float
    active_from: float               # relative time decode begins
    first_due: float = -1.0          # carried-over next-token deadline


class SLOsServeScheduler:
    name = "slos-serve"

    def __init__(self, perf: PerfModel, cfg: SchedulerConfig = None):
        self.perf = perf
        self.cfg = cfg or SchedulerConfig()
        # per-SLO-class acceptance EWMA (keyed by tier TPOT value).  The
        # frontend attaches one and feeds it observed verify outcomes;
        # until then the cfg.spec_alpha prior is used for every tier.
        self.estimator: Optional[AcceptanceEstimator] = None
        # last plan's speculation decision, for observability/demos:
        # (tiers, spec_lens or None, per-tier alphas used)
        self.last_spec_plan: Optional[tuple] = None

    def _alphas(self, tiers: Sequence[float]):
        """Per-tier acceptance rates for planning, or None if spec is off
        (speculation is enabled by the cfg.spec_alpha prior; the attached
        estimator only refines the value per SLO class)."""
        if self.cfg.spec_alpha is None:
            return None
        if self.estimator is not None:
            return self.estimator.alphas(list(tiers))
        return self.cfg.spec_alpha

    # ------------------------------------------------------------------ #
    def zero_load_time(self, prefill_len: int) -> float:
        return self.perf.batch_time(prefill_len)

    def mem_units(self, req: Request) -> int:
        return max(1, math.ceil(req.total_tokens() / self.cfg.page_size))

    def _tier_of(self, tiers: list[float], req: Request) -> int:
        t = req.tightest_tpot()
        return tiers.index(t) if t is not None else -1

    # ------------------------------------------------------------------ #
    def plan(self, now: float, running: list[Request], new: list[Request],
             mem_free: int, admission_only: bool = False,
             cached_prefix: Optional[dict[int, int]] = None,
             live_prefix: Optional[dict[int, int]] = None,
             prefetch_penalty: Optional[dict[int, float]] = None
             ) -> PlanResult:
        """One scheduler invocation.  ``admission_only`` skips the batch
        materialization (Algorithm 2) — routing verdicts (§4.2) only need
        the DP's admit/decline decision, not the batch timeline.

        ``cached_prefix`` maps rid -> tokens of the request's prompt the
        serving engine already holds as shared prefix pages
        (``PagedKVManager.prefix_discounts``; token-exact with partial-page
        matching).  The DP then plans with the *residual* prefill length:
        cached tokens consume no prefill budget, so the same TTFT SLO
        admits more requests (the prefix-cache counterpart of AdaServe's
        "spend the headroom" principle).  The deadline itself stays a
        function of the full prompt — the SLO is defined on the request,
        not on the work.

        ``live_prefix`` maps rid -> matched prefix pages currently MAPPED
        by other requests (``PagedKVManager.live_prefix_pages``): sharing
        them costs no free-pool capacity, so they shave the candidate's
        memory-unit demand.  Zero-refcount cached hit pages must NOT be
        discounted — they are already counted inside ``mem_free``, and
        discounting them here would double-count the same headroom (which
        is also why the cached_prefix token discount never touches
        ``m``).

        ``prefetch_penalty`` maps rid -> seconds of modeled H2D transfer
        a spilled-prefix hit would trigger
        (``PagedKVManager.prefetch_seconds``): the cached_prefix discount
        for host-tier pages is real, but the bytes still have to cross
        the bus before the residual prefill's attention can read them, so
        the candidate's first prefill deadline shrinks by that latency —
        a tight-TTFT request whose discount only exists on the host tier
        admits honestly or not at all."""
        cfg = self.cfg
        cached_prefix = cached_prefix or {}
        live_prefix = live_prefix or {}
        prefetch_penalty = prefetch_penalty or {}
        new = sorted(new, key=lambda r: r.arrival)
        deferred = new[cfg.max_new_per_plan:]
        new = new[:cfg.max_new_per_plan]

        tiers = sorted({r.tightest_tpot() for r in running + new
                        if r.tightest_tpot() is not None})
        if not tiers:
            tiers = [0.1]
        L = len(tiers)

        # --- decode demand of running decodes (forced, not DP candidates)
        run_counts = [0] * L
        decode_jobs: list[_DecodeJob] = []
        cands: list[Candidate] = []
        for r in running:
            tier = self._tier_of(tiers, r)
            if r.in_decode:
                run_counts[tier] += 1
                # next-token deadline carries over from the last emitted
                # token so replans don't silently grant extra slack
                last = r.token_times[-1] if r.token_times else (
                    r.stage_complete_times[-1] if r.stage_complete_times
                    else now)
                due = max(last + tiers[tier] - now, 1e-6)
                # §3.2.3: strengthen the SLO of requests that fell behind
                # under speculation uncertainty
                stage_start = (r.stage_complete_times[-1]
                               if r.stage_complete_times else r.arrival)
                expected = int((now - stage_start) / tiers[tier])
                behind = expected - r.tokens_done
                eff_tpot = strengthen_slo(tiers[tier], behind)
                decode_jobs.append(_DecodeJob(
                    r, eff_tpot, tier,
                    remaining=r.remaining_in_stage,   # stop at stage end:
                    # a following tool-prefill is a NEW forced candidate
                    active_from=0.0,
                    first_due=min(due, eff_tpot)))
            elif r.in_prefill:
                if not r.prefill_deadlines:
                    r.compute_prefill_deadlines(self.zero_load_time)
                ddl = self._current_prefill_ddl(r) - now
                cands.append(Candidate(
                    req=r, ddl=max(ddl, cfg.min_ddl_slack),
                    p=r.remaining_in_stage, m=0, tier=tier,
                    value=r.value, forced=True))

        for r in new:
            r.compute_prefill_deadlines(self.zero_load_time)
            ddl = (r.prefill_deadlines[0] - now
                   - prefetch_penalty.get(r.rid, 0.0))
            disc = min(cached_prefix.get(r.rid, 0),
                       r.current_stage.length - 1)
            cands.append(Candidate(
                req=r, ddl=max(ddl, cfg.min_ddl_slack),
                p=max(r.current_stage.length - disc, 1),
                m=max(self.mem_units(r) - live_prefix.get(r.rid, 0), 1),
                tier=self._tier_of(tiers, r), value=r.value, forced=False))

        # --- speculative decoding plan (per-tier speculation lengths),
        # co-optimized with admission: the spec planner proposes the
        # draft-length vector that maximizes leftover prefill throughput
        # at the current per-class acceptance estimates, then the DP is
        # solved under BOTH the speculative and the autoregressive fluid
        # bound (pb_star_fluid(spec_lens=...)) and the higher-value
        # admission wins — speculation is only adopted when the tokens it
        # reclaims actually admit at least as much SLO-weighted work.
        alphas = self._alphas(tiers)
        spec_lens = None
        spec_cands: list = [None]
        if alphas is not None:
            est_counts = list(run_counts)
            for c in cands:
                if c.tier >= 0:
                    est_counts[c.tier] += 1
            m_tiers = [t * cfg.spec_margin for t in tiers]
            sp = plan_speculation(est_counts, m_tiers, self.perf, alphas)
            if sp is not None and any(sp.spec_lens):
                spec_cands.append(sp.spec_lens)

        res = None
        best_key = None
        for sls in spec_cands:
            r_ = dp_admission(cands, tiers, run_counts, mem_free, self.perf,
                              cfg.horizon, spec_lens=sls)
            key = (not r_.relaxed, r_.best_value)
            # ties go to speculation (iterated last): same admitted value
            # at longer drafts means more prefill budget per batch
            if best_key is None or key >= best_key:
                res, best_key, spec_lens = r_, key, sls
        self.last_spec_plan = (tuple(tiers), spec_lens,
                               None if alphas is None else alphas)

        admitted = [c.req for c in res.accepted]
        declined = [c.req for c in res.declined if not c.forced]
        # forced candidates that the DP "declined" are kept regardless
        forced_kept = [c.req for c in res.declined if c.forced]
        admitted += forced_kept

        batches = [] if admission_only else self._materialize(
            res.accepted + [c for c in res.declined if c.forced],
            decode_jobs, tiers)
        return PlanResult(admitted=[r for r in admitted
                                    if r.state.value == "new"],
                          declined=declined, deferred=deferred,
                          batches=batches, relaxed=res.relaxed)

    # ------------------------------------------------------------------ #
    def _remaining_decode(self, r: Request) -> int:
        total = 0
        for idx in range(r.stage_idx, len(r.stages)):
            s = r.stages[idx]
            if s.kind == StageKind.DECODE:
                total += s.length
                if idx == r.stage_idx:
                    total -= r.tokens_done
        return total

    def _current_prefill_ddl(self, r: Request) -> float:
        n_prior = sum(1 for s in r.stages[:r.stage_idx]
                      if s.kind == StageKind.PREFILL)
        ddls = r.prefill_deadlines
        return ddls[min(n_prior, len(ddls) - 1)]

    # ------------------------------------------------------------------ #
    def _materialize(self, accepted_cands: list[Candidate],
                     decode_jobs: list[_DecodeJob],
                     tiers: list[float]) -> list[Batch]:
        """Build the batch timeline: Algorithm 2 + EDF prefill allocation.

        Decode entries carry ``sl+1`` tokens under speculation (drafted +
        bonus, what the target model actually processes); the perf-model
        #SpecStep is the max drafted length in the batch.
        """
        cfg = self.cfg
        perf = self.perf
        alphas = self._alphas(tiers)
        alpha_of = ([float(alphas)] * len(tiers)
                    if isinstance(alphas, (int, float))
                    else list(alphas or []))
        prefills = sorted(
            [{"req": c.req, "ddl": c.ddl, "rem": c.p} for c in accepted_cands],
            key=lambda d: d["ddl"])
        jobs = {id(j): j for j in decode_jobs}
        # EDF heap over decode scheduling deadlines
        heap: list[tuple[float, int]] = []
        for j in decode_jobs:
            due = j.first_due if j.first_due > 0 else j.tpot
            heapq.heappush(heap, (due, id(j)))

        t = 0.0
        batches: list[Batch] = []
        while len(batches) < cfg.max_planned_batches and t < cfg.horizon:
            active = [j for j in jobs.values()
                      if j.active_from <= t + 1e-9 and j.remaining > 0]
            has_prefill = any(p["rem"] > 0 for p in prefills)
            if not active and not has_prefill:
                break
            # Per-REQUEST draft lengths: each active decode plans at its
            # own strengthened TPOT and class alpha, so a fallen-behind
            # request in the same tier can draft deeper than its peers
            # instead of dragging the whole tier to its pace.
            sl_of = None
            if active:
                if alphas is not None:
                    r_tpots = [j.tpot * cfg.spec_margin for j in active]
                    r_alphas = [alpha_of[j.tier] for j in active]
                    sp = plan_speculation_requests(r_tpots, r_alphas, perf)
                    if sp is not None and any(sp.spec_lens) and sp.batch_time > 0:
                        sl_of = {id(j): sp.spec_lens[i]
                                 for i, j in enumerate(active)}
                        t0 = sp.batch_time
                    else:
                        t0 = min(j.tpot for j in active)
                else:
                    t0 = min(j.tpot for j in active)
            else:
                t0 = cfg.prefill_only_latency
            # no batch can run faster than one forward pass: a fallen-
            # behind decode whose strengthened TPOT dips below the
            # weight-read floor (§3.2.3 under acceptance collapse) would
            # otherwise demand a zero-budget batch and livelock the
            # replica — serve it at the floor, best effort
            floor = max(perf.batch_time(1) * 1.05, cfg.min_batch_latency)
            t0 = max(t0, floor)
            # a pending prefill with a deadline inside this batch window
            # must complete at batch END <= its deadline: shrink the batch
            # (shorter-than-TPOT batches are always SLO-safe) — but never
            # below the weight-read floor, where the token budget vanishes
            next_ddl = min((p["ddl"] for p in prefills if p["rem"] > 0),
                           default=math.inf)
            if next_ddl < t + t0:
                t0 = max(next_ddl - t, floor)
            end = t + t0
            spec_step = max(sl_of.values()) if sl_of else 0
            budget = perf.time2bs(t0, spec_step=spec_step)
            b = Batch(est_duration=t0, spec_step=spec_step)

            # -- decode allocation (EDF over scheduling deadlines)
            requeue = []
            while heap and heap[0][0] <= end + 1e-9 and budget > 0:
                ddl, jid = heapq.heappop(heap)
                j = jobs.get(jid)
                if j is None or j.remaining <= 0 or j.active_from > t + 1e-9:
                    continue
                per = (sl_of.get(jid, 0) + 1) if sl_of else 1
                take = int(min(per, math.ceil(j.remaining), budget))
                if take <= 0:
                    requeue.append((ddl, jid))
                    break
                b.add(j.req.rid, StageKind.DECODE, take)
                budget -= take
                # expected progress: a verify of (take-1) drafts emits
                # Acc(take-1) tokens in expectation (§3.2.3 / App. D),
                # at the job's own class acceptance estimate
                emitted = (acc_len(take - 1, alpha_of[j.tier])
                           if sl_of else float(take))
                j.remaining -= emitted
                if j.remaining > 0:
                    heapq.heappush(heap, (ddl + j.tpot * emitted, jid))
            for item in requeue:
                heapq.heappush(heap, item)

            # -- prefill allocation (EDF by prefill deadline)
            for p in prefills:
                if budget <= 0:
                    break
                if p["rem"] <= 0:
                    continue
                take = int(min(budget, p["rem"]))
                b.add(p["req"].rid, StageKind.PREFILL, take)
                budget -= take
                p["rem"] -= take
                if p["rem"] == 0:
                    r = p["req"]
                    tpot = r.tightest_tpot()
                    rem = self._next_decode_stage_len(r)
                    if tpot is not None and rem > 0:
                        tier = tiers.index(tpot)
                        if cfg.prefill_emits_first_token:
                            rem = max(rem - 1, 0)
                        j = _DecodeJob(r, tpot, tier, remaining=rem,
                                       active_from=end)
                        jobs[id(j)] = j
                        heapq.heappush(heap, (end + tpot, id(j)))
            # -- spare capacity accelerates decodes past their SLO pace
            # (running ahead of a deadline is always SLO-safe and frees
            # KV memory sooner — crucial for long-decode workloads where
            # memory, not compute, caps concurrency)
            if budget > 0 and not sl_of:
                active2 = [j for j in jobs.values()
                           if j.active_from <= t + 1e-9 and j.remaining > 0]
                while budget > 0 and active2:
                    for j in list(active2):
                        if budget <= 0:
                            break
                        take = int(min(4, math.ceil(j.remaining), budget))
                        b.add(j.req.rid, StageKind.DECODE, take)
                        budget -= take
                        j.remaining -= take
                        if j.remaining <= 0:
                            active2.remove(j)
                    if not any(j.remaining > 0 for j in active2):
                        break
            b.prefill_budget = max(0, int(budget))
            if b.entries or b.prefill_budget:
                batches.append(b)
            t = end
        return batches

    @staticmethod
    def _has_decode_after(r: Request) -> bool:
        return any(s.kind == StageKind.DECODE
                   for s in r.stages[r.stage_idx:])

    @staticmethod
    def _next_decode_stage_len(r: Request) -> int:
        """Length of the decode stage that follows the current prefill
        (the decode job a completed prefill activates)."""
        for s in r.stages[r.stage_idx:]:
            if s.kind == StageKind.DECODE:
                return s.length
        return 0
