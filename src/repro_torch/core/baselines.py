"""Baseline schedulers (paper §2.3 & §6): vLLM, Sarathi-Serve, DistServe.

All three share the SLOs-Serve scheduler interface (``plan(now, running,
new, mem_free) -> PlanResult``) so the simulator can swap them in.  They are
greedy per-iteration schedulers: each plan() emits exactly one next batch and
is re-invoked when it completes.

* ``VLLMScheduler``   — prefill-oriented (§2.3): eagerly executes waiting
  prefills (whole prompts, preempting/stalling decodes), decode batches only
  when no prefill waits.  Optional fixed-length speculative decoding
  (vLLM (Spec) in Fig. 9).
* ``SarathiScheduler`` — decode-oriented chunked prefill: every batch has a
  *fixed* token budget sized to the tightest decode SLO; decodes fill first,
  leftover budget is given to FCFS prefill chunks.
* ``DistServeScheduler`` — disaggregated: replicas are given a ``role``
  ("prefill" or "decode"); prefill replicas run FCFS whole-prompt batches,
  decode replicas run pure decode batches.  The cluster simulator migrates
  requests between pools after prefill (KV transfer assumed free — favorable
  to the baseline).

None of them performs SLO-based admission control: requests are admitted
whenever KV memory allows (with the decode-length oracle all systems get,
§6 Setup) and queue otherwise.
"""
from __future__ import annotations

import math
from typing import Optional

from repro_torch.core.batch import Batch
from repro_torch.core.perf_model import PerfModel
from repro_torch.core.request import Request
from repro_torch.core.scheduler import PlanResult, SchedulerConfig
from repro_torch.core.slo import StageKind


class GreedySchedulerBase:
    name = "greedy-base"
    role = "mixed"

    def __init__(self, perf: PerfModel, cfg: SchedulerConfig = None):
        self.perf = perf
        self.cfg = cfg or SchedulerConfig()

    def zero_load_time(self, prefill_len: int) -> float:
        return self.perf.batch_time(prefill_len)

    def mem_units(self, req: Request) -> int:
        return max(1, math.ceil(req.total_tokens() / self.cfg.page_size))

    def _admit_by_memory(self, new: list[Request], mem_free: int
                         ) -> tuple[list[Request], list[Request]]:
        admitted, deferred = [], []
        for r in sorted(new, key=lambda r: r.arrival):
            need = self.mem_units(r)
            if need <= mem_free:
                admitted.append(r)
                mem_free -= need
            else:
                deferred.append(r)
        return admitted, deferred

    def _finish_batch(self, entries_batch: Batch) -> Batch:
        n = entries_batch.n_tokens
        entries_batch.est_duration = self.perf.batch_time(
            n, spec_step=entries_batch.spec_step)
        return entries_batch


class VLLMScheduler(GreedySchedulerBase):
    name = "vllm"

    def __init__(self, perf, cfg=None, spec_len: int = 0,
                 max_prefill_tokens: int = 2048):
        super().__init__(perf, cfg)
        self.spec_len = spec_len            # >0 = vLLM (Spec)
        self.max_prefill_tokens = max_prefill_tokens
        if spec_len:
            self.name = "vllm-spec"

    def plan(self, now, running, new, mem_free) -> PlanResult:
        admitted, deferred = self._admit_by_memory(new, mem_free)
        active = running + admitted
        prefills = sorted([r for r in active if r.in_prefill],
                          key=lambda r: r.arrival)
        decodes = [r for r in active if r.in_decode]
        b = Batch()
        if prefills:
            # Prefill-oriented: run prompts eagerly, decodes stall (Fig. 3).
            budget = self.max_prefill_tokens
            for r in prefills:
                take = min(budget, r.remaining_in_stage)
                b.add(r.rid, StageKind.PREFILL, take)
                budget -= take
                if budget <= 0:
                    break
        elif decodes:
            sl = self.spec_len
            b.spec_step = sl
            for r in decodes:
                b.add(r.rid, StageKind.DECODE, sl + 1 if sl else 1)
        batches = [self._finish_batch(b)] if b.entries else []
        return PlanResult(admitted=admitted, declined=[], deferred=deferred,
                          batches=batches)


class SarathiScheduler(GreedySchedulerBase):
    name = "sarathi"

    def __init__(self, perf, cfg=None, tightest_tpot: Optional[float] = None):
        super().__init__(perf, cfg)
        # Fixed batch budget sized to the tightest decode SLO (§6 Baseline).
        self._fixed_tpot = tightest_tpot
        self._budget_cache: Optional[int] = None

    def _budget(self, active: list[Request]) -> int:
        if self._budget_cache is not None:
            return self._budget_cache
        tpot = self._fixed_tpot
        if tpot is None:
            tiers = [r.tightest_tpot() for r in active
                     if r.tightest_tpot() is not None]
            tpot = min(tiers) if tiers else 0.1
        self._budget_cache = max(1, self.perf.time2bs(tpot))
        return self._budget_cache

    def plan(self, now, running, new, mem_free) -> PlanResult:
        admitted, deferred = self._admit_by_memory(new, mem_free)
        active = running + admitted
        budget = self._budget(active)
        b = Batch()
        # decodes first (decode-oriented), then FCFS prefill chunks
        for r in active:
            if r.in_decode and budget > 0:
                b.add(r.rid, StageKind.DECODE, 1)
                budget -= 1
        for r in sorted((r for r in active if r.in_prefill),
                        key=lambda r: r.arrival):
            if budget <= 0:
                break
            take = min(budget, r.remaining_in_stage)
            b.add(r.rid, StageKind.PREFILL, take)
            budget -= take
        batches = [self._finish_batch(b)] if b.entries else []
        return PlanResult(admitted=admitted, declined=[], deferred=deferred,
                          batches=batches)


class DistServeScheduler(GreedySchedulerBase):
    """Per-replica scheduler for the disaggregated baseline.

    The cluster simulator assigns roles and migrates requests post-prefill.
    """
    name = "distserve"

    def __init__(self, perf, cfg=None, role: str = "prefill",
                 max_prefill_tokens: int = 8192):
        super().__init__(perf, cfg)
        assert role in ("prefill", "decode")
        self.role = role
        self.name = f"distserve-{role}"
        self.max_prefill_tokens = max_prefill_tokens

    def plan(self, now, running, new, mem_free) -> PlanResult:
        admitted, deferred = self._admit_by_memory(new, mem_free)
        active = running + admitted
        b = Batch()
        if self.role == "prefill":
            for r in sorted((r for r in active if r.in_prefill),
                            key=lambda r: r.arrival):
                take = min(self.max_prefill_tokens, r.remaining_in_stage)
                b.add(r.rid, StageKind.PREFILL, take)
                break                         # FCFS one prompt per batch
        else:
            for r in active:
                if r.in_decode:
                    b.add(r.rid, StageKind.DECODE, 1)
        batches = [self._finish_batch(b)] if b.entries else []
        return PlanResult(admitted=admitted, declined=[], deferred=deferred,
                          batches=batches)
