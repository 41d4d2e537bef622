"""Soft admission control fallbacks: the best-effort tier (paper §4.1).

Declined requests (unattainable SLOs, e.g. during bursts) are served from a
best-effort queue that consumes *surplus* token budget left in executed
batches after all SLO-guaranteed allocations.  Preemption discards only KV
cache while keeping generated tokens, so a preempted request resumes with a
single prefill over (prompt + generated-so-far) rather than re-decoding.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.request import Request, RequestState
from repro_torch.core.slo import StageKind


@dataclasses.dataclass
class BEEntry:
    req: Request
    # tokens of (prompt + regenerated context) that must be (re)prefilled
    # before decoding can continue; grows on preemption.
    recompute_remaining: int = 0
    prefilled: bool = False
    generated: int = 0           # decode tokens produced so far (kept on preempt)

    def total_context(self) -> int:
        return self.req.total_prefill_tokens() + self.generated


class BestEffortQueue:
    """FCFS best-effort tier consuming leftover batch budget."""

    def __init__(self, page_size: int = 16):
        self.entries: list[BEEntry] = []
        self.page_size = page_size

    def __len__(self) -> int:
        return len(self.entries)

    def add(self, req: Request) -> None:
        req.state = RequestState.BEST_EFFORT
        e = BEEntry(req=req,
                    recompute_remaining=req.current_stage.length
                    if req.current_stage.kind == StageKind.PREFILL else 0)
        self.entries.append(e)

    # ------------------------------------------------------------------ #
    def resident_pages(self) -> int:
        return sum(math.ceil(max(e.total_context(), 1) / self.page_size)
                   for e in self.entries if e.req.kv_resident)

    def preempt_for_pages(self, pages_needed: int) -> int:
        """Discard KV of BE requests (LIFO) until ``pages_needed`` freed.

        Returns pages actually freed.  Preempted requests keep their
        generated tokens and re-enter with a single recompute prefill (§4.1).
        """
        freed = 0
        for e in reversed(self.entries):
            if freed >= pages_needed:
                break
            if not e.req.kv_resident:
                continue
            freed += math.ceil(max(e.total_context(), 1) / self.page_size)
            e.req.kv_resident = False
            e.req.state = RequestState.PREEMPTED
            # resume = one prefill over prompt + previously generated tokens
            e.recompute_remaining = e.total_context()
            e.prefilled = False
        return freed

    # ------------------------------------------------------------------ #
    def consume_budget(self, budget: int, now: float,
                       free_pages: int) -> tuple[int, list[Request]]:
        """Allocate up to ``budget`` surplus tokens to BE requests.

        Returns (tokens_used, finished_requests).  Requests without resident
        KV first spend budget on their recompute prefill (needs pages).
        """
        used = 0
        finished: list[Request] = []
        for e in list(self.entries):
            if budget <= 0:
                break
            r = e.req
            if not r.kv_resident:
                pages = math.ceil(max(e.total_context(), 1) / self.page_size)
                if pages > free_pages:
                    continue
                free_pages -= pages
                r.kv_resident = True
                r.state = RequestState.BEST_EFFORT
            if e.recompute_remaining > 0:
                take = min(budget, e.recompute_remaining)
                e.recompute_remaining -= take
                budget -= take
                used += take
                if e.recompute_remaining > 0:
                    continue
                # recompute done: if original stage was prefill, mark progress
                if r.current_stage.kind == StageKind.PREFILL:
                    r.advance(r.remaining_in_stage, now)
            # decode one token at a time from remaining budget
            while (budget > 0 and not r.finished
                   and r.current_stage.kind == StageKind.DECODE):
                r.advance(1, now)
                e.generated += 1
                budget -= 1
                used += 1
            # a follow-up prefill stage (tool loop) becomes recompute work
            if (not r.finished and r.current_stage.kind == StageKind.PREFILL
                    and e.recompute_remaining == 0):
                e.recompute_remaining = r.remaining_in_stage
            if r.finished:
                r.kv_resident = False
                finished.append(r)
                self.entries.remove(e)
        return used, finished
