"""Serving frontend: the request-facing layer around (scheduler, engine).

``ReplicaDriver`` owns the Algorithm-1 control loop for ONE replica:
queueing arrivals, invoking the planner, executing planned batches on the
engine, streaming tokens to per-request callbacks, SLO bookkeeping, the
real best-effort tier (§4.1: surplus batch budget spent on declined
requests), and page-pressure victim selection — when admission or a
decode-step reservation exhausts the page pool, best-effort victims are
preempted (``PagedKVManager.preempt`` frees their device pages, newest
first, mirroring ``BestEffortQueue.preempt_for_pages``) and later resume
with a recompute prefill.

``ServingFrontend`` is the single-replica wrapper (launch/serve.py).

Time is virtual (the planner's §3.1.1 perf model) so the control plane is
deterministic and testable; the engine executes every token for real.

This module is ``repro/serving/frontend.py`` with its imports rewritten:
both classes hold the engine by duck type and make no tensor calls, so the
same control loop drives the PyTorch engine, prefix-aware admission (the
engine's ``prefix_aware_admission`` option) included.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Optional

import numpy as np

from repro_torch.core.admission import BestEffortQueue
from repro_torch.core.batch import Batch
from repro_torch.core.request import Request, RequestState
from repro_torch.core.scheduler import SLOsServeScheduler
from repro_torch.core.slo import StageKind
from repro_torch.core.spec_planner import AcceptanceEstimator
from repro_torch.serving.engine import ServingEngine


def _null_span(name, **attrs):
    return contextlib.nullcontext()


@dataclasses.dataclass
class FrontendStats:
    submitted: int = 0
    served: int = 0          # terminal outcomes (finished + dropped)
    attained: int = 0
    dropped: int = 0
    cancelled: int = 0       # caller-cancelled (client disconnect); not
    tokens_out: int = 0      # counted as served — never an SLO outcome
    best_effort: int = 0     # requests demoted to the best-effort tier
    preempted: int = 0       # real PagedKVManager.preempt invocations


@dataclasses.dataclass
class DriveResult:
    n_exec: int = 0          # engine batches executed
    elapsed: float = 0.0     # virtual time consumed
    declined: list = dataclasses.field(default_factory=list)


class ReplicaDriver:
    """One replica's serving loop, reusable by the single-replica
    ``ServingFrontend`` and the multi-replica ``ClusterFrontend``."""

    def __init__(self, engine: ServingEngine, scheduler: SLOsServeScheduler,
                 idx: int = 0, seed: int = 0, telemetry=None):
        self.engine = engine
        self.sched = scheduler
        self.idx = idx
        # telemetry is a ReplicaTelemetry (or None when disabled): every
        # hot-path hook below is guarded by one `is not None` check, so a
        # bare driver pays nothing
        self.tel = telemetry
        self._span = _null_span
        if telemetry is not None and telemetry.tracer is not None \
                and telemetry.tracer.enabled:
            self._span = telemetry.tracer.span
            engine.tracer = telemetry.tracer
        self.rng = np.random.default_rng(seed)
        self.new_q: list[Request] = []
        self.running: list[Request] = []
        # §4.1 best-effort tier: FCFS service, LIFO preemption — the same
        # ordering contract as the simulator's BestEffortQueue
        self.be = BestEffortQueue(engine.ecfg.page_size)
        self.saved_ctx: dict[int, object] = {}   # rid -> ctx evicted by drop
        self.streams: dict[int, Callable] = {}
        self.prompts: dict[int, list] = {}
        self.encs: dict[int, object] = {}
        self.stats = FrontendStats()
        self.preempted_rids: set[int] = set()
        # terminal-outcome hook: a serving gateway (or any transport)
        # sets `on_finish(req, attained, dropped)` to learn the moment a
        # request reaches a terminal state, since `_finish`/`drop_request`
        # immediately forget the stream callback
        self.on_finish: Optional[Callable] = None
        # online per-SLO-class acceptance estimation: when the scheduler
        # plans speculation (cfg.spec_alpha prior set), attach an EWMA
        # estimator and feed it each verify's accepted/drafted outcome so
        # the planned draft lengths track the observed acceptance per
        # TPOT class (§3.2.3; SpecServe drift adaptation).  A draftless
        # engine cannot speculate: disarm the planner (engine truth wins
        # over the REPRO_SPEC_DECODE config default) — otherwise planned
        # sl+1 decode allocations run autoregressively and overshoot the
        # per-stage token counts the plan promised.
        if engine.spec is None:
            if scheduler.cfg.spec_alpha is not None:
                scheduler.cfg = dataclasses.replace(
                    scheduler.cfg, spec_alpha=None)
        elif scheduler.cfg.spec_alpha is not None \
                and scheduler.estimator is None:
            scheduler.estimator = AcceptanceEstimator(
                prior=scheduler.cfg.spec_alpha)

    # ------------------------------ intake ----------------------------- #
    def enqueue(self, req: Request, prompt: Optional[list] = None,
                on_token: Optional[Callable] = None, enc_states=None,
                best_effort: bool = False) -> None:
        if prompt is None:
            prompt = self.rng.integers(
                1, self.engine.cfg.vocab, req.stages[0].length).tolist()
        self.prompts[req.rid] = prompt
        if on_token:
            self.streams[req.rid] = on_token
        if enc_states is not None:
            self.encs[req.rid] = enc_states
        if best_effort:
            self.be.add(req)
            self.stats.best_effort += 1
            if self.tel is not None:
                self.tel.best_effort.inc()
        else:
            self.new_q.append(req)

    def forget(self, rid: int) -> None:
        self.streams.pop(rid, None)
        self.prompts.pop(rid, None)
        self.encs.pop(rid, None)
        self.saved_ctx.pop(rid, None)

    def drop_request(self, r: Request) -> None:
        self.stats.dropped += 1
        self.stats.served += 1
        if self.tel is not None:
            self.tel.on_drop(r)
        if self.on_finish is not None:
            self.on_finish(r, False, True)
        self.forget(r.rid)

    def cancel(self, rid: int) -> bool:
        """Cancel a request on behalf of the caller (client disconnect):
        remove it from every queue it may sit in and release its engine
        state through the existing preempt/drop release path —
        ``engine.drop`` frees the device pages (CoW-aware unref, shared
        budget credited) and the sequence slot in one call.  Cancelled
        requests count in ``stats.cancelled`` only; they are neither
        served nor attained.  Returns whether the request was found."""
        found = False
        for r in list(self.new_q):
            if r.rid == rid:
                self.new_q.remove(r)
                found = True
        for e in list(self.be.entries):
            if e.req.rid == rid:
                self.be.entries.remove(e)
                found = True
        for r in list(self.running):
            if r.rid == rid:
                self.running.remove(r)
                found = True
        if rid in self.engine.reqs:
            self.engine.drop(rid)
            found = True
        if found:
            self.stats.cancelled += 1
            self.preempted_rids.discard(rid)
            self.forget(rid)
        return found

    @property
    def idle(self) -> bool:
        return not (self.new_q or self.running or len(self.be))

    def next_arrival(self) -> Optional[float]:
        return min((r.arrival for r in self.new_q), default=None)

    # ----------------------------- routing ----------------------------- #
    def verdict(self, now: float, req: Request,
                prompt: Optional[list] = None) -> bool:
        """SLO-attainability probe (§4.2): would this replica's DP
        scheduler admit ``req`` against its live state right now?  With
        ``prompt``, the probe credits this replica's cached prefix — the
        verdict a prefix-affinity hop is after."""
        cached, live, pen = self._discounts([req], prompt)
        res = self.sched.plan(now, self.running, [req], self._mem_free(),
                              admission_only=True,
                              cached_prefix=cached, live_prefix=live,
                              prefetch_penalty=pen)
        return any(r.rid == req.rid for r in res.admitted)

    def _discounts(self, reqs: list[Request],
                   prompt: Optional[list] = None
                   ) -> tuple[Optional[dict], Optional[dict],
                              Optional[dict]]:
        """Cached-prefix discounts for the DP planner: per request, the
        token-exact resident-prompt hit (discounts prefill tokens), the
        matched pages other requests currently map (discounts memory
        units — cached zero-ref matches already sit inside ``mem_free``),
        and the modeled H2D prefetch latency when part of the hit lives
        in the host spill tier (charged against the request's first
        prefill deadline so tight-TTFT admission stays honest about the
        transfer it would trigger).  One ``prefix_discounts`` chain walk
        yields all three.  Pages resident only in the best-effort tier
        are excluded from the memory discount: ``_mem_free`` already
        counts them as preemptable-free supply, and one page must never
        discount demand and inflate supply at once."""
        kv = self.engine.kv
        be_pages = self._be_page_set()
        toks, pages, pen = {}, {}, {}
        for r in reqs:
            if r.rid in self.encs:
                continue      # enc-conditioned prompts never share
            pr = prompt if prompt is not None else self.prompts.get(r.rid)
            if pr is None:
                continue
            hit, live, spilled = kv.prefix_discounts(
                pr, exclude_pages=be_pages)
            if hit:
                toks[r.rid] = hit
            if live:
                pages[r.rid] = live
            if spilled:
                pen[r.rid] = kv.prefetch_seconds(spilled)
        return toks or None, pages or None, pen or None

    def _mem_free(self) -> int:
        # pages reclaimable by preempting the best-effort tier count as
        # free for admission (the simulator's _replan does the same)
        return self.engine.kv.free_pages + self._be_resident_pages()

    def _be_resident_pages(self) -> int:
        kv = self.engine.kv
        return sum(len(kv.tables.get(e.req.rid, []))
                   for e in self.be.entries if e.req.kv_resident)

    def _be_page_set(self) -> set[int]:
        """Pages mapped by kv-resident best-effort requests — the pages
        ``_mem_free`` treats as preemptable-free supply."""
        kv = self.engine.kv
        out: set[int] = set()
        for e in self.be.entries:
            if e.req.kv_resident:
                out.update(kv.tables.get(e.req.rid, ()))
        return out

    # --------------------------- main loop ----------------------------- #
    def drive(self, now: float, max_batches: int = 8) -> DriveResult:
        """One scheduler invocation + up to ``max_batches`` engine batches;
        declined arrivals are returned for the caller's fallback policy
        (retry, route to another replica, or best-effort demotion)."""
        res = DriveResult()
        arrivals = [r for r in self.new_q if r.arrival <= now]
        self.new_q = [r for r in self.new_q if r.arrival > now]
        cached, live, pen = self._discounts(arrivals)
        t0 = time.perf_counter()
        with self._span("plan", replica=self.idx):
            plan = self.sched.plan(now, self.running, arrivals,
                                   self._mem_free(),
                                   cached_prefix=cached, live_prefix=live,
                                   prefetch_penalty=pen)
        if self.tel is not None:
            self.tel.on_plan(time.perf_counter() - t0, plan.admitted,
                             plan.declined, plan.deferred)
        for r in plan.admitted:
            if self._admit(r, now):
                r.state = RequestState.RUNNING
                self.running.append(r)
            elif r.rid in self.prompts:
                self.new_q.append(r)     # engine pressure: retry next plan
        self.new_q.extend(plan.deferred)
        res.declined = plan.declined

        t = now
        by_rid = {r.rid: r for r in self.running}
        for b in plan.batches[:max_batches]:
            with self._span("execute", replica=self.idx,
                            n=len(b.entries), spec=b.spec_step):
                out = self.engine.execute(b, on_pressure=self._preempt_for)
            t += max(b.est_duration, 1e-3)
            res.n_exec += 1
            pref_done = 0
            prog = self.engine.last_prefill_progress
            for e in b.entries:          # prefill progress = fresh tokens
                r = by_rid.get(e.rid)    # actually consumed (replay after
                if r is not None and e.kind == StageKind.PREFILL \
                        and r.in_prefill:      # preemption doesn't count)
                    adv = min(prog.get(e.rid, 0), r.remaining_in_stage)
                    r.advance(adv, t)
                    pref_done += adv
            est = self.sched.estimator
            if est is not None:
                # fold this batch's verify outcomes into the per-SLO-class
                # acceptance EWMA (keyed by the request's tightest TPOT,
                # the value the planner tiers on)
                for rid, (acc, drafted) in \
                        self.engine.last_spec_stats.items():
                    r = by_rid.get(rid)
                    if r is not None and drafted > 0:
                        est.observe(r.tightest_tpot(), acc, drafted)
            dec_done = 0
            for rid, toks in out.items():
                self.stats.tokens_out += len(toks)
                dec_done += len(toks)
                if toks and rid in self.streams:
                    self.streams[rid](rid, toks)
                r = by_rid.get(rid)
                if r is not None:
                    r.advance(len(toks), t)
            if self.tel is not None:
                self.tel.on_batch_planned(b)
                self.tel.on_delivered(StageKind.PREFILL, pref_done)
                self.tel.on_delivered(StageKind.DECODE, dec_done)
            # surplus batch budget flows to the best-effort tier (§4.1)
            if b.prefill_budget > 0 and len(self.be):
                self._serve_best_effort(b.prefill_budget, t)
            self._sweep(by_rid, t)
        if not plan.batches and len(self.be):
            # idle drain: no SLO-guaranteed work planned, so grant the
            # best-effort tier one prefill-only batch worth of budget
            dt = self.sched.cfg.prefill_only_latency
            budget = max(int(self.sched.perf.time2bs(dt)), 16)
            if self._serve_best_effort(budget, t + dt):
                t += dt
                res.n_exec += 1
        res.elapsed = t - now
        return res

    def _sweep(self, by_rid: dict, t: float) -> None:
        eng = self.engine
        for r in list(self.running):
            if r.finished:
                self._finish(r)
                by_rid.pop(r.rid, None)
            elif r.in_prefill and r.rid in eng.reqs \
                    and not eng.reqs[r.rid].pending:
                need = r.remaining_in_stage   # tool loop: new context
                if need > 0:
                    eng.reqs[r.rid].pending.extend(
                        self.rng.integers(1, eng.cfg.vocab, need).tolist())

    def _finish(self, r: Request) -> None:
        self.engine.finish(r.rid)
        if r in self.running:
            self.running.remove(r)
        self.stats.served += 1
        att = r.slo_attained(self.sched.zero_load_time)
        self.stats.attained += att
        if self.tel is not None:
            self.tel.on_finish(r, bool(att))
        if self.on_finish is not None:
            self.on_finish(r, bool(att), False)
        self.forget(r.rid)

    # -------------------- admission & victim selection ------------------ #
    def _admit(self, r: Request, now: float) -> bool:
        """Engine admission with page-pressure preemption: a declined page
        reservation victimizes best-effort requests to free real device
        pages, then retries.  A prefix hit at admission is fresh request
        progress the engine will never re-prefill, so the request advances
        by it here (``engine.last_hit_fresh``)."""
        eng = self.engine
        prompt = self.prompts[r.rid]
        if not self._servable(r, prompt):
            self.drop_request(r)         # can never fit this engine
            return False
        expected = r.total_tokens() + 8
        enc = self.encs.get(r.rid)
        if eng.ecfg.prefix_aware_admission and enc is None:
            # shave the up-front reservation by the probed cached-prefix
            # hit: those tokens' pages are mapped (not drawn fresh) at
            # admit, so the table only has to cover the residual now —
            # decode growth extends on demand (EngineConfig docstring)
            expected = max(expected - eng.kv.probe_prefix(prompt), 1)
        ok = eng.add_request(r.rid, prompt, expected, enc_states=enc)
        if not ok:
            # fresh demand is the full reservation minus LIVE shared-prefix
            # pages (mapped by others, free to share); cached matches are
            # already inside free_pages, and best-effort-resident matches
            # are about to be preempted into it — neither may be
            # discounted twice
            disc = eng.kv.live_prefix_pages(
                prompt, exclude_pages=self._be_page_set()) \
                if enc is None else 0
            need = eng.kv.pages_needed(expected) - disc
            if need > eng.kv.free_pages:
                self._preempt_for(need - eng.kv.free_pages)
                ok = eng.add_request(r.rid, prompt, expected, enc_states=enc)
            if not ok and not eng.kv.free_seqs and self._evict_slot():
                ok = eng.add_request(r.rid, prompt, expected, enc_states=enc)
        if ok:
            self._advance_hit(r, now)
        return ok

    def _servable(self, r: Request, prompt: list) -> bool:
        """A request whose FINAL context (all prefill + decode stages)
        exceeds the per-sequence cap can never finish on this engine:
        decode would silently cap at max_len and the request would sit in
        the system forever (or a tool-loop prefill would raise)."""
        return (len(prompt) <= self.engine.ecfg.max_len
                and r.total_tokens() <= self.engine.ecfg.max_len)

    def _preempt_for(self, pages_needed: int) -> int:
        """Free >= ``pages_needed`` device pages by preempting best-effort
        victims, newest first (the LIFO order of
        ``BestEffortQueue.preempt_for_pages``); returns pages freed."""
        freed = 0
        for e in reversed(self.be.entries):
            if freed >= pages_needed:
                break
            r = e.req
            if not r.kv_resident or r.rid not in self.engine.reqs:
                continue
            freed += self.engine.preempt(r.rid)
            r.kv_resident = False
            r.state = RequestState.PREEMPTED
            # keep the queue's own §4.1 bookkeeping truthful
            e.recompute_remaining = len(self.engine.reqs[r.rid].pending)
            e.prefilled = False
            self.stats.preempted += 1
            if self.tel is not None:
                self.tel.preemptions.inc()
            self.preempted_rids.add(r.rid)
        return freed

    def _evict_slot(self) -> bool:
        """Sequence-slot pressure: fully evict one best-effort victim
        (newest first), stashing its context for a later ``restore``."""
        for e in reversed(self.be.entries):
            r = e.req
            if r.rid not in self.engine.reqs:
                continue
            if r.kv_resident:
                self.engine.preempt(r.rid)
                r.kv_resident = False
                r.state = RequestState.PREEMPTED
                e.recompute_remaining = len(self.engine.reqs[r.rid].pending)
                e.prefilled = False
                self.stats.preempted += 1
                if self.tel is not None:
                    self.tel.preemptions.inc()
                self.preempted_rids.add(r.rid)
            self.saved_ctx[r.rid] = self.engine.drop(r.rid)
            return True
        return False

    # ------------------------- best-effort tier ------------------------- #
    @staticmethod
    def _rest_tokens(r: Request) -> int:
        rest = sum(s.length for s in r.stages[r.stage_idx:])
        return max(rest - r.tokens_done, 0)

    def _advance_hit(self, r: Request, t: float) -> None:
        """Credit the request-level progress of an admission-time prefix
        hit (cached tokens the engine will never re-prefill)."""
        fresh = self.engine.last_hit_fresh
        if fresh and r.in_prefill:
            r.advance(fresh, t)

    def _emit(self, r: Request, toks: list, t: float) -> None:
        self.stats.tokens_out += len(toks)
        if toks and r.rid in self.streams:
            self.streams[r.rid](r.rid, toks)
        r.advance(len(toks), t)

    def _serve_best_effort(self, budget: int, t: float) -> bool:
        """Spend surplus batch budget on the best-effort tier with REAL
        execution: FCFS over entries (BestEffortQueue order); preempted
        entries first re-reserve pages and replay their recompute prefill,
        then decode.  Returns whether any engine work ran."""
        eng = self.engine
        worked = False
        for e in list(self.be.entries):
            if budget <= 0:
                break
            r = e.req
            rid = r.rid
            if not self._servable(r, self.prompts.get(rid, [])):
                self.be.entries.remove(e)     # final context can't ever fit
                self.drop_request(r)
                continue
            ctx = eng.reqs.get(rid)
            if ctx is None:
                saved = self.saved_ctx.pop(rid, None)
                if saved is not None:
                    if not eng.restore(rid, saved, len(saved.pending)
                                       + self._rest_tokens(r) + 8):
                        self.saved_ctx[rid] = saved
                        self._maybe_unservable(e)
                        continue
                elif not eng.add_request(rid, self.prompts[rid],
                                         r.total_tokens() + 8,
                                         enc_states=self.encs.get(rid)):
                    self._maybe_unservable(e)
                    continue
                ctx = eng.reqs[rid]
                r.kv_resident = True
                r.state = RequestState.BEST_EFFORT
                self._advance_hit(r, t)
            elif not r.kv_resident:
                # preempted: re-reserve pages, then replay the recompute
                # prefill below (re-queued for re-prefill).  Hysteresis
                # against preempt/readmit thrash: beyond the victim's own
                # need, require a page of decode-growth headroom per
                # running request, or the next guaranteed batch would just
                # preempt it again after a wasted full-history recompute.
                need = eng.kv.pages_needed(len(ctx.pending)
                                           + self._rest_tokens(r) + 8)
                if eng.kv.free_pages < need + len(self.running):
                    continue
                if not eng.readmit(rid, len(ctx.pending)
                                   + self._rest_tokens(r) + 8):
                    continue
                r.kv_resident = True
                r.state = RequestState.BEST_EFFORT
                self._advance_hit(r, t)
            while budget > 0 and ctx.pending:
                cap = eng.kv.token_capacity(rid) - eng.kv.length(rid)
                take = min(budget, len(ctx.pending), max(cap, 0))
                if take <= 0:
                    break
                b = Batch()
                b.add(rid, StageKind.PREFILL, take)
                try:
                    out = eng.execute(b)
                except RuntimeError:
                    # a copy-on-write target exceeded the capacity cap
                    # (token_capacity counts mapped+free pages, not the
                    # extra CoW page): the best-effort tier never crashes
                    # the loop — back off until pages free up (the raise
                    # fired before any pending tokens were consumed)
                    break
                budget -= take
                worked = True
                prog = eng.last_prefill_progress.get(rid, 0)
                if r.in_prefill and prog:
                    r.advance(min(prog, r.remaining_in_stage), t)
                self._emit(r, out.get(rid, []), t)
            e.recompute_remaining = len(ctx.pending)
            e.prefilled = not ctx.pending
            if ctx.pending:
                continue
            while budget > 0 and not r.finished and r.in_decode \
                    and not ctx.done:
                n = min(budget, r.remaining_in_stage)
                b = Batch()
                b.add(rid, StageKind.DECODE, n)
                try:
                    out = eng.execute(b).get(rid, [])
                except RuntimeError:
                    break                # CoW page short: back off
                if not out:
                    break                # page-capped: wait for free pages
                budget -= len(out)
                worked = True
                e.generated += len(out)
                self._emit(r, out, t)
            if not r.finished and r.in_prefill and not ctx.pending:
                need = r.remaining_in_stage   # tool loop context
                if need > 0:
                    ctx.pending.extend(self.rng.integers(
                        1, eng.cfg.vocab, need).tolist())
            if r.finished:
                r.kv_resident = False
                self.be.entries.remove(e)
                self._finish(r)
        return worked

    def _maybe_unservable(self, e) -> None:
        """A best-effort request that cannot be admitted even into a fully
        idle pool will never fit: drop it instead of spinning forever.
        (``free_pages == total_pages`` also requires the SHARED budget to
        be unconstrained — a request blocked only by another replica's
        budget usage is temporary, not unservable.)"""
        kv = self.engine.kv
        if kv.used_pages == 0 and not self.running \
                and kv.free_pages == kv.total_pages:
            self.be.entries.remove(e)
            self.drop_request(e.req)


class ServingFrontend:
    """Single-replica frontend: a thin wrapper over one ReplicaDriver.
    launch/serve.py and examples/serve_e2e.py drive this class; a network
    server would wrap ``submit`` / ``step`` with its transport."""

    def __init__(self, engine: ServingEngine, scheduler: SLOsServeScheduler,
                 max_decline_retries: int = 3, seed: int = 0,
                 telemetry=None):
        self.engine = engine
        self.sched = scheduler
        self.max_retries = max_decline_retries
        # telemetry is an optional ClusterTelemetry hub; the driver gets
        # its replica-0 instrument and `step` drives the per-step sampler
        self.telemetry = telemetry
        tel = telemetry.replica(0) \
            if telemetry is not None and telemetry.enabled else None
        self.driver = ReplicaDriver(engine, scheduler, seed=seed,
                                    telemetry=tel)
        self.draining: set[int] = set()      # on_step compatibility
        self.clock = 0.0

    @property
    def drivers(self) -> list[ReplicaDriver]:
        return [self.driver]

    @property
    def stats(self) -> FrontendStats:
        return self.driver.stats

    # ------------------------------------------------------------------ #
    def submit(self, req: Request, prompt: Optional[list] = None,
               on_token: Optional[Callable] = None,
               enc_states=None) -> None:
        """Queue a request; ``on_token(rid, [tokens])`` streams output."""
        self.driver.enqueue(req, prompt, on_token, enc_states)
        self.driver.stats.submitted += 1

    def cancel(self, rid: int) -> bool:
        """Cancel a submitted request (client disconnect passthrough)."""
        return self.driver.cancel(rid)

    @property
    def idle(self) -> bool:
        return self.driver.idle

    # ------------------------------------------------------------------ #
    def step(self, max_batches: int = 8) -> int:
        """One scheduler invocation + up to ``max_batches`` engine batches.
        Returns the number of batches executed."""
        now = self.clock
        res = self.driver.drive(now, max_batches)
        for r in res.declined:
            r.routing_hops += 1
            if r.routing_hops <= self.max_retries:
                self.driver.new_q.append(r)
            else:
                self.driver.drop_request(r)
        if res.n_exec == 0:
            nxt = min((r.arrival for r in self.driver.new_q),
                      default=now + 0.1)
            self.clock = max(now + 0.05, nxt)
        else:
            self.clock = now + res.elapsed
        if self.telemetry is not None:
            self.telemetry.on_step(self, self.clock, res.n_exec)
        return res.n_exec

    # ------------------------------------------------------------------ #
    def run_until_idle(self, max_steps: int = 10_000) -> FrontendStats:
        for _ in range(max_steps):
            if self.idle:
                break
            self.step()
        return self.stats
