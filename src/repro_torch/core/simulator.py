"""Discrete-event multi-replica serving simulator.

Replays a workload against a cluster of replicas, each owning a scheduler
(SLOs-Serve or a baseline) and a KV-page pool, using the paper's §3.1.1
performance model as the execution-time oracle.  This is the evaluation
vehicle for every scheduler-level experiment (capacity Fig. 1/9, burst
Fig. 11, scaling Fig. 13, ablation Fig. 14, overhead Fig. 15): the paper's
contribution is the planner, and the planner's world-model *is* this
performance model — wall-clock GPU execution is exactly what the dry-run +
roofline analysis covers on the JAX side.

Mechanics mirrored from the paper:
  * Algorithm 1 control loop — replan on timeout / #new / #finished
    thresholds; planned batches execute back-to-back.
  * Soft admission: declined requests go to the best-effort tier (§4.1) or
    are routed to the next replica (§4.2, sequential routing with a hop
    limit and a BE backup policy).
  * Best-effort tier consumes surplus batch budget; preemption discards KV
    only (resume with one recompute prefill).
  * DistServe-style disaggregation: replicas carry roles; requests migrate
    between prefill/decode pools on stage boundaries (KV transfer free).
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import math
import time as _time
from collections import deque
from typing import Optional

import numpy as np

from repro_torch.core.admission import BestEffortQueue
from repro_torch.core.batch import Batch
from repro_torch.core.perf_model import PerfModel
from repro_torch.core.request import Request, RequestState
from repro_torch.core.scheduler import PlanResult
from repro_torch.core.slo import StageKind


@dataclasses.dataclass
class SimConfig:
    page_size: int = 16
    total_pages: int = 4096             # KV pool per replica
    replan_timeout: float = 0.25        # Algorithm 1 thresholds
    thresh_new: int = 0                 # replan as soon as a request waits
    thresh_finished: int = 4
    max_route_hops: int = 3             # §4.2 sequential routing limit
    routing_delay: float = 0.002
    exec_noise_sigma: float = 0.0       # lognormal noise on batch times
    drain_time: float = 120.0           # extra time after last arrival
    best_effort: bool = True            # §4.1 fallback tier on/off (ablation)
    seed: int = 0


@dataclasses.dataclass
class RequestRecord:
    rid: int
    attained: bool
    finished: bool
    ttft: Optional[float]
    mean_tpot: Optional[float]
    tier: str
    hops: int


@dataclasses.dataclass
class SimResult:
    n_requests: int
    n_finished: int
    n_attained: int
    n_best_effort: int
    n_preemptions: int
    records: list[RequestRecord]
    sched_overheads: list[float]
    sim_wallclock: float
    load_trace: list[tuple[float, int, int]]   # (t, n_std_in_system, n_be)

    @property
    def attainment(self) -> float:
        return self.n_attained / max(self.n_requests, 1)

    def p99(self, field: str) -> float:
        vals = [getattr(r, field) for r in self.records
                if getattr(r, field) is not None]
        return float(np.percentile(vals, 99)) if vals else float("nan")


class Replica:
    def __init__(self, idx: int, scheduler, perf: PerfModel, cfg: SimConfig):
        self.idx = idx
        self.sched = scheduler
        self.perf = perf
        self.cfg = cfg
        self.running: list[Request] = []
        self.new_queue: list[Request] = []
        self.planned: deque[Batch] = deque()
        self.busy = False
        self.reserved_pages = 0
        self.be = BestEffortQueue(cfg.page_size)
        self.last_plan_time = -math.inf
        self.new_since_plan = 0
        self.finished_since_plan = 0

    # ------------------------------------------------------------------ #
    def pages_for(self, req: Request) -> int:
        return max(1, math.ceil(req.total_tokens() / self.cfg.page_size))

    @property
    def free_pages(self) -> int:
        return self.cfg.total_pages - self.reserved_pages

    def should_replan(self, now: float) -> bool:
        return (not self.planned
                or now - self.last_plan_time >= self.cfg.replan_timeout
                or self.new_since_plan > self.cfg.thresh_new
                or self.finished_since_plan > self.cfg.thresh_finished)

    def has_work(self) -> bool:
        return bool(self.new_queue or self.running or len(self.be))


class ClusterSim:
    def __init__(self, schedulers: list, perf: PerfModel,
                 cfg: SimConfig = None, distserve: bool = False):
        self.cfg = cfg or SimConfig()
        self.perf = perf
        self.replicas = [Replica(i, s, perf, self.cfg)
                         for i, s in enumerate(schedulers)]
        self.distserve = distserve
        self.rng = np.random.default_rng(self.cfg.seed)
        self._rr = 0
        self._blocked_migrations: list = []
        self.sched_overheads: list[float] = []
        self.n_preempt = 0
        self.n_be = 0
        self.load_trace: list[tuple[float, int, int]] = []

    # ---------------------------- dispatch ----------------------------- #
    def _dispatch_replica(self, req: Request) -> Replica:
        if self.distserve:
            pool = [r for r in self.replicas if r.sched.role == "prefill"]
            return min(pool, key=lambda r: len(r.new_queue) + len(r.running))
        r = self.replicas[self._rr % len(self.replicas)]
        self._rr += 1
        return r

    # ------------------------------------------------------------------ #
    def run(self, requests: list[Request],
            spec_alpha: Optional[float] = None) -> SimResult:
        t_wall = _time.time()
        cfg = self.cfg
        events: list = []   # (time, seq, kind, payload)
        seq = itertools.count()
        for r in requests:
            heapq.heappush(events, (r.arrival, next(seq), "arrival", r))
        end_time = (max((r.arrival for r in requests), default=0.0)
                    + cfg.drain_time)
        now = 0.0
        last_trace = -1.0

        while events:
            now, _, kind, payload = heapq.heappop(events)
            if now > end_time:
                break
            if kind == "arrival":
                rep = (payload._route_to if hasattr(payload, "_route_to")
                       else self._dispatch_replica(payload))
                if hasattr(payload, "_route_to"):
                    del payload._route_to
                rep.new_queue.append(payload)
                rep.new_since_plan += 1
                if not rep.busy:
                    self._kick(rep, now, events, seq)
            elif kind == "batch_done":
                rep, batch, progress = payload
                touched = self._apply_batch(rep, batch, progress, now)
                rep.busy = False
                if self.distserve and self._blocked_migrations:
                    touched |= self._retry_migrations(now)
                self._kick(rep, now, events, seq)
                for other in touched:
                    if other is not rep:
                        self._kick(other, now, events, seq)
            if now - last_trace >= 1.0:
                n_std = sum(len(r.running) + len(r.new_queue)
                            for r in self.replicas)
                n_be = sum(len(r.be) for r in self.replicas)
                self.load_trace.append((now, n_std, n_be))
                last_trace = now

        return self._collect(requests, t_wall)

    # ------------------------------------------------------------------ #
    def _kick(self, rep: Replica, now: float, events, seq) -> None:
        """Start the replica's next batch, replanning if triggered."""
        if rep.busy:
            return
        if rep.should_replan(now) and rep.has_work():
            self._replan(rep, now, events, seq)
        while rep.planned:
            batch = rep.planned.popleft()
            started = self._start_batch(rep, batch, now, events, seq)
            if started:
                return
        # nothing startable; idle until next event

    def _replan(self, rep: Replica, now: float, events, seq) -> None:
        cfg = self.cfg
        t0 = _time.time()
        mem_free = rep.free_pages + (rep.be.resident_pages()
                                     if cfg.best_effort else 0)
        res: PlanResult = rep.sched.plan(now, rep.running,
                                         list(rep.new_queue), mem_free)
        self.sched_overheads.append(_time.time() - t0)
        for r in res.admitted:
            need = rep.pages_for(r)
            if need > rep.free_pages and cfg.best_effort:
                freed = rep.be.preempt_for_pages(need - rep.free_pages)
                self.n_preempt += 1 if freed else 0
            r.state = RequestState.RUNNING
            r.kv_resident = True
            rep.reserved_pages += need
            rep.running.append(r)
            if r in rep.new_queue:
                rep.new_queue.remove(r)
        single = len(self.replicas) == 1 or self.distserve
        for r in res.declined:
            # single replica: a decline is final only when the SLO is truly
            # slipping away; requests whose prefill deadline is still
            # comfortably ahead (memory frees as running decodes finish)
            # are deferred and retried.  Multi-replica: route immediately
            # (§4.2) — another replica may have capacity NOW.
            ddl = r.prefill_deadlines[0] if r.prefill_deadlines else now
            if single and ddl - now > 2 * cfg.replan_timeout:
                continue                      # stays in new_queue
            if r in rep.new_queue:
                rep.new_queue.remove(r)
            self._handle_declined(rep, r, now, events, seq)
        # deferred stay in new_queue
        rep.planned = deque(res.batches)
        rep.last_plan_time = now
        rep.new_since_plan = len(rep.new_queue)
        rep.finished_since_plan = 0

    def _handle_declined(self, rep: Replica, r: Request, now, events, seq):
        cfg = self.cfg
        multi = len(self.replicas) > 1 and not self.distserve
        if multi and r.routing_hops < cfg.max_route_hops:
            r.routing_hops += 1
            nxt = self.replicas[(rep.idx + 1) % len(self.replicas)]
            r._route_to = nxt
            heapq.heappush(events, (now + cfg.routing_delay, next(seq),
                                    "arrival", r))
        elif cfg.best_effort:
            self.n_be += 1
            rep.be.add(r)
        else:
            # no fallback: serve anyway without guarantees (ablation mode)
            r.state = RequestState.RUNNING
            r.kv_resident = True
            rep.reserved_pages += rep.pages_for(r)
            rep.running.append(r)

    # ------------------------------------------------------------------ #
    def _start_batch(self, rep: Replica, batch: Batch, now: float,
                     events, seq) -> bool:
        cfg = self.cfg
        by_rid = {r.rid: r for r in rep.running}
        progress: list[tuple[Request, StageKind, int, int]] = []
        n_tokens = 0
        for e in batch.entries:
            r = by_rid.get(e.rid)
            if r is None or r.finished:
                continue
            if e.kind == StageKind.PREFILL and r.in_prefill:
                take = min(e.n_tokens, r.remaining_in_stage)
            elif e.kind == StageKind.DECODE and r.in_decode:
                take = e.n_tokens
            else:
                continue
            if take <= 0:
                continue
            emit = take
            if batch.spec_step > 0 and e.kind == StageKind.DECODE:
                # verify of (take-1) drafts: accepted prefix + bonus token
                drafted = take - 1
                accepted = 0
                while accepted < drafted and self.rng.random() < _alpha(rep):
                    accepted += 1
                emit = accepted + 1
            progress.append((r, e.kind, take, emit))
            n_tokens += take
        # surplus budget -> best-effort tier (§4.1)
        be_used = 0
        be_finished: list[Request] = []
        if cfg.best_effort and batch.prefill_budget > 0 and len(rep.be):
            be_free = rep.free_pages - rep.be.resident_pages()
            be_used, be_finished = rep.be.consume_budget(
                batch.prefill_budget, now, max(be_free, 0))
            n_tokens += be_used
        if n_tokens == 0:
            return False
        dur = rep.perf.batch_time(n_tokens, spec_step=batch.spec_step)
        if cfg.exec_noise_sigma > 0:
            dur *= float(self.rng.lognormal(0.0, cfg.exec_noise_sigma))
        rep.busy = True
        heapq.heappush(events, (now + dur, next(seq), "batch_done",
                                (rep, batch, (progress, be_finished))))
        return True

    def _apply_batch(self, rep: Replica, batch: Batch, payload,
                     now: float) -> set:
        progress, be_finished = payload
        touched: set = set()
        for (r, kind, take, emit) in progress:
            if r.finished:
                continue
            was_stage = r.stage_idx
            r.advance(emit, now)
            if r.finished:
                rep.running.remove(r)
                rep.reserved_pages -= rep.pages_for(r)
                r.kv_resident = False
                rep.finished_since_plan += 1
            elif r.stage_idx != was_stage:
                if self.distserve:
                    dst = self._migrate(rep, r, now)
                    if dst is not None:
                        touched.add(dst)
                elif r.in_prefill:
                    # tool loop: a fresh prefill stage appeared mid-request;
                    # its (tight) deadline needs an immediate replan
                    rep.finished_since_plan += self.cfg.thresh_finished + 1
        return touched

    def _migrate(self, rep: Replica, r: Request,
                 now: float) -> Optional[Replica]:
        """DistServe: move request to the pool matching its new stage.
        The destination must have KV pages free (the real system blocks
        the KV transfer otherwise); blocked requests wait on the source,
        retried after every batch completion."""
        want = "prefill" if r.in_prefill else "decode"
        if rep.sched.role == want:
            return None
        pool = [x for x in self.replicas if x.sched.role == want]
        if not pool:
            return None
        need = rep.pages_for(r)
        fits = [x for x in pool if x.free_pages >= need]
        if not fits:
            self._blocked_migrations.append((rep, r))
            return None
        dst = min(fits, key=lambda x: len(x.running))
        rep.running.remove(r)
        rep.reserved_pages -= rep.pages_for(r)
        dst.running.append(r)
        dst.reserved_pages += dst.pages_for(r)
        dst.finished_since_plan += self.cfg.thresh_finished + 1  # force replan
        return dst

    def _retry_migrations(self, now: float) -> set:
        touched = set()
        pending, self._blocked_migrations = self._blocked_migrations, []
        for rep, r in pending:
            if r.finished or r not in rep.running:
                continue
            dst = self._migrate(rep, r, now)
            if dst is not None:
                touched.add(dst)
        return touched

    # ------------------------------------------------------------------ #
    def _collect(self, requests: list[Request], t_wall: float) -> SimResult:
        zl = self.perf.batch_time
        records = []
        n_att = n_fin = 0
        for r in requests:
            att = r.slo_attained(lambda n: zl(n))
            fin = r.finished
            n_att += att
            n_fin += fin
            ttft = (r.stage_complete_times[0] - r.arrival
                    if r.stage_complete_times else None)
            tpots = None
            if len(r.token_times) >= 2:
                span = r.token_times[-1] - r.token_times[0]
                tpots = span / max(len(r.token_times) - 1, 1)
            records.append(RequestRecord(
                r.rid, att, fin, ttft, tpots,
                tier=r.state.value, hops=r.routing_hops))
        return SimResult(
            n_requests=len(requests), n_finished=n_fin, n_attained=n_att,
            n_best_effort=self.n_be, n_preemptions=self.n_preempt,
            records=records, sched_overheads=self.sched_overheads,
            sim_wallclock=_time.time() - t_wall, load_trace=self.load_trace)


def _alpha(rep: Replica) -> float:
    a = getattr(rep.sched.cfg, "spec_alpha", None)
    return a if a is not None else 0.0


# --------------------------- capacity search --------------------------- #
def find_capacity(make_sim, scenario: str, duration: float = 60.0,
                  target: float = 0.9, lo: float = 0.1, hi: float = 16.0,
                  iters: int = 7, seed: int = 0, n_chips: int = 1) -> float:
    """Binary-search the max request rate (per chip) with >= ``target``
    SLO attainment — the paper's serving-capacity metric (§2.1)."""
    from repro_torch.core.workload import generate_workload

    def attain(rate: float) -> float:
        sim = make_sim()
        reqs = generate_workload(scenario, rate * n_chips, duration, seed)
        if not reqs:
            return 1.0
        res = sim.run(reqs)
        return res.attainment

    if attain(hi) >= target:
        return hi
    if attain(lo) < target:
        return 0.0
    for _ in range(iters):
        mid = math.sqrt(lo * hi)
        if attain(mid) >= target:
            lo = mid
        else:
            hi = mid
    return lo
