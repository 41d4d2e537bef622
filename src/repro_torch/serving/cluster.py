"""Real multi-replica cluster runtime (paper §4.2, Fig. 7): an SLO-routed
engine pool with page-pressure preemption.

``ClusterFrontend`` owns N REAL replicas — each a ``ServingEngine`` +
``SLOsServeScheduler`` behind a ``ReplicaDriver`` — with per-replica paged
KV pools carved from ONE ``SharedPageBudget``.  It performs dynamic request
routing: on arrival each candidate replica's DP scheduler renders an
SLO-attainability verdict (``ReplicaDriver.verdict``); declines route
sequentially to the next replica up to ``RoutingPolicy.max_hops``, after
which the backup policy fires (best-effort tier or decline).  The policy
type is shared with the simulator (``core/router.RoutingPolicy``) so
``ClusterSim`` and the real cluster are driven by one configuration.

Page-pressure resilience is end-to-end on real engines: when admission or
a decode-step reservation exhausts a replica's pool, the driver preempts
best-effort victims (``PagedKVManager.preempt`` frees their device pages)
and the victims later replay a recompute prefill — the §4.1 mechanics, but
with every token executed by the model.

Replicas advance in virtual lockstep: each ``step`` routes due arrivals,
drives every replica once from the shared clock, and advances the clock by
the longest replica's virtual elapsed time (replicas run concurrently in
wall-time; the §4.2 routing delay is below this step granularity).

This module is ``repro/serving/cluster.py`` with its imports rewritten.
What differs is ``build``: every replica's engine runs on the one
``device`` it is given (on one card all replicas share it, and share the
same parameter tensors), its KV pools in ``dtype`` (float32, bfloat16
or float16).  Mesh-sharded replicas run as in the reference: ``mesh``
puts every replica's engine over one mesh (sharing one cut of the
parameters), ``devices_per_replica=k`` carves the ``devices`` list, the
port's counterpart of ``jax.devices()`` (every visible CUDA device
unless given), into contiguous k-device meshes.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.perf_model import PerfModel
from repro_torch.core.request import Request
from repro_torch.core.router import RoutingPolicy
from repro_torch.core.scheduler import SchedulerConfig, SLOsServeScheduler
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (ServingMesh,
                                              make_serving_mesh,
                                              serving_shard_plan,
                                              shard_params)
from repro_torch.models.config import ModelConfig
from repro_torch.serving.engine import EngineConfig, ServingEngine
from repro_torch.serving.frontend import ReplicaDriver
from repro_torch.serving.kvcache import SharedPageBudget
from repro_torch.telemetry.instruments import ClusterTelemetry


@dataclasses.dataclass
class ClusterStats:
    submitted: int = 0
    served: int = 0          # terminal outcomes (finished + dropped)
    attained: int = 0
    dropped: int = 0
    cancelled: int = 0       # caller-cancelled (disconnect); never served
    routed: int = 0          # requests served away from their first choice
    best_effort: int = 0     # requests demoted to the best-effort tier
    preempted: int = 0       # real PagedKVManager.preempt invocations
    tokens_out: int = 0
    prompt_tokens: int = 0       # prompt tokens submitted (hit-rate denom)
    prefix_hit_tokens: int = 0   # prompt tokens served from shared pages
    partial_hit_tokens: int = 0  # of which: token-level boundary-head hits
    affinity_routed: int = 0     # first probes placed by prefix affinity
    spec_drafted_tokens: int = 0   # draft proposals verified by targets
    spec_accepted_tokens: int = 0  # of which: accepted (EWMA feed)
    prefix_evictions: int = 0    # published pages LRU-evicted (or spilled)
    spilled_pages: int = 0       # of which: retagged into the host tier
    prefetched_pages: int = 0    # host entries moved back to device pages
    host_evictions: int = 0      # host-tier LRU drops (eviction is final)
    spilled_hit_tokens: int = 0  # prompt tokens served via the host tier
    placed_chains: int = 0       # proactive placement installs (cluster)

    # Derived ratios, all guarded against zero-denominator runs (a trace
    # with no terminal requests, no speculation, or no prompts must read
    # as 0.0, not raise).
    @property
    def attainment(self) -> float:
        return self.attained / self.served if self.served else 0.0

    @property
    def spec_acceptance_rate(self) -> float:
        return (self.spec_accepted_tokens / self.spec_drafted_tokens
                if self.spec_drafted_tokens else 0.0)

    @property
    def prefix_hit_rate(self) -> float:
        return (self.prefix_hit_tokens / self.prompt_tokens
                if self.prompt_tokens else 0.0)

    def as_dict(self) -> dict:
        """Counters + derived ratios, for exporters / JSON reports."""
        d = dataclasses.asdict(self)
        d["attainment"] = self.attainment
        d["spec_acceptance_rate"] = self.spec_acceptance_rate
        d["prefix_hit_rate"] = self.prefix_hit_rate
        return d


@dataclasses.dataclass
class _Payload:
    req: Request
    prompt: Optional[list]
    on_token: Optional[Callable]
    enc_states: object
    start: int = 0           # round-robin first-choice replica


class ClusterFrontend:
    def __init__(self, drivers: list[ReplicaDriver],
                 policy: RoutingPolicy = None, seed: int = 0,
                 telemetry: Optional[ClusterTelemetry] = None):
        self.drivers = drivers
        self.policy = policy or RoutingPolicy()
        self.rng = np.random.default_rng(seed)
        self.budget: Optional[SharedPageBudget] = None
        self.telemetry = telemetry
        self.autoscaler = None           # optional; stepped after sampling
        self.clock = 0.0
        self.pending: list[_Payload] = []
        self.payloads: dict[int, _Payload] = {}
        # replica pool elasticity (autoscaler): draining replicas receive
        # no routed work and retire once idle; retired replicas' terminal
        # stats accumulate in _retired so cluster totals never regress
        self.draining: set[int] = set()
        self._retired = ClusterStats()
        self._spawn = None               # set by build(): idx -> driver
        self._next_idx = len(drivers)
        self._rr = 0
        self._routed: set[int] = set()
        self._submitted = 0
        self._dropped = 0
        self._cancelled = 0
        self._prompt_tokens = 0
        self._affinity_routed = 0
        self._placed_chains = 0
        self._steps = 0

    # ------------------------------------------------------------------ #
    @classmethod
    def build(cls, model_cfg: ModelConfig, params, n_replicas: int,
              perf: PerfModel, *, sched_cfg: SchedulerConfig = None,
              policy: RoutingPolicy = None, total_pages: int = 256,
              replica_pages: int = None, page_size: int = 16,
              max_slots: int = 8, max_len: int = 256, dtype=torch.float32,
              seed: int = 0, draft: Optional[tuple] = None,
              spec_alpha: Optional[float] = None,
              share_prefix: bool = True,
              token_level_prefix: bool = True,
              host_spill_pages: int = None, h2d_gbps: float = None,
              telemetry=None, mesh=None,
              devices_per_replica: int = None,
              shard_axes: str = "model", devices=None,
              device=None) -> "ClusterFrontend":
        """Carve ``total_pages`` (one shared budget) into per-replica paged
        KV pools and stand up N real engines over shared ``params``.
        ``replica_pages`` defaults to an even split; setting it higher lets
        an idle-neighbor replica borrow budget (its physical pool exceeds
        its fair share, the SharedPageBudget caps the aggregate).

        ``draft=(draft_cfg, draft_params)`` arms each replica's
        SpecDecoder; ``spec_alpha`` (defaulting to 0.7 when a draft is
        supplied) seeds the per-replica schedulers' acceptance prior so
        their plans actually carry speculative draft lengths — each
        ReplicaDriver then attaches a per-SLO-class EWMA that adapts the
        plan to observed acceptance.

        ``telemetry`` is a ``ClusterTelemetry``, a bool forcing metrics
        on/off regardless of ``REPRO_METRICS``, or None (env default).

        ``device`` (``resolve_device``: CUDA unless named) carries every
        replica's engine, the autoscaler's too; ``params`` must live on
        it and are shared, not copied.  ``token_level_prefix`` goes to
        every replica's ``EngineConfig``, and so does ``dtype``, the KV
        pools' dtype (float32, bfloat16 or float16; ``ServingEngine``
        refuses any other, and a 16-bit one for an SSM model).

        Mesh-sharded replicas: ``mesh`` (a ``ServingMesh``) runs EVERY
        replica's engine over that one mesh, on one cut of ``params``;
        ``devices_per_replica=k`` instead carves ``devices`` (default:
        every visible CUDA device; ``["cpu"] * 4`` on the CPU) into
        contiguous k-device slices and gives replica i slice ``i % n``,
        its own mesh over ``shard_axes``, the params cut once per slice.
        Autoscaler-grown replicas reuse the slices round-robin.  Either
        way ``device`` is unused, and ``params`` may live anywhere."""
        meshes = None
        if devices_per_replica is not None:
            if devices is None:
                devices = make_serving_mesh().devices
            devs = list(devices)
            n_slices = max(1, len(devs) // devices_per_replica)
            meshes = [make_serving_mesh(
                devs[j * devices_per_replica:(j + 1) * devices_per_replica],
                axis=shard_axes) for j in range(n_slices)]
        elif mesh is not None:
            if not isinstance(mesh, ServingMesh):
                raise TypeError("build: mesh must be a ServingMesh "
                                "(distributed.sharding.make_serving_mesh)")
            meshes = [mesh]
        cuts = {}

        def replica_params(rep_mesh):
            """The params cut once per mesh, shared by its replicas."""
            if rep_mesh is None:
                return params
            if id(rep_mesh) not in cuts:
                plan = serving_shard_plan(model_cfg, rep_mesh, shard_axes,
                                          max_seqs=max_slots)
                cuts[id(rep_mesh)] = shard_params(params, model_cfg,
                                                  rep_mesh, plan)
            return cuts[id(rep_mesh)]
        if meshes is None:
            device = resolve_device(device)
        budget = SharedPageBudget(total_pages)
        if replica_pages is None:
            replica_pages = max(1, total_pages // n_replicas)
        if spec_alpha is None and draft is not None:
            spec_alpha = 0.7
        if not isinstance(telemetry, ClusterTelemetry):
            telemetry = ClusterTelemetry(enabled=telemetry)

        def make_driver(i: int) -> ReplicaDriver:
            """Spawn replica ``i`` — also the autoscaler's grow path, so
            added replicas are configured exactly like the initial pool
            (same shared budget, params, and scheduler config)."""
            rep_mesh = None if meshes is None else meshes[i % len(meshes)]
            # host-spill knobs default to the EngineConfig env-driven
            # defaults (REPRO_HOST_SPILL / REPRO_HOST_SPILL_PAGES) unless
            # set explicitly here
            spill_kw = {}
            if host_spill_pages is not None:
                spill_kw["host_spill_pages"] = host_spill_pages
            if h2d_gbps is not None:
                spill_kw["h2d_gbps"] = h2d_gbps
            eng = ServingEngine(
                model_cfg, replica_params(rep_mesh),
                EngineConfig(max_slots=max_slots, max_len=max_len,
                             page_size=page_size, total_pages=replica_pages,
                             dtype=dtype, seed=seed + i,
                             share_prefix=share_prefix,
                             token_level_prefix=token_level_prefix,
                             mesh=rep_mesh, shard_axes=shard_axes,
                             **spill_kw),
                draft=draft, kv_budget=budget,
                device=device if rep_mesh is None else None)
            kw = dict(page_size=page_size, prefill_emits_first_token=True)
            if spec_alpha is not None:
                # only override when armed: passing None would defeat the
                # REPRO_SPEC_DECODE env default (dataclass default_factory)
                kw["spec_alpha"] = spec_alpha
            cfg = sched_cfg or SchedulerConfig(**kw)
            tel = telemetry.replica(i) if telemetry.enabled else None
            return ReplicaDriver(eng, SLOsServeScheduler(perf, cfg),
                                 idx=i, seed=seed + i, telemetry=tel)

        drivers = [make_driver(i) for i in range(n_replicas)]
        cluster = cls(drivers, policy=policy, seed=seed,
                      telemetry=telemetry)
        cluster.budget = budget
        cluster._spawn = make_driver
        cluster._next_idx = n_replicas
        return cluster

    # ------------------------------------------------------------------ #
    def submit(self, req: Request, prompt: Optional[list] = None,
               on_token: Optional[Callable] = None, enc_states=None) -> None:
        """Queue a request for routing at its arrival time."""
        p = _Payload(req, prompt, on_token, enc_states)
        self.payloads[req.rid] = p
        self.pending.append(p)
        self._submitted += 1
        self._prompt_tokens += (len(prompt) if prompt is not None
                                else req.stages[0].length)

    def cancel(self, rid: int) -> bool:
        """Cancel a request cluster-wide (client disconnect): a pending
        arrival is simply unqueued; a routed request is cancelled on its
        replica via ``ReplicaDriver.cancel`` (engine drop — pages and
        sequence slot released, shared budget credited).  Returns whether
        the request was found anywhere."""
        for p in list(self.pending):
            if p.req.rid == rid:
                self.pending.remove(p)
                self.payloads.pop(rid, None)
                self._cancelled += 1
                return True
        self.payloads.pop(rid, None)
        for d in self.drivers:
            if d.cancel(rid):
                return True
        return False

    @property
    def idle(self) -> bool:
        return not self.pending and all(d.idle for d in self.drivers)

    @property
    def stats(self) -> ClusterStats:
        base = self._retired
        s = dataclasses.replace(
            base, submitted=self._submitted,
            dropped=base.dropped + self._dropped,
            served=base.served + self._dropped,
            cancelled=base.cancelled + self._cancelled,
            routed=len(self._routed),
            affinity_routed=self._affinity_routed,
            placed_chains=base.placed_chains + self._placed_chains,
            prompt_tokens=self._prompt_tokens)
        for d in self.drivers:
            s.served += d.stats.served
            s.attained += d.stats.attained
            s.dropped += d.stats.dropped
            s.cancelled += d.stats.cancelled
            s.best_effort += d.stats.best_effort
            s.tokens_out += d.stats.tokens_out
            s.preempted += d.engine.counters["preemptions"]
            s.prefix_hit_tokens += d.engine.counters["prefix_hit_tokens"]
            s.partial_hit_tokens += d.engine.kv.partial_hit_tokens
            s.spec_drafted_tokens += d.engine.counters["spec_drafted_tokens"]
            s.spec_accepted_tokens += (
                d.engine.counters["spec_accepted_tokens"])
            kv = d.engine.kv
            s.prefix_evictions += kv.prefix_evictions
            s.spilled_pages += kv.spilled_pages
            s.prefetched_pages += kv.prefetched_pages
            s.host_evictions += kv.host_evictions
            s.spilled_hit_tokens += kv.spilled_hit_tokens
        return s

    # ----------------------------- routing ----------------------------- #
    def _first_choice(self, p: _Payload) -> int:
        """Pick the request's first-choice replica: the replica with the
        best cached-prefix match for its prompt (prefix-affinity hint —
        shared pages there make its DP verdict cheaper to satisfy and the
        prefill shorter), falling back to round-robin when no replica
        holds any of the prefix (or the prompt is not known yet)."""
        n = len(self.drivers)
        rr = self._rr % n
        self._rr += 1
        if self.draining:                # never first-pick a draining replica
            for k in range(n):
                if self.drivers[(rr + k) % n].idx not in self.draining:
                    rr = (rr + k) % n
                    break
        if not self.policy.prefix_affinity or p.prompt is None \
                or p.enc_states is not None:
            return rr
        hits = [-1 if d.idx in self.draining
                else d.engine.kv.probe_prefix(p.prompt)
                for d in self.drivers]
        # equal hits break toward the emptier replica (then lowest index,
        # for determinism): proactive placement put the hot chain on an
        # under-loaded peer precisely so affinity would move load there
        best = max(range(n),
                   key=lambda i: (hits[i],
                                  self.drivers[i].engine.kv.free_pages, -i))
        if hits[best] <= 0:
            return rr
        self._affinity_routed += 1
        return best

    def _route(self, p: _Payload, now: float) -> None:
        """§4.2 sequential routing: try replicas in round-robin order from
        the request's first choice (prefix affinity may pin that choice);
        every decline consumes one hop, and the backup policy fires once
        the hop limit is exhausted."""
        req = p.req
        n = len(self.drivers)
        # rotation from the first choice, draining replicas filtered out
        # (they take no new work); with nothing live the full rotation is
        # the fallback so the request still terminates via backup policy
        order = [self.drivers[(p.start + k) % n] for k in range(n)]
        cands = [d for d in order if d.idx not in self.draining] or order
        probe = p.prompt if p.enc_states is None else None
        while req.routing_hops <= self.policy.max_hops:
            d = cands[req.routing_hops % len(cands)]
            if d.verdict(now, req, probe):
                if req.routing_hops > 0:
                    self._routed.add(req.rid)
                d.enqueue(req, p.prompt, p.on_token, p.enc_states)
                p.prompt = d.prompts[req.rid]   # pin the generated prompt
                return
            req.routing_hops += 1
        if self.policy.backup == "best_effort":
            d = min(cands, key=lambda x: len(x.be))
            d.enqueue(req, p.prompt, p.on_token, p.enc_states,
                      best_effort=True)
            p.prompt = d.prompts[req.rid]
        else:
            self._dropped += 1
            self.payloads.pop(req.rid, None)

    # --------------------- replica pool elasticity ---------------------- #
    def add_replica(self) -> ReplicaDriver:
        """Grow the pool by one replica (autoscaler scale-up).  The new
        engine draws on the SAME SharedPageBudget, so aggregate KV memory
        stays bounded regardless of pool size."""
        if self._spawn is None:
            raise RuntimeError(
                "add_replica requires a cluster built via "
                "ClusterFrontend.build (no spawn recipe available)")
        d = self._spawn(self._next_idx)
        self._next_idx += 1
        self.drivers.append(d)
        return d

    def drain_replica(self, i: int) -> ReplicaDriver:
        """Begin graceful removal of ``drivers[i]``: it stops receiving
        routed work, queued (not yet admitted) arrivals bounce back
        through routing, and its best-effort tier migrates to live peers
        via the preempt + drop/restore recompute-replay machinery — each
        migrated request resumes on the target with a bit-identical token
        stream.  In-flight SLO-guaranteed requests finish in place; the
        replica retires (leaves the pool) once idle, inside ``step``."""
        d = self.drivers[i]
        if d.idx in self.draining:
            return d
        if len(self.drivers) - len(self.draining) <= 1:
            raise RuntimeError("cannot drain the last live replica")
        self.draining.add(d.idx)
        now = self.clock
        for r in list(d.new_q):          # not yet admitted: just re-route
            d.new_q.remove(r)
            p = self.payloads.get(r.rid)
            d.forget(r.rid)
            if p is not None:
                self._route(p, now)
            else:
                self._dropped += 1
        targets = [x for x in self.drivers if x.idx not in self.draining]
        for e in list(d.be.entries):
            dst = min(targets, key=lambda x: len(x.be))
            self._migrate(d, dst, e)
        return d

    def _migrate(self, src: ReplicaDriver, dst: ReplicaDriver, e) -> None:
        """Move one best-effort entry from ``src`` to ``dst``: preempt
        (free src device pages), drop the full context, and stash it as
        ``dst.saved_ctx`` — dst's best-effort loop later restores it and
        replays the recompute prefill for an identical continuation."""
        r = e.req
        rid = r.rid
        src.be.entries.remove(e)
        if rid in src.engine.reqs:
            if r.kv_resident:
                src.engine.preempt(rid)
                r.kv_resident = False
                src.stats.preempted += 1
                if src.tel is not None:
                    src.tel.preemptions.inc()
            ctx = src.engine.drop(rid)
        else:
            ctx = src.saved_ctx.pop(rid, None)
        if rid in src.prompts:
            dst.prompts[rid] = src.prompts.pop(rid)
        if rid in src.streams:
            dst.streams[rid] = src.streams.pop(rid)
        if rid in src.encs:
            dst.encs[rid] = src.encs.pop(rid)
        src.saved_ctx.pop(rid, None)
        if ctx is not None:
            dst.saved_ctx[rid] = ctx
        dst.be.add(r)
        moved = dst.be.entries[-1]
        moved.generated = e.generated
        if ctx is not None:
            moved.recompute_remaining = len(ctx.pending)
            moved.prefilled = False

    def _retire(self, d: ReplicaDriver) -> None:
        """Remove an idle draining replica, folding its terminal stats
        into the retained base so cluster totals never move backwards.
        An idle replica holds no live pages, and its cached (zero-ref)
        prefix pages already credited the shared budget at unref, so
        removal cannot leak budget.  The victim's published chains spill
        to a surviving replica's host tier first — a drain removes
        capacity, it must not also erase the prefix working set."""
        self._spill_chains_to_survivors(d)
        s = self._retired
        s.served += d.stats.served
        s.attained += d.stats.attained
        s.dropped += d.stats.dropped
        s.cancelled += d.stats.cancelled
        s.best_effort += d.stats.best_effort
        s.tokens_out += d.stats.tokens_out
        s.preempted += d.engine.counters["preemptions"]
        s.prefix_hit_tokens += d.engine.counters["prefix_hit_tokens"]
        s.partial_hit_tokens += d.engine.kv.partial_hit_tokens
        s.spec_drafted_tokens += d.engine.counters["spec_drafted_tokens"]
        s.spec_accepted_tokens += d.engine.counters["spec_accepted_tokens"]
        kv = d.engine.kv
        s.prefix_evictions += kv.prefix_evictions
        s.spilled_pages += kv.spilled_pages
        s.prefetched_pages += kv.prefetched_pages
        s.host_evictions += kv.host_evictions
        s.spilled_hit_tokens += kv.spilled_hit_tokens
        self.drivers.remove(d)
        self.draining.discard(d.idx)
        if self.telemetry is not None:
            self.telemetry.tracer.emit(
                {"kind": "retire", "t": round(self.clock, 6),
                 "replica": d.idx})

    def _spill_chains_to_survivors(self, d: ReplicaDriver) -> None:
        """Export every chain resident on ``d`` (device or host tier) into
        the emptiest live peer's host tier.  Installs are idempotent and
        capped by the target's own host budget (its LRU decides what
        survives); targets with the spill tier off simply decline."""
        targets = [x for x in self.drivers
                   if x is not d and x.idx not in self.draining]
        if not targets:
            return
        kv = d.engine.kv
        for h in kv.root_chains():
            dst = max(targets, key=lambda x: x.engine.kv.free_pages)
            dst.engine.kv.install_host_chain(kv.export_chain(h))

    # ----------------------- proactive placement ----------------------- #
    def _placement_pass(self, now: float) -> None:
        """Periodic proactive prefix placement (the planned-affinity
        upgrade of ``RoutingPolicy.prefix_affinity``): aggregate per-chain
        probe/hit popularity across replicas, take the top-K hot chains,
        and install each onto under-loaded live replicas that do not hold
        it — via the host tier, so placement costs no device pages until
        a request actually hits the chain there.  Popularity decays by
        half each pass, keeping the ranking recent."""
        pol = self.policy
        counts: dict[int, int] = {}
        live = [d for d in self.drivers if d.idx not in self.draining]
        for d in live:
            for h, c in d.engine.kv.chain_hits.items():
                counts[h] = counts.get(h, 0) + c
        hot = sorted((h for h, c in counts.items()
                      if c >= pol.placement_min_hits),
                     key=lambda h: (-counts[h], h))[:pol.placement_top_k]
        for h in hot:
            holder = next(
                (d for d in live
                 if h in d.engine.kv.prefix_index
                 or h in d.engine.kv.host_index), None)
            if holder is None:
                continue
            chain = None            # export lazily, once per hot chain
            for d in live:
                kv = d.engine.kv
                if d is holder or kv.host_spill_pages <= 0 \
                        or h in kv.prefix_index or h in kv.host_index:
                    continue
                if kv.free_pages * 2 < kv.total_pages:
                    continue        # loaded replica: placement would thrash
                if chain is None:
                    chain = holder.engine.kv.export_chain(h)
                placed = kv.install_host_chain(chain)
                if placed and self.telemetry is not None:
                    self.telemetry.tracer.emit(
                        {"kind": "place", "t": round(now, 6),
                         "replica": d.idx, "pages": placed})
                self._placed_chains += 1 if placed else 0
        for d in live:
            d.engine.kv.chain_hits = {
                h: c // 2 for h, c in d.engine.kv.chain_hits.items()
                if c // 2 > 0}

    # ------------------------------------------------------------------ #
    def step(self, max_batches: int = 8) -> int:
        """Route due arrivals, drive every replica once, advance the
        shared clock.  Returns total engine batches executed."""
        now = self.clock
        arrivals = [p for p in self.pending if p.req.arrival <= now]
        self.pending = [p for p in self.pending if p.req.arrival > now]
        for p in arrivals:
            p.start = self._first_choice(p)
            self._route(p, now)
        n_exec = 0
        elapsed = 0.0
        declined: list[tuple[ReplicaDriver, Request]] = []
        for d in self.drivers:
            r = d.drive(now, max_batches)
            n_exec += r.n_exec
            elapsed = max(elapsed, r.elapsed)
            declined.extend((d, q) for q in r.declined)
        for d, q in declined:
            d.forget(q.rid)
            q.routing_hops += 1
            p = self.payloads.get(q.rid)
            if p is not None:
                self._route(p, now)
        # prune payloads of requests that reached a terminal state (their
        # driver forgot them) so long-running clusters don't accumulate
        # prompt lists and stream closures without bound
        live = {p.req.rid for p in self.pending}
        for d in self.drivers:
            live.update(d.prompts.keys())
        self.payloads = {rid: p for rid, p in self.payloads.items()
                         if rid in live}
        if n_exec:
            self.clock = now + elapsed
        else:
            nxt = min((p.req.arrival for p in self.pending),
                      default=now + 0.1)
            for d in self.drivers:
                a = d.next_arrival()
                if a is not None:
                    nxt = min(nxt, a)
            self.clock = max(now + 0.05, nxt)
        if self.draining:                # retire drained-empty replicas
            for d in list(self.drivers):
                if d.idx in self.draining and d.idle:
                    self._retire(d)
        self._steps += 1
        if self.policy.prefix_affinity and self.policy.placement_interval \
                and self._steps % self.policy.placement_interval == 0 \
                and len(self.drivers) > 1:
            self._placement_pass(self.clock)
        if self.telemetry is not None:
            self.telemetry.on_step(self, self.clock, n_exec)
            if self.autoscaler is not None:
                self.autoscaler.step(self, self.clock)
        return n_exec

    # ------------------------------------------------------------------ #
    def run_until_idle(self, max_steps: int = 10_000) -> ClusterStats:
        for _ in range(max_steps):
            if self.idle:
                break
            self.step()
        return self.stats
