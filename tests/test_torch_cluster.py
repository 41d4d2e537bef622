"""The port's multi-replica cluster against the JAX package's
(``tests/test_cluster.py``, ``tests/test_kv_spill.py``): both clusters
come from ``make_real_cluster`` over the same bridged weights and run the
same scenario (routing order, hop limit and backup decline; prefix
affinity; the burst with overflow, best-effort and preemption, also
with bf16 KV pools; a drain with migration and spill to the survivor; a
draft-armed run; a placement pass).  Each scenario asserts that every request streams what it streams
on the JAX cluster, that ``ClusterStats.as_dict()`` is equal (but for the
keys in ``TIE_BREAK_KEYS``) and that the shared budget and every replica's
page accounting hold after every step of the port's cluster."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.configs as jcfgs                                   # noqa: E402
import repro.core.perf_model as jperf                           # noqa: E402
import repro.core.request as jreq                               # noqa: E402
import repro.core.router as jrouter                             # noqa: E402
import repro.core.scheduler as jsched                           # noqa: E402
import repro.models as jmodels                                  # noqa: E402
import repro.serving.kvcache as jkv                             # noqa: E402
from repro_torch import bridge, device                          # noqa: E402
from repro_torch.configs import get_reduced                     # noqa: E402
from repro_torch.core import (perf_model, request, router,      # noqa: E402
                              scheduler)
from repro_torch.serving import kvcache                         # noqa: E402
from repro_torch.serving.cluster import ClusterFrontend         # noqa: E402

ARCH = "smollm-135m"
# Keys that move with the reference's decode tie-break (``id()`` of the
# decode jobs, ``core/scheduler.py:304-309``): which of two equally due
# decodes goes first sets token times, and so which requests attain their
# SLO.  They are checked for consistency, not equality.
TIE_BREAK_KEYS = ("attained", "attainment")

_jax_init = jax.jit(jmodels.init_params, static_argnums=(1,))


class Side:
    """One package's cluster entry points and weights."""

    def __init__(self, R, Rq, S, P, cfg, params, draft, **kw):
        self.R, self.Rq, self.S = R, Rq, S
        self.perf = P.cpu_scale_perf_model()
        self.cfg, self.params, self.draft, self.kw = cfg, params, draft, kw

    def cluster(self, n=2, draft=False, **over):
        kw = dict(policy=self.R.RoutingPolicy(max_hops=1), total_pages=32,
                  replica_pages=16, page_size=4, max_slots=8, max_len=64,
                  sched_cfg=self.S.SchedulerConfig(
                      page_size=4, prefill_emits_first_token=True))
        kw.update(over)
        if "policy_kw" in kw:
            kw["policy"] = self.R.RoutingPolicy(**kw.pop("policy_kw"))
        if draft:
            kw["draft"] = self.draft
            kw["sched_cfg"] = self.S.SchedulerConfig(
                page_size=4, prefill_emits_first_token=True, spec_alpha=0.7)
        return self.R.make_real_cluster(n, self.cfg, self.params, self.perf,
                                        **kw, **self.kw)

    def request(self, rid, t, prompt=24, output=8, **kw):
        kw = {"ttft_slowdown": 8.0, "tpot": 0.15, **kw}
        return self.Rq.simple_request(rid, t, prompt=prompt, output=output,
                                      **kw)


@pytest.fixture(scope="module")
def sides():
    jcfg = jcfgs.get_reduced(ARCH)
    jparams = _jax_init(jax.random.PRNGKey(0), jcfg)
    jdcfg = dataclasses.replace(jcfg, name="draft", n_layers=1,
                                block_pattern=("attn",))
    jdparams = _jax_init(jax.random.PRNGKey(7), jdcfg)

    def port(tree):
        return bridge.params_from_numpy(jax.tree.map(np.asarray, tree),
                                        device="cpu")
    cfg = get_reduced(ARCH)
    dcfg = dataclasses.replace(cfg, name="draft", n_layers=1,
                               block_pattern=("attn",))
    return (Side(jrouter, jreq, jsched, jperf, jcfg, jparams,
                 (jdcfg, jdparams)),
            Side(router, request, scheduler, perf_model, cfg, port(jparams),
                 (dcfg, port(jdparams)), device="cpu"))


def invariants(cl):
    """Budget conservation (a draft pool holds its up-front charge) and
    each replica's page accounting."""
    used = 0
    for d in cl.drivers:
        kv = d.engine.kv
        if d.engine.spec is not None:
            used += d.engine.spec.budget_pages
        live = int((kv.refcount > 0).sum())
        assert kv.used_pages == live
        assert len(kv.free) + len(kv.cached) + live == kv.total_pages
        assert not set(kv.prefix_index) & set(kv.host_index)
        assert kv.host_used == len(kv.host_index) <= max(
            kv.host_spill_pages, 0)
        used += kv.used_pages
    assert used == cl.budget.used <= cl.budget.total_pages


def run(cl, max_steps=600, check=False, until=None):
    for _ in range(max_steps):
        if (until is None and cl.idle) or (until is not None and until()):
            break
        cl.step()
        if check:
            invariants(cl)
    return cl.stats


def same_stats(want, got):
    a, b = want.as_dict(), got.as_dict()
    assert set(a) == set(b)
    for k in a:
        if k not in TIE_BREAK_KEYS:
            assert b[k] == a[k], k
    assert 0 <= b["attained"] <= b["served"]
    assert b["attainment"] == pytest.approx(
        b["attained"] / b["served"] if b["served"] else 0.0)


def collect(streams):
    return lambda rid, toks: streams.setdefault(rid, []).extend(toks)


def test_routing_order_hop_limit_and_backup(sides):
    out = []
    for side in sides:
        res = {}
        cl = side.cluster(n=3, policy_kw=dict(max_hops=2))
        probed = []
        for d in cl.drivers:
            d.verdict = (lambda i: lambda now, req, prompt=None:
                         (probed.append(i), False)[1])(d.idx)
        streams = {}
        cl.submit(side.request(1, 0.0, prompt=8, output=4,
                               ttft_slowdown=4.0, tpot=0.1),
                  on_token=collect(streams))
        cl.step()
        res["probed"] = probed
        res["stats"] = run(cl, check=side is sides[1])
        # the first replica declines: one hop to the second, which serves
        cl = side.cluster(n=3, policy_kw=dict(max_hops=2))
        cl.drivers[0].verdict = lambda now, req, prompt=None: False
        req = side.request(7, 0.0, prompt=8, output=4, ttft_slowdown=6.0,
                           tpot=0.1)
        cl.submit(req, on_token=collect(streams))
        res["routed"] = run(cl, check=side is sides[1])
        res["hops"] = req.routing_hops
        res["served_by"] = [d.stats.served for d in cl.drivers]
        # hop limit 1 and a declining backup: dropped after two probes
        cl = side.cluster(n=3, policy_kw=dict(max_hops=1, backup="decline"))
        probed2 = []
        for d in cl.drivers:
            d.verdict = (lambda i: lambda now, req, prompt=None:
                         (probed2.append(i), False)[1])(d.idx)
        cl.submit(side.request(1, 0.0, prompt=8, output=4,
                               ttft_slowdown=4.0, tpot=0.1))
        cl.step()
        res["probed2"], res["declined"], res["idle"] = \
            probed2, cl.stats, cl.idle
        res["streams"] = streams
        out.append(res)
    want, got = out
    assert got["probed"] == want["probed"] == [0, 1, 2]
    assert got["probed2"] == want["probed2"] == [0, 1]
    assert got["hops"] == want["hops"] == 1
    assert got["served_by"] == want["served_by"] == [0, 1, 0]
    assert got["streams"] == want["streams"]
    assert got["stats"].best_effort == 1 and got["routed"].routed == 1
    assert got["declined"].dropped == 1 and got["idle"]
    for key in ("stats", "routed", "declined"):
        same_stats(want[key], got[key])


def test_shared_budget_conservation_across_managers():
    """The same sharing life cycle on two managers under one budget, in
    both packages: equal answers, and ``used`` is the sum of the
    managers' used pages after every operation."""
    def managers(K, cfg, **kw):
        budget = K.SharedPageBudget(24)
        return budget, [K.PagedKVManager(
            cfg, total_pages=16, page_size=4, max_seqs=4, max_len=64,
            budget=budget, share_prefix=True, **kw) for _ in range(2)]
    toks = list(range(500, 516))
    ops = [(0, "admit", 1, 16, toks), (0, "register", 1, toks),
           (0, "admit", 2, 16, toks), (0, "preempt", 1),
           (0, "release", 2), (0, "admit", 3, 16, toks),
           (1, "admit", 4, 80, None), (1, "admit", 4, 64, None),
           (0, "extend", 3, 40), (1, "preempt", 4), (0, "release", 1),
           (0, "release", 3), (1, "release", 4)]
    logs = []
    for K, cfg, kw in ((jkv, jcfgs.get_reduced(ARCH), {}),
                       (kvcache, get_reduced(ARCH), {"device": "cpu"})):
        budget, mgrs = managers(K, cfg, **kw)
        log = []
        for i, op, *args in ops:
            m = mgrs[i]
            if op == "admit":
                log.append(m.admit(*args[:2], tokens=args[2]))
            elif op == "register":
                log.append(m.register_prefix(*args))
            else:
                log.append(getattr(m, op)(*args))
            log.append((budget.used, [x.used_pages for x in mgrs]))
            assert budget.used == sum(x.used_pages for x in mgrs)
        logs.append(log)
        assert budget.used == 0
    assert logs[1] == logs[0]


def test_prefix_affinity_routes_to_warm_replica(sides):
    out = []
    family = np.random.default_rng(9).integers(1, 512, 24).tolist()
    for side in sides:
        cl = side.cluster()
        streams = {}
        for rid in (1, 2):
            cl.submit(side.request(rid, cl.clock), prompt=list(family),
                      on_token=collect(streams))
            run(cl, check=side is sides[1])
        out.append((cl.stats, streams,
                    [d.stats.served for d in cl.drivers],
                    cl.drivers[0].engine.counters["prefix_hit_tokens"]))
    (want, ws, wserved, whit), (got, gs, gserved, ghit) = out
    assert gs == ws
    assert got.affinity_routed == 1 and gserved == wserved == [2, 0]
    assert ghit == whit >= 20
    same_stats(want, got)


def _burst(sides, jax_over=None, port_over=None):
    """The burst scenario on both packages' clusters (``*_over`` go to
    each side's ``cluster``): eight requests at once, then four more once
    best-effort KV is resident.  Returns each side's (stats, streams,
    preempted rids, budget used at the end)."""
    out = []
    for side, over in zip(sides, (jax_over or {}, port_over or {})):
        cl = side.cluster(**over)
        rng = np.random.default_rng(3)
        streams, prompts = {}, {}

        def submit(rid, t):
            prompts[rid] = rng.integers(1, 512, 24).tolist()
            cl.submit(side.request(rid, t), prompt=prompts[rid],
                      on_token=collect(streams))
        for i in range(8):
            submit(i, 0.0)
        check = side is sides[1]
        run(cl, 200, check, until=lambda: any(
            e.req.kv_resident for d in cl.drivers for e in d.be.entries))
        for i in (100, 101, 102, 103):
            submit(i, cl.clock)
        stats = run(cl, check=check)
        preempted = set().union(*(d.preempted_rids for d in cl.drivers))
        out.append((stats, streams, preempted, cl.budget.used))
    return out


def test_burst_overflow_routes_and_preempts(sides):
    (want, ws, wp, _), (got, gs, gp, used) = _burst(sides)
    assert gs == ws
    assert gp == wp and gp
    assert got.served == got.submitted == 12 and got.dropped == 0
    assert got.routed >= 1 and got.best_effort >= 1 and got.preempted >= 1
    assert used == 0
    same_stats(want, got)


def test_bf16_cluster_matches_jax(sides):
    """The burst scenario with every replica's KV pools in bfloat16
    (``build(dtype=...)``) on both packages: equal streams, preemptions and
    ``ClusterStats``, every replica's pool leaves bf16."""
    (want, ws, wp, _), (got, gs, gp, used) = _burst(
        sides, dict(dtype=jax.numpy.bfloat16), dict(dtype=torch.bfloat16))
    assert gs == ws and gp == wp and gp
    assert got.served == got.submitted == 12 and used == 0
    same_stats(want, got)
    cl = sides[1].cluster(dtype=torch.bfloat16)
    assert all(leaf.dtype == torch.bfloat16 for d in cl.drivers
               for pool in d.engine.kv.pools for leaf in pool["self"].values())


def test_drain_migrates_and_spills_to_survivor(sides):
    """Replica 0 serves a prompt family, then takes a best-effort request
    (every verdict declines; the emptier tier takes it); draining replica
    0 migrates that request mid-flight to replica 1, and its retirement
    spills the family's chain into replica 1's host tier, where a re-sent
    prompt is served by prefetch."""
    out = []
    family = np.random.default_rng(17).integers(1, 512, 24).tolist()
    for side in sides:
        cl = side.cluster(total_pages=48, host_spill_pages=16)
        check = side is sides[1]
        streams = {}
        cl.submit(side.request(1, 0.0), prompt=list(family),
                  on_token=collect(streams))
        run(cl, check=check)
        saved = [d.verdict for d in cl.drivers]
        for d in cl.drivers:
            d.verdict = lambda now, req, prompt=None: False
        for rid in (100, 101):           # tiers: replica 1, then 0
            cl.submit(side.request(rid, cl.clock, prompt=12, output=8,
                                   ttft_slowdown=6.0),
                      on_token=collect(streams))
            cl.step()
        for d, v in zip(cl.drivers, saved):
            d.verdict = v
        assert [e.req.rid for e in cl.drivers[0].be.entries] == [101]
        cl.step()
        survivor = cl.drivers[1].engine.kv
        cold = survivor.probe_prefix(list(family))
        cl.drain_replica(0)
        assert not len(cl.drivers[0].be)
        run(cl, check=check, until=lambda: not cl.draining)
        warm = survivor.probe_prefix(list(family))
        cl.submit(side.request(2, cl.clock), prompt=list(family),
                  on_token=collect(streams))
        stats = run(cl, check=check)
        out.append((stats, streams, cold, warm, len(cl.drivers),
                    survivor.prefetched_pages, cl.budget.used))
    want, got = out
    assert got[1:] == want[1:]
    stats, streams, cold, warm, n, prefetched, used = got
    assert len(streams[101]) == len(streams[100]) == 8 and n == 1
    assert cold == 0 and warm >= 20 and prefetched > 0 and used == 0
    assert stats.spilled_hit_tokens > 0
    same_stats(want[0], stats)


def test_draft_armed_cluster_streams_match(sides):
    """Speculation planned by the schedulers (the verify kernel's path on
    the CPU): equal streams and spec counters in both packages, and equal
    to the speculation-off cluster's streams."""
    floor = sides[0].perf.batch_time(1)
    rng = np.random.default_rng(3)
    prompts = {rid: rng.integers(1, 512, 12).tolist() for rid in range(3)}
    out = []
    for side, draft in ((sides[0], True), (sides[1], True),
                        (sides[1], False)):
        cl = side.cluster(total_pages=64, draft=draft)
        streams = {}
        for rid, tpot in ((0, floor * 1.07), (1, floor * 1.07), (2, 0.15)):
            cl.submit(side.request(rid, 0.0, prompt=12, output=8,
                                   ttft_slowdown=6.0, tpot=tpot),
                      prompt=prompts[rid], on_token=collect(streams))
        out.append((run(cl, check=side is sides[1]), streams))
    (want, ws), (got, gs), (_, ar) = out
    assert gs == ws == ar
    assert got.spec_drafted_tokens > 0
    same_stats(want, got)


def test_placement_pass_and_affinity_to_placed_chain(sides):
    out = []
    family = np.random.default_rng(11).integers(1, 512, 24).tolist()
    for side in sides:
        cl = side.cluster(total_pages=64, host_spill_pages=16,
                          policy_kw=dict(max_hops=1, placement_interval=1,
                                         placement_min_hits=1))
        check = side is sides[1]
        streams = {}
        for rid in (1, 2):
            cl.submit(side.request(rid, cl.clock), prompt=list(family),
                      on_token=collect(streams))
            run(cl, check=check)
        kv1 = cl.drivers[1].engine.kv
        placed = (len(kv1.host_index), len(kv1.prefix_index))
        kv0 = cl.drivers[0].engine.kv
        assert kv0.admit(999, 8 * 4)      # replica 0 half loaded
        cl.submit(side.request(3, cl.clock), prompt=list(family),
                  on_token=collect(streams))
        run(cl, check=check)
        kv0.release(999)
        out.append((cl.stats, streams, placed, kv1.prefetched_pages,
                    [d.stats.served for d in cl.drivers]))
    want, got = out
    assert got[1:] == want[1:]
    stats, _, placed, prefetched, served = got
    assert stats.placed_chains >= 1 and placed[0] > 0 and placed[1] == 0
    assert prefetched > 0 and served == [2, 1]
    same_stats(want[0], stats)


def test_build_options_not_ported_raise(sides):
    """float16 replicas build (``tests/test_torch_fp16.py`` serves them)
    and float64 pools raise; the mesh options are ported
    (``tests/test_torch_mesh_serving.py``): a mesh that is not a
    ``ServingMesh`` is refused, and one-device slices of a ``devices``
    list give each replica a one-shard mesh."""
    side = sides[1]
    cl = side.cluster(dtype=torch.float16)
    assert all(d.engine.kv.dtype == torch.float16 for d in cl.drivers)
    with pytest.raises(NotImplementedError):
        side.cluster(dtype=torch.float64)
    with pytest.raises(TypeError):
        side.cluster(mesh=object())
    cl = side.cluster(devices_per_replica=1, devices=["cpu"] * 2)
    assert [d.engine.mesh.devices for d in cl.drivers] == \
        [(torch.device("cpu"),)] * len(cl.drivers)


def test_replicas_share_the_parameter_tensors(sides):
    cl = sides[1].cluster()
    assert all(d.engine.params is sides[1].params for d in cl.drivers)
    assert all(d.engine.device == device.resolve_device("cpu")
               for d in cl.drivers)
    assert isinstance(cl, ClusterFrontend)
