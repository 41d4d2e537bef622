"""Mesh-sharded serving of the port (``repro_torch.distributed.sharding``,
``EngineConfig.mesh``, ``PagedKVManager.place``, the cluster's ``mesh`` /
``devices_per_replica``) on CPU meshes of ``["cpu"] * n``, mirroring the
reference's ``tests/test_mesh_serving.py``: an engine over a mesh serves
the greedy streams of the engine on one device, with the same
``prefill_calls`` and ``decode_calls``, for head-sharded GQA,
expert-parallel MoE (top-2 and top-3), lane-sharded SSM rows and
head-sharded MLA; an indivisible mesh shards nothing; spec decoding, bf16
and float16 pools and a 2 x 2 cluster carve with the host tier on serve as
without a mesh.

Shards combine by concatenation and by sums of one contributor, and each
paged wrapper is told the unsharded head count for its key splits, so the
plain versions' logits are bit-equal sharded and unsharded: every case
asserts ``torch.equal`` on every logit row of every shard.  The unsharded
port engine is held to the JAX engine on bridged weights (one JAX engine
per model, module-scoped) with the repo's tie rule: a differing step is a
tie when the reference's top-2 margin there is below 1e-4.  The plan and
spec functions are held to the reference's on abstract JAX meshes, which
need no devices."""
import dataclasses
import threading
import time
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

import repro.configs as jcfgs                                   # noqa: E402
import repro.core.batch as jbatch                               # noqa: E402
import repro.core.slo as jslo                                   # noqa: E402
import repro.distributed.sharding as jshd                       # noqa: E402
import repro.models as jmodels                                  # noqa: E402
import repro.models.transformer as jtransformer                 # noqa: E402
import repro.serving.engine as jengine                          # noqa: E402
from repro_torch import bridge                                  # noqa: E402
from repro_torch.configs import (_MODULES, get_config,         # noqa: E402
                                 get_reduced)
from repro_torch.core.batch import Batch                        # noqa: E402
from repro_torch.core.perf_model import cpu_scale_perf_model    # noqa: E402
from repro_torch.core.request import simple_request             # noqa: E402
from repro_torch.core.router import (RoutingPolicy,             # noqa: E402
                                     make_real_cluster)
from repro_torch.core.scheduler import SchedulerConfig          # noqa: E402
from repro_torch.core.slo import StageKind                      # noqa: E402
from repro_torch.distributed import sharding as shd             # noqa: E402
from repro_torch.kernels import build                           # noqa: E402
from repro_torch.kernels import mla_paged_prefill as mk         # noqa: E402
from repro_torch.kernels import paged_attention as pa           # noqa: E402
from repro_torch.kernels import paged_prefill as pp             # noqa: E402
from repro_torch.kernels import paged_verify as pv              # noqa: E402
from repro_torch.models import attention                        # noqa: E402
from repro_torch.models.transformer import init_paged_cache     # noqa: E402
from repro_torch.serving import engine as tengine               # noqa: E402
from repro_torch.serving.engine import (EngineConfig,           # noqa: E402
                                        ServingEngine)

TIE_MARGIN = 1e-4
ECFG = dict(max_slots=4, max_len=128, total_pages=64)
CHUNKS, N_DECODE = (11, 9), 6          # the second chunk starts mid-page
QWEN, MOE, SSM, MLA = ("qwen3-1.7b", "phi3.5-moe-42b-a6.6b", "mamba2-2.7b",
                       "deepseek-v2-236b")
WIDE = dict(n_heads=8, n_kv_heads=4)   # 4-way heads need KVH % 4 == 0

_jax_init = jax.jit(jmodels.init_params, static_argnums=(1,))


def _cfgs(arch, **over):
    """(JAX config, port config) of ``arch``'s reduced variant."""
    jc, tc = jcfgs.get_reduced(arch), get_reduced(arch)
    if over:
        jc, tc = (dataclasses.replace(jc, **over),
                  dataclasses.replace(tc, **over))
    return jc, tc


def _prompts(vocab, n=2, length=20, seed=3):
    rng = np.random.default_rng(seed)
    return [(rid, rng.integers(1, vocab, length).tolist())
            for rid in range(1, n + 1)]


def _script(eng, batch_cls, kinds, prompts):
    """Per request: chunked prefill, then one decode burst; the streams."""
    streams = {}
    for rid, prompt in prompts:
        assert eng.add_request(rid, prompt, expected_total=48)
        got = []
        for n in CHUNKS:
            b = batch_cls()
            b.add(rid, kinds.PREFILL, n)
            got += eng.execute(b).get(rid, [])
        b = batch_cls()
        b.add(rid, kinds.DECODE, N_DECODE)
        got += eng.execute(b).get(rid, [])
        streams[rid] = got
    return streams


class _Logits:
    """Records every ``logits_fn`` output of the port engine, per thread:
    the unsharded engine's on the caller's, each shard's on its own."""

    def __init__(self, monkeypatch):
        self.rows: dict[str, list] = {}
        self._lock = threading.Lock()
        inner = tengine.logits_fn

        def rec(params, cfg, hidden):
            out = inner(params, cfg, hidden)
            with self._lock:
                self.rows.setdefault(threading.current_thread().name,
                                     []).append(out.detach().clone())
            return out
        monkeypatch.setattr(tengine, "logits_fn", rec)

    def take(self):
        rows, self.rows = self.rows, {}
        return rows


def _port_run(cfg, params, prompts, mesh=None, **kw):
    eng = ServingEngine(cfg, params, EngineConfig(mesh=mesh, **ECFG, **kw),
                        device=None if mesh is not None else "cpu")
    return _script(eng, Batch, StageKind, prompts), dict(eng.counters), eng


def _jax_streams(jcfg, jparams, prompts):
    eng = jengine.ServingEngine(jcfg, jparams, jengine.EngineConfig(**ECFG))
    return _script(eng, jbatch.Batch, jslo.StageKind, prompts)


def _tie_or_equal(got, want, jcfg, jparams, prompts):
    """Streams equal, or their first difference a tie of the reference's
    logits (top-2 margin below TIE_MARGIN)."""
    for rid, prompt in prompts:
        a, b = got[rid], want[rid]
        if a == b:
            continue
        i = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        h, _, _ = jmodels.model_forward(
            jparams, jcfg, jnp.asarray([prompt + b[:i]], jnp.int32))
        top = np.sort(np.asarray(jmodels.logits_fn(jparams, jcfg,
                                                   h[:, -1]))[0])[-2:]
        assert top[1] - top[0] < TIE_MARGIN, (rid, i, a, b)
        warnings.warn(f"rid {rid}: tie at step {i} (margin "
                      f"{top[1] - top[0]:.2e})")


def _family(arch, **over):
    jc, tc = _cfgs(arch, **over)
    jparams = _jax_init(jax.random.PRNGKey(0), jc)
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      device="cpu")
    prompts = _prompts(tc.vocab)
    return dict(jcfg=jc, cfg=tc, jparams=jparams, params=params,
                prompts=prompts, jax=_jax_streams(jc, jparams, prompts))


@pytest.fixture(scope="module")
def families():
    """One bridged weight set and one JAX engine run per model, built on
    first use."""
    cache = {}

    def get(arch, **over):
        key = (arch, tuple(sorted(over.items())))
        if key not in cache:
            cache[key] = _family(arch, **over)
        return cache[key]
    return get


def _assert_mesh_parity(fam, sizes, flags, monkeypatch, **over_cfg):
    cfg = dataclasses.replace(fam["cfg"], **over_cfg) if over_cfg \
        else fam["cfg"]
    log = _Logits(monkeypatch)
    base, base_c, _ = _port_run(cfg, fam["params"], fam["prompts"])
    base_rows = log.take()
    assert all(len(s) == 7 for s in base.values())
    if not over_cfg:
        _tie_or_equal(base, fam["jax"], fam["jcfg"], fam["jparams"],
                      fam["prompts"])
    (want,) = base_rows.values()
    for n in sizes:
        mesh = shd.make_serving_mesh(["cpu"] * n)
        plan = shd.serving_shard_plan(cfg, mesh, max_seqs=ECFG["max_slots"])
        for flag in flags:
            assert getattr(plan, flag), (n, plan)
        got, got_c, eng = _port_run(cfg, fam["params"], fam["prompts"], mesh)
        rows = log.take()
        assert got == base, (n, plan)
        for k in ("decode_calls", "prefill_calls", "decode_steps"):
            assert got_c[k] == base_c[k], (n, k)
        # every shard's logits, call for call, bit-equal to the unsharded
        assert sorted(rows) == [f"mesh-shard-{i}" for i in range(n)]
        for name, seq in rows.items():
            assert len(seq) == len(want)
            assert all(torch.equal(a, b) for a, b in zip(seq, want)), name
        assert len(eng.kv.shard_pools) == n
    return base_c


# ------------------------- plans and specs ------------------------------- #
def _jax_axis(spec):
    return next((i for i, a in enumerate(spec) if a is not None), None)


def _flat(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}/{k}" if path else str(k)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{path}/{i}" if path else str(i)))
        return out
    return {path: tree}


def _jax_flat(tree):
    return {jshd._path_str(kp): _jax_axis(sp) for kp, sp in
            jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, jshd.P))[0]}


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_plan_flags_match_reference(n):
    mesh = shd.make_serving_mesh(["cpu"] * n)
    amesh = jax.sharding.AbstractMesh((n,), ("model",))
    for arch in _MODULES:
        for max_seqs in (0, 4, 6):
            want = jshd.serving_shard_plan(jcfgs.get_config(arch), amesh,
                                           max_seqs=max_seqs)
            got = shd.serving_shard_plan(get_config(arch), mesh,
                                         max_seqs=max_seqs)
            assert dataclasses.asdict(got) == dataclasses.asdict(want), \
                (arch, n, max_seqs)


@pytest.mark.parametrize("n", [2, 4])
def test_param_and_cache_specs_match_reference(n):
    """``serving_param_specs`` and ``serving_cache_specs`` (both lane
    views) against the reference's, leaf by leaf, on the port's own
    trees of every reduced config."""
    mesh = shd.make_serving_mesh(["cpu"] * n)
    amesh = jax.sharding.AbstractMesh((n,), ("model",))
    from repro_torch.models.transformer import init_params
    for arch in sorted(_MODULES):
        jc, tc = _cfgs(arch)
        jplan = jshd.serving_shard_plan(jc, amesh, max_seqs=4)
        plan = shd.serving_shard_plan(tc, mesh, max_seqs=4)
        jparams = jax.eval_shape(lambda: jmodels.init_params(
            jax.random.PRNGKey(0), jc))
        params = init_params(tc, torch.Generator().manual_seed(0),
                             device="cpu")
        want = _jax_flat(jshd.serving_param_specs(jparams, jc, jplan))
        got = _flat(shd.serving_param_specs(params, tc, plan))
        assert got == want, arch
        jpools = jax.eval_shape(
            lambda: jtransformer.init_paged_cache(jc, 8, 4, 4))
        pools = init_paged_cache(tc, 8, 4, 4, device="cpu")
        for lane_view in (False, True):
            want = _jax_flat(jshd.serving_cache_specs(jpools, jc, jplan,
                                                      lane_view=lane_view))
            got = _flat(shd.serving_cache_specs(pools, tc, plan,
                                                lane_view=lane_view))
            assert got == want, (arch, lane_view)


# ----------------------------- streams ----------------------------------- #
def test_gqa_head_sharded_streams(families, monkeypatch):
    """qwen3 at 2 shards: heads and mlp split; the plain kernels' launch
    counts are shards x layers x the engine's calls."""
    fam = families(QWEN)
    counts0 = (pp.COUNTS["plain"], pa.COUNTS["plain"])
    c = _assert_mesh_parity(fam, (2,), ("heads", "mlp"), monkeypatch)
    L = fam["cfg"].n_layers
    # the unsharded run and the 2-shard run: 1 + 2 launches per layer per
    # prefill group and per decode step, on the same counters
    assert pp.COUNTS["plain"] - counts0[0] == 3 * L * c["prefill_calls"]
    assert pa.COUNTS["plain"] - counts0[1] == 3 * L * c["decode_steps"]


def test_gqa_four_way_custom_heads(families, monkeypatch):
    _assert_mesh_parity(families(QWEN, **WIDE), (4,), ("heads", "mlp"),
                        monkeypatch)


def test_moe_expert_parallel_streams(families, monkeypatch):
    _assert_mesh_parity(families(MOE), (2, 4), ("experts",), monkeypatch)


def test_ssm_lane_sharded_streams(families, monkeypatch):
    _assert_mesh_parity(families(SSM), (2, 4), ("ssm_lanes",), monkeypatch)


def test_mla_head_sharded_streams(families, monkeypatch):
    _assert_mesh_parity(families(MLA), (2,), ("mla_heads", "experts"),
                        monkeypatch)


def test_moe_top3_exact_over_shards(families, monkeypatch):
    """k > 2: the slot buffer is summed over the shards before the slots
    are added in slot order, so a top-3 deepseek-v2 stays bit-equal (the
    reference's per-token psum is exact for k <= 2 only)."""
    fam = families(MLA)
    moe = dataclasses.replace(fam["cfg"].moe, top_k=3)
    _assert_mesh_parity(fam, (2,), ("mla_heads", "experts"), monkeypatch,
                        moe=moe)


def test_indivisible_plan_falls_back_replicated(families, monkeypatch):
    """3 shards split none of qwen3's 4 heads / 2 KV heads: every flag is
    off, every leaf replicates, and the streams are identical."""
    fam = families(QWEN)
    mesh = shd.make_serving_mesh(["cpu"] * 3)
    plan = shd.serving_shard_plan(fam["cfg"], mesh, max_seqs=4)
    assert not plan.any and not plan.ssm_lanes
    _assert_mesh_parity(fam, (3,), (), monkeypatch)


# ---------------------- spec decoding, bf16, cluster --------------------- #
def _perturbed(tree, noise=0.02):
    rng = np.random.default_rng(11)
    return jax.tree.map(
        lambda a: (a + noise * np.std(a) * rng.standard_normal(a.shape)
                   ).astype(a.dtype) if a.ndim >= 2 else a, tree)


def test_spec_decode_over_mesh(families):
    """Spec decoding with a perturbed, partly accepted draft: the verify
    runs through the engine's sharded program (B3's plain version at
    shard widths), the draft unsharded on shard 0's device."""
    fam = families(QWEN)
    draft = (fam["cfg"], bridge.params_from_numpy(
        _perturbed(jax.tree.map(np.asarray, fam["jparams"])), device="cpu"))
    prompt = fam["prompts"][0][1]

    def run(mesh):
        eng = ServingEngine(fam["cfg"], fam["params"],
                            EngineConfig(mesh=mesh, **ECFG), draft=draft,
                            device=None if mesh is not None else "cpu")
        assert eng.add_request(1, prompt, expected_total=64)
        b = Batch()
        b.add(1, StageKind.PREFILL, len(prompt))
        got = eng.execute(b)[1]
        for k in (3, 1, 5, 4, 3):
            b = Batch(spec_step=k)
            b.add(1, StageKind.DECODE, k + 1)
            got += eng.execute(b)[1]
        return got, dict(eng.counters)
    base, bc = run(None)
    got, gc = run(shd.make_serving_mesh(["cpu"] * 2))
    assert got == base
    fused = ("prefill_fused_ops", "verify_fused_ops")    # every shard's
    assert {k: v for k, v in gc.items() if k not in fused} == \
        {k: v for k, v in bc.items() if k not in fused}
    assert all(gc[k] == 2 * bc[k] for k in fused)
    assert 0 < bc["spec_accepted_tokens"] < bc["spec_drafted_tokens"]


def _pools_over_mesh(families, monkeypatch, dtype):
    """Pools of ``dtype`` on 2 shards serve the unsharded engine's streams
    and logits, and every shard's pools keep the dtype."""
    fam = families(QWEN)
    log = _Logits(monkeypatch)
    base, bc, _ = _port_run(fam["cfg"], fam["params"], fam["prompts"],
                            dtype=dtype)
    (want,) = log.take().values()
    got, gc, eng = _port_run(fam["cfg"], fam["params"], fam["prompts"],
                             shd.make_serving_mesh(["cpu"] * 2),
                             dtype=dtype)
    assert got == base
    assert all(gc[k] == bc[k] for k in ("prefill_calls", "decode_calls"))
    for seq in log.take().values():
        assert all(torch.equal(a, b) for a, b in zip(seq, want))
    assert all(t.dtype == dtype for pools in eng.kv.shard_pools
               for t in pools[0]["self"].values())


def test_bf16_pools_over_mesh(families, monkeypatch):
    _pools_over_mesh(families, monkeypatch, torch.bfloat16)


def test_fp16_pools_over_mesh(families, monkeypatch):
    _pools_over_mesh(families, monkeypatch, torch.float16)


def test_cluster_two_replicas_two_devices_each(families):
    """``ClusterFrontend.build(devices_per_replica=2, devices=["cpu"] *
    4)`` with the host tier on: each replica gets its own 2-shard mesh
    slice and its own cut of the parameters, and the cluster serves the
    streams of an unsharded cluster, spilling and prefetching the same
    pages."""
    fam = families(QWEN)
    cfg, params = fam["cfg"], fam["params"]
    rng = np.random.default_rng(7)
    shared = rng.integers(1, cfg.vocab, 12).tolist()
    # odd requests share a 12-token prefix; the third wave re-sends the
    # first, whose evicted pages went to the host tier
    prompts = {rid: (shared if rid % 2 else
                     rng.integers(1, cfg.vocab, 12).tolist())
               + rng.integers(1, cfg.vocab, 4 + rid).tolist()
               for rid in range(1, 7)}

    def run(**build_kw):
        cl = make_real_cluster(
            2, cfg, params, cpu_scale_perf_model(),
            policy=RoutingPolicy(max_hops=1), total_pages=24,
            replica_pages=12, page_size=4, max_slots=8, max_len=64,
            host_spill_pages=16,
            sched_cfg=SchedulerConfig(page_size=4,
                                      prefill_emits_first_token=True),
            **build_kw)
        got: dict[int, list] = {}
        for w, wave in enumerate(((1, 2, 3), (4, 5, 6), (1, 2, 3))):
            for rid in wave:
                key = rid + 10 * w
                cl.submit(simple_request(key, cl.clock,
                                         prompt=len(prompts[rid]), output=4,
                                         ttft_slowdown=8.0, tpot=0.15),
                          prompt=prompts[rid],
                          on_token=lambda r, t: got.setdefault(r, []).extend(t))
            cl.run_until_idle()
        kv = [d.engine.kv for d in cl.drivers]
        return cl, got, [(k.spilled_pages, k.prefetched_pages) for k in kv]

    cl, sharded, spill = run(devices_per_replica=2, devices=["cpu"] * 4)
    meshes = [d.engine.mesh for d in cl.drivers]
    assert all(m is not None and m.size == 2 for m in meshes)
    assert meshes[0] is not meshes[1]                       # two slices
    assert cl.drivers[0].engine.shard_params is not \
        cl.drivers[1].engine.shard_params
    _, base, base_spill = run(device="cpu")
    assert sharded == base and spill == base_spill
    assert sum(s for s, _ in spill) > 0 and sum(p for _, p in spill) > 0


def test_cluster_replicas_share_one_mesh(families):
    """``ClusterFrontend.build(mesh=...)``: every replica's engine over
    the one mesh, on one cut of the parameters, serving the unsharded
    cluster's streams."""
    fam = families(QWEN)
    prompts = dict(fam["prompts"])

    def run(**kw):
        cl = make_real_cluster(
            2, fam["cfg"], fam["params"], cpu_scale_perf_model(),
            policy=RoutingPolicy(max_hops=1), total_pages=64,
            replica_pages=32, page_size=4, max_slots=8, max_len=64,
            sched_cfg=SchedulerConfig(page_size=4,
                                      prefill_emits_first_token=True), **kw)
        got: dict[int, list] = {}
        for rid, p in prompts.items():
            cl.submit(simple_request(rid, 0.0, prompt=len(p), output=4,
                                     ttft_slowdown=8.0, tpot=0.15), prompt=p,
                      on_token=lambda r, t: got.setdefault(r, []).extend(t))
        assert cl.run_until_idle().served == len(prompts)
        return cl, got
    mesh = shd.make_serving_mesh(["cpu"] * 2)
    cl, got = run(mesh=mesh)
    engines = [d.engine for d in cl.drivers]
    assert all(e.mesh is mesh for e in engines)
    assert engines[0].shard_params is engines[1].shard_params
    assert got == run(device="cpu")[1]


# ------------------------- failures and split rules ---------------------- #
def test_shard_error_reaches_caller(families):
    """A shard that raises mid-call aborts the barrier: the shard waiting
    in a collective leaves it at once, and the caller gets the first
    shard's own error."""
    fam = families(QWEN)
    eng = ServingEngine(fam["cfg"], fam["params"], EngineConfig(
        mesh=shd.make_serving_mesh(["cpu"] * 2), **ECFG))
    inner = eng._prefill_body

    def body(params, gen, shard, *args):
        if shard.index == 1:
            raise ValueError("shard 1 fails")
        return inner(params, gen, shard, *args)
    eng._prefill_body = body
    assert eng.add_request(1, fam["prompts"][0][1], expected_total=48)
    b = Batch()
    b.add(1, StageKind.PREFILL, 11)
    t0 = time.perf_counter()
    with pytest.raises(ValueError, match="shard 1 fails"):
        eng.execute(b)
    assert time.perf_counter() - t0 < shd.BARRIER_TIMEOUT / 10


def test_split_rules_read_the_unsharded_heads(monkeypatch):
    """Each paged wrapper's launch hands its split rule the head count it
    is given as ``split_heads`` (the engine's shards pass the unsharded
    one), and the model passes the config's counts under a shard."""
    seen = []

    def splits(*args):
        seen.append(args)
        return 1
    monkeypatch.setattr(build, "load", lambda *a: (lambda *b: 0))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("S", (), {"cuda_stream": 0}))
    for mod in (pa, pp, pv, mk):
        monkeypatch.setattr(mod, "n_splits", splits)
        monkeypatch.setattr(mod, "sm_count", lambda dev: 132)
    g = torch.Generator().manual_seed(0)
    B, S, hd, page, mp = 2, 3, 32, 4, 4
    kp = torch.randn(9, page, 2, hd, generator=g)
    table = torch.arange(8, dtype=torch.int32).reshape(B, mp)
    pos0 = torch.tensor([1, 2], dtype=torch.int32)
    clen = torch.tensor([3, 2], dtype=torch.int32)
    q = torch.randn(B, S, 4, hd, generator=g)
    kn = torch.randn(B, S, 2, hd, generator=g)
    pa._launch(q[:, 0].contiguous(), kp, kp.clone(), table, clen, 0.1, None,
               split_heads=4)
    pp._launch(q, kn, kn.clone(), kp, kp.clone(), table, pos0, clen, 0.1,
               None, split_heads=4)
    pv._launch(q, kn, kn.clone(), kp, kp.clone(), table, pos0, clen, 0.1,
               None, split_heads=4)
    r, rope = mk.KERNEL_RANK, mk.KERNEL_ROPE
    mk._launch(torch.randn(B, S, 2, r), torch.randn(B, S, 2, rope),
               torch.randn(B, S, r), torch.randn(B, S, rope),
               torch.randn(9, page, r), torch.randn(9, page, rope), table,
               pos0, clen, 0.1, split_heads=8)
    assert [a[1] for a in seen[:1]] == [4]           # B1: (B, KVH, ...)
    assert seen[1][3] == 4                           # B2: (B, S, G, KVH, ..)
    assert seen[2][1] == 4                           # B3: (B, KVH, ...)
    assert seen[3][2] == 8                           # B4: (B, S, H, ...)


def test_model_passes_unsharded_heads_under_a_shard(families, monkeypatch):
    fam = families(QWEN)
    got = []
    for name in ("paged_decode_attention", "paged_prefill_attention"):
        inner = getattr(attention, name)

        def spy(*a, _inner=inner, **kw):
            got.append(kw.get("split_heads"))
            return _inner(*a, **kw)
        monkeypatch.setattr(attention, name, spy)
    _port_run(fam["cfg"], fam["params"], fam["prompts"][:1],
              shd.make_serving_mesh(["cpu"] * 2))
    assert got and set(got) == {fam["cfg"].n_kv_heads}
    got.clear()
    _port_run(fam["cfg"], fam["params"], fam["prompts"][:1])
    assert got and set(got) == {None}
