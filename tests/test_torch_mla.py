"""The port's MLA path (DeepSeek-V2) against the JAX package: kernel B4's
plain version and the port's loop oracle against the JAX oracle
``ref_mla_paged_prefill`` (which ``tests/test_mla_prefill.py`` holds the
Pallas kernel equal to), ``mla_forward`` in every ported mode, the model's
logits, the bridge's MLA pools, ``kv_page_bytes``, and the serving
engine's greedy streams.  Both packages run the same weights, drawn with
numpy at the shapes and scales of the reference's init and bridged.

Tolerances: kernel outputs atol 1e-5 on valid rows (float32 sums in
another order than XLA's), pools after a write bit for bit; mixer outputs
atol 1e-5; logits atol 1e-4 (a few layers of float32 matmuls).  Greedy
streams must be equal: a difference counts as a fault unless the
reference's top-2 logit margin there is below 1e-4 (a tie)."""
import dataclasses
import functools
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

import repro.configs as jcfgs                                   # noqa: E402
import repro.core.batch as jbatch                               # noqa: E402
import repro.core.slo as jslo                                   # noqa: E402
import repro.models as jmodels                                  # noqa: E402
import repro.serving.engine as jengine                          # noqa: E402
from repro.kernels.ref import (                                 # noqa: E402
    ref_mla_paged_prefill as jax_ref_mla)
from repro.models import attention as jattn                     # noqa: E402
from repro.serving.kvcache import kv_page_bytes as jax_page_bytes  # noqa: E402
from repro_torch import bridge                                  # noqa: E402
from repro_torch.configs import get_config, get_reduced         # noqa: E402
from repro_torch.core.batch import Batch                        # noqa: E402
from repro_torch.core.slo import StageKind                      # noqa: E402
from repro_torch.kernels import mla_paged_prefill as mk         # noqa: E402
from repro_torch.kernels.ref import ref_mla_paged_prefill       # noqa: E402
from repro_torch.models import (init_paged_cache, logits_fn,    # noqa: E402
                                model_forward)
from repro_torch.models.attention import mla_forward           # noqa: E402
from repro_torch.serving.engine import (EngineConfig,           # noqa: E402
                                        ServingEngine)
from repro_torch.serving.kvcache import kv_page_bytes           # noqa: E402

ARCH = "deepseek-v2-236b"
ATOL_KERNEL = 1e-5
ATOL_LOGITS = 1e-4
TIE_MARGIN = 1e-4
THREE_LAYERS = dict(n_layers=3, block_pattern=("mla", "mla_moe", "mla_moe"))


def _t(*arrs):
    return [torch.from_numpy(np.array(a)) for a in arrs]


def _numpy_weights(init, seed):
    """Weights drawn with numpy at the shapes of the reference's ``init``
    (``jax.eval_shape``: nothing is compiled) and at its scales: norms 1,
    embeddings 0.02, every other matrix normal / sqrt(fan-in), where the
    fan-in of ``w_uk``, ``w_uv`` and ``w_uq`` is their first (latent) axis
    and that of ``wo`` its heads x head dim.  Returns (JAX params, port
    params): the same numbers on both sides."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))

    def draw(path, leaf):
        name = jax.tree_util.keystr(path[-1:]).strip("[']")
        shape = leaf.shape
        if "norm" in name or name == "scale":
            return np.ones(shape, np.float32)
        if name == "embed":
            std = 0.02
        elif name in ("w_uk", "w_uv", "w_uq"):
            std = shape[-3] ** -0.5
        elif name == "wo":
            std = (shape[-3] * shape[-2]) ** -0.5
        else:
            std = shape[-2] ** -0.5
        return (rng.standard_normal(shape) * std).astype(np.float32)
    weights = jax.tree_util.tree_map_with_path(draw, shapes)
    return (jax.tree.map(jnp.asarray, weights),
            bridge.params_from_numpy(weights, device="cpu"))


# ------------------------------ B4 kernel ------------------------------- #
def _kernel_inputs(B, S, H, r, rope, page, max_pages, seed=0):
    """numpy inputs: queries, the chunk's latents, pools with 3 spare
    pages, a permuted block table."""
    rng = np.random.default_rng(seed)
    n_pages = B * max_pages + 3
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    table = rng.permutation(n_pages)[:B * max_pages].reshape(
        B, max_pages).astype(np.int32)
    return (f(B, S, H, r), f(B, S, H, rope), f(B, S, r), f(B, S, rope),
            f(n_pages, page, r), f(n_pages, page, rope), table)


@functools.partial(jax.jit, static_argnums=(6, 7, 8, 9))
def _jax_oracle_jit(q_lat, q_rope, ckv, krope, cp, rp, table, pos0, clen,
                    scale):
    return jax_ref_mla(q_lat, q_rope, ckv, krope, cp, rp, np.array(table),
                       np.array(pos0), np.array(clen), scale=scale)


def _jax_oracle(inputs, pos0, clen, scale):
    """The JAX oracle, traced once per shape (its per-row loops run on
    static block tables, positions and lengths)."""
    out = _jax_oracle_jit(*[jnp.asarray(a) for a in inputs[:6]],
                          tuple(map(tuple, inputs[6].tolist())),
                          tuple(pos0.tolist()), tuple(clen.tolist()), scale)
    return [np.asarray(a) for a in out]


# the shapes of tests/test_mla_prefill.py: chunks straddling page edges,
# page-aligned chunks with a masked third lane, a wider latent mid-page
SHAPES = [(2, 8, 4, 32, 16, 4, 8), (3, 16, 2, 16, 8, 16, 4),
          (2, 12, 4, 64, 32, 8, 6)]


@pytest.mark.parametrize("impl", ["plain", "port_ref"])
@pytest.mark.parametrize("B,S,H,r,rope,page,max_pages", SHAPES)
def test_mla_prefill_matches_jax_oracle(impl, B, S, H, r, rope, page,
                                        max_pages):
    """Context on valid rows and the written pools; lanes mix a mid-page
    start, a page-aligned start, a masked lane and a partial lane."""
    inputs = _kernel_inputs(B, S, H, r, rope, page, max_pages)
    pos0 = np.array([3, page, 0][:B], np.int32)
    clen = np.array([S, S // 2, 0][:B], np.int32)
    scale = (r + rope) ** -0.5
    want, cp_w, rp_w = _jax_oracle(inputs, pos0, clen, scale)
    args = _t(*inputs, pos0, clen)
    if impl == "plain":
        got, cp, rp = mk.mla_paged_prefill_attention(*args, scale=scale)
        assert got[2:].abs().sum() == 0 if B > 2 else True
    else:
        got, cp, rp = ref_mla_paged_prefill(*args, scale=scale)
    np.testing.assert_array_equal(cp.numpy(), cp_w)
    np.testing.assert_array_equal(rp.numpy(), rp_w)
    for b in range(B):
        n = int(clen[b])
        np.testing.assert_allclose(got[b, :n].numpy(), want[b, :n],
                                   atol=ATOL_KERNEL, rtol=0)
        if impl == "plain":
            assert not got[b, n:].any()          # padded rows are zeros


def test_mla_prefill_masked_rows_write_nothing():
    """A chunk_len 0 lane and the padded tail of a partial lane leave every
    pool row outside the written positions bit-identical."""
    B, S, H, r, rope, page, max_pages = 2, 8, 2, 16, 8, 4, 8
    inputs = _kernel_inputs(B, S, H, r, rope, page, max_pages, seed=1)
    pos0 = np.array([2, 5], np.int32)
    clen = np.array([0, 3], np.int32)        # lane 0 masked, lane 1 partial
    args = _t(*inputs, pos0, clen)
    cp0, rp0 = args[4].clone(), args[5].clone()
    scale = (r + rope) ** -0.5
    mk.mla_paged_prefill_attention(*args, scale=scale)
    cp, rp, table = args[4], args[5], inputs[6]
    touched = {(int(table[1, p // page]), p % page) for p in range(5, 8)}
    for pid in range(cp.shape[0]):
        for row in range(page):
            if (pid, row) not in touched:
                assert torch.equal(cp[pid, row], cp0[pid, row])
                assert torch.equal(rp[pid, row], rp0[pid, row])
    _, cp_w, rp_w = ref_mla_paged_prefill(*_t(*inputs, pos0, clen),
                                          scale=scale)
    assert torch.equal(cp, cp_w) and torch.equal(rp, rp_w)


def test_mla_prefill_ignores_unreachable_pages():
    """Poisoning every latent row past each lane's visible history and all
    unmapped pages leaves the output unchanged."""
    B, S, H, r, rope, page, max_pages = 2, 8, 4, 32, 16, 4, 8
    inputs = _kernel_inputs(B, S, H, r, rope, page, max_pages, seed=2)
    pos0 = np.array([3, page], np.int32)
    clen = np.array([S, S // 2], np.int32)
    scale = (r + rope) ** -0.5
    clean, _, _ = mk.mla_paged_prefill_attention(
        *_t(*inputs, pos0, clen), scale=scale)
    cp, rp, table = inputs[4].copy(), inputs[5].copy(), inputs[6]
    mapped = np.zeros(cp.shape[0], bool)
    mapped[table.ravel()] = True
    cp[~mapped] = rp[~mapped] = 1e4
    pos = np.arange(max_pages * page)
    for b in range(B):
        bad = (pos >= pos0[b] + clen[b]).reshape(max_pages, page)
        for i, pid in enumerate(table[b]):
            cp[pid][bad[i]] = 1e4
            rp[pid][bad[i]] = 1e4
    poisoned, _, _ = mk.mla_paged_prefill_attention(
        *_t(*inputs[:4], cp, rp, table, pos0, clen), scale=scale)
    for b in range(B):
        n = int(clen[b])
        np.testing.assert_allclose(poisoned[b, :n].numpy(),
                                   clean[b, :n].numpy(), atol=ATOL_KERNEL,
                                   rtol=0)


# ------------------------------ mla_forward ----------------------------- #
PAGE, N_PAGES, MAX_PAGES = 8, 24, 12


_jax_mla = jax.jit(jattn.mla_forward, static_argnums=(2,))


@pytest.fixture(scope="module")
def mla_layer():
    jcfg = jcfgs.get_reduced(ARCH)
    jp, tp = _numpy_weights(lambda k: jattn.init_mla(k, jcfg), seed=1)
    return jcfg, jp, tp


@pytest.mark.parametrize("mode", ["no_cache", "paged_chunk", "decode",
                                  "decode_absorbed"])
def test_mla_forward_matches_jax(mla_layer, mode):
    jcfg, jp, tp = mla_layer
    cfg = get_reduced(ARCH)
    if mode == "decode_absorbed":
        jcfg = dataclasses.replace(jcfg, mla_absorb=True)
        cfg = dataclasses.replace(cfg, mla_absorb=True)
    rng = np.random.default_rng(4)
    B = 2
    S = 1 if mode.startswith("decode") else 12
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    pos0 = np.array([5, 16] if S > 1 else [17, 30], np.int32)
    clen = np.array([S, 7] if S > 1 else [1, 0], np.int32)
    positions = (pos0[:, None] + np.arange(S)[None]).astype(np.int32)
    if mode == "no_cache":
        positions = np.tile(np.arange(S, dtype=np.int32), (B, 1))
        want, _ = _jax_mla(jp, jnp.asarray(x), jcfg,
                                    positions=jnp.asarray(positions))
        got, _ = mla_forward(tp, torch.from_numpy(x), cfg,
                             positions=torch.from_numpy(positions))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=ATOL_KERNEL, rtol=0)
        return
    c = cfg.mla
    table = rng.permutation(N_PAGES)[:B * MAX_PAGES // 2].reshape(
        B, -1).astype(np.int32)
    pools = {"ckv_pages": rng.standard_normal(
                 (N_PAGES, PAGE, c.kv_lora_rank)).astype(np.float32),
             "krope_pages": rng.standard_normal(
                 (N_PAGES, PAGE, c.qk_rope_head_dim)).astype(np.float32)}
    want, jcache = _jax_mla(
        jp, jnp.asarray(x), jcfg, positions=jnp.asarray(positions),
        cache=jax.tree.map(jnp.asarray, pools), pos0=jnp.asarray(pos0),
        block_tables=jnp.asarray(table), chunk_len=jnp.asarray(clen))
    tcache = bridge.pools_from_numpy(pools, device="cpu")
    got, _ = mla_forward(tp, torch.from_numpy(x), cfg,
                         positions=torch.from_numpy(positions), cache=tcache,
                         pos0=torch.from_numpy(pos0),
                         block_tables=torch.from_numpy(table),
                         chunk_len=torch.from_numpy(clen))
    for b in range(B):
        n = max(int(clen[b]), 1 if S == 1 else 0)
        np.testing.assert_allclose(got[b, :n].numpy(),
                                   np.asarray(want)[b, :n],
                                   atol=ATOL_KERNEL, rtol=0)
    # the written latents come out of each side's own projections
    for k, a in bridge.pools_to_numpy(tcache).items():
        np.testing.assert_allclose(a, np.asarray(jcache[k]),
                                   atol=ATOL_KERNEL, rtol=0)


# ------------------------------ the model ------------------------------- #
_jax_forward = jax.jit(jmodels.model_forward, static_argnums=(1,))


def _configs(layers):
    jcfg, cfg = jcfgs.get_reduced(ARCH), get_reduced(ARCH)
    if layers == 3:
        jcfg = dataclasses.replace(jcfg, **THREE_LAYERS)
        cfg = dataclasses.replace(cfg, **THREE_LAYERS)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg


@pytest.fixture(scope="module")
def models():
    """{layers: (jcfg, cfg, JAX params, bridged port params)} with numpy
    weights at the reference init's shapes and scales."""
    return {layers: _configs(layers) + _numpy_weights(
                lambda k, c=_configs(layers)[0]: jmodels.init_params(k, c),
                seed=layers)
            for layers in (2, 3)}


@pytest.mark.parametrize("layers", [2, 3])
def test_logits_match_jax(models, layers):
    """Full causal; with three layers (a two-layer ``mla_moe`` segment:
    stacked MLA pools and expert weights) also a chunked prefill over pages
    (one lane padded) and a 1-token decode.  The engine tests below run
    the paged path of the same three-layer model."""
    jcfg, cfg, jparams, tparams = models[layers]
    rng = np.random.default_rng(layers)
    B, L = 2, 20
    toks = rng.integers(0, cfg.vocab, (B, 2 * L + 1)).astype(np.int32)
    h, _, _ = _jax_forward(jparams, jcfg, jnp.asarray(toks))
    want = np.asarray(jmodels.logits_fn(jparams, jcfg, h))
    th, _, _ = model_forward(tparams, cfg, torch.from_numpy(toks).long())
    np.testing.assert_allclose(logits_fn(tparams, cfg, th).numpy(), want,
                               atol=ATOL_LOGITS, rtol=0)
    if layers == 2:
        return

    table = np.arange(B * MAX_PAGES, dtype=np.int32).reshape(B, MAX_PAGES)
    jcache = jmodels.init_paged_cache(jcfg, N_PAGES, PAGE, B)
    tcache = init_paged_cache(cfg, N_PAGES, PAGE, device="cpu")
    clen = np.array([2 * L, 2 * L - 5], np.int32)        # lane 1 padded
    steps = [(toks[:, :2 * L], np.zeros(B, np.int32), clen),
             (toks[np.arange(B), clen][:, None], clen, np.ones(B, np.int32))]
    for x, pos0, clen in steps:
        h, jcache, _ = _jax_forward(
            jparams, jcfg, jnp.asarray(x), cache=jcache,
            pos0=jnp.asarray(pos0), block_tables=jnp.asarray(table),
            chunk_len=jnp.asarray(clen))
        want = np.asarray(jmodels.logits_fn(jparams, jcfg, h))
        th, _, _ = model_forward(
            tparams, cfg, torch.from_numpy(x).long(), cache=tcache,
            pos0=torch.from_numpy(pos0), block_tables=torch.from_numpy(table),
            chunk_len=torch.from_numpy(clen))
        got = logits_fn(tparams, cfg, th).numpy()
        for b in range(B):
            n = int(clen[b])
            np.testing.assert_allclose(got[b, :n], want[b, :n],
                                       atol=ATOL_LOGITS, rtol=0)
    pools = bridge.pools_to_numpy(tcache)
    jpools = jax.tree.map(np.asarray, jcache)
    assert jax.tree.structure(pools) == jax.tree.structure(jpools)
    for a, b in zip(jax.tree.leaves(pools), jax.tree.leaves(jpools)):
        np.testing.assert_allclose(a, b, atol=ATOL_LOGITS, rtol=0)


def test_bridge_round_trips_mla_pools():
    """Unstacked (P, page, r) and stacked (n, P, page, r) MLA pools, beside
    GQA pools: the write-off page lands on the page axis, and the way back
    is bit-equal."""
    rng = np.random.default_rng(5)
    P, page = 5, 4
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    pools = [{"self": {"ckv_pages": f(P, page, 16),
                       "krope_pages": f(P, page, 8)}},
             {"self": {"ckv_pages": f(2, P, page, 16),
                       "krope_pages": f(2, P, page, 8)}},
             {"self": {"k_pages": f(3, P, page, 2, 8),
                       "v_pages": f(P, page, 2, 8)}}]
    port = bridge.pools_from_numpy(pools, device="cpu")
    assert port[0]["self"]["ckv_pages"].shape == (P + 1, page, 16)
    assert port[1]["self"]["krope_pages"].shape == (2, P + 1, page, 8)
    assert port[2]["self"]["k_pages"].shape == (3, P + 1, page, 2, 8)
    assert port[2]["self"]["v_pages"].shape == (P + 1, page, 2, 8)
    assert not port[0]["self"]["ckv_pages"][-1].any()
    assert not port[1]["self"]["ckv_pages"][:, -1].any()
    back = bridge.pools_to_numpy(port)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(pools)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("variant", ["full", "reduced", "three_layers",
                                     "smollm"])
def test_kv_page_bytes_match_jax(variant):
    if variant == "smollm":
        cfg, jcfg = get_config("smollm-135m"), jcfgs.get_config("smollm-135m")
    elif variant == "full":
        cfg, jcfg = get_config(ARCH), jcfgs.get_config(ARCH)
    else:
        cfg, jcfg = get_reduced(ARCH), jcfgs.get_reduced(ARCH)
        if variant == "three_layers":
            cfg = dataclasses.replace(cfg, **THREE_LAYERS)
            jcfg = dataclasses.replace(jcfg, **THREE_LAYERS)
    for page in (8, 16):
        assert kv_page_bytes(cfg, page) == jax_page_bytes(jcfg, page)


# ------------------------------ the engine ------------------------------ #
ECFG = dict(max_slots=4, max_len=128, total_pages=64)
rng = np.random.default_rng(3)
P1 = rng.integers(1, 512, 24).tolist()
P2 = rng.integers(1, 512, 24).tolist()
P4 = P1[:10] + rng.integers(1, 512, 6).tolist()   # token-level head: CoW copy
P5 = P1[:16]             # hit capped at 15: its write CoWs a shared page
PROMPTS = {1: P1, 2: P2, 4: P4, 5: P5}

# rids 1 and 2, two lanes of each group: chunks (10, 9, 5) (the second
# starting mid-page), as the reference's test_mla_prefill streams; then
# two prefix hits on rid 1's published page and batched decodes of four
# lanes, 4 steps for rids 1 and 2 first
SCRIPT = [
    "admit 1 2",
    [(1, "P", 10), (2, "P", 10)], [(1, "P", 9), (2, "P", 9)],
    [(1, "P", 5), (2, "P", 5)],
    "admit 4 5", [(4, "P", 16), (5, "P", 16)],
    [(1, "D", 4), (2, "D", 4), (4, "D", 3), (5, "D", 2)],
    [(1, "D", 2), (2, "D", 3), (4, "D", 4), (5, "D", 1)],
]
PREEMPT_AT = len(SCRIPT) - 1      # replay run: preempt rid 4 before this


def _run(eng, batch_cls, kinds, preempt=False):
    streams = {rid: [] for rid in PROMPTS}
    for i, step in enumerate(SCRIPT):
        if isinstance(step, str):
            for rid in map(int, step.split()[1:]):
                assert eng.add_request(rid, PROMPTS[rid], expected_total=48)
            continue
        if preempt and i == PREEMPT_AT:
            assert eng.preempt(4) > 0
            assert eng.readmit(4, len(eng.reqs[4].pending) + 16)
            b = batch_cls()
            b.add(4, kinds["P"], len(eng.reqs[4].pending))
            assert eng.execute(b).get(4, []) == []    # replay: no emission
        b = batch_cls()
        for rid, kind, n in step:
            b.add(rid, kinds[kind], n)
        for rid, toks in eng.execute(b).items():
            streams[rid] += toks
    return streams


@pytest.fixture(scope="module")
def reference(models):
    """The JAX engine's streams on the three-layer model (stacked pools:
    its copy-on-write copies walk a layer axis)."""
    jcfg, _, jparams, params = models[3]
    eng = jengine.ServingEngine(jcfg, jparams, jengine.EngineConfig(
        share_prefix=True, **ECFG))
    kinds = {"P": jslo.StageKind.PREFILL, "D": jslo.StageKind.DECODE}
    streams = _run(eng, jbatch.Batch, kinds)
    assert eng.kv.partial_head_copies > 0 and eng.kv.cow_copies > 0
    return jcfg, jparams, params, streams, dict(eng.counters)


def _port(params, **kw):
    return ServingEngine(_configs(3)[1], params, EngineConfig(**ECFG, **kw),
                         device="cpu")


def _assert_streams_equal(got, want, prompt, jcfg, jparams):
    if got == want:
        return
    i = next((k for k, (a, b) in enumerate(zip(got, want)) if a != b),
             min(len(got), len(want)))
    assert len(got) == len(want) or i < min(len(got), len(want)), (got, want)
    toks = jnp.asarray([prompt + want[:i]], jnp.int32)
    h, _, _ = jmodels.model_forward(jparams, jcfg, toks)
    top = np.sort(np.asarray(jmodels.logits_fn(jparams, jcfg, h))[0, -1])
    margin = float(top[-1] - top[-2])
    assert margin < TIE_MARGIN, (
        f"stream differs at step {i} with reference margin {margin}: "
        f"{got} vs {want}")
    warnings.warn(f"tie at step {i} (reference top-2 margin {margin})")


@pytest.mark.parametrize("share", [True, False])
def test_streams_match_jax(reference, share):
    jcfg, jparams, params, want, jcounters = reference
    eng = _port(params, share_prefix=share)
    got = _run(eng, Batch, {"P": StageKind.PREFILL, "D": StageKind.DECODE})
    for rid in got:
        assert len(got[rid]) > 1
        _assert_streams_equal(got[rid], want[rid], PROMPTS[rid], jcfg,
                              jparams)
    for key in ("prefill_calls", "decode_calls", "decode_tokens"):
        assert eng.counters[key] == jcounters[key], key
    if share:
        assert eng.counters["prefix_hit_tokens"] == \
            jcounters["prefix_hit_tokens"] > 0
        assert eng.kv.partial_head_copies > 0 and eng.kv.cow_copies > 0
    else:
        assert eng.counters["prefix_hit_tokens"] == 0
    assert eng._moe_cf == 2.0                  # E / k: dropless


def test_preempt_replay_is_bit_identical(reference):
    _, _, params, _, _ = reference
    kinds = {"P": StageKind.PREFILL, "D": StageKind.DECODE}
    want = _run(_port(params), Batch, kinds)
    eng = _port(params)
    got = _run(eng, Batch, kinds, preempt=True)
    assert eng.counters["preemptions"] == 1
    assert got == want


def test_mla_replay_rehearsal_gives_the_timed_shape():
    """``chip_smoke.py``'s mla replay at reduced width on the CPU (the same
    engine, scheduler and trace, the three-layer cut): every request is
    served, B4's plain version runs once per layer per prefill group, and
    the groups include the bucket at which the card times B4."""
    import importlib.util
    from pathlib import Path

    from repro_torch.core.scheduler import (SchedulerConfig,
                                            SLOsServeScheduler)
    from repro_torch.device import generator
    from repro_torch.launch import serve
    from repro_torch.models import init_params
    from repro_torch.serving.frontend import ServingFrontend
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    _, cfg = _configs(3)
    dev = torch.device("cpu")
    params = init_params(cfg, generator(dev, 0), device=dev)
    eng = ServingEngine(cfg, params, EngineConfig(
        max_slots=8, max_len=1024, page_size=16, total_pages=512),
        device=dev)
    fe = ServingFrontend(eng, SLOsServeScheduler(
        serve.VIRTUAL_PERF, SchedulerConfig(prefill_emits_first_token=True)),
        seed=0)
    for req in serve.trace(serve.parse_args(smoke.MLA_REPLAY
                                            + ["--seed", "0"])):
        fe.submit(req)
    buckets = set()
    prefill_forward = eng._prefill_forward

    def seen(cache, tokens, *args):
        buckets.add(f"{tokens.shape[0]}/{tokens.shape[1]}")
        return prefill_forward(cache, tokens, *args)
    eng._prefill_forward = seen
    plain0 = mk.COUNTS["plain"]
    fe.run_until_idle()
    assert fe.stats.served == fe.stats.submitted == 8
    assert mk.COUNTS["plain"] - plain0 == 3 * eng.counters["prefill_calls"]
    main = next(c for c in smoke.MLA_CASES if c[0] == "main")
    assert f"{main[1]}/{main[2]}" in buckets
