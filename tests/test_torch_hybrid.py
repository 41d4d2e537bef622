"""The port's zamba2 hybrid (Mamba2 layers and one shared attention block)
and phi3.5-moe (``attn_moe`` blocks) against the JAX package: the configs,
the model's logits in full causal and in paged chunked prefill + decode,
the shared block's one parameter set and its occurrences' own pools, the
bridge's hybrid trees, the serving engine's greedy streams, and the
launcher's counts.  Both packages run the same weights (the JAX init,
bridged; zamba2's Mamba2 layers get numpy-drawn conv bias, D and dt bias
so that no term is trivially 0 or 1) and the same numpy inputs.

Tolerances: logits atol 1e-4 (a few layers of float32 matmuls summed in
another order than XLA's); lane rows and pools after a call atol 1e-4.
Greedy streams must be equal: a difference counts as a fault unless the
reference's top-2 logit margin there is below 1e-4 (a tie)."""
import dataclasses
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
import repro.models.transformer as jtransformer                 # noqa: E402
import repro.serving.engine as jengine                          # noqa: E402
from repro.serving.kvcache import kv_page_bytes as jax_page_bytes  # noqa: E402
from repro_torch import bridge                                  # noqa: E402
from repro_torch import configs                                 # noqa: E402
from repro_torch.configs import get_config, get_reduced         # noqa: E402
from repro_torch.core.batch import Batch                        # noqa: E402
from repro_torch.core.slo import StageKind                      # noqa: E402
from repro_torch.kernels import paged_attention as pa           # noqa: E402
from repro_torch.kernels import paged_prefill as pp             # noqa: E402
from repro_torch.kernels import ssd_scan as sk                  # noqa: E402
from repro_torch.models import (init_paged_cache, init_params,  # noqa: E402
                                logits_fn, model_forward)
from repro_torch.models import transformer                      # noqa: E402
from repro_torch.models.moe import dropless_capacity_factor     # noqa: E402
from repro_torch.serving.engine import (EngineConfig,           # noqa: E402
                                        ServingEngine)
from repro_torch.serving.kvcache import (PagedKVManager,        # noqa: E402
                                         kv_page_bytes)

HYBRID, MOE = "zamba2-7b", "phi3.5-moe-42b-a6.6b"
ATOL_LOGITS = 1e-4
TIE_MARGIN = 1e-4
# the reduced zamba2 holds one shared-attention occurrence; this variant
# holds two, so that their own pools can be told apart
TWO_OCCURRENCES = dict(n_layers=5, block_pattern=(
    "ssm", "shared_attn", "ssm", "shared_attn", "ssm"))

_jax_init_params = jax.jit(jmodels.init_params, static_argnums=(1,))
_jax_forward = jax.jit(jmodels.model_forward, static_argnums=(1,),
                       static_argnames=("moe_cf",))


# ------------------------------ configs -------------------------------- #
@pytest.mark.parametrize("arch", [HYBRID, MOE])
def test_configs_are_the_reference_s(arch):
    """Both registries give the same full and reduced configs; the port's
    registry refuses no architecture and its stack takes every block kind
    of the reference.  zamba2-7b: 68 Mamba2 layers, 13 shared-attention
    occurrences at head dim 112 and state 64, 5.74 B parameters (21.4 GiB
    in float32), its pages 16 x 372,736 B over the 13 occurrences."""
    for get, jget in ((get_config, jcfgs.get_config),
                      (get_reduced, jcfgs.get_reduced)):
        cfg, jcfg = get(arch), jget(arch)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert cfg.param_count() == jcfg.param_count()
        assert kv_page_bytes(cfg) == jax_page_bytes(jcfg)
    assert configs._NOT_PORTED == ()
    assert set(transformer.PORTED_KINDS) == (
        set(jtransformer.ATTN_KINDS) | set(jtransformer.MLA_KINDS) | {"ssm"})
    assert set(transformer.MOE_KINDS) == set(jtransformer.MOE_KINDS)
    cfg = get_config(HYBRID)
    assert (cfg.block_pattern.count("ssm"),
            cfg.block_pattern.count("shared_attn")) == (68, 13)
    assert (cfg.head_dim, cfg.ssm.d_state, cfg.ssm.head_dim) == (112, 64, 64)
    assert 5.73e9 < cfg.param_count() < 5.74e9
    assert kv_page_bytes(cfg) == 16 * 372_736
    # the widths the card's kernels are built for include zamba2's
    pa.check_head_dim("paged_decode_attention", cfg.head_dim)
    with pytest.raises(ValueError):
        pa.check_head_dim("paged_decode_attention", 96)
    assert cfg.ssm.d_state in sk.KERNEL_STATES


# ------------------------------ the model ------------------------------ #
def _configs(arch, variant):
    jcfg, cfg = jcfgs.get_reduced(arch), get_reduced(arch)
    if variant == "two_occurrences":
        jcfg = dataclasses.replace(jcfg, **TWO_OCCURRENCES)
        cfg = dataclasses.replace(cfg, **TWO_OCCURRENCES)
    return jcfg, cfg


def _jax_params(jcfg, seed=0):
    """The JAX init as writable numpy arrays; every Mamba2 layer's conv
    bias, D and dt bias moved by numpy draws."""
    params = jax.tree.map(np.array, jax.tree.map(
        np.asarray, _jax_init_params(jax.random.PRNGKey(seed), jcfg)))
    rng = np.random.default_rng(11)
    for kind, seg in zip((k for k, _ in jcfg.segments()),
                         params["segments"]):
        if kind != "ssm":
            continue
        p = seg["p"]["ssm"]
        for name, scale in (("conv_b", 0.1), ("D", 0.5), ("dt_bias", 0.5)):
            p[name] = (p[name] + scale * rng.standard_normal(p[name].shape)
                       ).astype(np.float32)
    return params


def _bridged(arch, variant="reduced"):
    jcfg, cfg = _configs(arch, variant)
    params = _jax_params(jcfg)
    return (jcfg, cfg, jax.tree.map(jnp.asarray, params),
            bridge.params_from_numpy(params, device="cpu"))


@pytest.fixture(scope="module")
def models():
    """(jcfg, cfg, JAX params, port params) per (arch, variant)."""
    return {key: _bridged(*key) for key in (
        (HYBRID, "reduced"), (HYBRID, "two_occurrences"), (MOE, "reduced"))}


def test_hybrid_tree_has_one_shared_block(models):
    """The JAX tree crosses the bridge unchanged: one top-level
    ``shared_attn`` block, the reference's empty marker at every
    occurrence, Mamba2 segments beside it.  The port's own init gives the
    same tree (paths and shapes)."""
    jcfg, cfg, jparams, tparams = models[HYBRID, "two_occurrences"]
    assert [seg == {} for seg in tparams["segments"]] == \
        [k == "shared_attn" for k, _ in cfg.segments()]
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    tflat = jax.tree_util.tree_flatten_with_path(
        tparams, is_leaf=lambda t: isinstance(t, torch.Tensor))[0]
    assert [jax.tree_util.keystr(p) for p, _ in flat] == \
        [jax.tree_util.keystr(p) for p, _ in tflat]
    for (_, j), (_, t) in zip(flat, tflat):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    own = init_params(cfg, torch.Generator().manual_seed(0), device="meta")
    oflat = jax.tree_util.tree_flatten_with_path(
        own, is_leaf=lambda t: isinstance(t, torch.Tensor))[0]
    assert [(jax.tree_util.keystr(p), tuple(t.shape)) for p, t in oflat] == \
        [(jax.tree_util.keystr(p), tuple(t.shape)) for p, t in tflat]


@pytest.mark.parametrize("arch,variant", [(HYBRID, "reduced"),
                                          (HYBRID, "two_occurrences"),
                                          (MOE, "reduced")])
def test_logits_match_jax(models, arch, variant):
    """Full causal logits; then a chunked prefill over paged pools and
    lane rows (lane 1 padded) and a 1-token decode: the logits on real
    rows and every pool and lane row after each call.  MoE layers at the
    reference's default capacity factor (full causal) and at the engine's
    dropless E / k (paged)."""
    jcfg, cfg, jparams, tparams = models[arch, variant]
    rng = np.random.default_rng(0)
    B, L = 2, 24
    toks = rng.integers(0, cfg.vocab, (B, L + 1)).astype(np.int32)
    h, _, _ = _jax_forward(jparams, jcfg, jnp.asarray(toks))
    want = np.asarray(jmodels.logits_fn(jparams, jcfg, h))
    th, _, _ = model_forward(tparams, cfg, torch.from_numpy(toks).long())
    np.testing.assert_allclose(logits_fn(tparams, cfg, th).numpy(), want,
                               atol=ATOL_LOGITS, rtol=0)

    cf = dropless_capacity_factor(cfg)
    page, n_pages = 8, 8
    jcache = jmodels.init_paged_cache(jcfg, n_pages, page, B)
    tcache = init_paged_cache(cfg, n_pages, page, B, device="cpu")
    table = np.array([[0, 2, 4, 6], [1, 3, 5, 7]], np.int32)
    clen = np.array([L, L - 7], np.int32)
    steps = [(toks[:, :L], np.zeros(B, np.int32), clen),
             (toks[np.arange(B), clen][:, None], clen, np.ones(B, np.int32))]
    for x, pos0, cl in steps:
        h, jcache, _ = _jax_forward(
            jparams, jcfg, jnp.asarray(x), cache=jcache,
            pos0=jnp.asarray(pos0), block_tables=jnp.asarray(table),
            chunk_len=jnp.asarray(cl), moe_cf=cf)
        want = np.asarray(jmodels.logits_fn(jparams, jcfg, h))
        th, _, _ = model_forward(tparams, cfg, torch.from_numpy(x).long(),
                              cache=tcache, pos0=torch.from_numpy(pos0),
                              block_tables=torch.from_numpy(table),
                              chunk_len=torch.from_numpy(cl), moe_cf=cf)
        got = logits_fn(tparams, cfg, th).numpy()
        for b in range(B):
            np.testing.assert_allclose(got[b, :cl[b]], want[b, :cl[b]],
                                       atol=ATOL_LOGITS, rtol=0)
        rows = bridge.pools_to_numpy(tcache)
        jrows = jax.tree.map(np.asarray, jcache)
        assert jax.tree.structure(rows) == jax.tree.structure(jrows)
        for a, b in zip(jax.tree.leaves(rows), jax.tree.leaves(jrows)):
            np.testing.assert_allclose(a, b, atol=ATOL_LOGITS, rtol=0)


def test_occurrences_share_params_and_keep_own_pools(models, monkeypatch):
    """Every ``shared_attn`` occurrence runs the one ``params
    ["shared_attn"]`` block; each reads its own pools.  After a prefill,
    the second occurrence's pages are poisoned: in the next decode step
    every block before it gives the same output as with clean pools, it
    and the blocks after it do not; the first occurrence's pools are
    never read by the second."""
    _, cfg, _, tparams = models[HYBRID, "two_occurrences"]
    seen = []
    block = transformer.block_forward

    def spy(p, kind, *a, **k):
        out = block(p, kind, *a, **k)
        seen.append((kind, p, out[0]))
        return out
    monkeypatch.setattr(transformer, "block_forward", spy)
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 13))).long()
    table = torch.tensor([[0, 1]], dtype=torch.int32)

    def run(poison):
        cache = init_paged_cache(cfg, 4, 8, 1, device="cpu")
        model_forward(tparams, cfg, toks[:, :12], cache=cache,
                      pos0=torch.zeros(1, dtype=torch.int32),
                      block_tables=table,
                      chunk_len=torch.tensor([12], dtype=torch.int32))
        if poison is not None:
            for leaf in cache[poison]["self"].values():
                leaf[:2] = 1e3
        seen.clear()
        model_forward(tparams, cfg, toks[:, 12:], cache=cache,
                      pos0=torch.tensor([12], dtype=torch.int32),
                      block_tables=table,
                      chunk_len=torch.ones(1, dtype=torch.int32))
        return list(seen)
    segs = [k for k, _ in cfg.segments()]
    first, second = [i for i, k in enumerate(segs) if k == "shared_attn"]
    clean = run(None)
    assert [kind for kind, _, _ in clean] == segs
    assert all(p is tparams["shared_attn"] for kind, p, _ in clean
               if kind == "shared_attn")
    dirty = run(second)
    for i, ((_, _, a), (_, _, b)) in enumerate(zip(clean, dirty)):
        assert torch.equal(a, b) == (i < second), i
    dirty = run(first)
    assert all(torch.equal(a, b) == (i < first)
               for i, ((_, _, a), (_, _, b)) in enumerate(zip(clean, dirty)))


def test_bridge_round_trips_hybrid_pools(models):
    """A hybrid cache (Mamba2 lane rows, then a shared-attention
    occurrence's GQA pools with their write-off page, ...) crosses both
    ways unchanged."""
    jcfg, cfg, _, _ = models[HYBRID, "two_occurrences"]
    shapes = jax.eval_shape(lambda: jmodels.init_paged_cache(jcfg, 6, 4, 3))
    rng = np.random.default_rng(7)
    pools = jax.tree.map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    port = bridge.pools_from_numpy(pools, device="cpu")
    tcache = init_paged_cache(cfg, 6, 4, 3, device="meta")
    assert jax.tree.map(lambda t: tuple(t.shape), port) == \
        jax.tree.map(lambda t: tuple(t.shape), tcache)
    assert port[1]["self"]["k_pages"].shape[0] == 7       # write-off page
    back = bridge.pools_to_numpy(port)
    assert jax.tree.structure(back) == jax.tree.structure(pools)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(pools)):
        np.testing.assert_array_equal(a, b)


def test_hybrid_manager_rules():
    """The KV manager on a hybrid: page pools for the shared-attention
    occurrences, lane rows (lane axis 0, unstacked) for the Mamba2
    segments, prefix sharing forced off as for any SSM model, and
    speculative decoding refused (truncation cannot roll back lane
    state), as in the reference."""
    cfg = get_reduced(HYBRID)
    kv = PagedKVManager(cfg, total_pages=8, page_size=4, max_seqs=2,
                        max_len=64, share_prefix=True, device="cpu")
    assert not kv.share_prefix
    assert kv.lane_select_axes() == [0, -1, 0]
    assert set(kv.pools[1]["self"]) == {"k_pages", "v_pages"}
    with pytest.raises(NotImplementedError):
        ServingEngine(cfg, None, draft=(cfg, None), device="cpu")


# ------------------------------ the engine ----------------------------- #
ECFG = dict(max_slots=4, max_len=128, total_pages=64, share_prefix=False)
rng = np.random.default_rng(3)
PROMPTS = {1: rng.integers(0, 512, 10).tolist(),
           2: rng.integers(0, 512, 12).tolist(),
           3: rng.integers(0, 512, 9).tolist()}
# rid 1 in unaligned chunks 7 + 3; a prefill group of three lanes, padded
# to four; a group of two lanes beside a decode; decode groups of three
# lanes padded to four, with uneven step budgets (frozen lanes)
SCRIPT = [
    [(1, "P", 7)],
    [(1, "P", 3), (2, "P", 6), (3, "P", 5)],
    [(2, "P", 6), (3, "P", 4), (1, "D", 2)],
    [(1, "D", 3), (2, "D", 1), (3, "D", 4)],
    [(1, "D", 1), (2, "D", 3), (3, "D", 2)],
]
KINDS = {"P": StageKind.PREFILL, "D": StageKind.DECODE}


def _run(eng, batch_cls, kinds):
    for rid, prompt in PROMPTS.items():
        assert eng.add_request(rid, prompt, expected_total=32)
    streams = {rid: [] for rid in PROMPTS}
    for step in SCRIPT:
        b = batch_cls()
        for rid, kind, n in step:
            b.add(rid, kinds[kind], n)
        for rid, toks in eng.execute(b).items():
            streams[rid] += toks
    return streams


@pytest.fixture(scope="module")
def references(models):
    """The JAX engine's streams and counters, per arch."""
    out = {}
    kinds = {"P": jslo.StageKind.PREFILL, "D": jslo.StageKind.DECODE}
    for arch in (HYBRID, MOE):
        jcfg, _, jparams, _ = models[arch, "reduced"]
        eng = jengine.ServingEngine(jcfg, jparams,
                                    jengine.EngineConfig(**ECFG))
        out[arch] = _run(eng, jbatch.Batch, kinds), dict(eng.counters)
    return out


def _margin(model, prompt, prefix):
    jcfg, _, jparams, _ = model
    h, _, _ = _jax_forward(jparams, jcfg,
                           jnp.asarray([prompt + prefix], jnp.int32),
                           moe_cf=dropless_capacity_factor(jcfg))
    top = np.sort(np.asarray(jmodels.logits_fn(jparams, jcfg, h))[0, -1])
    return float(top[-1] - top[-2])


@pytest.mark.parametrize("arch", [HYBRID, MOE])
def test_streams_match_jax(models, references, arch):
    """The port's engine (B1 / B2 plain versions at every attention layer
    or occurrence, B5's at every Mamba2 layer, lane rows gathered and
    scattered per call) gives the JAX engine's greedy streams and
    counters on the same script."""
    model = models[arch, "reduced"]
    want, jcounters = references[arch]
    eng = ServingEngine(model[1], model[3], EngineConfig(**ECFG),
                        device="cpu")
    n0 = {m: m.COUNTS["plain"] for m in (pa, pp, sk)}
    got = _run(eng, Batch, KINDS)
    for rid in got:
        assert len(got[rid]) > 3
        if got[rid] == want[rid]:
            continue
        i = next(k for k, (a, b) in enumerate(zip(got[rid], want[rid]))
                 if a != b)
        margin = _margin(model, PROMPTS[rid], want[rid][:i])
        assert margin < TIE_MARGIN, (rid, i, margin, got[rid], want[rid])
        warnings.warn(f"tie at step {i} (reference top-2 margin {margin})")
    for key in ("prefill_calls", "decode_calls", "decode_tokens"):
        assert eng.counters[key] == jcounters[key], key
    cfg, c = model[1], eng.counters
    n_attn = sum(k != "ssm" for k in cfg.block_pattern)
    n_ssm = cfg.block_pattern.count("ssm")
    assert pa.COUNTS["plain"] - n0[pa] == n_attn * c["decode_steps"]
    assert pp.COUNTS["plain"] - n0[pp] == n_attn * c["prefill_calls"]
    assert sk.COUNTS["plain"] - n0[sk] == n_ssm * c["prefill_calls"]


@pytest.mark.parametrize("arch", [HYBRID, MOE])
def test_launcher_counts_match_jax_launcher(arch):
    """``repro_torch.launch.serve --arch A --reduced --device cpu`` on the
    defaults gives the JAX launcher's line (``python -m repro.launch.serve
    --arch A``): served 18/18 requests (1 dropped), 109 tokens, SLO
    attained 17/18, 33 prefill chunks, 19 decode loops of 92 tokens.  The
    planner runs in virtual time, so the counts do not depend on the
    weights.  The JAX line is held as numbers, as in ``test_torch_ssm.py``:
    running the JAX launcher here would add its own process and compiles,
    about 20 s for each arch on an 8-core CPU, to a suite that already
    runs close to its time limit."""
    from repro_torch.launch import serve
    fe, eng = serve.build(serve.parse_args(
        ["--arch", arch, "--reduced", "--device", "cpu"]))
    serve.replay(fe)
    s, c = fe.stats, eng.counters
    assert (s.served, s.submitted, s.dropped, s.tokens_out, s.attained) == \
        (18, 18, 1, 109, 17)
    assert (c["prefill_calls"], c["decode_calls"], c["decode_tokens"]) == \
        (33, 19, 92)
