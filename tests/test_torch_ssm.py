"""The port's Mamba2 path against the JAX package: kernel B5's plain
version (``ssd_chunked_plain``) against the Pallas kernel in interpret
mode (``ops.ssd``) and against ``ssd_chunked`` with a carried state, the
port's token-by-token oracle against the JAX one, the conv, mixer and
decode step, the model's logits and lane rows, the bridge's lane rows,
the KV manager's SSM rules, the serving engine's greedy streams, and the
launcher's counts.  Both packages run the same weights (the JAX init,
bridged, with numpy-drawn conv bias, D and dt bias so that no term is
trivially 0 or 1) and the same numpy inputs.

Tolerances: SSD outputs and states atol = rtol = 1e-5 (float32 sums in
another order than XLA's); the chunked form against the sequential oracle
1e-4 (a different algorithm: the decay is a difference of cumulative sums
there, a running product here); mixer outputs 1e-5; logits 1e-4 (two
layers of float32 matmuls).  Greedy streams must be equal: a difference
counts as a fault unless the reference's top-2 logit margin there is
below 1e-4 (a tie)."""
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
import repro.models.ssm as jssm                                 # noqa: E402
import repro.serving.engine as jengine                          # noqa: E402
from repro.kernels import ops as jops                           # noqa: E402
from repro.kernels.ref import ref_ssd as jax_ref_ssd            # noqa: E402
from repro_torch import bridge                                  # noqa: E402
from repro_torch.configs import get_config, get_reduced         # noqa: E402
from repro_torch.core.batch import Batch                        # noqa: E402
from repro_torch.core.slo import StageKind                      # noqa: E402
from repro_torch.kernels import ssd_scan as sk                  # noqa: E402
from repro_torch.kernels.ref import ref_ssd                     # noqa: E402
from repro_torch.models import (init_paged_cache, logits_fn,    # noqa: E402
                                model_forward)
from repro_torch.models import ssm                              # noqa: E402
from repro_torch.serving.engine import (EngineConfig,           # noqa: E402
                                        ServingEngine)
from repro_torch.serving.kvcache import (PagedKVManager,        # noqa: E402
                                         kv_page_bytes)

ARCH = "mamba2-2.7b"
TOL = 1e-5
ATOL_ORACLE = 1e-4
ATOL_LOGITS = 1e-4
TIE_MARGIN = 1e-4


# jitted: one compile each instead of one per eager primitive
_jax_ssd_chunked = jax.jit(jssm.ssd_chunked, static_argnums=(5,))
_jax_ssm_forward = jax.jit(jssm.ssm_forward, static_argnums=(2,))
_jax_decode_step = jax.jit(jssm.ssm_decode_step, static_argnums=(2,))
_jax_init_params = jax.jit(jmodels.init_params, static_argnums=(1,))
_jax_causal_conv = jax.jit(jssm._causal_conv)


def _t(*arrs):
    return [torch.from_numpy(np.array(a)) for a in arrs]


# ------------------------------ B5 kernel ------------------------------- #
def _ssd_inputs(B, S, H, P, N, seed=0, pad=None):
    """numpy inputs at the model's scales: x, B and C as silu outputs,
    dt = softplus(normal), A = -linspace(1, 16); ``pad`` (lane, first
    padded position) zeroes dt from there, as the engine's bucket padding
    does."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    silu = lambda a: a / (1 + np.exp(-a))
    xh, Bm, Cm = silu(f(B, S, H, P)), silu(f(B, S, N)), silu(f(B, S, N))
    dt = np.log1p(np.exp(f(B, S, H))).astype(np.float32)
    if pad is not None:
        dt[pad[0], pad[1]:] = 0.0
    A = -np.linspace(1.0, 16.0, H, dtype=np.float32)
    return xh, dt, A, Bm, Cm


# B, S, H, P, N, chunk, padded lane: several chunks carried, one chunk of a
# length that is no power of two, a lane whose tail is padding
SSD_SHAPES = [(2, 48, 4, 16, 8, 16, None), (1, 24, 3, 8, 16, 24, None),
              (3, 32, 2, 32, 32, 8, (1, 20))]


@pytest.mark.parametrize("B,S,H,P,N,chunk,pad", SSD_SHAPES)
def test_ssd_plain_matches_pallas_interpret(B, S, H, P, N, chunk, pad):
    """Zero initial state, y only: the TPU kernel's own function."""
    inputs = _ssd_inputs(B, S, H, P, N, pad=pad)
    want = np.asarray(jops.ssd(*map(jnp.asarray, inputs), chunk=chunk,
                               interpret=True))
    plain0 = sk.COUNTS["plain"]
    y, _ = sk.ssd_scan(*_t(*inputs), chunk=chunk)
    assert sk.COUNTS["plain"] == plain0 + 1
    np.testing.assert_allclose(y.numpy(), want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("B,S,H,P,N,chunk,pad", SSD_SHAPES)
def test_ssd_plain_matches_ssd_chunked_with_state(B, S, H, P, N, chunk, pad):
    """A nonzero initial state: y and the final state against the JAX
    ``ssd_chunked``; then both against the sequential oracles, and the
    padded lane's state after its padding equals its state at the last
    real token."""
    inputs = _ssd_inputs(B, S, H, P, N, seed=1, pad=pad)
    h0 = (np.random.default_rng(2).standard_normal((B, H, P, N))
          .astype(np.float32) * 0.3)
    wy, wh = _jax_ssd_chunked(*map(jnp.asarray, inputs), chunk,
                              jnp.asarray(h0))
    y, hT = sk.ssd_scan(*_t(*inputs), chunk=chunk, init_state=_t(h0)[0])
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(hT.numpy(), np.asarray(wh), atol=TOL, rtol=TOL)

    oy, oh = ref_ssd(*_t(*inputs), init_state=_t(h0)[0])
    jy, jh = jax_ref_ssd(*map(jnp.asarray, inputs),
                         init_state=jnp.asarray(h0))
    np.testing.assert_allclose(oy.numpy(), np.asarray(jy), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(oh.numpy(), np.asarray(jh), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(y.numpy(), oy.numpy(), atol=ATOL_ORACLE,
                               rtol=0)
    np.testing.assert_allclose(hT.numpy(), oh.numpy(), atol=ATOL_ORACLE,
                               rtol=0)
    if pad is not None:
        lane, n = pad
        cut = [a[lane:lane + 1, :n] for a in inputs[:2]] + [inputs[2]] + \
              [a[lane:lane + 1, :n] for a in inputs[3:]]
        _, h_real = ref_ssd(*_t(*cut), init_state=_t(h0[lane:lane + 1])[0])
        np.testing.assert_allclose(hT[lane:lane + 1].numpy(), h_real.numpy(),
                                   atol=ATOL_ORACLE, rtol=0)


def test_ssd_wrapper_dispatch():
    """The chunk must divide S; a device without a kernel raises (no
    fallback to the plain version)."""
    xh, dt, A, Bm, Cm = _t(*_ssd_inputs(1, 16, 2, 8, 8))
    with pytest.raises(ValueError):
        sk.ssd_scan(xh, dt, A, Bm, Cm, chunk=5)
    meta = [t.to("meta") for t in (xh, dt, A, Bm, Cm)]
    with pytest.raises(RuntimeError):
        sk.ssd_scan(*meta, chunk=8)


# ------------------------------ the mixer ------------------------------- #
def _configs():
    jcfg, cfg = jcfgs.get_reduced(ARCH), get_reduced(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg


@pytest.fixture(scope="module")
def model():
    """(jcfg, cfg, JAX params, port params): the JAX init with numpy-drawn
    conv bias, D and dt bias in every layer, bridged."""
    jcfg, cfg = _configs()
    params = jax.tree.map(np.asarray,
                          _jax_init_params(jax.random.PRNGKey(0), jcfg))
    params = jax.tree.map(np.array, params)             # writable copies
    rng = np.random.default_rng(11)
    p = params["segments"][0]["p"]["ssm"]
    for name, scale in (("conv_b", 0.1), ("D", 0.5), ("dt_bias", 0.5)):
        p[name] = (p[name] + scale * rng.standard_normal(p[name].shape)
                   ).astype(np.float32)
    return (jcfg, cfg, jax.tree.map(jnp.asarray, params),
            bridge.params_from_numpy(params, device="cpu"))


def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree)


def test_causal_conv_with_chunk_len_matches_jax(model):
    """The carried state is the last K - 1 REAL inputs of each lane (a
    lane of 0 keeps its state, one of 2 reaches back into the state)."""
    _, _, jparams, tparams = model
    jp = _layer0(jparams["segments"][0]["p"]["ssm"])
    tp = _layer0(tparams["segments"][0]["p"]["ssm"])
    rng = np.random.default_rng(4)
    C = jp["conv_w"].shape[1]
    x = rng.standard_normal((4, 8, C)).astype(np.float32)
    st = rng.standard_normal((4, 3, C)).astype(np.float32)
    clen = np.array([8, 5, 2, 0], np.int32)
    wo, ws = _jax_causal_conv(jp["conv_w"], jp["conv_b"], jnp.asarray(x),
                              jnp.asarray(st), jnp.asarray(clen))
    go, gs = ssm._causal_conv(tp["conv_w"], tp["conv_b"], *_t(x, st, clen))
    np.testing.assert_allclose(go.numpy(), np.asarray(wo), atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(gs[3].numpy(), st[3])


def test_ssm_forward_and_decode_match_jax(model):
    """A prefill chunk with a cache and padded lanes (one partial, one of
    length 0), then a decode step from the resulting state: outputs on the
    real rows and the new lane rows."""
    jcfg, cfg, jparams, tparams = model
    jp = _layer0(jparams["segments"][0]["p"]["ssm"])
    tp = _layer0(tparams["segments"][0]["p"]["ssm"])
    rng = np.random.default_rng(5)
    B, S = 3, 16
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    cache = {"conv": rng.standard_normal(
                 (B, s.d_conv - 1, d_in + 2 * s.d_state)).astype(np.float32),
             "state": 0.3 * rng.standard_normal(
                 (B, d_in // s.head_dim, s.head_dim, s.d_state)
             ).astype(np.float32)}
    clen = np.array([16, 11, 0], np.int32)
    wo, wc = _jax_ssm_forward(jp, jnp.asarray(x), jcfg,
                              cache=jax.tree.map(jnp.asarray, cache),
                              chunk_len=jnp.asarray(clen))
    go, gc = ssm.ssm_forward(tp, _t(x)[0], cfg,
                             cache={k: _t(v)[0] for k, v in cache.items()},
                             chunk_len=_t(clen)[0])
    for b in range(B):
        np.testing.assert_allclose(go[b, :clen[b]].numpy(),
                                   np.asarray(wo)[b, :clen[b]],
                                   atol=TOL, rtol=TOL)
    for k in cache:
        np.testing.assert_allclose(gc[k].numpy(), np.asarray(wc[k]),
                                   atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(gc["conv"][2].numpy(), cache["conv"][2])

    x1 = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    wo, wc = _jax_decode_step(jp, jnp.asarray(x1), jcfg, wc)
    go, gc = ssm.ssm_decode_step(tp, _t(x1)[0], cfg, gc)
    np.testing.assert_allclose(go.numpy(), np.asarray(wo), atol=TOL, rtol=TOL)
    for k in cache:
        np.testing.assert_allclose(gc[k].numpy(), np.asarray(wc[k]),
                                   atol=TOL, rtol=TOL)


_jax_forward = jax.jit(jmodels.model_forward, static_argnums=(1,))


def test_logits_and_lane_rows_match_jax(model):
    """Full causal logits; then a chunked prefill over lane rows (lane 1
    padded) and a 1-token decode, the logits on real rows and the lane
    rows after each call."""
    jcfg, cfg, jparams, tparams = model
    rng = np.random.default_rng(0)
    B, L = 2, 24
    toks = rng.integers(0, cfg.vocab, (B, L + 1)).astype(np.int32)
    h, _, _ = _jax_forward(jparams, jcfg, jnp.asarray(toks))
    want = np.asarray(jmodels.logits_fn(jparams, jcfg, h))
    th, _, _ = model_forward(tparams, cfg, torch.from_numpy(toks).long())
    np.testing.assert_allclose(logits_fn(tparams, cfg, th).numpy(), want,
                               atol=ATOL_LOGITS, rtol=0)

    jcache = jmodels.init_paged_cache(jcfg, 4, 8, B)
    tcache = init_paged_cache(cfg, 4, 8, B, device="cpu")
    table = np.zeros((B, 4), np.int32)
    clen = np.array([L, L - 7], np.int32)
    steps = [(toks[:, :L], np.zeros(B, np.int32), clen),
             (toks[np.arange(B), clen][:, None], clen, np.ones(B, np.int32))]
    for x, pos0, cl in steps:
        h, jcache, _ = _jax_forward(
            jparams, jcfg, jnp.asarray(x), cache=jcache,
            pos0=jnp.asarray(pos0), block_tables=jnp.asarray(table),
            chunk_len=jnp.asarray(cl))
        want = np.asarray(jmodels.logits_fn(jparams, jcfg, h))
        th, _, _ = model_forward(tparams, cfg, torch.from_numpy(x).long(),
                              cache=tcache, pos0=torch.from_numpy(pos0),
                              block_tables=torch.from_numpy(table),
                              chunk_len=torch.from_numpy(cl))
        got = logits_fn(tparams, cfg, th).numpy()
        for b in range(B):
            np.testing.assert_allclose(got[b, :cl[b]], want[b, :cl[b]],
                                       atol=ATOL_LOGITS, rtol=0)
        rows = bridge.pools_to_numpy(tcache)
        jrows = jax.tree.map(np.asarray, jcache)
        assert jax.tree.structure(rows) == jax.tree.structure(jrows)
        for a, b in zip(jax.tree.leaves(rows), jax.tree.leaves(jrows)):
            np.testing.assert_allclose(a, b, atol=ATOL_LOGITS, rtol=0)


def test_bridge_round_trips_lane_rows():
    """Stacked and unstacked lane rows cross unchanged, beside a GQA pool
    that gets its write-off page."""
    rng = np.random.default_rng(6)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    pools = [{"conv": f(2, 4, 3, 10), "state": f(2, 4, 2, 8, 6)},
             {"conv": f(4, 3, 10), "state": f(4, 2, 8, 6)},
             {"self": {"k_pages": f(5, 4, 2, 8), "v_pages": f(5, 4, 2, 8)}}]
    port = bridge.pools_from_numpy(pools, device="cpu")
    assert port[0]["state"].shape == (2, 4, 2, 8, 6)
    assert port[1]["conv"].shape == (4, 3, 10)
    assert port[2]["self"]["k_pages"].shape == (6, 4, 2, 8)
    back = bridge.pools_to_numpy(port)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(pools)):
        np.testing.assert_array_equal(a, b)


def test_full_config_and_manager_rules():
    """The full config is the reference's; lane rows are (max_seqs, ...)
    per layer and cost no page bytes; prefix sharing is forced off, as in
    the reference."""
    cfg = get_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jcfgs.get_config(ARCH))
    assert kv_page_bytes(cfg) == 0
    shapes = jax.eval_shape(lambda: jmodels.init_paged_cache(
        jcfgs.get_reduced(ARCH), 8, 4, 3))
    tcache = init_paged_cache(get_reduced(ARCH), 8, 4, 3, device="meta")
    assert jax.tree.map(lambda a: a.shape, shapes) == \
        jax.tree.map(lambda t: tuple(t.shape), tcache)
    kv = PagedKVManager(get_reduced(ARCH), total_pages=8, page_size=4,
                        max_seqs=2, max_len=64, share_prefix=True,
                        device="cpu")
    assert not kv.share_prefix
    toks = list(range(1, 17))
    assert kv.admit(1, 16, tokens=toks)
    kv.register_prefix(1, toks)
    assert kv.prefix_discounts(toks) == (0, 0, 0)
    assert kv.lane_select_axes() == [1]
    with pytest.raises(NotImplementedError):
        ServingEngine(get_reduced(ARCH), None, draft=(get_reduced(ARCH),
                                                      None), device="cpu")


# ------------------------------ the engine ------------------------------ #
ECFG = dict(max_slots=4, max_len=128, total_pages=64, share_prefix=False)
rng = np.random.default_rng(3)
PROMPTS = {1: rng.integers(0, 512, 10).tolist(),
           2: rng.integers(0, 512, 12).tolist(),
           3: rng.integers(0, 512, 9).tolist()}

# rid 1 in unaligned chunks 7 + 3; a prefill group of three lanes (all in
# the 8-token bucket: chunks 3, 6 and 5), padded to four; a group of two
# lanes beside a decode; decode groups of three lanes padded to four, with
# uneven step budgets (frozen lanes)
SCRIPT = [
    [(1, "P", 7)],
    [(1, "P", 3), (2, "P", 6), (3, "P", 5)],
    [(2, "P", 6), (3, "P", 4), (1, "D", 2)],
    [(1, "D", 3), (2, "D", 1), (3, "D", 4)],
    [(1, "D", 1), (2, "D", 3), (3, "D", 2)],
]
PREEMPT_AT = len(SCRIPT) - 1      # replay run: preempt rid 2 before this


def _run(eng, batch_cls, kinds, preempt=False):
    for rid, prompt in PROMPTS.items():
        assert eng.add_request(rid, prompt, expected_total=32)
    streams = {rid: [] for rid in PROMPTS}
    for i, step in enumerate(SCRIPT):
        if preempt and i == PREEMPT_AT:
            assert eng.preempt(2) > 0
            assert eng.readmit(2, len(eng.reqs[2].pending) + 8)
            b = batch_cls()
            b.add(2, kinds["P"], len(eng.reqs[2].pending))
            assert eng.execute(b).get(2, []) == []    # replay: no emission
        b = batch_cls()
        for rid, kind, n in step:
            b.add(rid, kinds[kind], n)
        for rid, toks in eng.execute(b).items():
            streams[rid] += toks
    return streams


@pytest.fixture(scope="module")
def reference(model):
    """The JAX engine's streams and counters on fresh slots."""
    jcfg, _, jparams, _ = model
    eng = jengine.ServingEngine(jcfg, jparams, jengine.EngineConfig(**ECFG))
    kinds = {"P": jslo.StageKind.PREFILL, "D": jslo.StageKind.DECODE}
    return _run(eng, jbatch.Batch, kinds), dict(eng.counters)


def _port(model, **kw):
    return ServingEngine(model[1], model[3], EngineConfig(**{**ECFG, **kw}),
                         device="cpu")


def _margin(model, prompt, prefix):
    jcfg, _, jparams, _ = model
    h, _, _ = jmodels.model_forward(jparams, jcfg,
                                    jnp.asarray([prompt + prefix], jnp.int32))
    top = np.sort(np.asarray(jmodels.logits_fn(jparams, jcfg, h))[0, -1])
    return float(top[-1] - top[-2])


def _assert_streams_equal(got, want, prompt, model):
    if got == want:
        return
    i = next((k for k, (a, b) in enumerate(zip(got, want)) if a != b),
             min(len(got), len(want)))
    assert len(got) == len(want) or i < min(len(got), len(want)), (got, want)
    margin = _margin(model, prompt, want[:i])
    assert margin < TIE_MARGIN, (
        f"stream differs at step {i} with reference margin {margin}: "
        f"{got} vs {want}")
    warnings.warn(f"tie at step {i} (reference top-2 margin {margin})")


KINDS = {"P": StageKind.PREFILL, "D": StageKind.DECODE}


def test_streams_match_jax(model, reference):
    want, jcounters = reference
    eng = _port(model)
    got = _run(eng, Batch, KINDS)
    for rid in got:
        assert len(got[rid]) > 3
        _assert_streams_equal(got[rid], want[rid], PROMPTS[rid], model)
    for key in ("prefill_calls", "decode_calls", "decode_tokens"):
        assert eng.counters[key] == jcounters[key], key


def test_preempt_replay_is_bit_identical(model):
    """Preempting rid 2 zeroes its lane rows; the recompute prefill from
    position 0 then rebuilds them exactly."""
    want = _run(_port(model), Batch, KINDS)
    eng = _port(model)
    got = _run(eng, Batch, KINDS, preempt=True)
    assert eng.counters["preemptions"] == 1
    assert got == want


def test_reused_slot_starts_from_zero_state(model):
    """A one-slot engine serves request 1, frees its slot and serves
    request 2 there: the slot's lane rows are zero after acquire, and
    request 2's stream equals plain full-causal generation."""
    _, cfg, _, tparams = model
    eng = _port(model, max_slots=1)
    for rid, n_dec in ((1, 3), (2, 4)):
        prompt = PROMPTS[rid]
        assert eng.add_request(rid, prompt, expected_total=32)
        if rid == 2:
            assert all(not leaf.any() for leaf in eng.kv.pools[0].values())
        b = Batch()
        b.add(rid, StageKind.PREFILL, len(prompt))
        got = eng.execute(b)[rid]
        b = Batch()
        b.add(rid, StageKind.DECODE, n_dec)
        got += eng.execute(b)[rid]
        if rid == 1:
            assert any(leaf.any() for leaf in eng.kv.pools[0].values())
            eng.finish(rid)
    toks = list(prompt)
    for _ in range(len(got)):
        h, _, _ = model_forward(tparams, cfg, torch.tensor([toks]))
        toks.append(int(torch.argmax(logits_fn(tparams, cfg, h[0, -1]))))
    _assert_streams_equal(got, toks[len(prompt):], prompt, model)


def test_launcher_counts_match_jax_launcher():
    """``repro_torch.launch.serve --arch mamba2-2.7b --reduced --device
    cpu`` on the defaults gives the JAX launcher's line (``python -m
    repro.launch.serve --arch mamba2-2.7b``): served 18/18 requests (1
    dropped), 109 tokens, SLO attained 17/18, 33 prefill chunks, 19
    decode loops of 92 tokens.  The planner runs in virtual time, so the
    counts do not depend on the weights."""
    from repro_torch.launch import serve
    fe, eng = serve.build(serve.parse_args(
        ["--arch", ARCH, "--reduced", "--device", "cpu"]))
    plain0 = sk.COUNTS["plain"]
    serve.replay(fe)
    s, c = fe.stats, eng.counters
    assert (s.served, s.submitted, s.dropped, s.tokens_out, s.attained) == \
        (18, 18, 1, 109, 17)
    assert (c["prefill_calls"], c["decode_calls"], c["decode_tokens"]) == \
        (33, 19, 92)
    assert sk.COUNTS["plain"] - plain0 == \
        eng.cfg.n_layers * c["prefill_calls"]
