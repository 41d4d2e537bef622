"""bf16 KV serving (``EngineConfig.dtype``) in the port against the JAX
package, on the CPU at reduced sizes.

* The plain versions of the paged kernels (B1 decode, B2 fused prefill,
  B3 fused verify, B4 MLA latent-page prefill), what the wrappers run for
  CPU tensors, over bfloat16 pools against the JAX Pallas kernels in
  interpret mode on the same numpy-seeded inputs (float32 queries and new
  rows, GQA, a sliding window, mid-page chunk starts, a masked lane):
  outputs agree to atol 1e-5 on valid rows (both read the same bf16
  values widened to float32; the sums run in another order), pools after
  the write are bit-equal (both round to nearest even).
* The port's engine at ``dtype=torch.bfloat16`` against the JAX engine at
  ``jnp.bfloat16`` on the same weights (the port's seeded init, handed to
  JAX as numpy: an eager init costs no compile) and batches: smollm-135m
  (prefix hit and copy-on-write), deepseek-v2 (MLA), phi3.5-moe,
  whisper-large-v3 (encoder states) and speculative decoding with the
  one-layer draft.  Greedy streams are equal (a difference counts only
  where the reference's top-2 logit margin is below 1e-4: a tie), every
  pool leaf is bf16, the draft's pool too, and the draft's budget charge
  follows the bf16 page bytes as the reference's does.
* Inside the port in bf16: streams identical with prefix sharing on and
  off, across a preempt replay, and with the host spill tier on and off;
  a prefetched page is bit-equal to the page that was spilled.
* An SSM-bearing config over bf16 or float16 pools raises
  ``NotImplementedError`` (the reference cannot serve either), as do
  float64 pools; float16 pools of smollm-135m serve
  (``tests/test_torch_fp16.py`` holds them against the JAX engine).

The JAX references are a module-scoped fixture, one engine per model,
each through few shapes (every shape is a compile of the JAX engine)."""
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
from repro.kernels import ops                                   # noqa: E402
from repro.kernels.paged_prefill import (                       # noqa: E402
    paged_verify_attention as jax_paged_verify)
from repro_torch.configs import get_reduced                     # noqa: E402
from repro_torch.core.batch import Batch                        # noqa: E402
from repro_torch.core.slo import StageKind                      # noqa: E402
from repro_torch.kernels import mla_paged_prefill as mk         # noqa: E402
from repro_torch.kernels import paged_attention as pa           # noqa: E402
from repro_torch.kernels import paged_prefill as pp             # noqa: E402
from repro_torch.kernels import paged_verify as pv              # noqa: E402
from repro_torch.models import (encoder_forward,                # noqa: E402
                                init_encdec_params, init_params)
from repro_torch.serving.engine import (EngineConfig,           # noqa: E402
                                        ServingEngine)
from repro_torch.serving.kvcache import kv_page_bytes           # noqa: E402

ATOL = 1e-5
TIE_MARGIN = 1e-4
BF16 = torch.bfloat16
ECFG = dict(max_slots=4, max_len=128, total_pages=64)
K = {"P": StageKind.PREFILL, "D": StageKind.DECODE}
JK = {"P": jslo.StageKind.PREFILL, "D": jslo.StageKind.DECODE}



# the JAX dtype of each 16-bit torch dtype (tests/test_torch_fp16.py
# reuses these helpers for float16 pools)
JAX_DTYPES = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16}


# ----------------------- kernels' plain versions ------------------------ #
def _rng_inputs(seed, B, S, H, KV, hd, page, max_pages, dtype=BF16):
    """numpy inputs: float32 q (B, S, H, hd) and k/v_new (B, S, KV, hd);
    pools rounded to ``dtype`` (held as float32 numpy, so that both
    packages get the same 16-bit values), 3 spare pages; a permuted block
    table."""
    rng = np.random.default_rng(seed)
    n_pages = B * max_pages + 3

    def f(*s):
        return rng.standard_normal(s).astype(np.float32)
    table = rng.permutation(n_pages)[:B * max_pages].reshape(
        B, max_pages).astype(np.int32)
    return (f(B, S, H, hd), f(B, S, KV, hd), f(B, S, KV, hd),
            _round_np(f(n_pages, page, KV, hd), dtype),
            _round_np(f(n_pages, page, KV, hd), dtype), table)


def _round_np(a, dtype):
    """``a`` rounded to ``dtype`` (nearest even), held as float32 numpy."""
    return torch.from_numpy(a).to(dtype).float().numpy()


def _bf16_np(a):
    return _round_np(a, BF16)


def _jdt(a, dtype):
    return jnp.asarray(a, JAX_DTYPES[dtype])


def _tdt(a, dtype):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _jbf(a):
    return _jdt(a, BF16)


def _tbf(a):
    return _tdt(a, BF16)


def _t(*arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


def _same_pool(got, want):
    """bit-equal 16-bit pools (compared as their 16-bit patterns)"""
    np.testing.assert_array_equal(
        got.view(torch.int16).numpy(),
        np.asarray(want).view(np.int16))


@pytest.mark.parametrize("B,H,KV,hd,page,max_pages,window", [
    (3, 6, 2, 32, 8, 6, None),      # G 3
    (3, 9, 3, 64, 16, 5, 20),       # smollm's group, window over pages
])
def test_plain_decode_bf16_matches_pallas(B, H, KV, hd, page, max_pages,
                                          window):
    q, _, _, kp, vp, table = _rng_inputs(B + hd, B, 1, H, KV, hd, page,
                                         max_pages)
    q = q[:, 0]
    lens = np.array([1, page + 3, max_pages * page][:B], np.int32)
    want = np.asarray(ops.paged_attention(
        jnp.asarray(q), _jbf(kp), _jbf(vp), jnp.asarray(table),
        jnp.asarray(lens), window=window, interpret=True))
    n0 = pa.COUNTS["plain"]
    got = pa.paged_decode_attention(torch.from_numpy(q), _tbf(kp), _tbf(vp),
                                    *_t(table, lens), window=window)
    assert pa.COUNTS["plain"] == n0 + 1
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


PREFILL_CASES = [   # B, S, H, KV, hd, page, max_pages, pos0, clen, window
    (3, 8, 6, 2, 32, 8, 4, [3, 8, 0], [8, 4, 0], None),   # mid-page, masked
    (2, 12, 9, 3, 64, 16, 3, [5, 20], [12, 7], 6),        # window < chunk
]


@pytest.mark.parametrize("kernel", ["prefill", "verify"])
@pytest.mark.parametrize("B,S,H,KV,hd,page,max_pages,pos0,clen,window",
                         PREFILL_CASES)
def test_plain_prefill_and_verify_bf16_match_pallas(kernel, B, S, H, KV, hd,
                                                    page, max_pages, pos0,
                                                    clen, window):
    """B2 and B3 write the chunk's rows rounded to bf16 and attend over
    them as written: the Pallas kernels (``_prefill_kernel`` for both)
    read them back from the pages."""
    q, kn, vn, kp, vp, table = _rng_inputs(S + hd, B, S, H, KV, hd, page,
                                           max_pages)
    pos0, clen = np.array(pos0, np.int32), np.array(clen, np.int32)
    jfn = ops.paged_prefill if kernel == "prefill" else jax_paged_verify
    jout, jkp, jvp = jfn(jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn),
                         _jbf(kp), _jbf(vp), jnp.asarray(table),
                         jnp.asarray(pos0), jnp.asarray(clen), window=window,
                         interpret=True)
    mod, fn = ((pp, pp.paged_prefill_attention) if kernel == "prefill"
               else (pv, pv.paged_verify_attention))
    tkp, tvp = _tbf(kp), _tbf(vp)
    n0 = mod.COUNTS["plain"]
    out, kp2, vp2 = fn(*_t(q, kn, vn), tkp, tvp, *_t(table, pos0, clen),
                       window=window)
    assert mod.COUNTS["plain"] == n0 + 1
    assert kp2 is tkp and kp2.dtype == BF16 and out.dtype == torch.float32
    _same_pool(kp2, jkp)
    _same_pool(vp2, jvp)
    for b in range(B):
        n = int(clen[b])
        np.testing.assert_allclose(out[b, :n].numpy(), np.asarray(jout[b, :n]),
                                   atol=ATOL, rtol=0)
        assert not out[b, n:].any()


def test_plain_mla_bf16_matches_pallas():
    """B4 over bf16 latent pages: a mid-page chunk, an aligned one and a
    masked lane."""
    B, S, H, r, rope, page, max_pages = 3, 8, 4, 32, 16, 8, 5
    rng = np.random.default_rng(5)
    n_pages = B * max_pages + 3

    def f(*s):
        return rng.standard_normal(s).astype(np.float32)
    ql, qr, cn, rn = f(B, S, H, r), f(B, S, H, rope), f(B, S, r), f(B, S, rope)
    cp, rp = _bf16_np(f(n_pages, page, r)), _bf16_np(f(n_pages, page, rope))
    table = rng.permutation(n_pages)[:B * max_pages].reshape(
        B, max_pages).astype(np.int32)
    pos0, clen = np.array([5, 16, 0], np.int32), np.array([8, 6, 0], np.int32)
    scale = (24 + rope) ** -0.5
    jout, jcp, jrp = ops.mla_paged_prefill(
        *map(jnp.asarray, (ql, qr, cn, rn)), _jbf(cp), _jbf(rp),
        *map(jnp.asarray, (table, pos0, clen)), scale=scale, interpret=True)
    out, cp2, rp2 = mk.mla_paged_prefill_attention(
        *_t(ql, qr, cn, rn), _tbf(cp), _tbf(rp), *_t(table, pos0, clen),
        scale=scale)
    _same_pool(cp2, jcp)
    _same_pool(rp2, jrp)
    for b in range(B):
        n = int(clen[b])
        np.testing.assert_allclose(out[b, :n].numpy(), np.asarray(jout[b, :n]),
                                   atol=ATOL, rtol=0)
        assert not out[b, n:].any()


# ------------------------------- engines -------------------------------- #
rng = np.random.default_rng(0)
P1 = rng.integers(1, 512, 34).tolist()               # two full pages
P2 = P1[:20] + rng.integers(1, 512, 8).tolist()      # page + 4-token head
P3 = P1[:32]             # hit capped at 31: its write CoWs a shared page
PROMPTS = {1: P1, 2: P2, 3: P3}
# tests/test_torch_engine.py's requests through fewer shapes: rid 1's
# two full pages are published, rids 2 and 3 hit them and start mid-page
# (at 20, and at 31 with a copy-on-write of the shared boundary page),
# then one decode group whose lanes stop at uneven budgets
SCRIPT = [
    [(1, "P", 34)],
    "admit 2 3",
    [(2, "P", 28), (3, "P", 32)],
    [(1, "D", 4), (2, "D", 3), (3, "D", 2)],
]
PREEMPT_AT = 3          # replay run: preempt rid 2 before this batch
ENGINE_ARCHS = ("smollm-135m", "deepseek-v2-236b", "phi3.5-moe-42b-a6.6b")
WHISPER = "whisper-large-v3"


def _run(eng, batch_cls, kinds, preempt=False, encs=None):
    """SCRIPT through an engine of either package; returns {rid: stream}."""
    encs = encs or {}
    streams = {1: [], 2: [], 3: []}
    assert eng.add_request(1, P1, expected_total=48, enc_states=encs.get(1))
    for i, step in enumerate(SCRIPT):
        if step == "admit 2 3":
            for rid in (2, 3):
                assert eng.add_request(rid, PROMPTS[rid], expected_total=48,
                                       enc_states=encs.get(rid))
            continue
        if preempt and i == PREEMPT_AT:
            assert eng.preempt(2) > 0
            assert eng.readmit(2, len(eng.reqs[2].pending) + 16)
            b = batch_cls()
            b.add(2, kinds["P"], len(eng.reqs[2].pending))
            assert eng.execute(b).get(2, []) == []
        b = batch_cls()
        for rid, kind, n in step:
            b.add(rid, kinds[kind], n)
        for rid, toks in eng.execute(b).items():
            streams[rid] += toks
    return streams


def _leaves(tree):
    """The tensors of a (nested) pool tree."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    items = tree.values() if isinstance(tree, dict) else tree
    return [t for x in items for t in _leaves(x)]


def _to_jax(tree):
    """The port's weight tree as JAX arrays under the same key paths."""
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_jax(v) for v in tree)
    return jnp.asarray(tree.numpy())


def _weights(arch, seed=0):
    """(port weights, the same as JAX arrays) for ``arch`` reduced, or
    its one-layer draft with ``draft``."""
    cfg = get_reduced(arch) if isinstance(arch, str) else arch
    init = init_encdec_params if cfg.encoder is not None else init_params
    params = init(cfg, torch.Generator().manual_seed(seed), device="cpu")
    return params, _to_jax(params)


@pytest.fixture(scope="module")
def models():
    """Per architecture: the JAX config and weights, the port's, the
    JAX engine's bf16 streams and counters (and whisper's encoder states,
    from numpy frames through the port's encoder, fed to both)."""
    out = {}
    for arch in ENGINE_ARCHS + (WHISPER,):
        jcfg = jcfgs.get_reduced(arch)
        params, jp = _weights(arch)
        encs, jencs = None, None
        if arch == WHISPER:
            frames = np.random.default_rng(10).standard_normal(
                (3, jcfg.encoder.n_frames, jcfg.d_model)).astype(np.float32)
            with torch.no_grad():
                enc = encoder_forward(params["encoder"], get_reduced(arch),
                                      torch.from_numpy(frames))
            encs = {r: enc[r - 1:r].clone() for r in PROMPTS}
            jencs = {r: jnp.asarray(e.numpy()) for r, e in encs.items()}
        eng = jengine.ServingEngine(jcfg, jp, jengine.EngineConfig(
            share_prefix=True, dtype=jnp.bfloat16, **ECFG))
        streams = _run(eng, jbatch.Batch, JK, encs=jencs)
        assert all(x.dtype == jnp.bfloat16
                   for x in jax.tree.leaves(eng.kv.pools))
        out[arch] = (jcfg, jp, params, streams, dict(eng.counters), encs,
                     jencs)
    return out


def _port(arch, params, **kw):
    return ServingEngine(get_reduced(arch), params, EngineConfig(
        **{**ECFG, "dtype": BF16, **kw}), device="cpu")


def _jax_margin(jcfg, jp, toks, enc=None, dtype=BF16):
    """The reference's top-2 logit margin for the token after ``toks``,
    over KV pages of ``dtype``: one prefill through its paged cache."""
    T, page = len(toks), 16
    n_pages = -(-T // page)
    cache = jmodels.init_paged_cache(jcfg, n_pages, page, 1,
                                     JAX_DTYPES[dtype])
    h, _, _ = jmodels.model_forward(
        jp, jcfg, jnp.asarray([toks], jnp.int32), cache=cache,
        pos0=jnp.zeros((1,), jnp.int32),
        block_tables=jnp.arange(n_pages, dtype=jnp.int32)[None],
        chunk_len=jnp.asarray([T], jnp.int32), enc_states=enc)
    top = np.sort(np.asarray(jmodels.logits_fn(jp, jcfg, h))[0, -1])
    return float(top[-1] - top[-2])


def _assert_streams_equal(got, want, prompt, jcfg, jp, enc=None,
                          dtype=BF16):
    if got == want:
        return
    i = next((k for k, (a, b) in enumerate(zip(got, want)) if a != b),
             min(len(got), len(want)))
    assert i < min(len(got), len(want)), (got, want)
    margin = _jax_margin(jcfg, jp, prompt + want[:i], enc, dtype)
    assert margin < TIE_MARGIN, (
        f"stream differs at token {i} with reference margin {margin}: "
        f"{got} vs {want}")
    warnings.warn(f"tie at token {i} (reference top-2 margin {margin})")


@pytest.mark.parametrize("arch", ENGINE_ARCHS + (WHISPER,))
def test_engine_bf16_streams_match_jax(arch, models):
    jcfg, jp, params, want, jcounters, encs, jencs = models[arch]
    eng = _port(arch, params)
    got = _run(eng, Batch, K, encs=encs)
    for rid, prompt in PROMPTS.items():
        assert len(got[rid]) > 1
        _assert_streams_equal(got[rid], want[rid], prompt, jcfg, jp,
                              None if jencs is None else jencs[rid])
    for key in ("prefill_calls", "decode_calls", "decode_tokens",
                "prefix_hit_tokens"):
        assert eng.counters[key] == jcounters[key], key
    assert all(t.dtype == BF16 for t in _leaves(eng.kv.pools))
    if arch == "smollm-135m":
        assert eng.counters["prefix_hit_tokens"] > 0
        assert eng.kv.partial_head_copies > 0 and eng.kv.cow_copies > 0


def _draft(cfg):
    import dataclasses
    return dataclasses.replace(cfg, name=cfg.name + "-draft", n_layers=1,
                               block_pattern=("attn",))


P_SPEC = np.random.default_rng(2).integers(0, 512, 16).tolist()


def _spec_run(eng, batch_cls, kinds):
    """One prefill, then spec cycles of draft length 3 up to 11 tokens
    (the reference tests' naive scenario)."""
    assert eng.add_request(1, P_SPEC, expected_total=64)
    b = batch_cls()
    b.add(1, kinds["P"], len(P_SPEC))
    got = eng.execute(b).get(1, [])
    while len(got) < 11:
        b = batch_cls(spec_step=3)
        b.add(1, kinds["D"], 4)
        out = eng.execute(b).get(1, [])
        assert out
        got += out
    return got


def test_spec_decode_bf16_matches_jax(models):
    """Speculative decoding with the one-layer draft (seed 7): equal
    streams and spec counters, both pools bf16, and the draft's budget
    charge computed from bf16 page bytes as the reference's is."""
    from repro.serving.kvcache import SharedPageBudget as JBudget
    from repro_torch.serving.kvcache import SharedPageBudget
    arch = "smollm-135m"
    jcfg, jp, params, *_ = models[arch]
    jdcfg = _draft(jcfg)
    dparams, jdp = _weights(_draft(get_reduced(arch)), seed=7)
    jbudget = JBudget(512)
    jeng = jengine.ServingEngine(
        jcfg, jp, jengine.EngineConfig(dtype=jnp.bfloat16, **ECFG),
        draft=(jdcfg, jdp), kv_budget=jbudget)
    want = _spec_run(jeng, jbatch.Batch, JK)
    budget = SharedPageBudget(512)
    eng = ServingEngine(
        get_reduced(arch), params, EngineConfig(dtype=BF16, **ECFG),
        draft=(_draft(get_reduced(arch)), dparams), kv_budget=budget,
        device="cpu")
    got = _spec_run(eng, Batch, K)
    _assert_streams_equal(got, want, P_SPEC, jcfg, jp)
    if got == want:
        for k in ("spec_verify_calls", "spec_draft_calls",
                  "spec_accepted_tokens", "spec_drafted_tokens"):
            assert eng.counters[k] == jeng.counters[k], k
    assert eng.spec.budget_pages == jeng.spec.budget_pages > 0
    assert budget.used == jbudget.used
    assert all(t.dtype == BF16 for t in _leaves(eng.kv.pools)
               + _leaves(eng.spec.kv.pools))
    cfg = get_reduced(arch)
    assert 2 * kv_page_bytes(cfg, 16, BF16) == kv_page_bytes(cfg, 16)


# --------------------------- inside the port ---------------------------- #
def test_bf16_streams_identical_sharing_preempt(models):
    """In bf16: prefix sharing on and off, and a preempt / readmit replay,
    give the same streams as the uninterrupted sharing run."""
    _, _, params, *_ = models["smollm-135m"]
    want = _run(_port("smollm-135m", params), Batch, K)
    off = _port("smollm-135m", params, share_prefix=False)
    assert _run(off, Batch, K) == want
    assert off.counters["prefix_hit_tokens"] == 0
    eng = _port("smollm-135m", params)
    assert _run(eng, Batch, K, preempt=True) == want
    assert eng.counters["preemptions"] == 1


SPILL_ENGINE = dict(max_slots=6, max_len=128, page_size=4)


def _serve(eng, rid, prompt, decode=3):
    assert eng.add_request(rid, prompt, expected_total=len(prompt) + 8)
    out = []
    if eng.reqs[rid].pending:
        b = Batch()
        b.add(rid, K["P"], len(eng.reqs[rid].pending))
        out += eng.execute(b).get(rid, [])
    for _ in range(decode):
        b = Batch()
        b.add(rid, K["D"], 1)
        out += eng.execute(b).get(rid, [])
    eng.finish(rid)
    return out


def _host_leaves(data):
    """The tensors of a ``_page_to_host`` result (or a host entry's)."""
    return [t for seg in data if seg for t in seg["self"].values()]


def test_bf16_spill_on_off_and_prefetch_bit_equal(models):
    """Prompt families served twice on a roomy pool, an undersized one
    with the host tier off and one with it on: equal streams.  On the
    tier-on engine every prefetched page lands on the device bit-equal to
    the bf16 page that was spilled (the spill's host buffers keep the
    leaf's dtype)."""
    _, _, params, *_ = models["smollm-135m"]
    fams = [[1 + 80 * s + v for v in range(9 + 2 * s)] for s in range(4)]
    prompts = [f + [1 + 80 * s + v for v in range(40 + r, 46 + r)]
               for s, f in enumerate(fams) for r in (0, 20)]
    results, landed = {}, []
    for name, over in {"big": dict(total_pages=128, host_spill_pages=0),
                       "small-off": dict(total_pages=20, host_spill_pages=0),
                       "small-on": dict(total_pages=20,
                                        host_spill_pages=64)}.items():
        eng = ServingEngine(get_reduced("smollm-135m"), params, EngineConfig(
            dtype=BF16, **SPILL_ENGINE, **over), device="cpu")
        if name == "small-on":
            kv, flush = eng.kv, eng.kv.flush_prefetch

            def seen_flush(kv=kv, flush=flush):
                pend = list(kv._pending_prefetch)
                n = flush()
                landed.extend((_host_leaves(e.data),
                               _host_leaves(kv._page_to_host(q)))
                              for q, e in pend)
                return n
            kv.flush_prefetch = seen_flush
        results[name] = [_serve(eng, 10 * p + i, pr)
                         for p in range(2) for i, pr in enumerate(prompts)]
        assert all(t.dtype == BF16 for t in _leaves(eng.kv.pools))
        if name == "small-on":
            assert eng.kv.spilled_pages > 0 and eng.kv.prefetched_pages > 0
    assert results["small-off"] == results["big"]
    assert results["small-on"] == results["big"]
    assert landed
    for spilled, on_device in landed:
        assert len(spilled) == len(on_device) > 0
        for a, b in zip(spilled, on_device):
            assert a.dtype == b.dtype == BF16
            assert torch.equal(a.view(torch.int16), b.view(torch.int16))


def test_unserved_dtypes_raise(models):
    """bf16 and float16 over an SSM-bearing model (mamba2, zamba2's
    hybrid) raise, as the reference cannot serve them; float16 pools of a
    model without SSM layers serve; any other dtype raises."""
    for arch in ("mamba2-2.7b", "zamba2-7b"):
        cfg = get_reduced(arch)
        params = init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
        for dtype in (BF16, torch.float16):
            with pytest.raises(NotImplementedError, match="SSM"):
                ServingEngine(cfg, params, EngineConfig(dtype=dtype, **ECFG),
                              device="cpu")
        ServingEngine(cfg, params, EngineConfig(**ECFG), device="cpu")
    _, _, params, *_ = models["smollm-135m"]
    eng = _port("smollm-135m", params, dtype=torch.float16)
    assert all(t.dtype == torch.float16 for t in _leaves(eng.kv.pools))
    with pytest.raises(NotImplementedError):
        _port("smollm-135m", params, dtype=torch.float64)
