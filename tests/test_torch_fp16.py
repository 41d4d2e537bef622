"""float16 KV serving (``EngineConfig(dtype=torch.float16)``) in the port
against the JAX package, on the CPU at reduced sizes; the helpers are
``tests/test_torch_bf16.py``'s, over float16 in place of bfloat16.

* The plain versions of the paged kernels (B1 decode, B2 fused prefill,
  B3 fused verify, B4 MLA latent-page prefill) over float16 pools against
  the JAX Pallas kernels in interpret mode on the same numpy-seeded inputs
  (float32 queries and new rows, GQA, a window, mid-page chunk starts, a
  masked lane): outputs agree to atol 1e-5 on valid rows (both read the
  same fp16 values widened to float32; the sums run in another order),
  pools after the write are bit-equal (both round to nearest even).
* The port's engine at ``dtype=torch.float16`` against the JAX engine at
  ``jnp.float16`` on the same weights and batches: smollm-135m (prefix
  hit and copy-on-write) and deepseek-v2 (MLA), and speculative decoding
  with the one-layer draft.  Greedy streams are equal (a difference
  counts only where the reference's top-2 logit margin over fp16 pages is
  below 1e-4: a tie), every pool leaf is float16, the draft's too.
* Inside the port in float16: streams identical with prefix sharing on
  and off, across a preempt replay, and with the host spill tier on and
  off; a prefetched page is bit-equal to the page that was spilled.

The JAX engines are a module-scoped fixture, one per model."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

import repro.configs as jcfgs                                   # noqa: E402
import repro.core.batch as jbatch                               # noqa: E402
import repro.serving.engine as jengine                          # noqa: E402
import test_torch_bf16 as b16                                   # noqa: E402
from repro.kernels import ops                                   # noqa: E402
from repro.kernels.paged_prefill import (                       # noqa: E402
    paged_verify_attention as jax_paged_verify)
from repro_torch.configs import get_reduced                     # noqa: E402
from repro_torch.core.batch import Batch                        # noqa: E402
from repro_torch.kernels import mla_paged_prefill as mk         # noqa: E402
from repro_torch.kernels import paged_attention as pa           # noqa: E402
from repro_torch.kernels import paged_prefill as pp             # noqa: E402
from repro_torch.kernels import paged_verify as pv              # noqa: E402
from repro_torch.serving.engine import (EngineConfig,           # noqa: E402
                                        ServingEngine)
from repro_torch.serving.kvcache import kv_page_bytes           # noqa: E402

F16 = torch.float16
ATOL = b16.ATOL
ECFG = b16.ECFG
K, JK = b16.K, b16.JK
ENGINE_ARCHS = ("smollm-135m", "deepseek-v2-236b")


def _jf(a):
    return b16._jdt(a, F16)


def _tf(a):
    return b16._tdt(a, F16)


# ----------------------- kernels' plain versions ------------------------ #
def test_plain_decode_fp16_matches_pallas():
    """B1 over fp16 pools: smollm's group, a window over pages."""
    B, H, KV, hd, page, max_pages, window = 3, 9, 3, 64, 16, 5, 20
    q, _, _, kp, vp, table = b16._rng_inputs(B + hd, B, 1, H, KV, hd, page,
                                             max_pages, F16)
    q = q[:, 0]
    lens = np.array([1, page + 3, max_pages * page], np.int32)
    want = np.asarray(ops.paged_attention(
        jnp.asarray(q), _jf(kp), _jf(vp), jnp.asarray(table),
        jnp.asarray(lens), window=window, interpret=True))
    n0 = pa.COUNTS["plain"]
    got = pa.paged_decode_attention(torch.from_numpy(q), _tf(kp), _tf(vp),
                                    *b16._t(table, lens), window=window)
    assert pa.COUNTS["plain"] == n0 + 1
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("kernel", ["prefill", "verify"])
def test_plain_prefill_and_verify_fp16_match_pallas(kernel):
    """B2 and B3 write the chunk's rows rounded to fp16 (a mid-page start,
    a full chunk, a masked lane) and attend over them as written."""
    B, S, H, KV, hd, page, max_pages = 3, 8, 6, 2, 32, 8, 4
    pos0 = np.array([3, 8, 0], np.int32)
    clen = np.array([8, 4, 0], np.int32)
    q, kn, vn, kp, vp, table = b16._rng_inputs(S + hd, B, S, H, KV, hd, page,
                                               max_pages, F16)
    jfn = ops.paged_prefill if kernel == "prefill" else jax_paged_verify
    jout, jkp, jvp = jfn(jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn),
                         _jf(kp), _jf(vp), jnp.asarray(table),
                         jnp.asarray(pos0), jnp.asarray(clen), interpret=True)
    mod, fn = ((pp, pp.paged_prefill_attention) if kernel == "prefill"
               else (pv, pv.paged_verify_attention))
    tkp, tvp = _tf(kp), _tf(vp)
    n0 = mod.COUNTS["plain"]
    out, kp2, vp2 = fn(*b16._t(q, kn, vn), tkp, tvp,
                       *b16._t(table, pos0, clen))
    assert mod.COUNTS["plain"] == n0 + 1
    assert kp2 is tkp and kp2.dtype == F16 and out.dtype == torch.float32
    b16._same_pool(kp2, jkp)
    b16._same_pool(vp2, jvp)
    for b in range(B):
        n = int(clen[b])
        np.testing.assert_allclose(out[b, :n].numpy(), np.asarray(jout[b, :n]),
                                   atol=ATOL, rtol=0)
        assert not out[b, n:].any()


def test_plain_mla_fp16_matches_pallas():
    """B4 over fp16 latent pages: a mid-page chunk, an aligned one and a
    masked lane."""
    B, S, H, r, rope, page, max_pages = 3, 8, 4, 32, 16, 8, 5
    rng = np.random.default_rng(5)
    n_pages = B * max_pages + 3

    def f(*s):
        return rng.standard_normal(s).astype(np.float32)
    ql, qr, cn, rn = f(B, S, H, r), f(B, S, H, rope), f(B, S, r), f(B, S, rope)
    cp = b16._round_np(f(n_pages, page, r), F16)
    rp = b16._round_np(f(n_pages, page, rope), F16)
    table = rng.permutation(n_pages)[:B * max_pages].reshape(
        B, max_pages).astype(np.int32)
    pos0, clen = np.array([5, 16, 0], np.int32), np.array([8, 6, 0], np.int32)
    scale = (24 + rope) ** -0.5
    jout, jcp, jrp = ops.mla_paged_prefill(
        *map(jnp.asarray, (ql, qr, cn, rn)), _jf(cp), _jf(rp),
        *map(jnp.asarray, (table, pos0, clen)), scale=scale, interpret=True)
    out, cp2, rp2 = mk.mla_paged_prefill_attention(
        *b16._t(ql, qr, cn, rn), _tf(cp), _tf(rp),
        *b16._t(table, pos0, clen), scale=scale)
    b16._same_pool(cp2, jcp)
    b16._same_pool(rp2, jrp)
    for b in range(B):
        n = int(clen[b])
        np.testing.assert_allclose(out[b, :n].numpy(), np.asarray(jout[b, :n]),
                                   atol=ATOL, rtol=0)
        assert not out[b, n:].any()


# ------------------------------- engines -------------------------------- #
@pytest.fixture(scope="module")
def models():
    """Per architecture: the JAX config and weights, the port's, and the
    JAX engine's float16 streams and counters."""
    out = {}
    for arch in ENGINE_ARCHS:
        jcfg = jcfgs.get_reduced(arch)
        params, jp = b16._weights(arch)
        eng = jengine.ServingEngine(jcfg, jp, jengine.EngineConfig(
            share_prefix=True, dtype=jnp.float16, **ECFG))
        streams = b16._run(eng, jbatch.Batch, JK)
        assert all(x.dtype == jnp.float16
                   for x in jax.tree.leaves(eng.kv.pools))
        out[arch] = (jcfg, jp, params, streams, dict(eng.counters))
    return out


def _port(arch, params, **kw):
    return ServingEngine(get_reduced(arch), params, EngineConfig(
        **{**ECFG, "dtype": F16, **kw}), device="cpu")


@pytest.mark.parametrize("arch", ENGINE_ARCHS)
def test_engine_fp16_streams_match_jax(arch, models):
    jcfg, jp, params, want, jcounters = models[arch]
    eng = _port(arch, params)
    got = b16._run(eng, Batch, K)
    for rid, prompt in b16.PROMPTS.items():
        assert len(got[rid]) > 1
        b16._assert_streams_equal(got[rid], want[rid], prompt, jcfg, jp,
                                  dtype=F16)
    for key in ("prefill_calls", "decode_calls", "decode_tokens",
                "prefix_hit_tokens"):
        assert eng.counters[key] == jcounters[key], key
    assert all(t.dtype == F16 for t in b16._leaves(eng.kv.pools))
    if arch == "smollm-135m":
        assert eng.counters["prefix_hit_tokens"] > 0
        assert eng.kv.partial_head_copies > 0 and eng.kv.cow_copies > 0


def test_spec_decode_fp16_matches_jax(models):
    """Speculative decoding with the one-layer draft (seed 7): equal
    streams and spec counters, both pools float16, and the draft's budget
    charge computed from fp16 page bytes as the reference's is."""
    from repro.serving.kvcache import SharedPageBudget as JBudget
    from repro_torch.serving.kvcache import SharedPageBudget
    arch = "smollm-135m"
    jcfg, jp, params, *_ = models[arch]
    dparams, jdp = b16._weights(b16._draft(get_reduced(arch)), seed=7)
    jbudget = JBudget(512)
    jeng = jengine.ServingEngine(
        jcfg, jp, jengine.EngineConfig(dtype=jnp.float16, **ECFG),
        draft=(b16._draft(jcfg), jdp), kv_budget=jbudget)
    want = b16._spec_run(jeng, jbatch.Batch, JK)
    budget = SharedPageBudget(512)
    eng = ServingEngine(
        get_reduced(arch), params, EngineConfig(dtype=F16, **ECFG),
        draft=(b16._draft(get_reduced(arch)), dparams), kv_budget=budget,
        device="cpu")
    got = b16._spec_run(eng, Batch, K)
    b16._assert_streams_equal(got, want, b16.P_SPEC, jcfg, jp, dtype=F16)
    if got == want:
        for k in ("spec_verify_calls", "spec_draft_calls",
                  "spec_accepted_tokens", "spec_drafted_tokens"):
            assert eng.counters[k] == jeng.counters[k], k
    assert eng.spec.budget_pages == jeng.spec.budget_pages > 0
    assert budget.used == jbudget.used
    assert all(t.dtype == F16 for t in b16._leaves(eng.kv.pools)
               + b16._leaves(eng.spec.kv.pools))
    cfg = get_reduced(arch)
    assert 2 * kv_page_bytes(cfg, 16, F16) == kv_page_bytes(cfg, 16)


# --------------------------- inside the port ---------------------------- #
def test_fp16_streams_identical_sharing_preempt(models):
    """In float16: prefix sharing on and off, and a preempt / readmit
    replay, give the same streams as the uninterrupted sharing run."""
    _, _, params, *_ = models["smollm-135m"]
    want = b16._run(_port("smollm-135m", params), Batch, K)
    off = _port("smollm-135m", params, share_prefix=False)
    assert b16._run(off, Batch, K) == want
    assert off.counters["prefix_hit_tokens"] == 0
    eng = _port("smollm-135m", params)
    assert b16._run(eng, Batch, K, preempt=True) == want
    assert eng.counters["preemptions"] == 1


def test_fp16_spill_on_off_and_prefetch_bit_equal(models):
    """Prompt families served on a roomy pool, an undersized one with the
    host tier off and one with it on: equal streams; every prefetched page
    lands on the device bit-equal to the fp16 page that was spilled."""
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
            dtype=F16, **b16.SPILL_ENGINE, **over), device="cpu")
        if name == "small-on":
            kv, flush = eng.kv, eng.kv.flush_prefetch

            def seen_flush(kv=kv, flush=flush):
                pend = list(kv._pending_prefetch)
                n = flush()
                landed.extend((b16._host_leaves(e.data),
                               b16._host_leaves(kv._page_to_host(q)))
                              for q, e in pend)
                return n
            kv.flush_prefetch = seen_flush
        results[name] = [b16._serve(eng, 10 * p + i, pr)
                         for p in range(2) for i, pr in enumerate(prompts)]
        assert all(t.dtype == F16 for t in b16._leaves(eng.kv.pools))
        if name == "small-on":
            assert eng.kv.spilled_pages > 0 and eng.kv.prefetched_pages > 0
    assert results["small-off"] == results["big"]
    assert results["small-on"] == results["big"]
    assert landed
    for spilled, on_device in landed:
        assert len(spilled) == len(on_device) > 0
        for a, b in zip(spilled, on_device):
            assert a.dtype == b.dtype == F16
            assert torch.equal(a.view(torch.int16), b.view(torch.int16))
