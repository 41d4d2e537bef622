"""Dense fixed-buffer caches (``init_cache``: ``{"k", "v"}`` per attention
layer, ``{"ckv", "krope"}`` per MLA layer, SSM lane rows) in the port, on
the CPU at reduced sizes.

* Against the full forward, as ``tests/test_models.py`` holds the
  reference: an 8-token prefill then token-by-token decode equals the
  no-cache forward over the whole sequence (every ported block kind: GQA,
  a sliding window, MoE, MLA with MoE, Mamba2, the zamba2 hybrid, whisper
  with encoder states, the VLM with image states), and two prefill chunks
  equal one.
* Against the JAX package on the same weights (the port's seeded init,
  handed to JAX as numpy): the hidden states of a prefill and two decode
  steps, and every cache buffer after them, for smollm, deepseek-v2 with
  the absorbed (``mla_absorb``) MLA decode, and mamba2.
* The absorbed MLA decode equals the naive one
  (``tests/test_perf_variants.py``), so both hold against JAX.

Hidden states agree to atol 1e-4 (float32 through two layers whose sums
run in another order); MoE runs dropless (capacity factor E / k), as the
serving engine and the reference's tests do."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

import repro.configs as jcfgs                                   # noqa: E402
import repro.models as jmodels                                  # noqa: E402
from repro_torch.configs import get_reduced                     # noqa: E402
from repro_torch.device import generator                        # noqa: E402
from repro_torch.models import (encoder_forward, init_cache,    # noqa: E402
                                init_encdec_params, init_params,
                                model_forward)
from repro_torch.models.moe import dropless_capacity_factor     # noqa: E402
from repro_torch.training.tree import flatten, tree_map         # noqa: E402

ATOL = 1e-4
B, S, PRE, MAX_LEN = 2, 12, 8, 32

_jax_forward = jax.jit(jmodels.model_forward, static_argnums=(1,),
                       static_argnames=("moe_cf",))


def _setup(arch, cfg=None):
    cfg = cfg or get_reduced(arch)
    gen = generator(torch.device("cpu"), 0)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, 16))).long()
    enc = None
    if cfg.arch_type == "encdec":
        params = init_encdec_params(cfg, gen, device="cpu")
        frames = torch.from_numpy(rng.standard_normal(
            (B, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32))
        enc = encoder_forward(params["encoder"], cfg, frames)
    else:
        params = init_params(cfg, gen, device="cpu")
        if cfg.arch_type == "vlm":
            enc = torch.from_numpy(rng.standard_normal(
                (B, cfg.n_image_tokens, cfg.d_model)).astype(np.float32))
    return cfg, params, toks, enc


def _decode(params, cfg, toks, enc, cache, pre=PRE):
    """Prefill toks[:, :pre], then one token at a time; the hidden
    states of every position."""
    cf = dropless_capacity_factor(cfg)
    h, _, _ = model_forward(params, cfg, toks[:, :pre], cache=cache,
                            pos0=torch.zeros(B, dtype=torch.int32),
                            enc_states=enc, moe_cf=cf)
    hs = [h]
    for t in range(pre, toks.shape[1]):
        h, _, _ = model_forward(params, cfg, toks[:, t:t + 1], cache=cache,
                                pos0=torch.full((B,), t, dtype=torch.int32),
                                enc_states=enc, moe_cf=cf)
        hs.append(h)
    return torch.cat(hs, 1)


@pytest.mark.parametrize("arch", [
    "smollm-135m", "qwen3-1.7b-swa", "phi3.5-moe-42b-a6.6b",
    "deepseek-v2-236b", "mamba2-2.7b", "zamba2-7b", "whisper-large-v3",
    "llama-3.2-vision-11b"])
def test_incremental_decode_matches_full(arch):
    cfg, params, toks, enc = _setup(arch)
    toks = toks[:, :S]
    with torch.no_grad():
        full, _, _ = model_forward(params, cfg, toks, enc_states=enc,
                                   moe_cf=dropless_capacity_factor(cfg))
        got = _decode(params, cfg, toks, enc, init_cache(
            cfg, B, MAX_LEN, device="cpu"))
    np.testing.assert_allclose(got.numpy(), full.numpy(), atol=ATOL)


@pytest.mark.parametrize("arch", ["smollm-135m", "deepseek-v2-236b",
                                  "mamba2-2.7b", "zamba2-7b"])
def test_chunked_prefill_matches_full(arch):
    cfg, params, toks, enc = _setup(arch)
    cf = dropless_capacity_factor(cfg)
    zeros = torch.zeros(B, dtype=torch.int32)
    with torch.no_grad():
        one, _, _ = model_forward(params, cfg, toks, cache=init_cache(
            cfg, B, MAX_LEN, device="cpu"), pos0=zeros, moe_cf=cf)
        cache = init_cache(cfg, B, MAX_LEN, device="cpu")
        a, _, _ = model_forward(params, cfg, toks[:, :8], cache=cache,
                                pos0=zeros, moe_cf=cf)
        b, _, _ = model_forward(params, cfg, toks[:, 8:], cache=cache,
                                pos0=torch.full((B,), 8, dtype=torch.int32),
                                moe_cf=cf)
    np.testing.assert_allclose(torch.cat([a, b], 1).numpy(), one.numpy(),
                               atol=ATOL)


@pytest.mark.parametrize("arch,absorb", [
    ("smollm-135m", False), ("deepseek-v2-236b", True),
    ("mamba2-2.7b", False)])
def test_dense_cache_matches_jax(arch, absorb):
    cfg = dataclasses.replace(get_reduced(arch), mla_absorb=absorb)
    jcfg = dataclasses.replace(jcfgs.get_reduced(arch), mla_absorb=absorb)
    cfg, params, toks, _ = _setup(arch, cfg)
    toks = toks[:, :PRE + 2]
    jp = tree_map(lambda t: jnp.asarray(t.numpy().copy()), params)
    cf = dropless_capacity_factor(cfg)
    jcache = jmodels.init_cache(jcfg, B, MAX_LEN)
    jh = []
    for lo, hi in ((0, PRE), (PRE, PRE + 1), (PRE + 1, PRE + 2)):
        h, jcache, _ = _jax_forward(
            jp, jcfg, jnp.asarray(toks[:, lo:hi].numpy(), jnp.int32),
            cache=jcache, pos0=jnp.full((B,), lo, jnp.int32), moe_cf=cf)
        jh.append(np.asarray(h))
    cache = init_cache(cfg, B, MAX_LEN, device="cpu")
    with torch.no_grad():
        got = _decode(params, cfg, toks, None, cache)
    np.testing.assert_allclose(got.numpy(), np.concatenate(jh, 1),
                               atol=ATOL)
    paths, leaves = flatten(cache)
    jpaths, jleaves = flatten(jcache)
    assert paths == jpaths
    for path, a, b in zip(paths, leaves, jleaves):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   err_msg=path)


def test_mla_absorb_matches_naive_decode():
    base = get_reduced("deepseek-v2-236b")
    _, params, toks, _ = _setup("deepseek-v2-236b")
    outs = []
    with torch.no_grad():
        for cfg in (base, dataclasses.replace(base, mla_absorb=True)):
            outs.append(_decode(params, cfg, toks[:, :S], None,
                                init_cache(cfg, B, MAX_LEN, device="cpu")))
    np.testing.assert_allclose(outs[1].numpy(), outs[0].numpy(), atol=ATOL)


def test_dense_write_clamps_like_dynamic_update_slice():
    """A chunk that would run past the buffer's end lands at its end, as
    ``lax.dynamic_update_slice`` clamps the start."""
    from repro_torch.models.attention import dense_write
    buf = torch.zeros(2, 6, 1)
    vals = torch.arange(1, 7, dtype=torch.float32).reshape(2, 3, 1)
    dense_write(buf, vals, torch.tensor([1, 5]))
    want = jax.vmap(lambda b, v, s: jax.lax.dynamic_update_slice(
        b, v, (s, 0)))(jnp.zeros((2, 6, 1)), jnp.asarray(vals.numpy()),
                       jnp.asarray([1, 5]))
    np.testing.assert_array_equal(buf.numpy(), np.asarray(want))
