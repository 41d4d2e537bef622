"""The port's decoder against the JAX reference on bridged weights:
logits of ``model_forward`` in full-causal, chunked-prefill-over-pages and
1-token-decode modes (atol 1e-4: float32 through a few layers whose
matmuls sum in another order than XLA's), and the full smollm-135m
config's parameter count and shapes."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

import repro.configs as jcfgs                                   # noqa: E402
import repro.models as jmodels                                  # noqa: E402
from repro_torch import bridge                                  # noqa: E402
from repro_torch.configs import get_config, get_reduced        # noqa: E402
from repro_torch.models import (init_paged_cache, init_params,  # noqa: E402
                                logits_fn, model_forward)

ATOL = 1e-4
PAGE, N_PAGES, MAX_PAGES = 8, 24, 12


# jitted so that the two equal-shaped chunk calls share one compile
_jax_forward = jax.jit(jmodels.model_forward, static_argnums=(1,))


# the reference init jitted: one compile for the whole tree instead of one
# per eager op (seconds per model); its values agree with the eager init's
# to an ulp, and both sides of every comparison get the same numbers
_jax_init = jax.jit(jmodels.init_params, static_argnums=(1,))


def _jax_model(arch):
    jcfg = jcfgs.get_reduced(arch)
    jparams = _jax_init(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        device="cpu")
    return jcfg, jparams, get_reduced(arch), tparams


@pytest.mark.parametrize("arch", ["smollm-135m", "qwen3-1.7b-swa"])
def test_logits_match_jax(arch):
    """Full causal; then two chunked-prefill calls over pages (the second
    starting mid-page, one lane padded) and a 1-token decode; the
    qwen3-swa-reduced window (64) is crossed by the 90-token context."""
    jcfg, jparams, cfg, tparams = _jax_model(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    rng = np.random.default_rng(0)
    B, L1, L2 = 2, 44, 44          # equal chunks share one JAX compile
    toks = rng.integers(0, cfg.vocab, (B, L1 + L2 + 1)).astype(np.int32)

    h, _, _ = _jax_forward(jparams, jcfg, jnp.asarray(toks))
    want = np.asarray(jmodels.logits_fn(jparams, jcfg, h))
    th, _, _ = model_forward(tparams, cfg, torch.from_numpy(toks).long())
    np.testing.assert_allclose(logits_fn(tparams, cfg, th).numpy(), want,
                               atol=ATOL, rtol=0)

    # paged: lane b owns pages [b*MAX_PAGES, (b+1)*MAX_PAGES)
    table = np.arange(B * MAX_PAGES, dtype=np.int32).reshape(B, MAX_PAGES)
    jcache = jmodels.init_paged_cache(jcfg, N_PAGES, PAGE, B)
    tcache = init_paged_cache(cfg, N_PAGES, PAGE, device="cpu")
    clen2 = np.array([L2, L2 - 5], np.int32)             # lane 1 padded
    steps = [(toks[:, :L1], np.zeros(B, np.int32), np.full(B, L1, np.int32)),
             (toks[:, L1:L1 + L2], np.full(B, L1, np.int32), clen2)]
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
            np.testing.assert_allclose(got[b, :n], want[b, :n], atol=ATOL,
                                       rtol=0)
    pools = bridge.pools_to_numpy(tcache)
    jpools = jax.tree.map(np.asarray, jcache)
    for a, b in zip(jax.tree.leaves(pools), jax.tree.leaves(jpools)):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)

    # 1-token decode at each lane's frontier
    pos0 = (L1 + clen2).astype(np.int32)
    x = toks[np.arange(B), pos0][:, None]
    one = np.ones(B, np.int32)
    h, _, _ = _jax_forward(
        jparams, jcfg, jnp.asarray(x), cache=jcache, pos0=jnp.asarray(pos0),
        block_tables=jnp.asarray(table), chunk_len=jnp.asarray(one))
    want = np.asarray(jmodels.logits_fn(jparams, jcfg, h))
    th, _, _ = model_forward(tparams, cfg, torch.from_numpy(x).long(),
                          cache=tcache, pos0=torch.from_numpy(pos0),
                          block_tables=torch.from_numpy(table),
                          chunk_len=torch.from_numpy(one))
    np.testing.assert_allclose(logits_fn(tparams, cfg, th).numpy(), want,
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "command-r-plus-104b",
                                  "opt-125m"])
def test_dense_zoo_logits_match_jax(arch):
    """The rest of the dense zoo (its block kinds are the main path's):
    the registry serves each config as the reference defines it, and
    full-causal logits of the reduced config match on bridged weights."""
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(jcfgs.get_config(arch))
    jcfg, jparams, cfg, tparams = _jax_model(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 40))
    h, _, _ = _jax_forward(jparams, jcfg, jnp.asarray(toks, jnp.int32))
    want = np.asarray(jmodels.logits_fn(jparams, jcfg, h))
    th, _, _ = model_forward(tparams, cfg, torch.from_numpy(toks).long())
    np.testing.assert_allclose(logits_fn(tparams, cfg, th).numpy(), want,
                               atol=ATOL, rtol=0)


def test_full_smollm_shapes_match_jax():
    """Full-width smollm-135m: the same config, parameter count and every
    parameter's shape, without a forward pass (shapes only, on 'meta')."""
    cfg = get_config("smollm-135m")
    jcfg = jcfgs.get_config("smollm-135m")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.param_count() == jcfg.param_count()
    jshapes = jax.eval_shape(lambda k: jmodels.init_params(k, jcfg),
                             jax.random.PRNGKey(0))
    tparams = init_params(cfg, torch.Generator(), device="meta")
    flat = jax.tree_util.tree_flatten_with_path(jshapes)[0]
    tflat = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t, tparams,
                     is_leaf=lambda t: isinstance(t, torch.Tensor)))[0]
    assert [jax.tree_util.keystr(p) for p, _ in flat] == \
        [jax.tree_util.keystr(p) for p, _ in tflat]
    for (_, j), (_, t) in zip(flat, tflat):
        assert tuple(j.shape) == tuple(t.shape)
