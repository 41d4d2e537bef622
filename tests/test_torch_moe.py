"""The port's MoE FFN (``models/moe.py``) against the JAX package on
reduced deepseek-v2 (4 routed experts, top-2, one shared expert), a
wider variant (8 experts, top-3) and reduced phi3.5-moe (4 experts, top-2,
no shared expert): the same numpy-seeded weights and activations through
both, with the serving engine's dropless capacity factor E / k, the
reference's default 2.0, capacity factors small enough that units are
dropped, and the every-expert ``dense`` mode.  Outputs and the aux terms agree to atol
1e-5 (float32 matmuls summed in another order than XLA's).  Also the
full-width three-layer deepseek-v2 cut: the same parameter count and
every parameter's shape as the JAX init (shapes only)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

import repro.configs as jcfgs                                   # noqa: E402
import repro.models as jmodels                                  # noqa: E402
from repro.models import moe as jmoe                            # noqa: E402
from repro.models.config import MoEConfig                       # noqa: E402
from repro_torch.configs import get_config, get_reduced         # noqa: E402
from repro_torch.models import init_params                      # noqa: E402
from repro_torch.models import moe                              # noqa: E402

ARCH = "deepseek-v2-236b"
ATOL = 1e-5
WIDE = MoEConfig(n_experts=8, top_k=3, d_ff_expert=64, n_shared=0)


_jax_moe = jax.jit(jmoe.moe_forward, static_argnums=(2,),
                   static_argnames=("mode", "capacity_factor"))


def _cfg(variant):
    if variant == "phi35":
        arch = "phi3.5-moe-42b-a6.6b"
        return jcfgs.get_reduced(arch), get_reduced(arch)
    jcfg, cfg = jcfgs.get_reduced(ARCH), get_reduced(ARCH)
    if variant == "wide":
        jcfg = dataclasses.replace(jcfg, moe=WIDE)
        cfg = dataclasses.replace(cfg, moe=WIDE)
    return jcfg, cfg


def _weights(cfg, seed):
    """numpy weights with init_moe's shapes and scales."""
    rng = np.random.default_rng(seed)
    m, d = cfg.moe, cfg.d_model
    f = m.d_ff_expert

    def normal(*shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    w = {"router": normal(d, m.n_experts, scale=d ** -0.5),
         "w_gate": normal(m.n_experts, d, f, scale=d ** -0.5),
         "w_up": normal(m.n_experts, d, f, scale=d ** -0.5),
         "w_down": normal(m.n_experts, f, d, scale=f ** -0.5)}
    if m.n_shared:
        w["shared_gate"] = normal(d, m.n_shared * f, scale=d ** -0.5)
        w["shared_up"] = normal(d, m.n_shared * f, scale=d ** -0.5)
        w["shared_down"] = normal(m.n_shared * f, d, scale=f ** -0.5)
    return w


@pytest.mark.parametrize("variant", ["reduced", "wide"])
@pytest.mark.parametrize("cf", ["dropless", None, 0.75, 0.3])
def test_moe_matches_jax(variant, cf):
    jcfg, cfg = _cfg(variant)
    m = cfg.moe
    if cf == "dropless":
        cf = float(m.n_experts) / m.top_k          # the serving engine's
    w = _weights(cfg, seed=m.n_experts)
    B, S = 3, 10
    x = np.random.default_rng(1).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    want, jaux = _jax_moe(jax.tree.map(jnp.asarray, w), jnp.asarray(x), jcfg,
                          capacity_factor=cf)
    tw = {k: torch.from_numpy(v) for k, v in w.items()}
    got, aux = moe.moe_forward(tw, torch.from_numpy(x), cfg,
                               capacity_factor=cf)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(aux["aux_loss"].item(),
                               float(jaux["aux_loss"]), atol=ATOL, rtol=0)
    np.testing.assert_allclose(aux["expert_density"].numpy(),
                               np.asarray(jaux["expert_density"]),
                               atol=ATOL, rtol=0)
    # the small capacity factors really drop units
    T = B * S
    C = moe.capacity(2.0 if cf is None else cf, m.top_k, T, m.n_experts)
    _, _, topi = moe._route(tw, torch.from_numpy(x).reshape(T, -1), m)
    most = int(torch.bincount(topi.reshape(-1), minlength=m.n_experts).max())
    assert (most > C) == (cf is not None and cf < 1.0)


def test_dropless_moe_matches_dense_reference():
    """With E / k the dispatch is exact: the JAX package's every-expert
    ``dense`` mode (its small-shape oracle) gives the same output."""
    jcfg, cfg = _cfg("wide")
    w = _weights(cfg, seed=3)
    x = np.random.default_rng(2).standard_normal(
        (2, 7, cfg.d_model)).astype(np.float32)
    want, _ = _jax_moe(jax.tree.map(jnp.asarray, w), jnp.asarray(x), jcfg,
                       mode="dense")
    got, _ = moe.moe_forward({k: torch.from_numpy(v) for k, v in w.items()},
                             torch.from_numpy(x), cfg,
                             capacity_factor=WIDE.n_experts / WIDE.top_k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("variant", ["reduced", "wide", "phi35"])
def test_dense_mode_matches_jax_and_dropless_dispatch(variant):
    """``mode="dense"`` (every expert on every token, combined by the
    top-k weights) gives the JAX ``mode="dense"`` output and aux terms
    within 1e-5, and the port's dropless dispatch within 1e-5 (the same
    products summed in another order)."""
    jcfg, cfg = _cfg(variant)
    m = cfg.moe
    w = _weights(cfg, seed=5 + m.n_experts)
    x = np.random.default_rng(4).standard_normal(
        (2, 9, cfg.d_model)).astype(np.float32)
    want, jaux = _jax_moe(jax.tree.map(jnp.asarray, w), jnp.asarray(x), jcfg,
                          mode="dense")
    tw = {k: torch.from_numpy(v) for k, v in w.items()}
    got, aux = moe.moe_forward(tw, torch.from_numpy(x), cfg, mode="dense")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(aux["aux_loss"].item(),
                               float(jaux["aux_loss"]), atol=ATOL, rtol=0)
    dispatch, _ = moe.moe_forward(
        tw, torch.from_numpy(x), cfg,
        capacity_factor=moe.dropless_capacity_factor(cfg))
    np.testing.assert_allclose(got.numpy(), dispatch.numpy(), atol=ATOL,
                               rtol=0)
    with pytest.raises(ValueError):
        moe.moe_forward(tw, torch.from_numpy(x), cfg, mode="sparse")


def test_moe_capacity_matches_reference_formula():
    """C = max(1, ceil(cf * k * T / E)), the float expression the reference
    evaluates: the engine's E / k gives C >= T at deepseek's full width."""
    for T in (1, 8, 37, 4096):
        assert moe.capacity(160 / 6, 6, T, 160) >= T
        assert moe.capacity(2.0, 2, T, 4) == max(1, -(-2 * 2 * T // 4))
    assert moe.capacity(0.01, 2, 3, 64) == 1


def test_full_deepseek_cut_shapes_match_jax():
    """The full-width deepseek-v2 cut to three layers (the card's smoke
    test): the same config, parameter count and every parameter's shape as
    the JAX init, without a forward pass (shapes only, on 'meta')."""
    cut = dict(n_layers=3, block_pattern=("mla", "mla_moe", "mla_moe"))
    cfg = dataclasses.replace(get_config(ARCH), **cut)
    jcfg = dataclasses.replace(jcfgs.get_config(ARCH), **cut)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.param_count() == jcfg.param_count()
    assert 9.3e9 < cfg.param_count() < 9.4e9        # 34.8 GiB in float32
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
        assert str(t.dtype) == f"torch.{j.dtype}"
