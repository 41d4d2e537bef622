"""The port's training path (``repro_torch.training``, ``launch/train.py``
and ``model_forward(train=True)``) against the JAX package, on the CPU at
reduced sizes.

* ``lr_schedule`` at step 0, mid-warmup, the end of warmup, mid-decay, the
  last step and past it; three ``adamw_update`` steps on the same arrays
  (clipping active, matrices decayed, vectors not): params and moments
  within atol 1e-6.
* ``batches`` gives the reference's arrays for the same seed.
* A checkpoint round trip is bit-equal; a template of another shape
  raises.
* ``lm_loss`` and its gradient on the same weights (the port's seeded
  init, handed to JAX as numpy) for smollm, phi3.5-moe, mamba2 and
  deepseek-v2 reduced (MLA with MoE, capacity 2.0 as in training): the
  loss and every gradient leaf within atol 1e-4, and no kernel wrapper
  called (neither the kernel nor its plain version).
* One ``train_step`` against JAX's jitted ``make_train_step``: metrics
  (rel 1e-5), moments (atol 1e-6) and new params (atol 1e-6 wherever the
  gradient is above 1e-5, the step's bound elsewhere: the comment at the
  check).
* remat on and off: loss within rel 1e-5, ``grad_norm`` within rel 1e-4
  (``tests/test_perf_variants.py``'s bounds).
* ``sdpa_chunked`` against ``sdpa`` and the reference's ``sdpa_chunked``,
  with and without a window; ``attn_impl="chunked"`` against ``"naive"``
  at the model level.
* The port's own training: the loss falls by 0.25 or more for dense, MoE
  and SSM (``tests/test_training.py``'s bar), and the launcher runs.
* Every kernel wrapper (B1-B6) refuses an input that requires grad.

The JAX sides are jitted once per model (a compile is cheaper than eager
dispatch here)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

import repro.configs as jcfgs                                   # noqa: E402
import repro.training.data as jdata                             # noqa: E402
import repro.training.optimizer as jopt                         # noqa: E402
import repro.training.train_loop as jloop                       # noqa: E402
from repro.models.attention import sdpa_chunked as jax_sdpa_chunked  # noqa
from repro_torch.configs import get_reduced                     # noqa: E402
from repro_torch.device import generator                        # noqa: E402
from repro_torch.kernels import flash_attention as fa           # noqa: E402
from repro_torch.kernels import mla_paged_prefill as mk         # noqa: E402
from repro_torch.kernels import paged_attention as pa           # noqa: E402
from repro_torch.kernels import paged_prefill as pp             # noqa: E402
from repro_torch.kernels import paged_verify as pv              # noqa: E402
from repro_torch.kernels import ssd_scan as sk                  # noqa: E402
from repro_torch.launch import train as launch_train            # noqa: E402
from repro_torch.models import init_params, model_forward       # noqa: E402
from repro_torch.models.attention import (causal_mask, sdpa,    # noqa: E402
                                          sdpa_chunked)
from repro_torch.training import data, optimizer, train_loop    # noqa: E402
from repro_torch.training.checkpoint import (latest_step,       # noqa: E402
                                             restore_checkpoint,
                                             save_checkpoint)
from repro_torch.training.tree import flatten, leaves, tree_map  # noqa: E402

ATOL = 1e-4
KERNELS = (pa, pp, pv, mk, sk, fa)
LOSS_ARCHS = ["smollm-135m", "phi3.5-moe-42b-a6.6b", "mamba2-2.7b",
              "deepseek-v2-236b"]


def _np(tree):
    """Numpy copies: a view would let an in-place update of the port's
    tensors reach JAX arrays that alias it (JAX dispatches asynchronously
    and may not have read them yet)."""
    return tree_map(lambda t: t.detach().numpy().copy(), tree)


def _tokens(cfg, B=2, S=16, seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
            for k in ("tokens", "labels")}


def _torch_batch(b):
    return {k: torch.from_numpy(v).long() for k, v in b.items()}


def _model(arch, seed=0):
    cfg = get_reduced(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jcfgs.get_reduced(arch))
    params = init_params(cfg, generator(torch.device("cpu"), seed),
                         device="cpu")
    return cfg, params


def _close(got_tree, want_tree, atol):
    gp, gl = flatten(got_tree)
    wp, wl = flatten(want_tree)
    assert gp == wp
    for path, g, w in zip(gp, gl, wl):
        np.testing.assert_allclose(np.asarray(g.detach()), np.asarray(w),
                                   atol=atol, rtol=0, err_msg=path)


# ------------------------- optimizer and data --------------------------- #
def test_lr_schedule_matches_jax():
    cfg = optimizer.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    jcfg = jopt.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    fn, jfn = optimizer.lr_schedule(cfg), jopt.lr_schedule(jcfg)
    for step in (0, 5, 10, 55, 100, 150):
        assert float(fn(step)) == pytest.approx(float(jfn(step)), rel=1e-6,
                                                abs=1e-12), step
    assert float(fn(0)) == 0.0
    assert float(fn(100)) == pytest.approx(1e-4, rel=1e-5)


def test_adamw_update_matches_jax():
    rng = np.random.default_rng(1)

    def draw(scale):
        def a(*shape):
            return (rng.standard_normal(shape) * scale).astype(np.float32)
        return {"w": a(4, 5), "b": a(5), "stack": [a(2, 3, 4), a(3)]}
    params = draw(1.0)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1)
    cfg, jcfg = optimizer.AdamWConfig(**kw), jopt.AdamWConfig(**kw)
    tp = tree_map(torch.from_numpy, params)   # updated in place: JAX gets
    jp = tree_map(lambda a: jnp.asarray(a.copy()), params)   # its own copy
    ts, js = optimizer.init_opt_state(tp), jopt.init_opt_state(jp)
    jupdate = jax.jit(jopt.adamw_update, static_argnums=0)
    for _ in range(3):
        grads = draw(3.0)                       # global norm > grad_clip
        tp, ts, tm = optimizer.adamw_update(
            cfg, tp, tree_map(torch.from_numpy, grads), ts)
        jp, js, jm = jupdate(jcfg, jp, tree_map(jnp.asarray, grads), js)
        assert float(jm["grad_norm"]) > cfg.grad_clip
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-6)
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
        _close(tp, jp, 1e-6)
        _close({"mu": ts["mu"], "nu": ts["nu"]},
               {"mu": js["mu"], "nu": js["nu"]}, 1e-6)
        assert int(ts["step"]) == int(js["step"])


def test_batches_match_reference():
    for seed in (0, 3):
        it, jit_ = data.batches(100, 4, 16, seed), jdata.batches(100, 4, 16,
                                                                 seed)
        for _ in range(3):
            b, jb = next(it), next(jit_)
            for k in ("tokens", "labels"):
                assert b[k].dtype == jb[k].dtype
                np.testing.assert_array_equal(b[k], jb[k])


def test_unflatten_keeps_no_reference_to_its_leaves():
    """A step's gradients are freed when the step returns, without the
    cyclic collector (a recursive closure in ``unflatten`` kept them for
    a phi3.5-moe step on the card: 10.7 GB each)."""
    import gc
    import weakref
    from repro_torch.training.tree import unflatten
    t = torch.zeros(3)
    ref = weakref.ref(t)
    enabled = gc.isenabled()
    gc.disable()
    try:
        out = unflatten({"a": [1], "b": {"c": 2}}, [t, torch.ones(1)])
        assert out["a"][0] is t
        del t, out
        assert ref() is None
    finally:
        if enabled:
            gc.enable()


def test_checkpoint_round_trip(tmp_path):
    cfg, params = _model("phi3.5-moe-42b-a6.6b")
    opt = optimizer.init_opt_state(params)
    opt["mu"] = tree_map(lambda t: t + 1.5, opt["mu"])
    save_checkpoint(str(tmp_path), 5, params, opt)
    save_checkpoint(str(tmp_path), 7, params, opt)
    assert latest_step(str(tmp_path)) == 7
    template = {"params": params, "opt_state": opt}
    restored, step = restore_checkpoint(str(tmp_path), template, step=5)
    assert step == 5
    paths, got = flatten(restored)
    assert paths == flatten(template)[0]
    for a, b in zip(got, leaves(template)):
        assert a.dtype == b.dtype and a.device == b.device
        assert torch.equal(a, b)
    bad = {"params": dict(params, final_norm={"scale": torch.ones(3)}),
           "opt_state": opt}
    with pytest.raises(ValueError):
        restore_checkpoint(str(tmp_path), bad)


# ------------------------- loss and gradients --------------------------- #
@pytest.fixture(scope="module")
def grads_vs_jax():
    """Per arch: (port loss, parts, grads, kernel counts before/after) and
    the reference's jitted value_and_grad on the same weights and batch."""
    out = {}
    for arch in LOSS_ARCHS:
        cfg, params = _model(arch)
        b = _tokens(cfg)
        jcfg = jcfgs.get_reduced(arch)
        jp = tree_map(jnp.asarray, _np(params))

        def jloss(p, jcfg=jcfg, b=b):
            return jloop.lm_loss(p, jcfg, jnp.asarray(b["tokens"]),
                                 jnp.asarray(b["labels"]))
        (jl, jparts), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
            jp)
        before = [dict(m.COUNTS) for m in KERNELS]
        loss, parts, grads = train_loop.loss_and_grads(
            train_loop.trainable(params), cfg, _torch_batch(b))
        after = [dict(m.COUNTS) for m in KERNELS]
        out[arch] = (loss, parts, grads, before, after, jl, jparts, jg)
    return out


@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_loss_and_grads_match_jax(grads_vs_jax, arch):
    loss, parts, grads, before, after, jl, jparts, jg = grads_vs_jax[arch]
    assert before == after            # no kernel, no plain version
    assert float(loss) == pytest.approx(float(jl), abs=ATOL)
    for k in ("nll", "aux"):
        assert float(parts[k]) == pytest.approx(float(jparts[k]), abs=ATOL)
    if get_reduced(arch).moe:
        assert float(parts["aux"]) > 0
    _close(grads, jg, ATOL)


def test_train_step_matches_jax():
    cfg, params = _model("smollm-135m", seed=2)
    b = _tokens(cfg, seed=2)
    kw = dict(lr=1e-3, total_steps=10, warmup_steps=2)
    jp = tree_map(jnp.asarray, _np(params))
    jstate = jopt.init_opt_state(jp)
    jp2, js2, jm = jax.jit(jloop.make_train_step(
        jcfgs.get_reduced("smollm-135m"), jopt.AdamWConfig(**kw)))(
            jp, jstate, tree_map(jnp.asarray, b))
    tp = train_loop.trainable(params)
    step = train_loop.make_train_step(cfg, optimizer.AdamWConfig(**kw))
    tp2, ts2, tm = step(tp, optimizer.init_opt_state(tp), _torch_batch(b))
    assert tp2 is tp                                     # in place
    assert sorted(tm) == sorted(jm) == ["aux", "grad_norm", "loss", "lr",
                                        "nll"]
    for k in tm:
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-5,
                                             abs=1e-7), k
    _close({"mu": ts2["mu"], "nu": ts2["nu"]},
           {"mu": js2["mu"], "nu": js2["nu"]}, 1e-6)
    # The first step moves a parameter by lr * g / (|g| + eps) plus decay.
    # Where the clipped gradient is below 1e-5 (mu = 0.1 g below 1e-6) a
    # float32 difference of 1e-9 in g moves that by up to 1e-4 / |g| of lr,
    # so there atol 1e-6 cannot hold; there each step must go the way the
    # reference's goes wherever that is 0.1 lr or more (the float
    # difference moved one element by 0.07 lr), and the step's size is
    # bounded by 2 lr.  Elsewhere atol 1e-6.
    lr = float(tm["lr"])
    for (path, p), q, q0, mu in zip(zip(*flatten(tp2)), leaves(jp2),
                                    leaves(jp), leaves(js2["mu"])):
        p, q, q0 = p.detach().numpy(), np.asarray(q), np.asarray(q0)
        big = np.abs(mu) > 1e-6
        assert big.mean() > 0.9, path
        np.testing.assert_allclose(p[big], q[big], atol=1e-6, err_msg=path)
        moved = ~big & (np.abs(q - q0) >= 0.1 * lr)
        np.testing.assert_array_equal(np.sign(p - q0)[moved],
                                      np.sign(q - q0)[moved], err_msg=path)
        np.testing.assert_allclose(p, q, atol=2 * lr, err_msg=path)
    assert int(ts2["step"]) == int(js2["step"]) == 1


@pytest.mark.parametrize("arch", ["smollm-135m", "phi3.5-moe-42b-a6.6b",
                                  "mamba2-2.7b"])
def test_remat_same_loss_and_grads(arch):
    cfg, params = _model(arch, seed=3)
    b = _torch_batch(_tokens(cfg, seed=3))
    params = train_loop.trainable(params)
    got = {}
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        loss, _, grads = train_loop.loss_and_grads(params, c, b)
        got[remat] = (float(loss), float(optimizer.global_norm(grads)))
    assert got[True][0] == pytest.approx(got[False][0], rel=1e-5)
    assert got[True][1] == pytest.approx(got[False][1], rel=1e-4)


# ------------------------------ attention ------------------------------- #
@pytest.mark.parametrize("window", [None, 8])
def test_sdpa_chunked_matches_sdpa_and_jax(window):
    rng = np.random.default_rng(4)
    B, Sq, Sk, H, KV, hd = 2, 16, 60, 4, 2, 32
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd)))
    pos0 = np.array([40, 20], np.int32)
    kv_len = pos0 + Sq
    t = [torch.from_numpy(a) for a in (q, k, v, pos0, kv_len)]
    want = sdpa(*t[:3], causal_mask(B, Sq, Sk, t[3], t[4], window))
    got = sdpa_chunked(*t[:3], pos0=t[3], kv_len=t[4], window=window,
                       chunk=16)                        # 60 keys: one padded
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    jk, jv = (np.repeat(a, H // KV, axis=2) for a in (k, v))
    jwant = jax_sdpa_chunked(jnp.asarray(q), jnp.asarray(jk), jnp.asarray(jv),
                             pos0=jnp.asarray(pos0),
                             kv_len=jnp.asarray(kv_len), window=window,
                             chunk=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant), atol=1e-5)


def test_chunked_model_matches_naive_model():
    base, params = _model("qwen3-1.7b")
    opt = dataclasses.replace(base, attn_impl="chunked", attn_chunk=8)
    toks = torch.from_numpy(_tokens(base, S=24)["tokens"]).long()
    h_base, _, _ = model_forward(params, base, toks, train=True)
    h_opt, _, _ = model_forward(params, opt, toks, train=True)
    np.testing.assert_allclose(h_opt.numpy(), h_base.numpy(), atol=ATOL)
    # without train the no-cache call is B6's (its plain version here)
    h_kernel, _, _ = model_forward(params, base, toks)
    np.testing.assert_allclose(h_kernel.numpy(), h_base.numpy(), atol=ATOL)


# ------------------------------ training -------------------------------- #
_OPT = optimizer.AdamWConfig(lr=3e-3, total_steps=120, warmup_steps=5)


# the reference's settings (120 steps); MoE clears the bar in 60 steps
# (by 0.5) and SSM in 30 (by 0.9), which cuts their share of the time
@pytest.mark.parametrize("arch,seq_len,steps", [
    ("smollm-135m", 32, 120), ("phi3.5-moe-42b-a6.6b", 16, 60),
    ("mamba2-2.7b", 32, 30)])
def test_port_training_loss_falls(arch, seq_len, steps):
    before = [dict(m.COUNTS) for m in KERNELS]
    opt = dataclasses.replace(_OPT, total_steps=steps)
    res = train_loop.train(get_reduced(arch), steps=steps, batch=8,
                           seq_len=seq_len, seed=0, opt_cfg=opt,
                           device="cpu")
    assert [dict(m.COUNTS) for m in KERNELS] == before
    assert all(np.isfinite(res.losses))
    assert res.losses[-1] < res.losses[0] - 0.25, res.losses
    assert len(res.logged_at) == len(res.losses) == steps // 10 + 1


def test_launcher_trains_and_checkpoints(tmp_path, capsys):
    res = launch_train.main(["--device", "cpu", "--steps", "4", "--batch",
                             "2", "--seq-len", "16", "--checkpoint-dir",
                             str(tmp_path), "--checkpoint-every", "2"])
    assert res.steps == 4 and len(res.losses) == 2
    assert capsys.readouterr().out.startswith(
        "arch=smollm-135m-reduced steps=4 loss ")
    assert latest_step(str(tmp_path)) == 4


def test_train_raises_without_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        train_loop.train(get_reduced("smollm-135m"), steps=1)


# ------------------------------- guard ---------------------------------- #
def _kernel_calls():
    g = torch.Generator().manual_seed(5)

    def r(*s):
        return torch.randn(*s, generator=g)
    table = torch.tensor([[0, 1]], dtype=torch.int32)
    pos0, one = torch.tensor([3], dtype=torch.int32), torch.ones(
        1, dtype=torch.int32) * 2
    kp, vp = r(2, 4, 1, 16), r(2, 4, 1, 16)
    return {
        "paged_decode_attention": lambda q: pa.paged_decode_attention(
            q, kp, vp, table, torch.tensor([5], dtype=torch.int32)),
        "paged_prefill_attention": lambda q: pp.paged_prefill_attention(
            q, r(1, 2, 1, 16), r(1, 2, 1, 16), kp.clone(), vp.clone(), table,
            pos0, one),
        "paged_verify_attention": lambda q: pv.paged_verify_attention(
            q, r(1, 2, 1, 16), r(1, 2, 1, 16), kp.clone(), vp.clone(), table,
            pos0, one),
        "mla_paged_prefill_attention":
            lambda q: mk.mla_paged_prefill_attention(
                q, r(1, 2, 2, 8), r(1, 2, 16), r(1, 2, 8), r(2, 4, 16),
                r(2, 4, 8), table, pos0, one, scale=0.2),
        "ssd_scan": lambda q: sk.ssd_scan(
            q.reshape(1, 8, 2, 4), r(1, 8, 2).abs(), -r(2).abs(), r(1, 8, 4),
            r(1, 8, 4), chunk=4),
        "flash_attention_bh": lambda q: fa.flash_attention_bh(
            q.reshape(2, 2, 8), r(2, 5, 8), r(2, 5, 8)),
        "attention": lambda q: fa.attention(
            q.reshape(1, 2, 2, 8), r(1, 5, 1, 8), r(1, 5, 1, 8)),
    }


QSHAPES = {"paged_decode_attention": (1, 2, 16),
           "paged_prefill_attention": (1, 2, 2, 16),
           "paged_verify_attention": (1, 2, 2, 16),
           "mla_paged_prefill_attention": (1, 2, 2, 16),
           "ssd_scan": (64,), "flash_attention_bh": (32,),
           "attention": (32,)}


@pytest.mark.parametrize("name", sorted(QSHAPES))
def test_kernel_wrappers_refuse_inputs_that_require_grad(name):
    call = _kernel_calls()[name]
    q = torch.randn(*QSHAPES[name], requires_grad=True)
    with pytest.raises(RuntimeError, match="requires grad"):
        call(q)
    with torch.no_grad():
        call(q)
    call(q.detach())
