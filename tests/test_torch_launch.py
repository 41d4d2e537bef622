"""The port's launch layer (``repro_torch.launch.{mesh,steps,dryrun,
roofline,cost_analysis}``) and the training section of
``distributed/sharding.py`` against the JAX reference, on the CPU:

* ``param_spec`` (modes fsdp and tp), ``params_shardings``, ``batch_spec``
  and ``cache_shardings`` on every reduced config's parameter and
  ``init_cache`` trees equal ``tuple(spec)`` of the reference's on
  ``AbstractMesh``es of 16 x 16, 2 x 16 x 16 (with "pod") and 2 x 2 (no
  devices: JAX's ``eval_shape`` trees and the port's meta trees);
* ``steps.make_train_step(microbatches=2)`` against the reference's
  jitted one on the same weights (the port's seeded init handed to JAX),
  at ``tests/test_torch_training.py``'s tolerances;
* ``make_prefill_step`` / ``make_serve_step``: logits within 1e-4 of the
  reference's jitted steps, the caches too, next tokens equal;
* the dry run (``dryrun.analyze_step``, shard (0, 0) on meta) of reduced
  configs at small shapes over a 2 x 2 mesh: positive FLOPs and bytes,
  and per kind the collective counts and bytes that every shard of the
  same program run on ``["cpu"] * 4`` counted; ``dryrun.main`` at
  smollm-135m's full width on the 16 x 16 mesh writes a record with the
  reference's keys, and ``roofline.main`` reads it;
* ``roofline.analyze`` of a record written by hand gives the terms of
  ``H100_80G``'s spec-sheet constants.

The JAX steps are jitted once per (step, config)."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

import repro.configs as jcfgs                                   # noqa: E402
import repro.distributed.sharding as jshd                       # noqa: E402
import repro.launch.steps as jsteps                             # noqa: E402
import repro.models as jmodels                                  # noqa: E402
import repro.models.encdec as jencdec                           # noqa: E402
import repro.models.transformer as jtransformer                 # noqa: E402
import repro.training.optimizer as jopt                         # noqa: E402
from jax.sharding import AbstractMesh                           # noqa: E402
from repro_torch.configs import _MODULES, get_config, get_reduced  # noqa
from repro_torch.core.perf_model import H100_80G                # noqa: E402
from repro_torch.device import generator                        # noqa: E402
from repro_torch.distributed import sharding as shd             # noqa: E402
from repro_torch.launch import dryrun, roofline, steps          # noqa: E402
from repro_torch.launch.cost_analysis import (collective_counts,  # noqa
                                              COLLECTIVES)
from repro_torch.models import init_params                      # noqa: E402
from repro_torch.models.encdec import init_encdec_params        # noqa: E402
from repro_torch.models.transformer import init_cache           # noqa: E402
from repro_torch.training import optimizer                      # noqa: E402
from repro_torch.training.train_loop import trainable           # noqa: E402
from repro_torch.training.tree import flatten, leaves, tree_map  # noqa

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model"))}
ARCHS = sorted(_MODULES)


def _flat(tree, path=""):
    """{path: leaf} of the port's dict/list trees (a spec tuple is a
    leaf)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}/{k}" if path else str(k)))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{path}/{i}" if path else str(i)))
        return out
    return {path: tree}


def _jax_specs(tree):
    return {jshd._path_str(kp): tuple(ns.spec) for kp, ns in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


_SHAPES: dict = {}


def _trees(arch):
    """(JAX abstract params, port meta params) of a reduced config."""
    if arch not in _SHAPES:
        jc, tc = jcfgs.get_reduced(arch), get_reduced(arch)
        if jc.arch_type == "encdec":
            jp = jax.eval_shape(lambda: jencdec.init_encdec_params(
                jax.random.PRNGKey(0), jc))
            tp = init_encdec_params(tc, None, device="meta")
        else:
            jp = jax.eval_shape(lambda: jmodels.init_params(
                jax.random.PRNGKey(0), jc))
            tp = init_params(tc, None, device="meta")
        _SHAPES[arch] = jc, tc, jp, tp
    return _SHAPES[arch]


# -------------------------------- specs ---------------------------------- #
@pytest.mark.parametrize("name", list(MESHES))
def test_specs_match_reference(name):
    shape, axes = MESHES[name]
    amesh = AbstractMesh(shape, axes)
    mesh = shd.make_mesh(shape, axes)
    for arch in ARCHS:
        jc, tc, jp, tp = _trees(arch)
        for mode in ("fsdp", "tp"):
            want = _jax_specs(jshd.params_shardings(jp, jc, amesh, mode))
            got = _flat(shd.params_shardings(tp, tc, mesh, mode))
            assert got == want, (arch, mode)
        for batch, seq_shard in ((4, False), (32, False), (1, True)):
            jcache = jax.eval_shape(
                lambda: jtransformer.init_cache(jc, batch, 64))
            cache = init_cache(tc, batch, 64, device="meta")
            want = _jax_specs(jshd.cache_shardings(jcache, jc, amesh, batch,
                                                   seq_shard=seq_shard))
            got = _flat(shd.cache_shardings(cache, tc, mesh, batch,
                                            seq_shard=seq_shard))
            assert got == want, (arch, batch, seq_shard)
    for batch in (1, 2, 16, 32, 256):
        for extra in (0, 1, 2):
            assert shd.batch_spec(mesh, batch, extra) == tuple(
                jshd.batch_spec(amesh, batch, extra))
    # the reference's own unit cases (tests/test_sharding.py), both sides
    cases = [("segments/0/p/attn/wq", (4096, 32, 128), False),
             ("segments/0/p/attn/wq", (32, 4096, 32, 128), True),
             ("segments/0/p/mlp/w_up", (4096, 14336), False),
             ("segments/1/p/moe/w_gate", (160, 5120, 1536), False),
             ("segments/0/p/norm1/scale", (4096,), False),
             ("segments/0/p/attn/wq", (576, 9, 64), False),
             ("segments/0/p/ssm/conv_w", (4, 10240), False),
             ("embed/embed", (49152, 576), False)]
    for path, shp, stacked in cases:
        for mode in ("fsdp", "tp"):
            assert shd.param_spec(path, shp, mesh, stacked, mode) == tuple(
                jshd.param_spec(path, shp, amesh, stacked, mode)), (path,
                                                                    mode)
    for ax, dim in (("model", 9), ("model", 32), (("pod", "data"), 256),
                    (("pod", "data"), 16), ("data", 3)):
        if all(a in axes for a in shd._names(ax)):
            assert shd._fit(ax, dim, mesh) == jshd._fit(ax, dim, amesh)


# --------------------------- steps vs reference -------------------------- #
def _np(tree):
    return tree_map(lambda t: t.detach().numpy().copy(), tree)


def _port_model(arch, seed):
    cfg = get_reduced(arch)
    init = init_encdec_params if cfg.arch_type == "encdec" else init_params
    return cfg, init(cfg, generator(torch.device("cpu"), seed), device="cpu")


def test_microbatched_train_step_matches_reference():
    _microbatched_against_reference("smollm-135m", 2)


def test_microbatched_moe_train_step_matches_reference():
    """phi3.5-moe: each microbatch's capacity and aux statistics over its
    own rows, as the reference's scan takes them."""
    tm = _microbatched_against_reference("phi3.5-moe-42b-a6.6b", 3)
    assert float(tm["aux"]) > 0


def _microbatched_against_reference(arch, seed):
    """The port's unsharded two-microbatch step against the reference's
    jitted one on the port's init handed to JAX; returns the port's
    metrics."""
    cfg, params = _port_model(arch, seed)
    jc = jcfgs.get_reduced(arch)
    rng = np.random.default_rng(seed)
    b = {k: rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32)
         for k in ("tokens", "labels")}
    kw = dict(lr=1e-3, total_steps=10, warmup_steps=2)
    jp = tree_map(jnp.asarray, _np(params))
    jstate = jopt.init_opt_state(jp)
    jp2, js2, jm = jax.jit(jsteps.make_train_step(
        jc, jopt.AdamWConfig(**kw), microbatches=2))(
            jp, jstate, tree_map(jnp.asarray, b))
    tp = trainable(params)
    step = steps.make_train_step(cfg, optimizer.AdamWConfig(**kw),
                                 microbatches=2)
    tp2, ts2, tm = step(tp, optimizer.init_opt_state(tp),
                        {k: torch.from_numpy(v) for k, v in b.items()})
    assert tp2 is tp
    assert sorted(tm) == sorted(jm) == ["aux", "grad_norm", "loss", "lr",
                                        "nll"]
    for k in tm:
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-5,
                                             abs=1e-7), k
    # the reference's quirk: under microbatches "nll" is the total loss
    assert float(tm["nll"]) == float(tm["loss"])
    for part in ("mu", "nu"):
        for path, g, w in zip(*flatten(ts2[part]), leaves(js2[part])):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                       err_msg=path)
    # test_torch_training.py's bound on the step (its comment): atol 1e-6
    # where the moment is above 1e-6, 2 lr anywhere
    lr = float(tm["lr"])
    for (path, p), q, mu in zip(zip(*flatten(tp2)), leaves(jp2),
                                leaves(js2["mu"])):
        p, q = p.detach().numpy(), np.asarray(q)
        big = np.abs(np.asarray(mu)) > 1e-6
        np.testing.assert_allclose(p[big], q[big], atol=1e-6, err_msg=path)
        np.testing.assert_allclose(p, q, atol=2 * lr, err_msg=path)
    assert int(ts2["step"]) == int(js2["step"]) == 1
    return tm


@pytest.mark.parametrize("arch", ["smollm-135m", "whisper-large-v3",
                                  "mamba2-2.7b"])
def test_prefill_and_serve_steps_match_reference(arch):
    cfg, params = _port_model(arch, 3)
    jc = jcfgs.get_reduced(arch)
    rng = np.random.default_rng(3)
    Bn, S, max_len = 2, 16, 32
    tokens = rng.integers(0, cfg.vocab, (Bn, S)).astype(np.int32)
    enc = None
    if cfg.arch_type == "encdec":
        enc = rng.standard_normal((Bn, cfg.encoder.n_frames, cfg.d_model),
                                  dtype=np.float32)
    jp = tree_map(jnp.asarray, _np(params))
    jenc = None if enc is None else jnp.asarray(enc)
    jlog, jcache = jax.jit(jsteps.make_prefill_step(jc))(
        jp, jnp.asarray(tokens), jtransformer.init_cache(jc, Bn, max_len),
        jenc)
    tenc = None if enc is None else torch.from_numpy(enc)
    tlog, tcache = steps.make_prefill_step(cfg)(
        params, torch.from_numpy(tokens), init_cache(cfg, Bn, max_len,
                                                     device="cpu"), tenc)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4,
                               rtol=0)
    for path, g, w in zip(*flatten(tcache), leaves(jcache)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=0, err_msg=path)
    nxt = np.asarray(jlog)[:, -1].argmax(-1).astype(np.int32)[:, None]
    pos0 = np.full((Bn,), S, np.int32)
    jtok, jcache = jax.jit(jsteps.make_serve_step(jc))(
        jp, jnp.asarray(nxt), jcache, jnp.asarray(pos0), jenc)
    ttok, tcache = steps.make_serve_step(cfg)(
        params, torch.from_numpy(nxt), tcache, torch.from_numpy(pos0), tenc)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    for path, g, w in zip(*flatten(tcache), leaves(jcache)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=0, err_msg=path)


# -------------------------------- dry run -------------------------------- #
def _real(a, gen):
    """Real CPU tensors of an ``Abstract``'s shapes (parameters small
    normals, everything else zeros)."""
    def one(t, sp):
        if t.dtype.is_floating_point and t.dim() >= 1:
            return torch.randn(t.shape, generator=gen, dtype=t.dtype) * 0.05
        return torch.zeros(t.shape, dtype=t.dtype)
    return None if a is None else (shd._walk(one, a.tree, a.specs), a.specs)


SMALL = {"train": dict(seq_len=16, global_batch=4, kind="train"),
         "prefill": dict(seq_len=16, global_batch=4, kind="prefill"),
         "decode": dict(seq_len=32, global_batch=4, kind="decode"),
         "long": dict(seq_len=32, global_batch=1, kind="decode")}
DRY = [("smollm-135m", "train"), ("phi3.5-moe-42b-a6.6b", "train"),
       ("deepseek-v2-236b", "train"), ("mamba2-2.7b", "train"),
       ("smollm-135m", "prefill"), ("whisper-large-v3", "prefill"),
       ("smollm-135m", "decode"), ("zamba2-7b", "long"),
       ("qwen3-1.7b-swa", "long")]


@pytest.mark.parametrize("arch,kind", DRY, ids=[f"{a}-{k}" for a, k in DRY])
def test_dry_run_counts_the_collectives_of_the_sharded_run(arch, kind):
    cfg, shape = get_reduced(arch), SMALL[kind]
    amesh = shd.make_mesh((2, 2), ("data", "model"))
    dry = dryrun.analyze_step(cfg, shape, amesh, dtype=torch.float32)
    assert dry["flops"] > 0 and dry["bytes"] > 0
    assert dry["memory"]["argument_bytes"] > 0
    assert sorted(dry["collectives"]) == sorted(COLLECTIVES)
    assert dry["collective_bytes"] > 0
    mesh = shd.make_mesh((2, 2), ("data", "model"), ["cpu"] * 4)
    fn, args = steps.build(cfg, shape, mesh, torch.float32)
    gen = torch.Generator().manual_seed(0)
    real = [_real(a, gen) for a in args]
    workers = shd.ShardWorkers(mesh, timeout=60)
    outs = steps.run_sharded(fn, real, workers)
    assert len(outs) == 4
    for i in range(4):
        assert collective_counts(workers.comm.stats(i)) == \
            dry["collectives"], i


def test_dryrun_cli_and_roofline(tmp_path, capsys):
    out = tmp_path / "dryrun"
    assert dryrun.main(["--arch", "smollm-135m", "--shape", "train_4k",
                        "--out", str(out)]) == 0
    rec = json.loads((out / "smollm-135m_train_4k_16-16.json").read_text())
    assert set(rec) == {
        "arch", "shape", "variant", "mesh", "n_chips", "status", "compile_s",
        "flops", "hlo_bytes", "flops_xla_raw", "bytes_xla_raw",
        "utilization", "memory", "collectives", "params", "params_active",
        "kv_bytes_per_token"}
    assert rec["status"] == "ok" and rec["n_chips"] == 256
    assert rec["flops"] > 0 and rec["hlo_bytes"] > 0
    assert rec["params"] == get_config("smollm-135m").param_count()
    # FSDP: a shard rests on a small part of the weights and moments
    assert 0 < rec["memory"]["argument_bytes"] < (
        rec["params"] * 2 + rec["params"] * 8) / 16
    assert rec["collectives"]["total_bytes"] == sum(
        rec["collectives"][k]["bytes"] for k in COLLECTIVES)
    assert dryrun.main(["--arch", "smollm-135m", "--shape", "long_500k",
                        "--out", str(out)]) == 0
    roofline.main(["--dir", str(out), "--csv", str(tmp_path / "r.csv"),
                   "--md", str(tmp_path / "r.md")])
    md = (tmp_path / "r.md").read_text()
    assert "spec-sheet" in md and "smollm-135m" in md and "skipped" in md
    assert "ok" in (tmp_path / "r.csv").read_text()


def test_roofline_terms_from_h100_spec_sheet():
    rec = {"arch": "x", "shape": "train_4k", "mesh": "16x16", "n_chips": 256,
           "status": "ok", "flops": 4.0e15, "hlo_bytes": 2.0e12,
           "collectives": {"total_bytes": 9.0e11}, "params_active": 1.0e9,
           "compile_s": 1.0}
    r = roofline.analyze(rec)
    assert r["t_compute_s"] == pytest.approx(4.0e15 / H100_80G.peak_flops)
    assert r["t_memory_s"] == pytest.approx(2.0e12 / H100_80G.hbm_bw)
    assert r["t_collective_s"] == pytest.approx(9.0e11 / H100_80G.link_bw)
    assert r["dominant"] == "compute" and r["terms"] == "spec-sheet"
    assert r["hardware"] == "h100-80g"
    assert r["model_flops"] == pytest.approx(6.0 * 1e9 * 256 * 4096)
    assert r["useful_ratio"] == pytest.approx(6.0 * 1e9 * 256 * 4096
                                              / 256 / 4.0e15)
    assert "tensor-core" in roofline.suggestion(r) or "useful" in \
        roofline.suggestion(r)
    assert "NVLink" in roofline.suggestion(dict(r, dominant="collective"))
    assert "HBM" in roofline.suggestion(dict(r, dominant="memory"))
