"""The port's sharded training (``repro_torch.distributed.sharding``'s
training section, ``launch/steps.py``'s ``sharded_train_step``) on CPU
meshes of ``["cpu"] * n``, held against the port's unsharded step on the
same weights and batches, with the gates of ``chip_smoke.py``'s
``train_mesh`` phase:

* step 1's loss and every gathered gradient leaf within rtol 1e-4 (atol
  1e-6 x max |g| of the leaf); the losses of steps 2-3 within 1e-4
  relative; after step 3 every parameter within 2 x 3 x lr of the
  unsharded one (AdamW's normalised step can flip on a near-zero
  gradient);
* every part of a leaf that several shards hold is bit-equal across them
  after each step, and each shard rests on the bytes its specs predict;
* families: dense GQA (heads and FFN columns split), phi3.5-moe (experts
  split, aux statistics over data), deepseek-v2 (MLA heads and experts),
  mamba2 (SSM compute replicated), and meshes 2 x 2, 4 x 1 and 1 x 4.

Also: the MoE dispatch over data shards keeps the global capacity's
units (dropping as the unsharded call drops), and sequence-sharded decode
over a dense cache (``seq_sharded_attention``) against unsharded decode.
Everything here is the port; the reference's spec functions are held in
``tests/test_torch_launch.py``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_reduced                     # noqa: E402
from repro_torch.device import generator                        # noqa: E402
from repro_torch.distributed import sharding as shd             # noqa: E402
from repro_torch.launch import steps                            # noqa: E402
from repro_torch.models import init_params                      # noqa: E402
from repro_torch.models.attention import (causal_mask, sdpa,    # noqa: E402
                                          seq_sharded_attention)
from repro_torch.models.moe import moe_forward                  # noqa: E402
from repro_torch.models.transformer import init_cache           # noqa: E402
from repro_torch.training.optimizer import (AdamWConfig,        # noqa: E402
                                            init_opt_state)
from repro_torch.training.train_loop import (loss_and_grads,    # noqa: E402
                                             trainable)
from repro_torch.training.tree import flatten, tree_map         # noqa: E402

LR = 1e-3
OPT = AdamWConfig(lr=LR, warmup_steps=1, total_steps=10)
B, S, STEPS = 4, 16, 3
AXES = ("data", "model")


def _cpu_mesh(shape):
    return shd.make_mesh(shape, AXES, ["cpu"] * (shape[0] * shape[1]))


def _batches(cfg, seed=0, n=STEPS, b=B):
    rng = np.random.default_rng(seed)
    return [{k: torch.from_numpy(rng.integers(0, cfg.vocab, (b, S)))
             for k in ("tokens", "labels")} for _ in range(n)]


def _run_both(arch, shape, microbatches=1, seed=0, cfg=None, params=None):
    """The unsharded and the sharded step from one init (``params``, or
    ``cfg``'s seeded init; ``cfg`` defaults to ``arch``'s reduced config)
    over STEPS batches (each shard handed its rows by
    ``steps.shard_batch``).  Returns what the gates read."""
    cfg = cfg or get_reduced(arch)
    if params is None:
        params = init_params(cfg, generator(torch.device("cpu"), seed),
                             device="cpu")
    batches = _batches(cfg, seed)
    up = trainable(tree_map(torch.clone, params))
    uo = init_opt_state(up)
    ustep = steps.make_train_step(cfg, OPT, microbatches)
    _, _, g0 = steps.accumulate_grads(up, cfg, batches[0], microbatches)
    ulosses, uaux = [], []
    for b in batches:
        up, uo, m = ustep(up, uo, b)
        ulosses.append(float(m["loss"]))
        uaux.append(float(m["aux"]))

    mesh = _cpu_mesh(shape)
    pspecs = shd.params_shardings(params, cfg, mesh)
    ospecs = {"mu": pspecs, "nu": pspecs, "step": ()}
    prog = steps.sharded_train_step(cfg, mesh, pspecs, OPT, microbatches,
                                    keep_grads=True)
    workers = shd.ShardWorkers(mesh, timeout=60)
    sp = shd.shard_tree(params, pspecs, mesh, copy=True)
    so = [init_opt_state(p) for p in sp]
    predicted = (shd.shard_nbytes(params, pspecs, mesh)
                 + shd.shard_nbytes(init_opt_state(params), ospecs, mesh))
    slosses, saux, grads = [], [], None
    for k, b in enumerate(batches):
        bb = steps.shard_batch(prog, b, mesh)
        outs = workers.run(lambda i, ms: prog(ms, sp[i], so[i], bb[i]))
        sp, so = [o[0] for o in outs], [o[1] for o in outs]
        slosses.append(float(outs[0][2]["loss"]))
        saux.append(float(outs[0][2]["aux"]))
        assert len({float(o[2]["loss"]) for o in outs}) == 1
        if k == 0:
            grads = shd.unshard_tree([o[2]["grads"] for o in outs], pspecs,
                                     mesh)
        assert shd.replicas_equal(sp, pspecs, mesh), f"params, step {k + 1}"
        assert shd.replicas_equal(so, ospecs, mesh), f"moments, step {k + 1}"
    for p, o in zip(sp, so):
        held = sum(t.numel() * t.element_size()
                   for t in flatten(p)[1] + flatten(o)[1])
        assert held == predicted
    return dict(cfg=cfg, mesh=mesh, ulosses=ulosses, slosses=slosses,
                uaux=uaux, saux=saux, g0=g0, grads=grads, up=up,
                sparams=shd.unshard_tree(sp, pspecs, mesh))


def _assert_grads_agree(r):
    paths, got = flatten(r["grads"])
    for path, g, w in zip(paths, got, flatten(r["g0"])[1]):
        w = w.detach()
        np.testing.assert_allclose(
            g.numpy(), w.numpy(), rtol=1e-4,
            atol=1e-6 * float(w.abs().max()), err_msg=path)


CASES = [("smollm-135m", (2, 2)), ("phi3.5-moe-42b-a6.6b", (2, 2)),
         ("deepseek-v2-236b", (2, 2)), ("mamba2-2.7b", (2, 2)),
         ("smollm-135m", (4, 1)), ("smollm-135m", (1, 4))]
SPLITS = {"smollm-135m": {"heads", "mlp"},
          "phi3.5-moe-42b-a6.6b": {"heads", "experts", "mlp"},
          "deepseek-v2-236b": {"mla_heads", "experts", "mlp"},
          "mamba2-2.7b": set()}


@pytest.mark.parametrize("arch,shape", CASES,
                         ids=[f"{a}-{d}x{m}" for a, (d, m) in CASES])
def test_sharded_train_step_matches_unsharded(arch, shape):
    r = _run_both(arch, shape)
    plan = shd.serving_shard_plan(r["cfg"], r["mesh"])
    split = {f for f in ("heads", "mla_heads", "experts", "mlp")
             if getattr(plan, f)}
    # the model axis splits what the plan says at 2 (at 4, smollm's 2 KV
    # heads do not split: its FFN columns do)
    want = SPLITS[arch] if shape[1] == 2 else (
        {"mlp"} if shape[1] == 4 else set())
    assert split == want
    assert r["slosses"][0] == pytest.approx(r["ulosses"][0], rel=1e-4)
    _assert_grads_agree(r)
    for k in (1, 2):
        assert r["slosses"][k] == pytest.approx(r["ulosses"][k], rel=1e-4)
    for path, p, q in zip(*flatten(r["sparams"]), flatten(r["up"])[1]):
        np.testing.assert_allclose(p.numpy(), q.detach().numpy(),
                                   atol=2 * STEPS * LR, rtol=0,
                                   err_msg=path)


def test_microbatched_sharded_step_matches_unsharded():
    """Two microbatches on a 2 x 2 mesh (each data shard's rows halved)
    against the unsharded two-microbatch step: for a dense model the same
    gradient."""
    r = _run_both("smollm-135m", (2, 2), microbatches=2, seed=1)
    for k in range(STEPS):
        assert r["slosses"][k] == pytest.approx(r["ulosses"][k], rel=1e-4)
    for path, p, q in zip(*flatten(r["sparams"]), flatten(r["up"])[1]):
        np.testing.assert_allclose(p.numpy(), q.detach().numpy(),
                                   atol=2 * STEPS * LR, rtol=0,
                                   err_msg=path)


def _moe16():
    """phi3.5-moe's reduced config with the published 16 experts, and its
    seeded init: at the training default capacity factor (2.0:
    ceil(2 * 2 * 32 / 16) = 8 units an expert over a two-row microbatch)
    units are dropped."""
    base = get_reduced("phi3.5-moe-42b-a6.6b")
    cfg = dataclasses.replace(
        base, moe=dataclasses.replace(base.moe, n_experts=16))
    return cfg, init_params(cfg, generator(torch.device("cpu"), 1),
                            device="cpu")


def _drops(cfg, params, batch, microbatches=2):
    """Whether the training default capacity drops units of ``batch``'s
    microbatches: the dropless loss of some microbatch differs."""
    dropless = cfg.moe.n_experts / cfg.moe.top_k
    for rows in torch.tensor_split(torch.arange(B), microbatches):
        mb = {k: v[rows] for k, v in batch.items()}
        at = [float(loss_and_grads(params, cfg, mb, moe_cf=cf)[0])
              for cf in (None, dropless)]
        if at[0] != pytest.approx(at[1], rel=1e-4):
            return True
    return False


def test_microbatched_moe_step_takes_the_global_microbatch():
    """phi3.5-moe (16 experts) on data 2 x model 1 with two
    microbatches, at the training default capacity, which drops units:
    each data shard's microbatch j is its share of the global batch's
    j-th slice, as in the reference, so capacity and the aux statistics
    count the same tokens as the unsharded two-microbatch step: loss,
    aux, step 1's gradients and the trained parameters agree with it."""
    cfg, params = _moe16()
    assert _drops(cfg, trainable(tree_map(torch.clone, params)),
                  _batches(cfg, 1, n=1)[0])
    r = _run_both(None, (2, 1), microbatches=2, seed=1, cfg=cfg,
                  params=params)
    for k in range(STEPS):
        assert r["slosses"][k] == pytest.approx(r["ulosses"][k], rel=1e-4)
        assert r["saux"][k] == pytest.approx(r["uaux"][k], rel=1e-4)
    _assert_grads_agree(r)
    for path, p, q in zip(*flatten(r["sparams"]), flatten(r["up"])[1]):
        np.testing.assert_allclose(p.numpy(), q.detach().numpy(),
                                   atol=2 * STEPS * LR, rtol=0,
                                   err_msg=path)


def test_build_and_run_sharded_take_the_global_microbatch():
    """``steps.build``'s train program with two microbatches, run by
    ``steps.run_sharded`` on the global batch (no row order given by the
    caller): step 1's loss and aux equal the unsharded two-microbatch
    step's on the 16-expert MoE, which drops units."""
    cfg, params = _moe16()
    batch = _batches(cfg, 1, n=1)[0]
    up = trainable(tree_map(torch.clone, params))
    _, _, m = steps.make_train_step(cfg, OPT, 2)(up, init_opt_state(up),
                                                 batch)
    mesh = _cpu_mesh((2, 1))
    fn, args = steps.build(cfg, dict(seq_len=S, global_batch=B,
                                     kind="train"), mesh, torch.float32,
                           microbatches=2, opt_cfg=OPT)
    real = [(params, args[0].specs),
            (init_opt_state(params), args[1].specs),
            (batch, args[2].specs)]
    outs = steps.run_sharded(fn, real, shd.ShardWorkers(mesh, timeout=60))
    for o in outs:
        assert float(o[2]["loss"]) == pytest.approx(float(m["loss"]),
                                                    rel=1e-4)
        assert float(o[2]["aux"]) == pytest.approx(float(m["aux"]),
                                                   rel=1e-4)


def test_microbatch_order_hands_each_shard_its_share():
    """Eight rows, two microbatches, two data shards: shard 0 holds rows
    0, 1 (microbatch 0) and 4, 5 (microbatch 1), shard 1 rows 2, 3, 6, 7;
    one microbatch keeps the contiguous cut."""
    mesh = _cpu_mesh((2, 1))
    cfg = get_reduced("smollm-135m")
    pspecs = shd.params_shardings(
        init_params(cfg, generator(torch.device("cpu"), 0), device="cpu"),
        cfg, mesh)
    rows = torch.arange(8)[:, None].repeat(1, 3)
    two = steps.sharded_train_step(cfg, mesh, pspecs, OPT, 2)
    got = steps.shard_batch(two, {"tokens": rows, "labels": rows}, mesh)
    assert [g["tokens"][:, 0].tolist() for g in got] == [[0, 1, 4, 5],
                                                         [2, 3, 6, 7]]
    assert all(torch.equal(g["labels"], g["tokens"]) for g in got)
    one = steps.sharded_train_step(cfg, mesh, pspecs, OPT)
    got = steps.shard_batch(one, {"tokens": rows}, mesh)
    assert [g["tokens"][:, 0].tolist() for g in got] == [[0, 1, 2, 3],
                                                         [4, 5, 6, 7]]
    with pytest.raises(ValueError):
        steps.microbatch_order({"tokens": rows[:6]}, 2, 2)


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)])
def test_moe_dispatch_keeps_the_global_capacity(shape):
    """At capacity factor 0.5 units are dropped; over data shards each
    shard keeps the units the unsharded call keeps (the counts of earlier
    shards ahead of its own), so the outputs and the aux loss are the
    unsharded ones."""
    cfg = get_reduced("phi3.5-moe-42b-a6.6b")
    gen = generator(torch.device("cpu"), 3)
    from repro_torch.models.moe import init_moe
    p = init_moe(gen, cfg, device="cpu")
    x = torch.randn(4, 8, cfg.d_model, generator=gen)
    want, waux = moe_forward(p, x, cfg, capacity_factor=0.5)
    mesh = _cpu_mesh(shape)
    plan = shd.serving_shard_plan(cfg, mesh)
    specs = shd.compute_param_specs({"moe": p}, cfg, plan)["moe"]
    parts = shd.shard_tree(p, specs, mesh)
    xs = shd.shard_tree(x, ("data",), mesh)
    outs = shd.ShardWorkers(mesh, timeout=60).run(
        lambda i, ms: moe_forward(parts[i], xs[i], cfg, capacity_factor=0.5,
                                  shard=ms.model_ctx(plan)))
    got = torch.cat([outs[i][0] for i in range(0, mesh.size, shape[1])])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    for out, aux in outs:
        assert float(aux["aux_loss"]) == pytest.approx(
            float(waux["aux_loss"]), rel=1e-6)
    # the call dropped units: the plain capacity of half the tokens would
    # keep others
    assert not torch.allclose(moe_forward(p, x[:2], cfg,
                                          capacity_factor=0.5)[0],
                              want[:2], atol=1e-6)


# --------------------------- sequence sharding --------------------------- #
@pytest.mark.parametrize("window", [None, 24])
def test_seq_sharded_attention_matches_sdpa(window):
    """One decode token over a cache whose positions are split over two
    data shards: the merged output equals the unsharded masked ``sdpa``,
    and each shard wrote the new row only where it holds the position."""
    rng = np.random.default_rng(5)
    Bn, Smax, H, KV, hd = 3, 40, 4, 2, 16
    pos0 = torch.tensor([5, 19, 33], dtype=torch.int32)   # shard 0, 0, 1
    k = torch.from_numpy(rng.standard_normal((Bn, Smax, KV, hd),
                                             dtype=np.float32))
    v = torch.from_numpy(rng.standard_normal((Bn, Smax, KV, hd),
                                             dtype=np.float32))
    q = torch.from_numpy(rng.standard_normal((Bn, 1, H, hd),
                                             dtype=np.float32))
    kn = torch.from_numpy(rng.standard_normal((Bn, 1, KV, hd),
                                              dtype=np.float32))
    vn = torch.from_numpy(rng.standard_normal((Bn, 1, KV, hd),
                                              dtype=np.float32))
    ck, cv = k.clone(), v.clone()
    ck[torch.arange(Bn), pos0.long()] = kn[:, 0]
    cv[torch.arange(Bn), pos0.long()] = vn[:, 0]
    want = sdpa(q, ck, cv, causal_mask(Bn, 1, Smax, pos0, pos0 + 1, window))
    mesh = _cpu_mesh((2, 1))
    plan = shd.serving_shard_plan(get_reduced("smollm-135m"), mesh)
    caches = shd.shard_tree({"k": k, "v": v}, {"k": (None, "data"),
                                               "v": (None, "data")},
                            mesh, copy=True)
    outs = shd.ShardWorkers(mesh, timeout=60).run(
        lambda i, ms: seq_sharded_attention(
            q, kn, vn, caches[i], pos0, window,
            ms.model_ctx(plan, seq=True)))
    for out in outs:
        torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(torch.cat([c["k"] for c in caches], 1), ck,
                               rtol=0, atol=0)
    torch.testing.assert_close(torch.cat([c["v"] for c in caches], 1), cv,
                               rtol=0, atol=0)


@pytest.mark.parametrize("arch", ["qwen3-1.7b-swa", "zamba2-7b"])
def test_seq_sharded_decode_matches_unsharded(arch):
    """``long_500k``'s layout at a small size: batch 1, the dense cache's
    positions split over two data shards; the serve step's program,
    decoding 4 tokens after a 21-token prefill, gives the unsharded
    step's tokens, and the shards' caches the unsharded cache."""
    cfg = get_reduced(arch)
    params = init_params(cfg, generator(torch.device("cpu"), 4),
                         device="cpu")
    rng = np.random.default_rng(4)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 21)))
    max_len = 32
    cache = init_cache(cfg, 1, max_len, device="cpu")
    logits, cache = steps.make_prefill_step(cfg)(params, prompt, cache, None)
    tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    serve = steps.make_serve_step(cfg)

    mesh = _cpu_mesh((2, 1))
    cspecs = shd.cache_shardings(cache, cfg, mesh, 1, seq_shard=True)
    held = []
    shd._walk(lambda t, sp: held.append(sp), cache, cspecs)
    assert any("data" in sp for sp in held)
    pspecs = shd.params_shardings(params, cfg, mesh)
    prog = steps._sharded_cache_step(serve, cfg, mesh, pspecs, cspecs,
                                     seq_shard=True)
    workers = shd.ShardWorkers(mesh, timeout=60)
    sp = shd.shard_tree(params, pspecs, mesh, copy=True)
    sc = shd.shard_tree(tree_map(torch.clone, cache), cspecs, mesh,
                        copy=True)
    ucache, utok, stok = cache, tok, tok
    for t in range(4):
        pos0 = torch.full((1,), 21 + t, dtype=torch.int32)
        nxt, ucache = serve(params, utok, ucache, pos0, None)
        outs = workers.run(lambda i, ms: prog(ms, sp[i], stok, sc[i], pos0,
                                              None))
        sc = [o[1] for o in outs]
        assert all(torch.equal(o[0], outs[0][0]) for o in outs)
        assert torch.equal(outs[0][0], nxt), t
        utok = stok = nxt[:, None]
    got = shd.unshard_tree(sc, cspecs, mesh)
    for path, g, w in zip(*flatten(got), flatten(ucache)[1]):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5, msg=path)


def test_replicas_equal_sees_a_differing_replica():
    mesh = _cpu_mesh((2, 2))
    t = torch.arange(8.0).reshape(2, 4)
    specs = {"a": ("data",), "b": ()}
    parts = shd.shard_tree({"a": t, "b": t}, specs, mesh, copy=True)
    assert shd.replicas_equal(parts, specs, mesh)
    parts[3]["a"][0, 0] += 1          # shard (1, 1): its data part's twin
    assert not shd.replicas_equal(parts, specs, mesh)
    parts[3]["a"][0, 0] -= 1
    parts[0]["b"][1, 1] = -1.0        # a whole replicated leaf
    assert not shd.replicas_equal(parts, specs, mesh)


def test_meshes():
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    m = make_production_mesh()
    assert (m.axis_names, m.sizes, m.devices) == (AXES, (16, 16), None)
    m = make_production_mesh(multi_pod=True)
    assert m.shape == {"pod": 2, "data": 16, "model": 16} and m.size == 512
    assert m.coords(511) == {"pod": 1, "data": 15, "model": 15}
    assert m.part(300, ("pod", "data")) == (18, 32)
    h = make_host_mesh("cpu")
    assert h.shape == {"data": 1, "model": 1}
    assert h.devices == (torch.device("cpu"),)
    with pytest.raises(ValueError):
        shd.ShardWorkers(make_production_mesh())        # abstract
    with pytest.raises(ValueError):
        shd.make_mesh((2, 2), AXES, ["cpu"] * 3)
