"""Step functions and abstract inputs for the four input shapes (port of
``repro/launch/steps.py``):

  train_4k      seq 4,096   global_batch 256   -> train_step
  prefill_32k   seq 32,768  global_batch 32    -> prefill_step
  decode_32k    seq 32,768  global_batch 128   -> serve_step (1 new token
                                                  against a 32k cache)
  long_500k     seq 524,288 global_batch 1     -> serve_step, sub-quadratic
                                                  archs only (+ SWA variant)

``make_train_step``, ``make_prefill_step`` and ``make_serve_step`` are
the reference's unsharded steps.  Where the reference jits them with
``NamedSharding``s from ``params_shardings`` / ``batch_spec`` /
``cache_shardings``, ``build`` returns the port's per-shard program of
the step (``sharded_train_step`` and the prefill and serve
counterparts): ``program(ms, *args)`` runs on one shard's worker thread
(``ms`` its ``distributed.sharding.MeshShard``) with that shard's slices
of the arguments as their specs cut them.  Each program gathers the
parameters it computes with (``MeshShard.relayout`` to
``compute_param_specs``: FSDP over the data axes, at use, for the whole
tree at the start of the step), runs the step with ``shard=`` its
``ShardCtx``, and returns the shard's slices.  ``run_sharded`` runs a
program over a mesh's shards; ``run_shard0`` runs shard (0, 0)'s alone
on meta tensors, whose collectives return their gathered shapes and
count their bytes (the dry run).

The "abstract" inputs are ``Abstract``: meta tensors of the global
shapes with their specs beside them.  Parameters and caches default to
bfloat16, as the reference's; tokens are int32.  The enc-dec train step
takes ``_enc_input``'s stub as encoder states and the serve step
re-encodes every call, both as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.distributed.sharding import (MeshComms, MeshShard,
                                              _axis_size, _walk, batch_spec,
                                              cache_shardings,
                                              compute_cache_specs,
                                              compute_param_specs,
                                              data_group, local_slice,
                                              params_shardings,
                                              serving_shard_plan, shard_tree)
from repro_torch.kernels import shapes_only
from repro_torch.models.config import ModelConfig
from repro_torch.models.encdec import encoder_forward, init_encdec_params
from repro_torch.models.transformer import (init_cache, init_params,
                                            logits_fn, model_forward)
from repro_torch.training.optimizer import AdamWConfig, adamw_update
from repro_torch.training.train_loop import loss_and_grads
from repro_torch.training.tree import leaves, tree_map

SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}

SHARD_MODE = {"mode": "fsdp"}      # overridable knob (dryrun --shard tp)


def shape_supported(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    """Is (arch x shape) runnable?  Returns (ok, reason-if-skipped)."""
    if shape == "long_500k" and not cfg.sub_quadratic:
        return False, ("full-attention arch: 500k decode is quadratic; "
                       "run the -swa variant instead (DESIGN.md)")
    if shape == "long_500k" and cfg.arch_type == "encdec":
        return False, "whisper decoder has no 500k-token decode use-case"
    return True, ""


@dataclasses.dataclass
class Abstract:
    """An input of a step: a tree of meta tensors of the global shapes,
    and the spec of each leaf (``distributed/sharding.py``)."""
    tree: object
    specs: object


def abstract_params(cfg: ModelConfig, mesh, dtype=torch.bfloat16) -> Abstract:
    init = init_encdec_params if cfg.arch_type == "encdec" else init_params
    params = init(cfg, None, dtype, "meta")
    return Abstract(params, params_shardings(params, cfg, mesh,
                                             SHARD_MODE["mode"]))


# ------------------------------ train ---------------------------------- #
def accumulate_grads(params, cfg: ModelConfig, batch, microbatches: int = 1,
                     shard=None):
    """``loss_and_grads`` over ``batch``, or with ``microbatches`` > 1 the
    reference's gradient accumulation: float32 gradients summed over
    equal slices of the batch's rows, then divided by their number.
    Under microbatches ``parts["nll"]`` is the mean total loss, aux
    included, as in the reference.  Returns (loss, parts, grads)."""
    has_enc = "enc_states" in batch
    if microbatches == 1:
        return loss_and_grads(params, cfg, batch, has_enc=has_enc,
                              shard=shard)
    mb = {k: v.reshape(microbatches, v.shape[0] // microbatches,
                       *v.shape[1:]) for k, v in batch.items()}
    gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
    lsum = asum = torch.zeros((), dtype=torch.float32,
                              device=leaves(params)[0].device)
    for j in range(microbatches):
        loss, parts, grads = loss_and_grads(
            params, cfg, {k: v[j] for k, v in mb.items()}, has_enc=has_enc,
            shard=shard)
        for a, g in zip(leaves(gsum), leaves(grads)):
            a.add_(g.float())
        del grads
        lsum, asum = lsum + loss, asum + parts["aux"]
    loss = lsum / microbatches
    return loss, {"nll": loss, "aux": asum / microbatches}, tree_map(
        lambda g: g / microbatches, gsum)


def make_train_step(cfg: ModelConfig, opt_cfg: Optional[AdamWConfig] = None,
                    microbatches: int = 1):
    """The reference's train step, unsharded: ``train_step(params,
    opt_state, batch) -> (params, opt_state, metrics)``, the parameters
    (which must require grad: ``train_loop.trainable``) and moments
    updated in place.  microbatches > 1: gradient accumulation
    (``accumulate_grads``)."""
    opt_cfg = opt_cfg or AdamWConfig()

    def train_step(params, opt_state, batch):
        loss, parts, grads = accumulate_grads(params, cfg, batch,
                                              microbatches)
        params, opt_state, om = adamw_update(opt_cfg, params, grads,
                                             opt_state)
        return params, opt_state, {"loss": loss, **parts, **om}

    return train_step


def _split_flags(tree, specs):
    """A tree of bools: does a leaf's spec split it at all."""
    return _walk(lambda t, sp: any(e is not None for e in sp), tree, specs)


def _tree_norm(grads, split, ms: MeshShard, axis: str):
    """The global norm of a gradient tree of which this shard holds the
    compute layout: leaves split on ``axis`` add their squares over its
    group, in leaf order (``optimizer.global_norm``'s)."""
    gs, flags = leaves(grads), leaves(split)
    sq = [torch.sum(torch.square(g.float())) for g in gs]
    parts = [s for s, f in zip(sq, flags) if f]
    if parts:
        summed = iter(ms.psum(torch.stack(parts), axis).unbind(0))
        sq = [next(summed) if f else s for s, f in zip(sq, flags)]
    return torch.sqrt(sum(sq))


def sharded_train_step(cfg: ModelConfig, mesh, param_specs,
                       opt_cfg: Optional[AdamWConfig] = None,
                       microbatches: int = 1, keep_grads: bool = False):
    """One shard's train step over ``mesh``: ``program(ms, params,
    opt_state, batch) -> (params, opt_state, metrics)``, its parameters
    and moments resting as ``param_specs`` cut them, its batch its data
    shard's rows as ``shard_batch`` (or ``run_sharded``) hands them: the
    program carries its ``microbatches``, which both read.  Each step it
    gathers its parameters over the data axes (keeping the plan's model
    split), runs ``accumulate_grads`` with ``shard=``, sums the gradients
    over its data group in shard order and divides by its size, takes the
    norm of the whole tree, keeps its slice of each gradient and applies
    AdamW to its slice.  The metrics are the data group's means;
    ``keep_grads``: ``metrics["grads"]`` is the shard's slice of the
    averaged gradients (before clipping).  Under a data axis microbatch j
    is the reference's: the j-th slice of the global batch, of which each
    data shard holds its share (``microbatch_order``), so that MoE
    capacity and the aux statistics count the global microbatch's
    tokens."""
    opt_cfg = opt_cfg or AdamWConfig()
    plan = serving_shard_plan(cfg, mesh)
    data = data_group(mesh)

    def program(ms: MeshShard, params, opt_state, batch):
        shard = ms.model_ctx(plan)
        cspecs = compute_param_specs(params, cfg, plan)
        with torch.no_grad():
            pc = tree_map(lambda t: t.detach().requires_grad_(),
                          ms.relayout_tree(params, param_specs, cspecs))
        loss, parts, grads = accumulate_grads(pc, cfg, batch, microbatches,
                                              shard)
        del pc
        with torch.no_grad():
            mets = {"loss": loss, **parts}
            if data is not None:
                n = _axis_size(mesh, data)
                grads = tree_map(lambda g: ms.psum(g, data) / n, grads)
                mets = {k: ms.psum(v, data) / n for k, v in mets.items()}
            gnorm = _tree_norm(grads, _split_flags(grads, cspecs), ms,
                               plan.axis)
            grads = ms.relayout_tree(grads, cspecs, param_specs)
            params, opt_state, om = adamw_update(opt_cfg, params, grads,
                                                 opt_state, gnorm=gnorm)
        mets.update(om)
        if keep_grads:
            mets["grads"] = grads
        return params, opt_state, mets

    program.microbatches = microbatches
    return program


def microbatch_order(batch, parts: int, microbatches: int):
    """``batch`` (a dict of tensors, rows first) with its rows reordered
    so that cutting it into ``parts`` contiguous blocks hands block s its
    share of each of the reference's microbatches, in microbatch order:
    of B rows, microbatch j is rows [j B/m, (j+1) B/m), and block s gets
    rows j B/m + s B/(m parts) ... + B/(m parts) for j = 0 .. m-1.
    ``accumulate_grads``' j-th slice of block s is then its share of
    global microbatch j.  The identity for one microbatch or one part."""
    if microbatches == 1 or parts == 1:
        return batch
    out = {}
    for k, v in batch.items():
        if v.shape[0] % (microbatches * parts):
            raise ValueError(f"microbatch_order: {v.shape[0]} rows do not "
                             f"split into {microbatches} microbatches over "
                             f"{parts} data shards")
        out[k] = v.reshape(microbatches, parts, -1, *v.shape[1:]).transpose(
            0, 1).reshape(v.shape)
    return out


def shard_batch(program, batch, mesh):
    """Each shard's rows of a global train ``batch`` for ``program`` (a
    ``sharded_train_step``): the rows cut over the data axes as
    ``batch_spec`` cuts them, in the order of the program's microbatches
    (``microbatch_order``)."""
    B = next(iter(batch.values())).shape[0]
    specs = {k: batch_spec(mesh, B, extra_dims=v.dim() - 1)
             for k, v in batch.items()}
    parts = _axis_size(mesh, batch_spec(mesh, B)[0])
    return shard_tree(microbatch_order(batch, parts, program.microbatches),
                      specs, mesh)


def train_inputs(cfg: ModelConfig, mesh, seq_len: int, global_batch: int,
                 dtype=torch.bfloat16):
    params = abstract_params(cfg, mesh, dtype)
    mom = tree_map(lambda p: torch.empty(p.shape, dtype=torch.float32,
                                         device="meta"), params.tree)
    opt = Abstract({"mu": mom, "nu": tree_map(torch.empty_like, mom),
                    "step": torch.empty((), dtype=torch.int32,
                                        device="meta")},
                   {"mu": params.specs, "nu": params.specs, "step": ()})
    bs = batch_spec(mesh, global_batch)
    tok = torch.empty(global_batch, seq_len, dtype=torch.int32,
                      device="meta")
    batch = Abstract({"tokens": tok, "labels": torch.empty_like(tok)},
                     {"tokens": bs, "labels": bs})
    enc = _enc_input(cfg, mesh, global_batch, dtype)
    if enc is not None:
        batch.tree["enc_states"], batch.specs["enc_states"] = enc.tree, \
            enc.specs
    return params, opt, batch


def _enc_input(cfg: ModelConfig, mesh, batch: int, dtype):
    """Stubbed modality frontend output (frames / image patches)."""
    n = 0
    if cfg.arch_type == "vlm":
        n = cfg.n_image_tokens
    elif cfg.arch_type == "encdec":
        n = cfg.encoder.n_frames
    if n == 0:
        return None
    return Abstract(torch.empty(batch, n, cfg.d_model, dtype=dtype,
                                device="meta"),
                    batch_spec(mesh, batch, extra_dims=2))


# ----------------------------- prefill --------------------------------- #
def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, tokens, cache, enc_in, shard=None):
        B = tokens.shape[0]
        pos0 = torch.zeros(B, dtype=torch.int32, device=tokens.device)
        enc_states = enc_in
        if cfg.arch_type == "encdec" and enc_in is not None:
            enc_states = encoder_forward(params["encoder"], cfg, enc_in)
        h, cache, _ = model_forward(params, cfg, tokens, cache=cache,
                                    pos0=pos0, enc_states=enc_states,
                                    shard=shard)
        # serving prefill returns ONLY the last position's logits (vocab-
        # sized logits over 32k positions would dwarf every other tensor)
        logits = logits_fn(params, cfg, h[:, -1:, :])
        return logits, cache

    return prefill_step


def prefill_inputs(cfg: ModelConfig, mesh, seq_len: int, global_batch: int,
                   dtype=torch.bfloat16):
    params = abstract_params(cfg, mesh, dtype)
    tokens = Abstract(torch.empty(global_batch, seq_len, dtype=torch.int32,
                                  device="meta"),
                      batch_spec(mesh, global_batch))
    cache = _abstract_cache(cfg, mesh, global_batch, seq_len, dtype)
    enc = _enc_input(cfg, mesh, global_batch, dtype)
    return params, tokens, cache, enc


# ------------------------------ decode --------------------------------- #
def make_serve_step(cfg: ModelConfig):
    def serve_step(params, tokens, cache, pos0, enc_in, shard=None):
        enc_states = enc_in
        if cfg.arch_type == "encdec" and enc_in is not None:
            enc_states = encoder_forward(params["encoder"], cfg, enc_in)
        h, cache, _ = model_forward(params, cfg, tokens, cache=cache,
                                    pos0=pos0, enc_states=enc_states,
                                    shard=shard)
        logits = logits_fn(params, cfg, h)
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_tok, cache

    return serve_step


def decode_inputs(cfg: ModelConfig, mesh, seq_len: int, global_batch: int,
                  dtype=torch.bfloat16):
    params = abstract_params(cfg, mesh, dtype)
    seq_shard = global_batch == 1          # long-context: shard the KV seq
    tokens = Abstract(torch.empty(global_batch, 1, dtype=torch.int32,
                                  device="meta"),
                      batch_spec(mesh, global_batch))
    pos0 = Abstract(torch.empty(global_batch, dtype=torch.int32,
                                device="meta"),
                    batch_spec(mesh, global_batch, extra_dims=0))
    cache = _abstract_cache(cfg, mesh, global_batch, seq_len, dtype,
                            seq_shard=seq_shard)
    enc = _enc_input(cfg, mesh, global_batch, dtype)
    return params, tokens, cache, pos0, enc


def _abstract_cache(cfg: ModelConfig, mesh, batch: int, max_len: int, dtype,
                    seq_shard: bool = False) -> Abstract:
    cache = init_cache(cfg, batch, max_len, dtype, "meta")
    return Abstract(cache, cache_shardings(cache, cfg, mesh, batch,
                                           seq_shard=seq_shard))


def _sharded_cache_step(step, cfg: ModelConfig, mesh, param_specs,
                        cache_specs, seq_shard: bool = False):
    """One shard's program of a step over a dense cache: ``program(ms,
    params, tokens, cache, *rest) -> (out, cache)``, the cache resting as
    ``cache_specs`` cut it; the step computes with its parameters and
    cache in the plan's layout, and its cache slice goes back to rest."""
    plan = serving_shard_plan(cfg, mesh)

    @torch.no_grad()
    def program(ms: MeshShard, params, tokens, cache, *rest):
        shard = ms.model_ctx(plan, seq=seq_shard)
        pc = ms.relayout_tree(params, param_specs,
                              compute_param_specs(params, cfg, plan))
        cspecs = compute_cache_specs(cache, cache_specs, plan)
        cc = ms.relayout_tree(cache, cache_specs, cspecs)
        out, cc = step(pc, tokens, cc, *rest, shard=shard)
        return out, ms.relayout_tree(cc, cspecs, cache_specs)

    return program


# ------------------------------ registry -------------------------------- #
def build(cfg: ModelConfig, shape, mesh, dtype=torch.bfloat16,
          microbatches: int = 1, opt_cfg: Optional[AdamWConfig] = None):
    """Returns (program, args): ``program`` one shard's step over ``mesh``
    (the module docstring) and ``args`` its ``Abstract`` inputs (None
    for an absent encoder input).  ``shape``: a name of ``SHAPES`` or
    such a dict."""
    info = SHAPES[shape] if isinstance(shape, str) else shape
    S, B = info["seq_len"], info["global_batch"]
    if info["kind"] == "train":
        args = train_inputs(cfg, mesh, S, B, dtype)
        fn = sharded_train_step(cfg, mesh, args[0].specs, opt_cfg,
                                microbatches)
    elif info["kind"] == "prefill":
        args = prefill_inputs(cfg, mesh, S, B, dtype)
        fn = _sharded_cache_step(make_prefill_step(cfg), cfg, mesh,
                                 args[0].specs, args[2].specs)
    else:
        args = decode_inputs(cfg, mesh, S, B, dtype)
        fn = _sharded_cache_step(make_serve_step(cfg), cfg, mesh,
                                 args[0].specs, args[2].specs,
                                 seq_shard=B == 1)
    return fn, args


def run_sharded(program, args, workers) -> list:
    """Run ``program`` on every shard of ``workers``' mesh (a
    ``ShardWorkers`` over a ``distributed.sharding.Mesh``): ``args`` are
    (tree, specs) pairs of real tensors (or None), each shard given its
    own copy of its slices.  A train program's batch (its third
    argument) is the global batch in the reference's row order, cut in
    the order of the program's microbatches as ``shard_batch`` cuts it.
    Returns every shard's result, in order."""
    mesh = workers.mesh
    if hasattr(program, "microbatches"):     # (params, opt_state, batch)
        batch, specs = args[2]
        parts = _axis_size(mesh, next(iter(specs.values()))[0])
        args = [*args[:2], (microbatch_order(batch, parts,
                                             program.microbatches), specs),
                *args[3:]]
    placed = [None if a is None else shard_tree(a[0], a[1], mesh, copy=True)
              for a in args]
    return workers.run(lambda i, ms: program(
        ms, *[None if p is None else p[i] for p in placed]))


def run_shard0(program, args, mesh):
    """Shard (0, 0)'s program alone over ``Abstract`` inputs: every input
    its meta slice, every collective a solo one (its result the gathered
    shape, its bytes counted), every kernel wrapper its plain version
    (``kernels.shapes_only``).  Returns (result, MeshComms)."""
    comms = MeshComms(mesh, solo=True)
    local = [None if a is None else _walk(
        lambda t, sp: local_slice(t, sp, mesh, 0), a.tree, a.specs)
        for a in args]
    with shapes_only():
        return program(MeshShard(mesh, comms, 0), *local), comms
