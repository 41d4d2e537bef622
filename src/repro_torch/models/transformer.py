"""Decoder stack for every block kind of the reference (port of
``repro/models/transformer.py``).

Parameters keep the JAX pytree's layout: ``cfg.block_pattern`` is grouped
into homogeneous segments and each segment's block parameters are stacked
on a leading layer axis (unstacked when the segment has one layer).  Where
JAX runs ``lax.scan`` over a segment, this module loops over the layer
index in Python; each layer reads and writes its own slice of the stacked
page pools (or SSM lane rows) in place.  Block kinds: ``attn`` (GQA +
dense MLP), ``attn_moe`` (GQA + MoE FFN, phi3.5-moe), ``cross_attn``
(GQA, then cross-attention over encoder or image states, then a dense
MLP: whisper's decoder, the VLM's image layers), ``shared_attn`` (a GQA +
dense MLP block whose ONE parameter set, ``params["shared_attn"]``, runs
at every occurrence, each occurrence with its own page pools: zamba2),
``mla`` (MLA + dense MLP), ``mla_moe`` (MLA + MoE FFN, DeepSeek-V2) and
``ssm`` (a Mamba2 mixer, no FFN half); any other kind raises
``NotImplementedError``.  A ``shared_attn`` segment holds the reference's
empty marker ``{}`` in ``params["segments"]``.  Learned positions
(``cfg.learned_pos``, whisper) are added to the embeddings, clipped to
the table.

``model_forward(train=True)`` is the training forward: every mixer takes
the reference's plain branches (``sdpa`` / ``sdpa_chunked``, the SSM's
``ssd_chunked``), since the hand kernels have no backward.  With
``cfg.remat`` each layer of a segment of several layers then runs under
``torch.utils.checkpoint`` (its activations recomputed in the backward),
as the reference wraps its scan body in ``jax.checkpoint``.

``model_forward(shard=...)`` is one shard's call of a mesh-sharded engine
(``distributed/sharding.py``): attention heads, MoE experts and the dense
FFN's hidden columns run shard-local and are combined by all-gathers and
single-contributor sums; ``cross_attn`` blocks replicate whole (no shard
reaches them, as in the reference), zamba2's ``shared_attn`` shards like
``attn``, and SSM blocks compute replicated.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models.attention import (attn_forward, attn_output,
                                          cross_attn_forward, init_attn,
                                          init_mla, mla_forward,
                                          project_cross_kv)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (apply_mlp, apply_norm, embed,
                                       init_embed, init_mlp, init_norm,
                                       init_unembed, matmul_promoted)
from repro_torch.models.moe import init_moe, moe_forward
from repro_torch.models.ssm import (init_ssm, ssm_decode_step, ssm_forward,
                                    write_lane_rows)

PORTED_KINDS = ("attn", "attn_moe", "cross_attn", "shared_attn", "mla",
                "mla_moe", "ssm")
MLA_KINDS = ("mla", "mla_moe")
MOE_KINDS = ("attn_moe", "mla_moe")


def _check_ported(cfg: ModelConfig) -> None:
    bad = sorted({k for k in cfg.block_pattern if k not in PORTED_KINDS})
    if bad:
        raise NotImplementedError(
            f"{cfg.name}: block kinds {bad} are not yet ported")


# ------------------------------ blocks --------------------------------- #
def init_block(gen, kind: str, cfg: ModelConfig, dtype=torch.float32,
               device=None):
    p = {"norm1": init_norm(cfg.d_model, cfg.norm, device)}
    if kind == "ssm":
        p["ssm"] = init_ssm(gen, cfg, dtype, device)
        return p                                   # Mamba block: no FFN half
    if kind in MLA_KINDS:
        p["attn"] = init_mla(gen, cfg, dtype, device)
    else:
        p["attn"] = init_attn(gen, cfg, dtype, device)
    if kind == "cross_attn":
        p["norm_x"] = init_norm(cfg.d_model, cfg.norm, device)
        p["cross"] = init_attn(gen, cfg, dtype, device, cross=True)
    p["norm2"] = init_norm(cfg.d_model, cfg.norm, device)
    if kind in MOE_KINDS:
        p["moe"] = init_moe(gen, cfg, dtype, device)
    else:
        p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.act,
                            cfg.use_bias, dtype, device)
    return p


def block_forward(p, kind: str, cfg: ModelConfig, x, *, positions,
                  cache=None, pos0=None, block_tables=None, chunk_len=None,
                  verify=False, moe_cf=None, enc_kv=None, train=False,
                  shard=None):
    """One block: pre-norm attention (GQA or MLA) then a pre-norm dense MLP
    or MoE FFN, or a pre-norm Mamba2 mixer.  Returns (x, aux): aux is the
    MoE layer's load-balance ``aux_loss``, None for any other block.  A
    ``cross_attn`` block adds a pre-norm cross-attention over ``enc_kv``
    (dict(k, v), this layer's projection of the encoder states) after the
    self-attention residual, gated by ``tanh(gate)`` in a VLM.  MLA takes
    no ``verify`` flag: its verify window is a chunked prefill, as in the
    reference.

    An ``ssm`` block with a cache takes a decode step when S == 1, else a
    prefill chunk, and stores its new lane rows into ``cache`` in place; a
    lane with ``chunk_len`` 0 keeps its rows (a padded prefill lane by
    construction, a frozen decode lane by ``where``).  ``train``: the
    training forward; ``shard``: a mesh shard's context (the module
    docstring)."""
    if kind == "cross_attn":
        shard = None            # the whole block replicates
    h = apply_norm(p["norm1"], x, cfg.norm)
    if kind == "ssm":
        if cache is not None and x.shape[1] == 1:
            y, new = ssm_decode_step(p["ssm"], h, cfg, cache)
            keep = None if chunk_len is None else chunk_len > 0
        else:
            y, new = ssm_forward(
                p["ssm"], h, cfg, cache=cache,
                chunk_len=chunk_len if cache is not None else None,
                train=train)
            keep = None
        if cache is not None:
            write_lane_rows(cache, new, keep)
        return x + y.to(x.dtype), None
    if kind in MLA_KINDS:
        y, _ = mla_forward(p["attn"], h, cfg, positions=positions,
                           cache=cache, pos0=pos0, block_tables=block_tables,
                           chunk_len=chunk_len, train=train, shard=shard)
    else:
        ctx, _ = attn_forward(p["attn"], h, cfg, positions=positions,
                              cache=cache, pos0=pos0,
                              block_tables=block_tables,
                              chunk_len=chunk_len, verify=verify, train=train,
                              shard=shard)
        y = attn_output(p["attn"], ctx, shard)
    x = x + y.to(x.dtype)
    if kind == "cross_attn":
        hx = apply_norm(p["norm_x"], x, cfg.norm)
        x = x + cross_attn_forward(p["cross"], hx, enc_kv,
                                   gated=cfg.arch_type == "vlm", train=train)
    h2 = apply_norm(p["norm2"], x, cfg.norm)
    aux = None
    if kind in MOE_KINDS:
        y2, moe_aux = moe_forward(p["moe"], h2, cfg, capacity_factor=moe_cf,
                                  shard=shard)
        aux = moe_aux["aux_loss"]
    else:
        y2 = apply_mlp(p["mlp"], h2, cfg.act, shard)
    return x + y2.to(x.dtype), aux


def _stacked_like(tree, n: int):
    """Uninitialised tensors of ``tree``'s leaves with a leading axis n."""
    if isinstance(tree, dict):
        return {k: _stacked_like(v, n) for k, v in tree.items()}
    return tree.new_empty((n,) + tuple(tree.shape))


def _set_layer(stacked, i: int, tree) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _set_layer(stacked[k], i, v)
    else:
        stacked[i].copy_(tree)


def _layer(tree, i: int):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _unstack(tree, n: int) -> list:
    """The n per-layer trees of a stacked segment, views through one
    ``unbind`` per leaf: its backward stacks the layers' gradients into
    one tensor, where indexing each layer would add a zero-filled
    gradient of the whole stack per layer."""
    if isinstance(tree, dict):
        subs = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: sub[i] for k, sub in subs.items()} for i in range(n)]
    return tree.unbind(0)


# ----------------------------- model init ------------------------------ #
def init_params(cfg: ModelConfig, gen: torch.Generator,
                dtype=torch.float32, device=None):
    """Random weights with the JAX init's shapes and scales (normal draws
    times d_model^-0.5 etc.), drawn from ``gen``.  The numbers differ from
    JAX's for the same seed; tests bridge JAX's weights instead.
    ``device`` follows ``resolve_device``: CUDA unless named."""
    _check_ported(cfg)
    device = resolve_device(device)
    params = {"embed": init_embed(gen, cfg.vocab, cfg.d_model, dtype, device),
              "final_norm": init_norm(cfg.d_model, cfg.norm, device)}
    if not cfg.tie_embeddings:
        params["unembed"] = init_unembed(gen, cfg.vocab, cfg.d_model, dtype,
                                         device)
    if cfg.learned_pos:
        params["pos_embed"] = torch.randn(
            cfg.learned_pos, cfg.d_model, generator=gen, dtype=dtype,
            device=device) * 0.02
    segs = []
    for kind, n in cfg.segments():
        if kind == "shared_attn":
            # one block for every occurrence, drawn at the first one
            if "shared_attn" not in params:
                params["shared_attn"] = init_block(gen, kind, cfg, dtype,
                                                   device)
            segs.append({})               # marker: params live in shared_attn
            continue
        block = init_block(gen, kind, cfg, dtype, device)
        if n > 1:
            # filled layer by layer, so that at most one unstacked block
            # lives beside the stack (a deepseek-v2 MoE block is 15 GB)
            stacked = _stacked_like(block, n)
            for l in range(n):
                if l:
                    block = init_block(gen, kind, cfg, dtype, device)
                _set_layer(stacked, l, block)
                del block
            block = stacked
        segs.append({"p": block})
    params["segments"] = segs
    return params


# ------------------------------ caches --------------------------------- #
def _ssm_lane_shapes(cfg: ModelConfig, lanes: int) -> dict:
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    return {"conv": (lanes, s.d_conv - 1, d_in + 2 * s.d_state),
            "state": (lanes, d_in // s.head_dim, s.head_dim, s.d_state)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.float32, device=None):
    """Per-segment dense fixed-buffer caches, the reference's
    ``init_cache``: ``{"self": {"k", "v"}}`` of shape (batch, max_len, KVH,
    hd) for attention segments, ``{"self": {"ckv", "krope"}}`` of shape
    (batch, max_len, kv_lora_rank | qk_rope_head_dim) for MLA segments and
    the SSM lane rows ``{"conv", "state"}`` (one row per lane), each
    stacked on a leading layer axis for a segment of several layers, each
    layer with its own zeroed memory.  ``model_forward`` writes a chunk at
    ``pos0`` in place.  ``device`` follows ``resolve_device``: CUDA unless
    named."""
    _check_ported(cfg)
    device = resolve_device(device)
    caches = []
    for kind, n in cfg.segments():
        lead = (n,) if n > 1 else ()
        if kind == "ssm":
            shapes = _ssm_lane_shapes(cfg, batch)
        elif kind in MLA_KINDS:
            shapes = {"ckv": (batch, max_len, cfg.mla.kv_lora_rank),
                      "krope": (batch, max_len, cfg.mla.qk_rope_head_dim)}
        else:
            kv = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
            shapes = {"k": kv, "v": kv}
        c = {name: torch.zeros(lead + shape, dtype=dtype, device=device)
             for name, shape in shapes.items()}
        caches.append(c if kind == "ssm" else {"self": c})
    return caches


def init_paged_cache(cfg: ModelConfig, n_pages: int, page_size: int,
                     max_seqs: int = 1, dtype=torch.float32, device=None):
    """Per-segment page pools, ``{"self": {"k_pages", "v_pages"}}`` of
    shape (n_pages + 1, page, KVH, hd) for ``attn`` segments and
    ``{"self": {"ckv_pages", "krope_pages"}}`` of shape (n_pages + 1, page,
    kv_lora_rank | qk_rope_head_dim) for MLA segments (one headless latent
    row per token); for ``ssm`` segments per-sequence lane rows
    ``{"conv": (max_seqs, d_conv - 1, C), "state": (max_seqs, H, P, N)}``,
    whose size does not grow with context.  Each is stacked on a leading
    layer axis for a segment of several layers.  Each layer gets its own
    memory (JAX's ``broadcast_to`` would become an aliasing ``expand``
    here).  The extra
    last page is the write-off page of ``attention.paged_write``; no block
    table maps it.  ``device`` follows ``resolve_device``: CUDA unless
    named."""
    _check_ported(cfg)
    device = resolve_device(device)
    caches = []
    for kind, n in cfg.segments():
        lead = (n,) if n > 1 else ()
        if kind == "ssm":
            shapes = _ssm_lane_shapes(cfg, max_seqs)
            caches.append({name: torch.zeros(lead + shape, dtype=dtype,
                                             device=device)
                           for name, shape in shapes.items()})
            continue
        base = (n_pages + 1, page_size)
        if kind in MLA_KINDS:
            shapes = {"ckv_pages": (cfg.mla.kv_lora_rank,),
                      "krope_pages": (cfg.mla.qk_rope_head_dim,)}
        else:
            hd = (cfg.n_kv_heads, cfg.head_dim)
            shapes = {"k_pages": hd, "v_pages": hd}
        caches.append({"self": {
            name: torch.zeros(lead + base + tail, dtype=dtype, device=device)
            for name, tail in shapes.items()}})
    return caches


# ---------------------------- full forward ----------------------------- #
def _layer_forward(p, kind: str, cfg: ModelConfig, x, enc_states, **kw):
    """``block_forward`` of one layer, its cross-attention K/V projected
    from ``enc_states`` inside (so that remat recomputes them too)."""
    enc_kv = (project_cross_kv(p["cross"], enc_states)
              if kind == "cross_attn" else None)
    return block_forward(p, kind, cfg, x, enc_kv=enc_kv, **kw)


def model_forward(params, cfg: ModelConfig, tokens, *, cache=None, pos0=None,
                  block_tables=None, chunk_len=None, verify=False,
                  moe_cf=None, enc_states=None, train=False, shard=None):
    """Returns (hidden (B, S, D), cache, aux): aux is the sum of every MoE
    layer's load-balance ``aux_loss`` (a float32 scalar, 0 without MoE).

    ``cache=None`` is full causal attention over ``tokens`` (through B6,
    or the masked ``sdpa`` for a sliding window); with ``train`` it is the
    training forward (the module docstring).  Without a cache, under
    ``cfg.remat``, each layer of a segment of several layers is
    checkpointed.  With the fixed buffers of ``init_cache``, the S new
    tokens are written at ``pos0`` in place and attend through the masked
    ``sdpa``.
    ``enc_states`` (B, T, D): the encoder output (whisper) or image
    embeddings (VLM) that every ``cross_attn`` layer attends to; each such
    layer projects its own K/V from them on every call, as the reference
    does.  With paged
    pools from ``init_paged_cache``, the S new tokens of each lane are
    written at offset ``pos0`` (B,) through ``block_tables`` (B, max_pages)
    — only the first ``chunk_len`` (B,) of them — and the pools are
    updated in place (the returned cache is the one passed in).  SSM
    segments take lane rows with one row per batch lane (the manager's
    ``lane_cache``), updated in place the same way.
    ``verify=True`` marks the chunk as a speculative-decoding verify
    window, which the GQA layers send to the verify kernel.  ``moe_cf`` is
    the MoE capacity factor (None: the reference's default 2.0; the
    engine passes the dropless E / k).  ``shard``: one shard's call of a
    mesh-sharded engine, whose ``params`` and ``cache`` are that shard's
    (the module docstring)."""
    _check_ported(cfg)
    x = embed(params["embed"], tokens) if not tokens.is_floating_point() \
        else tokens
    B, S = x.shape[:2]
    if pos0 is None:
        pos0 = torch.zeros(B, dtype=torch.int32, device=x.device)
    positions = pos0[:, None] + torch.arange(S, device=x.device)[None, :]
    if cfg.learned_pos:
        x = x + params["pos_embed"][
            positions.clamp(0, cfg.learned_pos - 1).long()]
    auxes = []
    for i, (kind, n) in enumerate(cfg.segments()):
        # a shared_attn marker segment runs the one shared block
        seg_p = (params["shared_attn"] if kind == "shared_attn"
                 else params["segments"][i]["p"])
        seg_c = None
        if cache is not None:
            seg_c = cache[i] if kind == "ssm" else cache[i]["self"]
        if kind == "cross_attn" and enc_states is None:
            raise ValueError(f"{cfg.name}: cross_attn layers need enc_states")
        # the reference checkpoints the body of a scanned segment only
        remat = (cfg.remat and cache is None and n > 1
                 and kind != "shared_attn")
        per_layer = (None if n == 1 or kind == "shared_attn"
                     else _unstack(seg_p, n))
        for l in range(n):
            p = seg_p if per_layer is None else per_layer[l]
            c = None
            if seg_c is not None:
                c = seg_c if n == 1 else {k: t[l] for k, t in seg_c.items()}
            args = (p, kind, cfg, x, enc_states)
            kw = dict(positions=positions, cache=c, pos0=pos0,
                      block_tables=block_tables, chunk_len=chunk_len,
                      verify=verify, moe_cf=moe_cf, train=train,
                      shard=shard)
            if remat:
                x, aux = checkpoint(_layer_forward, *args, use_reentrant=False,
                                    **kw)
            else:
                x, aux = _layer_forward(*args, **kw)
            if aux is not None:
                auxes.append(aux)
    aux_total = (torch.stack(auxes).sum() if auxes else
                 torch.zeros((), dtype=torch.float32, device=x.device))
    return apply_norm(params["final_norm"], x, cfg.norm), cache, aux_total


def logits_fn(params, cfg: ModelConfig, hidden):
    w = params["embed"]["embed"].T if cfg.tie_embeddings else params["unembed"]
    return matmul_promoted(hidden, w)
