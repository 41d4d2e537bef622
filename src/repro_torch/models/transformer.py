"""Decoder stack for dense ``attn`` models (port of
``repro/models/transformer.py``).

Parameters keep the JAX pytree's layout: ``cfg.block_pattern`` is grouped
into homogeneous segments and each segment's block parameters are stacked
on a leading layer axis (unstacked when the segment has one layer).  Where
JAX runs ``lax.scan`` over a segment, this module loops over the layer
index in Python; each layer reads and writes its own slice of the stacked
page pools in place.  Only ``attn`` blocks are ported: any other block
kind raises ``NotImplementedError``.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models.attention import attn_forward, attn_output, init_attn
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (apply_mlp, apply_norm, embed,
                                       init_embed, init_mlp, init_norm,
                                       init_unembed)

PORTED_KINDS = ("attn",)


def _check_ported(cfg: ModelConfig) -> None:
    bad = sorted({k for k in cfg.block_pattern if k not in PORTED_KINDS})
    if bad or cfg.learned_pos or cfg.encoder is not None:
        raise NotImplementedError(
            f"{cfg.name}: block kinds {bad or cfg.block_pattern[:1]} "
            f"(or learned positions / encoder) are not yet ported")


# ------------------------------ blocks --------------------------------- #
def init_block(gen, cfg: ModelConfig, dtype=torch.float32, device=None):
    return {"norm1": init_norm(cfg.d_model, cfg.norm, device),
            "attn": init_attn(gen, cfg, dtype, device),
            "norm2": init_norm(cfg.d_model, cfg.norm, device),
            "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.act,
                            cfg.use_bias, dtype, device)}


def block_forward(p, cfg: ModelConfig, x, *, positions, cache=None,
                  pos0=None, block_tables=None, chunk_len=None, verify=False):
    """One ``attn`` block: pre-norm attention then pre-norm MLP."""
    h = apply_norm(p["norm1"], x, cfg.norm)
    ctx, _ = attn_forward(p["attn"], h, cfg, positions=positions,
                          cache=cache, pos0=pos0, block_tables=block_tables,
                          chunk_len=chunk_len, verify=verify)
    x = x + attn_output(p["attn"], ctx).to(x.dtype)
    h2 = apply_norm(p["norm2"], x, cfg.norm)
    return x + apply_mlp(p["mlp"], h2, cfg.act).to(x.dtype)


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _layer(tree, i: int):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


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
    segs = []
    for _, n in cfg.segments():
        blocks = [init_block(gen, cfg, dtype, device) for _ in range(n)]
        segs.append({"p": blocks[0] if n == 1 else _stack(blocks)})
    params["segments"] = segs
    return params


# ------------------------------ caches --------------------------------- #
def init_paged_cache(cfg: ModelConfig, n_pages: int, page_size: int,
                     dtype=torch.float32, device=None):
    """Per-segment page pools ``{"self": {"k_pages", "v_pages"}}`` of
    shape (layers, n_pages + 1, page, KVH, hd), unstacked for a one-layer
    segment.  Each layer gets its own memory (JAX's ``broadcast_to`` would
    become an aliasing ``expand`` here).  The extra last page is the
    write-off page of ``attention.paged_write``; no block table maps it.
    ``device`` follows ``resolve_device``: CUDA unless named."""
    _check_ported(cfg)
    device = resolve_device(device)
    caches = []
    for _, n in cfg.segments():
        shape = (n_pages + 1, page_size, cfg.n_kv_heads, cfg.head_dim)
        if n > 1:
            shape = (n,) + shape
        caches.append({"self": {
            "k_pages": torch.zeros(shape, dtype=dtype, device=device),
            "v_pages": torch.zeros(shape, dtype=dtype, device=device)}})
    return caches


# ---------------------------- full forward ----------------------------- #
def model_forward(params, cfg: ModelConfig, tokens, *, cache=None, pos0=None,
                  block_tables=None, chunk_len=None, verify=False):
    """Returns (hidden (B, S, D), cache).

    ``cache=None`` is full causal attention over ``tokens``.  With paged
    pools from ``init_paged_cache``, the S new tokens of each lane are
    written at offset ``pos0`` (B,) through ``block_tables`` (B, max_pages)
    — only the first ``chunk_len`` (B,) of them — and the pools are
    updated in place (the returned cache is the one passed in).
    ``verify=True`` marks the chunk as a speculative-decoding verify
    window, which the attention layers send to the verify kernel."""
    _check_ported(cfg)
    x = embed(params["embed"], tokens) if not tokens.is_floating_point() \
        else tokens
    B, S = x.shape[:2]
    if pos0 is None:
        pos0 = torch.zeros(B, dtype=torch.int32, device=x.device)
    positions = pos0[:, None] + torch.arange(S, device=x.device)[None, :]
    for i, (_, n) in enumerate(cfg.segments()):
        seg_p = params["segments"][i]["p"]
        seg_c = cache[i]["self"] if cache is not None else None
        for l in range(n):
            p = seg_p if n == 1 else _layer(seg_p, l)
            c = None
            if seg_c is not None:
                c = seg_c if n == 1 else {k: t[l] for k, t in seg_c.items()}
            x = block_forward(p, cfg, x, positions=positions, cache=c,
                              pos0=pos0, block_tables=block_tables,
                              chunk_len=chunk_len, verify=verify)
    return apply_norm(params["final_norm"], x, cfg.norm), cache


def logits_fn(params, cfg: ModelConfig, hidden):
    w = params["embed"]["embed"].T if cfg.tie_embeddings else params["unembed"]
    return hidden @ w
