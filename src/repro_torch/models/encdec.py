"""Encoder-decoder (Whisper-style) backbone [arXiv:2212.04356] (port of
``repro/models/encdec.py``).

The mel-spectrogram and conv feature extractor are a stub, as in the
reference: the encoder takes precomputed frame embeddings (B, T, D).  The
encoder is a stack of bidirectional pre-norm blocks (LayerNorm, GQA
attention through B6 with ``causal=False``, a GELU MLP of width 4 D) over
frames plus learned positions; its layer parameters are stacked on a
leading axis as in the reference's ``vmap`` init, and the layers run in a
Python loop where the reference scans.  The decoder is
``transformer.model_forward`` with ``cross_attn`` blocks over the encoder
output.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models.attention import attn_forward, attn_output, init_attn
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (apply_mlp, apply_norm, init_mlp,
                                       init_norm)
from repro_torch.models.transformer import (_set_layer, _stacked_like,
                                            _unstack, init_params,
                                            model_forward)


def init_encoder(cfg: ModelConfig, gen: torch.Generator, dtype=torch.float32,
                 device=None):
    """Encoder weights with the reference's shapes and scales, drawn from
    ``gen``: ``{"layers": stacked blocks, "pos": (n_frames, D),
    "final_norm"}``.  Filled layer by layer, so that at most one unstacked
    block lives beside the stack."""
    device = resolve_device(device)
    enc = cfg.encoder
    d = enc.d_model or cfg.d_model

    def one():
        return {"norm1": init_norm(d, "layernorm", device),
                "attn": init_attn(gen, cfg, dtype, device),
                "norm2": init_norm(d, "layernorm", device),
                "mlp": init_mlp(gen, d, 4 * d, "gelu", cfg.use_bias, dtype,
                                device)}
    block = one()
    layers = _stacked_like(block, enc.n_layers)
    for i in range(enc.n_layers):
        if i:
            block = one()
        _set_layer(layers, i, block)
        del block
    pos = torch.randn(enc.n_frames, d, generator=gen, dtype=dtype,
                      device=device) * 0.02
    return {"layers": layers, "pos": pos,
            "final_norm": init_norm(d, "layernorm", device)}


def encoder_forward(params, cfg: ModelConfig, frames):
    """frames: (B, T, D) precomputed conv-frontend embeddings (the stub).
    Returns the encoder states (B, T, D)."""
    B, T, _ = frames.shape
    x = frames + params["pos"][None, :T]
    positions = torch.arange(T, device=frames.device)[None, :].expand(B, T)
    for p in _unstack(params["layers"], cfg.encoder.n_layers):
        h = apply_norm(p["norm1"], x, "layernorm")
        ctx, _ = attn_forward(p["attn"], h, cfg, positions=positions,
                              causal=False)
        x = x + attn_output(p["attn"], ctx)
        h2 = apply_norm(p["norm2"], x, "layernorm")
        x = x + apply_mlp(p["mlp"], h2, "gelu")
    return apply_norm(params["final_norm"], x, "layernorm")


# --------------------------- whole enc-dec ------------------------------ #
def init_encdec_params(cfg: ModelConfig, gen: torch.Generator,
                       dtype=torch.float32, device=None):
    """Decoder weights (``transformer.init_params``) plus
    ``params["encoder"]`` (``init_encoder``), from one generator."""
    params = init_params(cfg, gen, dtype, device)
    params["encoder"] = init_encoder(cfg, gen, dtype, device)
    return params


def encdec_forward(params, cfg: ModelConfig, frames, tokens, *,
                   enc_states=None, **kw):
    """Run the encoder (unless ``enc_states`` is given), then the
    cross-attending decoder; returns ``model_forward``'s (hidden, cache,
    aux).
    Further keywords (``cache``, ``pos0``, ``block_tables``,
    ``chunk_len``) go to ``model_forward``."""
    if enc_states is None:
        enc_states = encoder_forward(params["encoder"], cfg, frames)
    return model_forward(params, cfg, tokens, enc_states=enc_states, **kw)
