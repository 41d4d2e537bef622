"""Shared layers: norms, RoPE, MLPs, embeddings (port of
``repro/models/layers.py``).  Parameters are plain tensors in dicts with
the JAX pytree's key names; norms and RoPE compute in float32."""
from __future__ import annotations

import torch
import torch.nn.functional as F


# ------------------------------ norms ---------------------------------- #
def init_norm(d: int, kind: str = "rmsnorm", device=None):
    p = {"scale": torch.ones(d, dtype=torch.float32, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros(d, dtype=torch.float32, device=device)
    return p


def promote(*ts):
    """``ts`` cast to their common dtype as ``jnp`` promotes mixed
    operands before an op (``torch`` refuses a float32 operand beside a
    bfloat16 one in a matmul, and lets a 0-d float32 tensor take a bf16
    tensor's dtype).  Tensors already of that dtype are returned as they
    are, so a float32 model's ops are unchanged."""
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return [t.to(dt) for t in ts]


def matmul_promoted(a, b):
    """``a @ b`` with ``jnp``'s dtype rule (``promote``)."""
    a, b = promote(a, b)
    return a @ b


def einsum_promoted(eq: str, *ops):
    """``torch.einsum`` with ``jnp.einsum``'s dtype rule (``promote``)."""
    return torch.einsum(eq, *promote(*ops))


def apply_norm(p, x, kind: str = "rmsnorm", eps: float = 1e-6):
    xf = x.float()
    if kind == "rmsnorm":
        xf = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
        return (xf * p["scale"]).to(x.dtype)
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, unbiased=False, keepdim=True)
    xf = (xf - mu) * torch.rsqrt(var + eps)
    return (xf * p["scale"] + p["bias"]).to(x.dtype)


def rms_head_norm(scale, x, eps: float = 1e-6):
    """Per-head q/k norm (Qwen3): x is (..., n_heads, head_dim)."""
    xf = x.float()
    xf = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
    return (xf * scale).to(x.dtype)


# ------------------------------- RoPE ---------------------------------- #
def rope_freqs(head_dim: int, theta: float, device=None):
    ex = torch.arange(0, head_dim, 2, dtype=torch.float32,
                      device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), ex)


def apply_rope(x, positions, theta: float = 10000.0):
    """Half-split RoPE.  x: (B, S, H, hd); positions: (B, S) int."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                  # (hd/2,)
    ang = positions[..., None].float() * freqs               # (B, S, hd/2)
    cos = torch.cos(ang)[..., None, :]                       # (B, S, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ------------------------------- MLPs ----------------------------------- #
def init_mlp(gen, d_model: int, d_ff: int, act: str = "swiglu",
             use_bias: bool = False, dtype=torch.float32, device=None):
    def normal(*shape):
        return torch.randn(*shape, generator=gen, dtype=dtype, device=device)
    p = {"w_up": normal(d_model, d_ff) * d_model ** -0.5,
         "w_down": normal(d_ff, d_model) * d_ff ** -0.5}
    if act == "swiglu":
        p["w_gate"] = normal(d_model, d_ff) * d_model ** -0.5
    if use_bias:
        p["b_up"] = torch.zeros(d_ff, dtype=dtype, device=device)
        p["b_down"] = torch.zeros(d_model, dtype=dtype, device=device)
    return p


def apply_mlp(p, x, act: str = "swiglu", shard=None):
    """``shard``: a mesh shard's ``ShardCtx`` (``distributed/sharding``).
    Under ``shard.mlp`` ``w_gate`` / ``w_up`` / ``b_up`` hold this shard's
    columns of d_ff, and the hidden activation is all-gathered (a
    concatenation: each column's value is the unsharded one) before the
    replicated ``w_down``; ``x`` passes ``shard.enter`` (for training:
    its gradient is summed over the shards)."""
    if shard is not None and shard.mlp:
        x = shard.enter(x)
    up = matmul_promoted(x, p["w_up"])
    if "b_up" in p:
        up = up + p["b_up"]
    if act == "swiglu":
        h = F.silu(matmul_promoted(x, p["w_gate"])) * up
    else:
        h = F.gelu(up, approximate="tanh")    # jax.nn.gelu's default
    if shard is not None and shard.mlp:
        h = shard.all_gather(h, h.dim() - 1)
    out = matmul_promoted(h, p["w_down"])
    if "b_down" in p:
        out = out + p["b_down"]
    return out


# ----------------------------- embeddings ------------------------------- #
def init_embed(gen, vocab: int, d_model: int, dtype=torch.float32,
               device=None):
    return {"embed": torch.randn(vocab, d_model, generator=gen, dtype=dtype,
                                 device=device) * 0.02}


def embed(p, tokens):
    return p["embed"][tokens]


def init_unembed(gen, vocab: int, d_model: int, dtype=torch.float32,
                 device=None):
    return torch.randn(d_model, vocab, generator=gen, dtype=dtype,
                       device=device) * d_model ** -0.5
