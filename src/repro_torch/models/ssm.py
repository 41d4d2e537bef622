"""Mamba2 (SSD, state-space duality) mixer block [arXiv:2405.21060]; port
of ``repro/models/ssm.py``.

Prefill runs the chunked SSD scan through ``kernels.ssd_scan`` (kernel B5
on the card, its plain version on the CPU); decode is the O(1) recurrent
update in plain PyTorch, as in the reference (it has no Pallas kernel).
The training forward (``ssm_forward(train=True)``) runs this module's own
``ssd_chunked``, the reference's pure-jnp scan, since B5 has no backward.
Per-lane state is ``{"conv": (B, d_conv - 1, C), "state": (B, H, P, N)}``,
C = d_inner + 2 d_state.  ``write_lane_rows`` stores a call's new state
into the caller's rows in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import einsum_promoted, matmul_promoted


def init_ssm(gen, cfg: ModelConfig, dtype=torch.float32, device=None):
    """The reference's shapes and scales, drawn from ``gen``."""
    s = cfg.ssm
    d = cfg.d_model
    d_in = s.expand * d
    nheads = d_in // s.head_dim
    conv_ch = d_in + 2 * s.d_state

    def normal(*shape):
        return torch.randn(*shape, generator=gen, dtype=dtype, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        # fused input projection: [x (d_in), z (d_in), B (N), C (N), dt (H)]
        "w_in": normal(d, 2 * d_in + 2 * s.d_state + nheads) * d ** -0.5,
        "conv_w": normal(s.d_conv, conv_ch) * 0.1,
        "conv_b": torch.zeros(conv_ch, dtype=dtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nheads, **f32)),
        "D": torch.ones(nheads, **f32),
        "dt_bias": torch.zeros(nheads, **f32),
        "norm_scale": torch.ones(d_in, **f32),
        "w_out": normal(d_in, d) * d_in ** -0.5,
    }


def _split_proj(cfg: ModelConfig, proj):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nheads = d_in // s.head_dim
    x, z, B, C, dt = torch.split(
        proj, [d_in, d_in, s.d_state, s.d_state, nheads], dim=-1)
    return x, z, B, C, dt, d_in, nheads


def _causal_conv(w, b, x, state=None, chunk_len=None):
    """Depthwise causal conv1d.  x: (B, S, C); state: (B, d_conv - 1, C).

    chunk_len: (B,) true lengths when x carries bucket padding; the
    returned state is then the last K - 1 REAL inputs (ending at position
    chunk_len - 1), gathered on the device with no host sync."""
    K = w.shape[0]
    if state is None:
        pad = x.new_zeros(x.shape[0], K - 1, x.shape[2])
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                         # (B, S+K-1, C)
    S = x.shape[1]
    out = sum(xp[:, i:i + S, :] * w[i] for i in range(K)) + b
    if K == 1:
        new_state = pad[:, :0]
    elif chunk_len is None:
        new_state = xp[:, -(K - 1):, :]
    else:
        # real input i sits at xp index K-1+i, so the last K-1 real inputs
        # are xp[len : len+K-1]
        idx = (chunk_len.long()[:, None]
               + torch.arange(K - 1, device=x.device)[None, :])
        new_state = torch.gather(
            xp, 1, idx[:, :, None].expand(-1, -1, xp.shape[2]))
    return F.silu(out), new_state


def _rmsnorm_gated(scale, x, z, eps=1e-6):
    xf = (x * F.silu(z)).float()
    xf = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
    return (xf * scale).to(x.dtype)


def ssd_chunked(xh, dt, A, Bm, Cm, chunk: int, init_state=None):
    """Chunked SSD scan (the reference's ``ssd_chunked``; its
    ``lax.scan`` over chunks is a Python loop here, and its einsums
    promote mixed dtypes as ``jnp.einsum`` does).

    xh: (B, S, H, P); dt: (B, S, H); A: (H,) negative decay rates; Bm, Cm:
    (B, S, N), one SSM group shared across heads; init_state: (B, H, P, N)
    or None.  Returns (y (B, S, H, P), final_state (B, H, P, N))."""
    Bsz, S, H, P = xh.shape
    N = Bm.shape[-1]
    if S % chunk:
        raise ValueError(f"ssd_chunked: chunk {chunk} does not divide S {S}")
    nc = S // chunk
    xc = xh.reshape(Bsz, nc, chunk, H, P)
    dtc = dt.reshape(Bsz, nc, chunk, H)
    Bc = Bm.reshape(Bsz, nc, chunk, N)
    Cc = Cm.reshape(Bsz, nc, chunk, N)
    mask = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                 device=xh.device))
    h = (torch.zeros(Bsz, H, P, N, device=xh.device) if init_state is None
         else init_state.float())
    ys = []
    for c in range(nc):
        xk, dtk, Bk, Ck = xc[:, c], dtc[:, c], Bc[:, c], Cc[:, c]
        dA = dtk.float() * A[None, None, :]                 # (B, L, H) <= 0
        seg = torch.cumsum(dA, dim=1)
        diff = seg[:, :, None, :] - seg[:, None, :, :]
        # mask BEFORE exp: exp of the (masked) positive upper triangle
        # overflows to inf and poisons gradients through the where
        diff = torch.where(mask[None, :, :, None], diff, -1e30)
        decay = torch.exp(diff)
        cb = einsum_promoted("bln,bmn->blm", Ck, Bk)        # (B, L, M)
        att = cb[..., None] * decay                         # (B, L, M, H)
        y_intra = einsum_promoted("blmh,bmh,bmhp->blhp", att, dtk, xk)
        # inter-chunk: contribution of the incoming state
        y_inter = einsum_promoted("bln,blh,bhpn->blhp", Ck,
                                  torch.exp(seg).to(Ck.dtype),
                                  h.to(Ck.dtype))
        # state at the end of the chunk
        decay_to_end = torch.exp(seg[:, -1:, :] - seg)      # (B, L, H)
        st = einsum_promoted("bln,blh,blh,blhp->bhpn", Bk, dtk,
                             decay_to_end.to(Bk.dtype), xk)
        h = h * torch.exp(dA.sum(dim=1))[..., None, None] + st.float()
        ys.append((y_intra + y_inter).to(xh.dtype))
    y = torch.stack(ys, dim=1).reshape(Bsz, S, H, P)
    return y, h.to(xh.dtype)


def ssm_forward(p, x, cfg: ModelConfig, *, cache=None, chunk_len=None,
                train: bool = False):
    """Full-sequence (prefill) Mamba2 block.  Returns (out, new_cache).

    cache: None or ``{"conv", "state"}`` lane rows carried across chunks;
    the updated rows are returned (new tensors; the caller stores them).
    chunk_len: (B,) true lengths of a bucket-padded chunk.  Pad tokens get
    dt = 0, so the SSD neither decays nor integrates them and the carried
    state is exactly the state after the real tokens; a lane with
    chunk_len 0 keeps its state.  train: the scan is ``ssd_chunked``,
    never the kernel."""
    s = cfg.ssm
    proj = x @ p["w_in"]
    xi, z, Bm, Cm, dt, d_in, nheads = _split_proj(cfg, proj)
    conv_in = torch.cat([xi, Bm, Cm], dim=-1)
    conv_state = cache["conv"] if cache is not None else None
    conv_out, new_conv = _causal_conv(p["conv_w"], p["conv_b"], conv_in,
                                      conv_state, chunk_len)
    xi = conv_out[..., :d_in]
    Bm = conv_out[..., d_in:d_in + s.d_state]
    Cm = conv_out[..., d_in + s.d_state:]
    dt = F.softplus(dt.float() + p["dt_bias"])
    S = x.shape[1]
    if chunk_len is not None:
        valid = (torch.arange(S, device=x.device)[None, :]
                 < chunk_len.long()[:, None])
        dt = torch.where(valid[..., None], dt, 0.0)
    A = -torch.exp(p["A_log"])
    xh = xi.reshape(*xi.shape[:2], nheads, s.head_dim)
    chunk = min(s.chunk_size, S)
    if S % chunk:
        chunk = S                    # odd shapes: a single chunk
    init_state = cache["state"] if cache is not None else None
    if train:
        y, hT = ssd_chunked(xh, dt, A, Bm, Cm, chunk, init_state)
    else:
        y, hT = _ssd.ssd_scan(xh.contiguous(), dt.contiguous(), A,
                              Bm.contiguous(), Cm.contiguous(), chunk=chunk,
                              init_state=init_state)
    y = y + xh * p["D"][None, None, :, None]
    y = y.reshape(*xi.shape[:2], d_in)
    y = _rmsnorm_gated(p["norm_scale"], y, z)
    out = matmul_promoted(y, p["w_out"])
    new_cache = ({"conv": new_conv, "state": hT}
                 if cache is not None else None)
    return out, new_cache


def ssm_decode_step(p, x, cfg: ModelConfig, cache):
    """O(1) recurrent decode.  x: (B, 1, D).  Returns (out, new_cache)."""
    s = cfg.ssm
    proj = x @ p["w_in"]
    xi, z, Bm, Cm, dt, d_in, nheads = _split_proj(cfg, proj)
    conv_in = torch.cat([xi, Bm, Cm], dim=-1)               # (B, 1, C)
    conv_out, new_conv = _causal_conv(p["conv_w"], p["conv_b"], conv_in,
                                      cache["conv"])
    xi = conv_out[..., :d_in]
    Bm = conv_out[..., d_in:d_in + s.d_state]
    Cm = conv_out[..., d_in + s.d_state:]
    dt = F.softplus(dt.float() + p["dt_bias"])              # (B, 1, H)
    A = -torch.exp(p["A_log"])
    xh = xi.reshape(xi.shape[0], nheads, s.head_dim)        # squeeze S = 1
    dt1 = dt[:, 0]                                          # (B, H)
    h = cache["state"].float()                              # (B, H, P, N)
    dA = torch.exp(dt1 * A[None, :])                        # (B, H)
    dBx = torch.einsum("bh,bn,bhp->bhpn", dt1, Bm[:, 0].float(),
                       xh.float())
    h = h * dA[..., None, None] + dBx
    y = torch.einsum("bn,bhpn->bhp", Cm[:, 0].float(), h)
    y = y + xh.float() * p["D"][None, :, None]
    y = y.reshape(x.shape[0], 1, d_in).to(x.dtype)
    y = _rmsnorm_gated(p["norm_scale"], y, z)
    out = matmul_promoted(y, p["w_out"])
    return out, {"conv": new_conv, "state": h.to(cache["state"].dtype)}


def write_lane_rows(cache, new, keep=None) -> None:
    """Store a call's new lane rows into ``cache`` in place.  ``keep``
    (B,) bool: lanes where it is False keep their old rows (the engine's
    frozen decode lanes: ``where(active, new, old)``)."""
    for k, old in cache.items():
        v = new[k].to(old.dtype)
        if keep is not None:
            v = torch.where(keep.view((-1,) + (1,) * (old.dim() - 1)), v, old)
        old.copy_(v)
