"""Mixture-of-Experts FFN: top-k routing, shared experts, load-balance
terms (port of ``repro/models/moe.py``: its ``dispatch`` mode, the
engine's, and its ``dense`` mode, every expert on every token).

Routing and capacity are the reference's: fp32 router logits, softmax,
top-k, the k weights renormalised (sum clipped at 1e-9); each (token,
slot) unit takes a place in its expert's queue in unit order
(token-major), and units at or past the capacity ``C = ceil(cf * k * T /
E)`` are dropped.  Two things differ from a literal copy, neither in the
result:

* The reference scatters the units into an ``(E, C, D)`` buffer and runs
  every expert over all C rows.  With the serving engine's dropless
  ``cf = E / k`` that makes ``C = T``: at deepseek-v2's full width a
  1024-token prefill group would build 160 x 1024 x 5120 floats (3.4 GB)
  and spend most of its expert FLOPs on empty rows.  Here each expert runs
  its SwiGLU only over its kept units (plain matrix products, as the
  reference leaves them to XLA).  The per-expert unit counts are read on
  the host once per call to size those products.
* The unit outputs are combined by gathering them into ``(T, k, D)`` and
  summing over the k slots in the reference's slot order, with no
  scatter-add: CUDA's atomic ``index_add_`` would sum in another order on
  every run and break the port's bit-identity contracts (sharing on/off,
  preempt replay).

``mode="dense"`` is the reference's exact small-shape oracle: every
expert runs over every token and the outputs are combined by the top-k
weights scattered into an (T, E) matrix (zero for an expert a token did
not pick).  Nothing is dropped, so it equals a dropless dispatch.

Expert parallel (``shard=``, a mesh shard's ``ShardCtx`` under
``shard.experts``): the weights hold this shard's ``E / n`` experts, the
router is replicated, and each shard runs only its experts' kept units.
The reference then ``psum``s each token's sum of its local units, which
is exact only for top-k <= 2 (a sum of k values, some of them zero, in
another grouping).  Here the shards sum the (T, k, D) slot buffer
instead, in which exactly one shard wrote each slot and the others hold
zeros (x + 0 == x), and the k slots are then added in slot order as
without a mesh: exact for any k (deepseek-v2 is top-6).

For training over a mesh (a ``ShardCtx`` with a data group) the step is
the reference's one program over the global batch: the load-balance
statistics (``density``, ``router_mean``) are averaged over the data
group before their product, and capacity is counted over the global
unit order: the capacity of the global token count, and each expert's
units on earlier data shards ahead of this shard's (their counts are
all-gathered).  Under expert parallel the experts' input rows and the
top-k weights pass ``shard.enter``, whose gradient sums each shard's
experts' share.  On the meta device (the dry run) no count can be read:
every local expert is counted at that capacity, the static size the
reference's compiled dispatch pads its buffer to.

``jax.lax.top_k`` and ``torch.topk`` may order exactly tied probabilities
differently.  With fp32 router probabilities from real activations exact
ties do not arise, so no tie-break is added that the reference lacks.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig


def init_moe(gen, cfg: ModelConfig, dtype=torch.float32, device=None):
    """Router, stacked routed experts and the shared experts, with the
    reference's shapes and scales, drawn from ``gen``."""
    m = cfg.moe
    d, f = cfg.d_model, m.d_ff_expert

    def normal(*shape, dt=dtype):
        return torch.randn(*shape, generator=gen, dtype=dt, device=device)
    s_in, s_out = d ** -0.5, f ** -0.5
    p = {"router": normal(d, m.n_experts, dt=torch.float32) * s_in,
         "w_gate": normal(m.n_experts, d, f) * s_in,
         "w_up": normal(m.n_experts, d, f) * s_in,
         "w_down": normal(m.n_experts, f, d) * s_out}
    if m.n_shared:
        p["shared_gate"] = normal(d, m.n_shared * f) * s_in
        p["shared_up"] = normal(d, m.n_shared * f) * s_in
        p["shared_down"] = normal(m.n_shared * f, d) * s_out
    return p


def _route(p, xt, m):
    logits = xt.float() @ p["router"]                        # (T, E)
    probs = torch.softmax(logits, dim=-1)
    topv, topi = torch.topk(probs, m.top_k, dim=-1)          # (T, k)
    topv = topv / topv.sum(dim=-1, keepdim=True).clamp(min=1e-9)
    return probs, topv, topi


def dropless_capacity_factor(cfg: ModelConfig):
    """E / k, the serving engine's capacity factor (capacity >= tokens, so
    no unit is dropped: exact inference), or None for a model without
    MoE."""
    return float(cfg.moe.n_experts) / cfg.moe.top_k if cfg.moe else None


def capacity(cf: float, k: int, T: int, E: int) -> int:
    """Per-expert queue length, computed as the reference computes it."""
    return max(1, math.ceil(cf * k * T / E))


def _dense(p, xt, probs, topv, topi):
    """Every expert over every token, combined by the top-k weights (the
    reference's ``mode="dense"``, einsum for einsum)."""
    combine = torch.zeros_like(probs).scatter(1, topi, topv).to(xt.dtype)
    h = (F.silu(torch.einsum("td,edf->etf", xt, p["w_gate"]))
         * torch.einsum("td,edf->etf", xt, p["w_up"]))
    eo = torch.einsum("etf,efd->etd", h, p["w_down"])
    return torch.einsum("etd,te->td", eo, combine)


def moe_forward(p, x, cfg: ModelConfig, mode: str = "dispatch",
                capacity_factor=None, shard=None):
    """Returns (out (B, S, D), aux) with aux ``{"aux_loss",
    "expert_density"}``.  ``mode`` is ``"dispatch"`` (capacity-based,
    the engine's) or ``"dense"`` (every expert on every token, no drops;
    ``capacity_factor`` unused).  ``capacity_factor`` None means 2.0 (the
    reference's training default); any value >= E / k is dropless.
    ``shard``: expert parallel over a mesh (the module docstring; the
    dispatch mode only)."""
    if mode not in ("dispatch", "dense"):
        raise ValueError(f"moe_forward: unknown mode {mode!r}")
    if shard is not None and shard.experts and mode != "dispatch":
        raise ValueError("moe_forward: expert parallel is dispatch-only")
    m = cfg.moe
    B, S, D = x.shape
    xt = x.reshape(-1, D)
    E, k = m.n_experts, m.top_k
    probs, topv, topi = _route(p, xt, m)
    if mode == "dense":
        out = _dense(p, xt, probs, topv, topi)
    else:
        out = _dispatch(p, xt, topv, topi, m, capacity_factor, shard)

    if m.n_shared:
        sh = F.silu(xt @ p["shared_gate"]) * (xt @ p["shared_up"])
        out = out + sh @ p["shared_down"]

    density = F.one_hot(topi, E).float().sum(1).mean(0)
    router_mean = probs.mean(0)
    if shard is not None:                    # global batch statistics
        density = shard.data_mean(density)
        router_mean = shard.data_mean(router_mean)
    aux_loss = E * torch.sum(density / k * router_mean)
    return out.reshape(B, S, D), {"aux_loss": aux_loss,
                                  "expert_density": density}


def _dispatch(p, xt, topv, topi, m, capacity_factor, shard=None):
    """Each expert's SwiGLU over its kept units, combined in slot order
    (the module docstring); under ``shard.experts`` only this shard's
    experts, their slots summed over the shards first."""
    cf = 2.0 if capacity_factor is None else capacity_factor
    T, D = xt.shape
    E, k = m.n_experts, m.top_k
    data = 1 if shard is None else shard.data_size
    C = capacity(cf, k, T * data, E)           # of the global token count
    e_u = topi.reshape(-1)                                   # (T*k,)
    t_u = torch.arange(T, device=xt.device).repeat_interleave(k)
    # units grouped by expert, in unit order within each expert: expert e
    # keeps the first min(count_e, C) of its group; a dropped unit's output
    # stays 0
    order = torch.argsort(e_u, stable=True)
    meta = xt.device.type == "meta"
    cnt = (e_u.new_empty(E) if meta
           else torch.bincount(e_u, minlength=E))
    if data > 1:                   # every data shard's counts, in order
        cnt = shard.data_all_gather(cnt, 0)
    if meta:
        counts, ahead = [C] * E, [0] * E
    else:
        rows = cnt.view(data, E).tolist()                    # host sync
        counts = rows[shard.data_index if data > 1 else 0]
        ahead = [sum(r[e] for r in rows[:shard.data_index]) if data > 1
                 else 0 for e in range(E)]
    unit_out = torch.zeros(T * k, D, dtype=xt.dtype, device=xt.device)
    # one unbind a weight: its backward stacks the experts' gradients,
    # where indexing each expert would add a zero-filled gradient of all E
    w_gate, w_up, w_down = (p[w].unbind(0)
                            for w in ("w_gate", "w_up", "w_down"))
    parallel = shard is not None and shard.experts
    w_u = topv.reshape(-1).to(xt.dtype)[:, None]
    if parallel:
        xt, w_u = shard.enter(xt, w_u)
    # this shard's experts: [e0, e0 + len(w_gate)) of E
    e0 = shard.index * len(w_gate) if parallel else 0
    start = sum(counts[:e0])
    for e in range(e0, e0 + len(w_gate)):
        n = counts[e]
        keep = max(0, min(n, C - ahead[e]))
        if keep:
            idx = (order.new_zeros(keep) if meta
                   else order[start:start + keep])
            h = xt[t_u[idx]]
            unit_out[idx] = (F.silu(h @ w_gate[e - e0])
                             * (h @ w_up[e - e0])) @ w_down[e - e0]
        start += n
    unit_out = unit_out * w_u
    per_slot = unit_out.reshape(T, k, D)
    if parallel:
        per_slot = shard.psum(per_slot)       # one contributor per slot
    out = per_slot[:, 0]
    for j in range(1, k):                    # the reference's slot order
        out = out + per_slot[:, j]
    return out
