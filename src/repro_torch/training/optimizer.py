"""AdamW and its learning-rate schedule (port of
``repro/training/optimizer.py``).

The same expressions in the same order as the reference: gradients
clipped by their global norm (``grad_clip / (norm + 1e-9)``, at most 1),
float32 moments, bias corrections ``1 - b ** step``, and weight decay on
tensors of two or more dimensions only, added to the step direction
before the learning rate scales it.  ``torch.optim.AdamW`` is not used:
it decays every tensor as ``p *= 1 - lr * wd``, which is another result.

Unlike the reference, which returns new arrays, ``adamw_update`` writes
the parameters and the moments in place (one copy of each lives on the
card) and returns the same trees.  The step count, the learning rate and
the norm stay 0-d tensors on the parameters' device: no host sync.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch.training.tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def lr_schedule(cfg: AdamWConfig) -> Callable:
    """Linear warmup to ``cfg.lr`` over ``warmup_steps``, then a cosine
    down to ``min_lr_frac * lr`` at ``total_steps``; float32."""
    def fn(step):
        step = torch.as_tensor(step).float()
        warm = step / max(cfg.warmup_steps, 1)
        prog = ((step - cfg.warmup_steps)
                / max(cfg.total_steps - cfg.warmup_steps, 1)).clamp(0.0, 1.0)
        cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
            1 + torch.cos(math.pi * prog))
        return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)
    return fn


def init_opt_state(params):
    """Zero float32 moments shaped like ``params`` and step 0 (int32)."""
    dev = leaves(params)[0].device
    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32)
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree):
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves(tree)))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state, gnorm=None):
    """One AdamW step.  Returns (params, state, metrics {grad_norm, lr});
    ``params`` and the moments are updated in place.  ``gnorm``: the
    global gradient norm when ``grads`` are one shard's slices of the
    tree (default: the norm of ``grads``)."""
    step = state["step"] + 1
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = lr_schedule(cfg)(step)
    bc1 = 1 - cfg.b1 ** step.float()
    bc2 = 1 - cfg.b2 ** step.float()
    for p, g, m, v in zip(leaves(params), leaves(grads),
                          leaves(state["mu"]), leaves(state["nu"])):
        # each in-place op rounds where the reference's expression does,
        # with at most three temporaries of the leaf's size alive (a
        # stacked expert leaf of phi3.5-moe is 3.4 GB)
        g = g.float() * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)       # b1 m + (1 - b1) g
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)   # b2 v + (1 - b2) g g
        del g
        delta = m / bc1                             # mhat
        delta.div_((v / bc2).sqrt_().add_(cfg.eps))  # / (sqrt(vhat) + eps)
        if p.dim() >= 2:                      # decay matrices only
            delta.add_(cfg.weight_decay * p.float())
        p.sub_(delta.mul_(lr))                # (p - lr delta), p's dtype
    return params, {"mu": state["mu"], "nu": state["nu"], "step": step}, {
        "grad_norm": gnorm, "lr": lr}
