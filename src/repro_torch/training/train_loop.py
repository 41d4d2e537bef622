"""Training loop (port of ``repro/training/train_loop.py``): the LM loss
with the MoE load-balance term, the train step and the host loop.

The forward is ``model_forward(train=True)``: attention through the
masked ``sdpa`` or ``sdpa_chunked`` and the SSM through ``ssd_chunked``,
the branches the reference differentiates, so no hand kernel (which has
no backward) and no kernel's plain version runs in training.  Gradients
come from ``torch.autograd.grad`` over the parameter leaves; the step runs
eagerly where the reference jits it.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from repro_torch.device import generator, resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (init_params, logits_fn,
                                            model_forward)
from repro_torch.training.optimizer import (AdamWConfig, adamw_update,
                                            init_opt_state)
from repro_torch.training.tree import leaves, tree_map, unflatten


def lm_loss(params, cfg: ModelConfig, tokens, labels, *, enc_states=None,
            moe_cf=None, aux_coef: float = 0.01, shard=None):
    """Mean next-token NLL over float32 logits plus ``aux_coef`` times the
    summed MoE load-balance loss.  Returns (loss, {"nll", "aux"}).
    ``shard``: a mesh shard's ``ShardCtx`` (``distributed/sharding.py``):
    ``params`` hold its heads, FFN columns or experts, and the loss is
    that of its data shard's rows."""
    h, _, aux = model_forward(params, cfg, tokens, enc_states=enc_states,
                              moe_cf=moe_cf, train=True, shard=shard)
    logits = logits_fn(params, cfg, h).float()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None].long())[..., 0]
    mean_nll = nll.mean()
    return mean_nll + aux_coef * aux, {"nll": mean_nll, "aux": aux}


def trainable(params):
    """Mark every parameter leaf as requiring grad; returns ``params``."""
    for p in leaves(params):
        p.requires_grad_(True)
    return params


def loss_and_grads(params, cfg: ModelConfig, batch, *, moe_cf=None,
                   has_enc: bool = False, shard=None):
    """``lm_loss`` and its gradient with respect to every leaf of
    ``params`` (which must require grad; see ``trainable``), as the
    reference's ``value_and_grad``.  Returns (loss, parts, grads), grads a
    tree like ``params`` (zeros for a leaf the loss does not reach).
    Under ``shard`` the backward pass runs on the calling thread (the
    collectives inside it wait for the other shards' threads)."""
    enc = batch.get("enc_states") if has_enc else None
    loss, parts = lm_loss(params, cfg, batch["tokens"], batch["labels"],
                          enc_states=enc, moe_cf=moe_cf, shard=shard)
    ps = leaves(params)
    with torch.autograd.set_multithreading_enabled(shard is None):
        gs = torch.autograd.grad(loss, ps, allow_unused=True)
    grads = unflatten(params, [torch.zeros_like(p) if g is None else g
                               for p, g in zip(ps, gs)])
    return loss.detach(), {k: v.detach() for k, v in parts.items()}, grads


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, moe_cf=None,
                    has_enc: bool = False):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics {loss, nll, aux, grad_norm, lr}); batch holds ``tokens`` and
    ``labels`` (B, S) (and ``enc_states`` with ``has_enc``).  The
    parameters and moments are updated in place (``adamw_update``)."""
    def train_step(params, opt_state, batch):
        loss, parts, grads = loss_and_grads(params, cfg, batch,
                                            moe_cf=moe_cf, has_enc=has_enc)
        params, opt_state, om = adamw_update(opt_cfg, params, grads,
                                             opt_state)
        return params, opt_state, {"loss": loss, **parts, **om}
    return train_step


@dataclasses.dataclass
class TrainResult:
    losses: list
    steps: int
    wallclock: float
    # seconds since the first step began at each logged loss (the logged
    # step has ended: reading its loss waits for the device)
    logged_at: list = dataclasses.field(default_factory=list)


def train(cfg: ModelConfig, steps: int = 100, batch: int = 8,
          seq_len: int = 128, seed: int = 0,
          opt_cfg: Optional[AdamWConfig] = None,
          log_every: int = 10, checkpoint_dir: Optional[str] = None,
          checkpoint_every: int = 0, device=None) -> TrainResult:
    """Single-device training loop on the Markov stream: weights from
    the port's seeded init on ``resolve_device(device)`` (CUDA unless
    named), the loss logged at every ``log_every``-th step and the last."""
    from repro_torch.training import data as data_mod
    from repro_torch.training.checkpoint import save_checkpoint

    device = resolve_device(device)
    opt_cfg = opt_cfg or AdamWConfig(total_steps=steps,
                                     warmup_steps=max(steps // 20, 5))
    params = trainable(init_params(cfg, generator(device, seed),
                                   device=device))
    opt_state = init_opt_state(params)
    step_fn = make_train_step(cfg, opt_cfg)
    it = data_mod.batches(cfg.vocab, batch, seq_len, seed)
    losses, logged_at = [], []
    t0 = time.perf_counter()
    for step in range(steps):
        b = tree_map(lambda a: torch.from_numpy(a).to(device).long(),
                     next(it))
        params, opt_state, m = step_fn(params, opt_state, b)
        if step % log_every == 0 or step == steps - 1:
            losses.append(float(m["loss"]))
            logged_at.append(time.perf_counter() - t0)
        if checkpoint_dir and checkpoint_every and (
                step + 1) % checkpoint_every == 0:
            save_checkpoint(checkpoint_dir, step + 1, params, opt_state)
    return TrainResult(losses=losses, steps=steps,
                       wallclock=time.perf_counter() - t0,
                       logged_at=logged_at)
