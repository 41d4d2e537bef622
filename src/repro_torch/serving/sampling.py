"""Token sampling: greedy / temperature / top-k (port of
``repro/serving/sampling.py``).

Greedy is exact argmax, like the reference.  Stochastic draws come from an
explicit ``torch.Generator`` on the logits' device; they cannot reproduce
``jax.random.categorical``'s stream, so they agree with the reference in
distribution only."""
from __future__ import annotations

from typing import Optional

import torch


def sample(logits, gen: Optional[torch.Generator] = None,
           temperature: float = 0.0, top_k: int = 0):
    """logits: (..., V) -> int32 token ids (...,).  Never waits on the
    device."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if gen is None:
        raise ValueError("stochastic sampling needs a torch.Generator")
    logits = logits.float() / temperature
    if top_k > 0:
        cutoff = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < cutoff, -1e30, logits)
    probs = torch.softmax(logits, dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    tok = torch.multinomial(flat, 1, generator=gen)
    return tok.reshape(probs.shape[:-1]).to(torch.int32)
