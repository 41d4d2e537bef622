"""Device resolution for every entry point of the port.

The device is always chosen explicitly, never by what happens to be
available: ``resolve_device(None)`` means CUDA, and it raises when no card
is present rather than quietly running on the CPU.  Tests and CPU runs
pass ``device="cpu"``.

On the card the engine runs in float32, the JAX engine's default dtype,
and TF32 is switched off for matrix products and cuDNN so that float32
means float32 (TF32 keeps about three decimal digits and would break the
greedy-stream parity with the reference).
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """Return the device to run on: CUDA unless the caller names another.

    Raises ``RuntimeError`` when CUDA is asked for (explicitly or by
    default) and no card is available; there is no silent CPU fallback.
    ``"meta"`` (shapes without storage) is accepted for shape checks.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run on the CPU explicitly")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        set_precision()
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def set_precision() -> None:
    """Full-precision float32 on the card: no TF32 in matmul or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def generator(device: torch.device, seed: int) -> torch.Generator:
    """An explicit random stream on ``device`` seeded with ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g
