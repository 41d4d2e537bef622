"""Architecture config registry (ported subset of ``repro.configs``).

``get_config(arch)`` returns the full published configuration and
``get_reduced(arch)`` the CPU-test variant of the same family.  Every
architecture of the reference is here: the dense GQA families (smollm,
qwen3, phi4-mini, command-r-plus and the OPT family), phi3.5-moe (GQA +
MoE), deepseek-v2 (MLA + MoE), mamba2 (SSM), zamba2 (Mamba2 with one
shared attention block), whisper (encoder-decoder) and llama-3.2-vision
(cross-attention image layers); an unknown name raises ``KeyError``.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

_MODULES = {
    "smollm-135m": "smollm_135m",
    "qwen3-1.7b": "qwen3_1p7b",
    "qwen3-1.7b-swa": "qwen3_1p7b",
    "phi4-mini-3.8b": "phi4_mini_3p8b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe_42b",
    "command-r-plus-104b": "command_r_plus_104b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "mamba2-2.7b": "mamba2_2p7b",
    "zamba2-7b": "zamba2_7b",
    "whisper-large-v3": "whisper_large_v3",
    "llama-3.2-vision-11b": "llama32_vision_11b",
    "opt-125m": "opt", "opt-7b": "opt", "opt-13b": "opt", "opt-30b": "opt",
}

# the reference's dry-run list (its registry order): every architecture but
# the OPT simulator family, and without the beyond-paper SWA variant
ASSIGNED = ["whisper-large-v3", "phi4-mini-3.8b", "llama-3.2-vision-11b",
            "command-r-plus-104b", "phi3.5-moe-42b-a6.6b", "deepseek-v2-236b",
            "mamba2-2.7b", "qwen3-1.7b", "smollm-135m", "zamba2-7b"]

# architectures the JAX reference serves that this package does not yet
_NOT_PORTED: tuple[str, ...] = ()

def _mod(arch: str):
    if arch in _NOT_PORTED:
        raise NotImplementedError(f"{arch}: not yet ported")
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    m = _mod(arch)
    return m.get(arch) if hasattr(m, "get") else m.CONFIG


def get_reduced(arch: str) -> ModelConfig:
    m = _mod(arch)
    return (m.get_reduced(arch) if hasattr(m, "get_reduced")
            else m.REDUCED)
