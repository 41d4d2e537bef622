"""qwen3-1.7b [hf:Qwen/Qwen3-8B family] — dense GQA with qk_norm.

``qwen3-1.7b-swa`` is the beyond-paper sliding-window variant that makes
the long_500k decode shape sub-quadratic (see DESIGN.md §long_500k).
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b", arch_type="dense",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=8, d_ff=6144,
    vocab=151936, head_dim=128, qk_norm=True, rope_theta=1000000.0,
    source="hf:Qwen/Qwen3-8B")

SWA = dataclasses.replace(CONFIG, name="qwen3-1.7b-swa",
                          sliding_window=4096)

REDUCED = ModelConfig(
    name="qwen3-1.7b-reduced", arch_type="dense",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, d_ff=512,
    vocab=512, head_dim=64, qk_norm=True,
    source="hf:Qwen/Qwen3-8B")

REDUCED_SWA = dataclasses.replace(REDUCED, name="qwen3-1.7b-swa-reduced",
                                  sliding_window=64)


def get(arch: str) -> ModelConfig:
    return SWA if arch.endswith("-swa") else CONFIG


def get_reduced(arch: str) -> ModelConfig:
    return REDUCED_SWA if arch.endswith("-swa") else REDUCED
