"""OPT family [arXiv:2205.01068] — the paper's own evaluation models,
kept for simulator-fidelity runs (OPT-125m is the speculative drafter)."""
from repro_torch.models.config import ModelConfig

_SPECS = {
    "opt-125m": dict(n_layers=12, d_model=768, n_heads=12, d_ff=3072),
    "opt-7b": dict(n_layers=32, d_model=4096, n_heads=32, d_ff=16384),
    "opt-13b": dict(n_layers=40, d_model=5120, n_heads=40, d_ff=20480),
    "opt-30b": dict(n_layers=48, d_model=7168, n_heads=56, d_ff=28672),
}


def get(arch: str) -> ModelConfig:
    s = _SPECS[arch]
    return ModelConfig(
        name=arch, arch_type="dense",
        n_layers=s["n_layers"], d_model=s["d_model"], n_heads=s["n_heads"],
        n_kv_heads=s["n_heads"], d_ff=s["d_ff"], vocab=50272,
        norm="layernorm", act="gelu", use_bias=True, learned_pos=2048,
        tie_embeddings=True, source="arXiv:2205.01068")


def get_reduced(arch: str) -> ModelConfig:
    return ModelConfig(
        name=f"{arch}-reduced", arch_type="dense",
        n_layers=2, d_model=192, n_heads=4, n_kv_heads=4, d_ff=512,
        vocab=512, norm="layernorm", act="gelu", use_bias=True,
        learned_pos=256, tie_embeddings=True, source="arXiv:2205.01068")
