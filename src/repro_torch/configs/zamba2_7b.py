"""zamba2-7b [arXiv:2411.15242] — hybrid: Mamba2 backbone with a SHARED
full-attention block applied every 6th position (parameters shared across
occurrences, per-occurrence KV caches)."""
from repro_torch.models.config import ModelConfig, SSMConfig


def _pattern(n_layers: int, period: int = 6, first: int = 5):
    pat = []
    for i in range(n_layers):
        pat.append("shared_attn" if (i >= first
                                     and (i - first) % period == 0)
                   else "ssm")
    return tuple(pat)


CONFIG = ModelConfig(
    name="zamba2-7b", arch_type="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, d_ff=14336,
    vocab=32000, block_pattern=_pattern(81),
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, d_conv=4,
                  chunk_size=128),
    source="arXiv:2411.15242")

REDUCED = ModelConfig(
    name="zamba2-reduced", arch_type="hybrid",
    n_layers=3, d_model=256, n_heads=4, n_kv_heads=4, d_ff=512,
    vocab=512, block_pattern=("ssm", "shared_attn", "ssm"),
    ssm=SSMConfig(d_state=32, head_dim=32, expand=2, d_conv=4,
                  chunk_size=32),
    source="arXiv:2411.15242")
