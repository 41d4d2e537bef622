"""phi4-mini-3.8b [arXiv:2412.08905] — dense RoPE SwiGLU GQA."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b", arch_type="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8, d_ff=8192,
    vocab=200064, rope_theta=10000.0, tie_embeddings=True,
    source="arXiv:2412.08905")

REDUCED = ModelConfig(
    name="phi4-mini-reduced", arch_type="dense",
    n_layers=2, d_model=384, n_heads=6, n_kv_heads=2, d_ff=768,
    vocab=512, tie_embeddings=True,
    source="arXiv:2412.08905")
