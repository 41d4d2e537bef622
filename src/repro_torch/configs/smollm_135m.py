"""smollm-135m [hf:HuggingFaceTB/SmolLM-135M] — llama-arch small dense."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m", arch_type="dense",
    n_layers=30, d_model=576, n_heads=9, n_kv_heads=3, d_ff=1536,
    vocab=49152, tie_embeddings=True, rope_theta=10000.0,
    source="hf:HuggingFaceTB/SmolLM-135M")

REDUCED = ModelConfig(
    name="smollm-135m-reduced", arch_type="dense",
    n_layers=2, d_model=192, n_heads=6, n_kv_heads=2, d_ff=512,
    vocab=512, tie_embeddings=True,
    source="hf:HuggingFaceTB/SmolLM-135M")
