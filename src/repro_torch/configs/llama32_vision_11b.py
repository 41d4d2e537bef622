"""llama-3.2-vision-11b [hf:meta-llama/Llama-3.2-11B-Vision] — dense GQA
decoder with gated cross-attention image layers every 5th position.
The ViT vision encoder is a STUB: the caller supplies patch embeddings."""
from repro_torch.models.config import ModelConfig

_CROSS = {3, 8, 13, 18, 23, 28, 33, 38}


def _pattern(n_layers: int, cross=frozenset(_CROSS)):
    return tuple("cross_attn" if i in cross else "attn"
                 for i in range(n_layers))


CONFIG = ModelConfig(
    name="llama-3.2-vision-11b", arch_type="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=128256, block_pattern=_pattern(40), rope_theta=500000.0,
    n_image_tokens=1600,
    source="hf:meta-llama/Llama-3.2-11B-Vision")

REDUCED = ModelConfig(
    name="llama32-vision-reduced", arch_type="vlm",
    n_layers=3, d_model=256, n_heads=4, n_kv_heads=2, d_ff=512,
    vocab=512, block_pattern=("attn", "cross_attn", "attn"),
    n_image_tokens=16,
    source="hf:meta-llama/Llama-3.2-11B-Vision")
