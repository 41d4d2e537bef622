"""whisper-large-v3 [arXiv:2212.04356] — encoder-decoder; the conv/mel
frontend is a STUB (the caller supplies frame embeddings).  Decoder layers
all carry cross-attention to the encoder output.  Learned positions are
sized to the reference's assigned decode shapes (the real model caps at
448 decoder positions; the reference's copy of this file says so)."""
from repro_torch.models.config import EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3", arch_type="encdec",
    n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20, d_ff=5120,
    vocab=51866, block_pattern=("cross_attn",) * 32,
    norm="layernorm", act="gelu", use_bias=True, tie_embeddings=True,
    learned_pos=32768,
    encoder=EncoderConfig(n_layers=32, n_frames=1500),
    source="arXiv:2212.04356")

REDUCED = ModelConfig(
    name="whisper-reduced", arch_type="encdec",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=4, d_ff=512,
    vocab=512, block_pattern=("cross_attn",) * 2,
    norm="layernorm", act="gelu", use_bias=True, tie_embeddings=True,
    learned_pos=256,
    encoder=EncoderConfig(n_layers=2, n_frames=64),
    source="arXiv:2212.04356")
