"""mamba2-2.7b [arXiv:2405.21060] — attention-free SSD (state-space
duality); sub-quadratic, runs the long_500k shape."""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b", arch_type="ssm",
    n_layers=64, d_model=2560, n_heads=1, n_kv_heads=1, d_ff=0,
    vocab=50280, block_pattern=("ssm",) * 64,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, d_conv=4,
                  chunk_size=128),
    source="arXiv:2405.21060")

REDUCED = ModelConfig(
    name="mamba2-reduced", arch_type="ssm",
    n_layers=2, d_model=256, n_heads=1, n_kv_heads=1, d_ff=0,
    vocab=512, block_pattern=("ssm",) * 2,
    ssm=SSMConfig(d_state=32, head_dim=32, expand=2, d_conv=4,
                  chunk_size=32),
    source="arXiv:2405.21060")
