"""command-r-plus-104b [hf:CohereForAI/c4ai-command-r-v01 family] —
large dense GQA, no biases."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b", arch_type="dense",
    n_layers=64, d_model=12288, n_heads=96, n_kv_heads=8, d_ff=33792,
    vocab=256000, rope_theta=75000000.0, use_bias=False,
    source="hf:CohereForAI/c4ai-command-r-v01")

REDUCED = ModelConfig(
    name="command-r-plus-reduced", arch_type="dense",
    n_layers=2, d_model=512, n_heads=8, n_kv_heads=2, d_ff=1024,
    vocab=512, use_bias=False,
    source="hf:CohereForAI/c4ai-command-r-v01")
