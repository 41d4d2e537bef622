"""phi3.5-moe-42b-a6.6b [hf:microsoft/Phi-3.5-MoE-instruct] —
16-expert top-2 MoE, GQA attention."""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b", arch_type="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=6400,
    vocab=32064, block_pattern=("attn_moe",) * 32,
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=6400),
    source="hf:microsoft/Phi-3.5-MoE-instruct")

REDUCED = ModelConfig(
    name="phi3.5-moe-reduced", arch_type="moe",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, d_ff=512,
    vocab=512, block_pattern=("attn_moe",) * 2,
    moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=512),
    source="hf:microsoft/Phi-3.5-MoE-instruct")
