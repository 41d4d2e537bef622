"""deepseek-v2-236b [arXiv:2405.04434] — MLA (kv_lora=512) +
160-routed/2-shared top-6 MoE; first layer dense."""
from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b", arch_type="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128, d_ff=12288,
    vocab=102400,
    block_pattern=("mla",) + ("mla_moe",) * 59,
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=160, top_k=6, d_ff_expert=1536, n_shared=2),
    source="arXiv:2405.04434")

REDUCED = ModelConfig(
    name="deepseek-v2-reduced", arch_type="moe",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=4, d_ff=512,
    vocab=512,
    block_pattern=("mla", "mla_moe"),
    mla=MLAConfig(kv_lora_rank=64, q_lora_rank=96,
                  qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32),
    moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=128, n_shared=1),
    source="arXiv:2405.04434")
