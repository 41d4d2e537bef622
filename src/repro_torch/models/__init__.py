"""Model zoo of the port: dense GQA decoders (``attn`` blocks),
DeepSeek-V2 (``mla`` / ``mla_moe`` blocks) and Mamba2 (``ssm`` blocks)."""
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (init_paged_cache, init_params,
                                            logits_fn, model_forward)

__all__ = ["ModelConfig", "init_params", "init_paged_cache", "model_forward",
           "logits_fn"]
