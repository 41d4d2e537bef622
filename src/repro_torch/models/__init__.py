"""Model zoo of the port: dense GQA decoders (``attn`` blocks), GQA with
MoE FFNs (``attn_moe``: phi3.5-moe), cross-attending decoders
(``cross_attn`` blocks: whisper with its encoder in ``encdec.py``, the
llama-3.2-vision VLM), DeepSeek-V2 (``mla`` / ``mla_moe`` blocks), Mamba2
(``ssm`` blocks) and the zamba2 hybrid (``ssm`` blocks and one shared
``shared_attn`` block)."""
from repro_torch.models.config import ModelConfig
from repro_torch.models.encdec import (encdec_forward, encoder_forward,
                                       init_encdec_params, init_encoder)
from repro_torch.models.transformer import (init_cache, init_paged_cache,
                                            init_params, logits_fn,
                                            model_forward)

__all__ = ["ModelConfig", "init_params", "init_cache", "init_paged_cache",
           "model_forward",
           "logits_fn", "init_encoder", "encoder_forward",
           "init_encdec_params", "encdec_forward"]
