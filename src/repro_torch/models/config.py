"""Model configuration system.

One ``ModelConfig`` describes any architecture in the assigned pool: dense
GQA decoders, MoE (top-k routing, shared experts, MLA), SSM (Mamba2/SSD),
hybrid (Zamba2), encoder-decoder (Whisper) and VLM (cross-attention layers).

The per-layer structure is a ``block_pattern``: a tuple of block kind
strings, one per layer, from:

    "attn"        self-attention mixer + dense FFN
    "attn_moe"    self-attention mixer + MoE FFN
    "mla_moe"     MLA mixer + MoE FFN (DeepSeek-V2)
    "mla"         MLA mixer + dense FFN
    "ssm"         Mamba2 (SSD) mixer (FFN folded into the block)
    "shared_attn" hybrid shared full-attention block (Zamba2) — parameters
                  are shared across every occurrence
    "cross_attn"  self-attention + cross-attention + dense FFN (VLM/dec)

``segments()`` groups the pattern into homogeneous runs so the model stack
can ``lax.scan`` each run (compact HLO for the 512-device dry-run compiles).
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0                 # always-on shared experts (DeepSeek)
    router_jitter: float = 0.0
    load_balance_coef: float = 0.01   # aux loss weight (training)


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: Optional[int] = None
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    d_conv: int = 4
    chunk_size: int = 128


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Whisper-style encoder over precomputed frame embeddings (conv
    frontend is a stub per the assignment carve-out)."""
    n_layers: int
    n_frames: int                     # fixed encoder sequence length
    d_model: int = 0                  # 0 = same as decoder


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                    # dense|moe|ssm|hybrid|encdec|vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                 # 0 = d_model // n_heads
    block_pattern: tuple = ()         # () = ("attn",) * n_layers
    rope_theta: float = 10000.0
    qk_norm: bool = False
    use_bias: bool = False
    act: str = "swiglu"               # swiglu | gelu
    norm: str = "rmsnorm"             # rmsnorm | layernorm
    tie_embeddings: bool = False
    learned_pos: int = 0              # >0: learned positions (whisper), no rope
    sliding_window: Optional[int] = None
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    encoder: Optional[EncoderConfig] = None
    # VLM: number of image tokens supplied by the (stubbed) vision frontend
    n_image_tokens: int = 0
    max_seq_len: int = 131072
    source: str = ""                  # citation for the config
    # ---- performance-iteration knobs (EXPERIMENTS.md §Perf) ----
    attn_impl: str = "naive"          # naive | chunked (flash-style scan)
    attn_chunk: int = 1024
    mla_absorb: bool = False          # DeepSeek absorbed-matmul decode
    remat: bool = False               # checkpoint each block in training

    # ------------------------------------------------------------------ #
    def __post_init__(self):
        if not self.block_pattern:
            object.__setattr__(self, "block_pattern",
                               ("attn",) * self.n_layers)
        assert len(self.block_pattern) == self.n_layers, (
            f"{self.name}: pattern len {len(self.block_pattern)} != "
            f"n_layers {self.n_layers}")
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.n_heads, 1))

    @property
    def attn_free(self) -> bool:
        return all(k == "ssm" for k in self.block_pattern)

    @property
    def sub_quadratic(self) -> bool:
        """Can this config serve 500k-token contexts?  SSM/hybrid always;
        dense only with a sliding window."""
        kinds = set(self.block_pattern)
        if kinds <= {"ssm", "shared_attn"} and "ssm" in kinds:
            # hybrid: attention KV is bounded by the few shared-attn blocks
            return True
        return self.sliding_window is not None

    def segments(self) -> list[tuple[str, int]]:
        """Group block_pattern into (kind, count) runs for scanning."""
        segs: list[tuple[str, int]] = []
        for k in self.block_pattern:
            if segs and segs[-1][0] == k:
                segs[-1] = (k, segs[-1][1] + 1)
            else:
                segs.append((k, 1))
        return segs

    # ---------------------- derived size accounting -------------------- #
    def param_count(self) -> int:
        """Total parameters (embeddings included once if tied)."""
        d, v = self.d_model, self.vocab
        total = v * d if self.tie_embeddings else 2 * v * d
        if self.learned_pos:
            total += self.learned_pos * d
        shared_done = False
        for kind in self.block_pattern:
            if kind == "shared_attn" and shared_done:
                continue
            if kind == "shared_attn":
                shared_done = True
            total += self._block_params(kind)
        if self.encoder:
            enc_d = self.encoder.d_model or d
            total += self.encoder.n_layers * (
                4 * enc_d * enc_d + 2 * enc_d * (4 * enc_d))
            total += self.encoder.n_frames * enc_d
        return total

    def _block_params(self, kind: str) -> int:
        d, h, kv, hd, f = (self.d_model, self.n_heads, self.n_kv_heads,
                           self.head_dim, self.d_ff)
        attn = d * h * hd + 2 * d * kv * hd + h * hd * d
        ffn_mult = 3 if self.act == "swiglu" else 2
        ffn = ffn_mult * d * f
        if kind in ("attn", "shared_attn"):
            return attn + ffn
        if kind == "cross_attn":
            return 2 * attn + ffn
        if kind == "attn_moe":
            m = self.moe
            moe_ffn = (m.n_experts + m.n_shared) * ffn_mult * d * m.d_ff_expert
            return attn + moe_ffn + d * m.n_experts
        if kind in ("mla", "mla_moe"):
            c = self.mla
            q_dim = h * (c.qk_nope_head_dim + c.qk_rope_head_dim)
            mla = (d * c.kv_lora_rank + d * c.qk_rope_head_dim
                   + c.kv_lora_rank * h * (c.qk_nope_head_dim + c.v_head_dim)
                   + (d * c.q_lora_rank + c.q_lora_rank * q_dim
                      if c.q_lora_rank else d * q_dim)
                   + h * c.v_head_dim * d)
            if kind == "mla":
                return mla + ffn_mult * d * f
            m = self.moe
            moe_ffn = (m.n_experts + m.n_shared) * ffn_mult * d * m.d_ff_expert
            return mla + moe_ffn + d * m.n_experts
        if kind == "ssm":
            s = self.ssm
            d_in = s.expand * d
            nheads = d_in // s.head_dim
            return (d * (2 * d_in + 2 * s.d_state + nheads)  # in_proj
                    + s.d_conv * (d_in + 2 * s.d_state)      # conv
                    + 2 * nheads                              # A, D
                    + d_in * d)                               # out_proj
        raise ValueError(kind)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top-k + shared only)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        full = self.param_count()
        ffn_mult = 3 if self.act == "swiglu" else 2
        per_expert = ffn_mult * self.d_model * m.d_ff_expert
        n_moe_layers = sum(1 for k in self.block_pattern
                           if k in ("attn_moe", "mla_moe"))
        inactive = n_moe_layers * (m.n_experts - m.top_k) * per_expert
        return full - inactive

    def kv_bytes_per_token(self, dtype_bytes: int = 2) -> int:
        """KV-cache (or SSM state amortization ~ 0) bytes per token."""
        total = 0
        for kind in self.block_pattern:
            if kind in ("attn", "attn_moe", "cross_attn"):
                total += 2 * self.n_kv_heads * self.head_dim * dtype_bytes
            elif kind == "shared_attn":
                total += 2 * self.n_kv_heads * self.head_dim * dtype_bytes
            elif kind in ("mla", "mla_moe"):
                c = self.mla
                total += (c.kv_lora_rank + c.qk_rope_head_dim) * dtype_bytes
            # ssm: O(1) state, no per-token growth
        return total
