"""Model configuration dataclass shared by models, cost model and launcher.

One ``ModelConfig`` describes any of the six assigned architecture families
(dense / moe / ssm / hybrid / vlm / audio).  Family-specific fields default to
"absent" so dense configs stay small.
"""

from __future__ import annotations

import dataclasses
from typing import Literal, Optional

Family = Literal["dense", "moe", "ssm", "hybrid", "vlm", "audio"]


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Encoder half of an enc-dec model (whisper).  The modality frontend
    (mel + conv) is a stub: the encoder consumes precomputed frame embeddings."""

    n_layers: int
    d_model: int
    n_heads: int
    d_ff: int
    n_frames: int  # encoder sequence length (1500 for whisper 30s audio)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int          # query heads; 0 for attention-free (ssm)
    n_kv_heads: int       # kv heads (GQA); ==n_heads for MHA, 1 for MQA
    d_ff: int             # dense-FFN hidden dim (or per-expert dim when dense_ff absent)
    vocab_size: int
    head_dim: int = 0     # 0 -> d_model // n_heads

    # --- attention flavour ---
    attention: Literal["gqa", "mla", "none", "local"] = "gqa"
    rope_theta: float = 10000.0
    mrope: bool = False               # qwen2-vl multimodal 3D rope
    mrope_sections: tuple = (16, 24, 24)
    window_size: int = 0              # sliding window for local attention

    # --- MLA (deepseek-v2 / minicpm3) ---
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    rope_head_dim: int = 64           # decoupled rope dims per head (MLA)
    v_head_dim: int = 0               # 0 -> head_dim

    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_expert: int = 0                 # per-expert FFN hidden dim
    first_dense_layers: int = 0       # deepseek: first layer(s) dense
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # --- recurrent (rwkv6 / recurrentgemma) ---
    # block_pattern: cyclic layer-type pattern, e.g. ("rec","rec","attn")
    block_pattern: tuple = ()
    lru_width: int = 0                # RG-LRU recurrence width (0 -> d_model)
    conv1d_width: int = 4             # temporal conv in recurrent block

    # --- frontend stubs ---
    frontend: Optional[Literal["vision_stub", "audio_stub"]] = None
    n_frontend_tokens: int = 0        # patch/frame embeddings per request
    encoder: Optional[EncoderConfig] = None

    # --- misc ---
    activation: Literal["swiglu", "geglu", "gelu"] = "swiglu"
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"

    # citation for the assigned config
    source: str = ""

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.v_head_dim == 0:
            object.__setattr__(self, "v_head_dim", self.head_dim)
        if self.lru_width == 0:
            object.__setattr__(self, "lru_width", self.d_model)

    # ------------------------------------------------------------------
    # Parameter accounting (used by the cost model, Eq. 4 / Eq. 8).
    # ------------------------------------------------------------------
    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def padded_vocab(self) -> int:
        """Embedding/lm-head vocab dim padded to a multiple of 16 so the
        vocab axis always shards over the 16-wide TP mesh axis (whisper's
        51865 and minicpm3's 73448 would otherwise replicate the logits).
        ``vocab_size`` itself stays the exact assigned value; padded logit
        columns are masked to -inf in the forward pass."""
        return -(-self.vocab_size // 16) * 16

    def attn_params_per_layer(self) -> int:
        h, hd = self.d_model, self.head_dim
        if self.attention == "none":
            # rwkv6 time-mix: r,k,v,g,o projections + decay params ~ 5 h^2
            return 5 * h * h
        if self.attention == "mla":
            r = self.kv_lora_rank
            qr = self.q_lora_rank or h
            nh = self.n_heads
            # q down/up, kv down/up, o
            return (h * qr + qr * nh * (hd + self.rope_head_dim)
                    + h * (r + self.rope_head_dim)
                    + r * nh * (hd + self.v_head_dim)
                    + nh * self.v_head_dim * h)
        nq, nkv = self.n_heads, self.n_kv_heads
        return h * nq * hd + 2 * h * nkv * hd + nq * hd * h

    def dense_ffn_params_per_layer(self) -> int:
        mult = 3 if self.activation in ("swiglu", "geglu") else 2
        return mult * self.d_model * self.d_ff

    def expert_params(self) -> int:
        """Parameters of ONE routed expert."""
        if not self.is_moe:
            return 0
        mult = 3 if self.activation in ("swiglu", "geglu") else 2
        return mult * self.d_model * self.d_expert

    def moe_params_per_layer(self) -> int:
        if not self.is_moe:
            return 0
        shared = self.n_shared_experts * self.expert_params()
        router = self.d_model * self.n_experts
        return self.n_experts * self.expert_params() + shared + router

    def params_total(self) -> int:
        per_layer_attn = self.attn_params_per_layer()
        n_moe_layers = self.n_layers - self.first_dense_layers if self.is_moe else 0
        n_dense_layers = self.n_layers - n_moe_layers
        p = self.n_layers * per_layer_attn
        p += n_dense_layers * self.dense_ffn_params_per_layer()
        p += n_moe_layers * self.moe_params_per_layer()
        p += self.d_model * self.vocab_size * (1 if self.tie_embeddings else 2)
        if self.encoder is not None:
            e = self.encoder
            p += e.n_layers * (4 * e.d_model**2 + 2 * e.d_model * e.d_ff)
            # decoder cross-attention
            p += self.n_layers * 4 * self.d_model**2
        return p

    def params_active(self) -> int:
        """Activated parameters per token (MoE: top_k + shared experts only)."""
        if not self.is_moe:
            return self.params_total()
        n_moe_layers = self.n_layers - self.first_dense_layers
        inactive = n_moe_layers * (self.n_experts - self.top_k) * self.expert_params()
        return self.params_total() - inactive

    def kv_bytes_per_token_per_layer(self, bytes_per_el: int = 2) -> int:
        if self.attention == "none":
            return 0  # recurrent state is O(1) in sequence length
        if self.attention == "mla":
            return (self.kv_lora_rank + self.rope_head_dim) * bytes_per_el
        return 2 * self.n_kv_heads * self.head_dim * bytes_per_el


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One of the four assigned workload shapes."""

    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}

__all__ = ["ModelConfig", "EncoderConfig", "InputShape", "INPUT_SHAPES", "Family"]
