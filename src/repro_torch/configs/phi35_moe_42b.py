"""phi3.5-moe-42b-a6.6b — [moe] 32L d_model=4096 32H (GQA kv=8) d_ff=6400
vocab=32064, MoE 16 experts top-2.  [hf:microsoft/Phi-3.5-MoE-instruct]

d_ff is the per-expert FFN hidden dim (each expert is a SwiGLU MLP).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6400,
    vocab_size=32064,
    attention="gqa",
    rope_theta=10000.0,
    n_experts=16,
    top_k=2,
    d_expert=6400,
    n_shared_experts=0,
    activation="swiglu",
    source="hf:microsoft/Phi-3.5-MoE-instruct",
)

REDUCED = ModelConfig(
    name="phi3.5-moe-reduced",
    family="moe",
    n_layers=2,
    d_model=256,
    n_heads=8,
    n_kv_heads=2,
    d_ff=512,
    vocab_size=512,
    attention="gqa",
    n_experts=4,
    top_k=2,
    d_expert=512,
    n_shared_experts=0,
    activation="swiglu",
    source="hf:microsoft/Phi-3.5-MoE-instruct (reduced)",
)
