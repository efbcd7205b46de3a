"""deepseek-v2-236b — [moe] 60L d_model=5120 128H d_ff=1536 (per-expert)
vocab=102400, MoE 160 routed experts top-6 + 2 shared, MLA kv_lora=512.

The paper's own model family (DeepSeek): this is the paper-representative
architecture for the hybrid TP-EP + fused AR-A2A technique.
[arXiv:2405.04434]
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    d_ff=12288,                # dense FFN dim of the first (dense) layer
    vocab_size=102400,
    head_dim=128,              # qk nope head dim
    attention="mla",
    kv_lora_rank=512,
    q_lora_rank=1536,
    rope_head_dim=64,
    v_head_dim=128,
    n_experts=160,
    top_k=6,
    d_expert=1536,
    n_shared_experts=2,
    first_dense_layers=1,
    activation="swiglu",
    source="arXiv:2405.04434",
)

REDUCED = ModelConfig(
    name="deepseek-v2-reduced",
    family="moe",
    n_layers=2,
    d_model=256,
    n_heads=8,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=512,
    head_dim=32,
    attention="mla",
    kv_lora_rank=64,
    q_lora_rank=96,
    rope_head_dim=16,
    v_head_dim=32,
    n_experts=4,
    top_k=2,
    d_expert=128,
    n_shared_experts=1,
    first_dense_layers=1,
    activation="swiglu",
    source="arXiv:2405.04434 (reduced)",
)
