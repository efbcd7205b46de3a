"""The paper's own evaluation models (§IV-A), as cost-model configs.

These drive the analyzer/benchmark reproductions of Figs. 3/10/11/12 and
Table I on the paper's two clusters.  (The runnable end-to-end archs are the
10 assigned configs; these two exist so every paper figure has its exact
model hyperparameters behind it.)
"""

from repro_torch.configs.base import ModelConfig

# DeepSeek-R1: 671B total / 37B activated, 256 routed + 1 shared expert,
# MLA kv_lora=512.  [arXiv:2501.12948 / arXiv:2412.19437]
DEEPSEEK_R1 = ModelConfig(
    name="deepseek-r1-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=18432,
    vocab_size=129280,
    head_dim=128,
    attention="mla",
    kv_lora_rank=512,
    q_lora_rank=1536,
    rope_head_dim=64,
    v_head_dim=128,
    n_experts=256,
    top_k=8,
    d_expert=2048,
    n_shared_experts=1,
    first_dense_layers=3,
    activation="swiglu",
    source="arXiv:2412.19437 (DeepSeek-V3 base; R1 shares the architecture)",
)

# Qwen3-235B-A22B: 128 experts top-8, GQA kv=4.  [arXiv:2505.09388]
QWEN3_235B = ModelConfig(
    name="qwen3-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_ff=12288,
    vocab_size=151936,
    head_dim=128,
    attention="gqa",
    n_experts=128,
    top_k=8,
    d_expert=1536,
    n_shared_experts=0,
    activation="swiglu",
    source="arXiv:2505.09388",
)

PAPER_MODELS = {m.name: m for m in (DEEPSEEK_R1, QWEN3_235B)}

__all__ = ["DEEPSEEK_R1", "QWEN3_235B", "PAPER_MODELS"]
