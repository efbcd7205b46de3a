"""recurrentgemma-9b — [hybrid] 38L d_model=4096 16H (MQA kv=1) d_ff=12288
vocab=256000.  RG-LRU recurrent blocks + local (sliding-window) attention in
a 2:1 pattern (rec, rec, attn).  Sub-quadratic: long_500k runs.
[arXiv:2402.19427]
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,                   # 12 x (rec, rec, attn) + 2 trailing rec
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab_size=256000,
    head_dim=256,
    attention="local",
    window_size=2048,
    block_pattern=("rec", "rec", "attn"),
    lru_width=4096,
    conv1d_width=4,
    activation="geglu",
    tie_embeddings=True,
    source="arXiv:2402.19427",
)

REDUCED = ModelConfig(
    name="recurrentgemma-reduced",
    family="hybrid",
    n_layers=3,                    # one full (rec, rec, attn) pattern
    d_model=256,
    n_heads=4,
    n_kv_heads=1,
    d_ff=512,
    vocab_size=512,
    head_dim=64,
    attention="local",
    window_size=64,
    block_pattern=("rec", "rec", "attn"),
    lru_width=256,
    conv1d_width=4,
    activation="geglu",
    tie_embeddings=True,
    source="arXiv:2402.19427 (reduced)",
)
