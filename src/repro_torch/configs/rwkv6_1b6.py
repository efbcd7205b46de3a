"""rwkv6-1.6b (Finch) — [ssm] 24L d_model=2048 attn-free d_ff=7168 vocab=65536.

Data-dependent decay (the Finch contribution).  Attention-free: O(1) state per
layer, so long_500k decode is supported.  [arXiv:2404.05892]
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=0,
    n_kv_heads=0,
    d_ff=7168,
    vocab_size=65536,
    attention="none",
    activation="gelu",          # rwkv channel-mix uses squared-relu internally
    source="arXiv:2404.05892",
)

REDUCED = ModelConfig(
    name="rwkv6-reduced",
    family="ssm",
    n_layers=2,
    d_model=256,
    n_heads=0,
    n_kv_heads=0,
    d_ff=512,
    vocab_size=512,
    attention="none",
    activation="gelu",
    source="arXiv:2404.05892 (reduced)",
)
