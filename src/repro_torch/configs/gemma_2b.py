"""gemma-2b — [dense] 18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=256000.

GeGLU activation, head_dim=256 (wider than d_model/n_heads), MQA on the 2b
size.  [arXiv:2403.08295]
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    family="dense",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    d_ff=16384,
    vocab_size=256000,
    head_dim=256,
    attention="gqa",
    rope_theta=10000.0,
    activation="geglu",
    tie_embeddings=True,
    source="arXiv:2403.08295",
)

REDUCED = ModelConfig(
    name="gemma-reduced",
    family="dense",
    n_layers=2,
    d_model=256,
    n_heads=4,
    n_kv_heads=1,
    d_ff=512,
    vocab_size=512,
    head_dim=64,
    attention="gqa",
    activation="geglu",
    tie_embeddings=True,
    source="arXiv:2403.08295 (reduced)",
)
