"""minitron-8b — [dense] 32L d_model=4096 32H (GQA kv=8) d_ff=16384
vocab=256000.  Pruned-and-distilled Nemotron-4.  [arXiv:2407.14679]
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=256000,
    attention="gqa",
    rope_theta=10000.0,
    activation="gelu",          # nemotron uses squared-relu; gelu-family MLP
    source="arXiv:2407.14679",
)

REDUCED = ModelConfig(
    name="minitron-reduced",
    family="dense",
    n_layers=2,
    d_model=256,
    n_heads=8,
    n_kv_heads=2,
    d_ff=512,
    vocab_size=512,
    attention="gqa",
    activation="gelu",
    source="arXiv:2407.14679 (reduced)",
)
