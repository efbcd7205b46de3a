"""smollm-360m — [dense] 32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152.

Llama-architecture small model.  The 15 query heads are NOT divisible by the
16-wide TP mesh axis — GSPMD handles this via padded (uneven) sharding, which
the dry-run exercises deliberately.  [hf:HuggingFaceTB/SmolLM-360M]
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    family="dense",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    d_ff=2560,
    vocab_size=49152,
    attention="gqa",
    rope_theta=10000.0,
    activation="swiglu",
    tie_embeddings=True,
    source="hf:HuggingFaceTB/SmolLM-360M",
)

REDUCED = ModelConfig(
    name="smollm-reduced",
    family="dense",
    n_layers=2,
    d_model=240,      # keeps the 15-head / uneven-sharding character: hd=16
    n_heads=15,
    n_kv_heads=5,
    d_ff=512,
    vocab_size=512,
    attention="gqa",
    activation="swiglu",
    tie_embeddings=True,
    source="hf:HuggingFaceTB/SmolLM-360M (reduced)",
)
