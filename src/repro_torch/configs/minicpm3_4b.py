"""minicpm3-4b — [dense] 62L d_model=2560 40H d_ff=6400 vocab=73448, MLA.

Multi-head Latent Attention: kv_lora_rank=256, q_lora_rank=768, decoupled
rope dims 32, nope head dim 64.  [hf:openbmb/MiniCPM3-4B]
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    family="dense",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    d_ff=6400,
    vocab_size=73448,
    head_dim=64,               # qk nope head dim
    attention="mla",
    kv_lora_rank=256,
    q_lora_rank=768,
    rope_head_dim=32,
    v_head_dim=64,
    activation="swiglu",
    source="hf:openbmb/MiniCPM3-4B",
)

REDUCED = ModelConfig(
    name="minicpm3-reduced",
    family="dense",
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
    activation="swiglu",
    source="hf:openbmb/MiniCPM3-4B (reduced)",
)
