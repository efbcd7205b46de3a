"""qwen2-vl-7b — [vlm] 28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064.

M-RoPE (3D multimodal rotary embedding, sections t/h/w), dynamic resolution.
The ViT vision encoder + projector is a STUB per the assignment: input_specs()
provides precomputed patch embeddings of the right shape.  [arXiv:2409.12191]
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    attention="gqa",
    rope_theta=1e6,
    mrope=True,
    mrope_sections=(16, 24, 24),     # t/h/w frequency-pair sections (sum=hd/2)
    frontend="vision_stub",
    n_frontend_tokens=256,           # patch embeddings prepended per request
    activation="swiglu",
    source="arXiv:2409.12191",
)

# Reduced same-family variant for CPU smoke tests (2 layers, d_model<=512).
REDUCED = ModelConfig(
    name="qwen2-vl-reduced",
    family="vlm",
    n_layers=2,
    d_model=256,
    n_heads=8,
    n_kv_heads=4,
    d_ff=512,
    vocab_size=512,
    attention="gqa",
    rope_theta=1e6,
    mrope=True,
    mrope_sections=(4, 6, 6),
    frontend="vision_stub",
    n_frontend_tokens=16,
    activation="swiglu",
    source="arXiv:2409.12191 (reduced)",
)
