"""whisper-tiny — [audio] 4L d_model=384 6H (MHA kv=6) d_ff=1536 vocab=51865.

Encoder-decoder; the mel-spectrogram + conv frontend is a STUB per the
assignment: input_specs() provides precomputed frame embeddings (1500 frames
for 30 s of audio at 50 Hz after the conv stride-2).  [arXiv:2212.04356]
"""

from repro_torch.configs.base import EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,                      # decoder layers
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    attention="gqa",
    activation="gelu",
    frontend="audio_stub",
    n_frontend_tokens=1500,
    encoder=EncoderConfig(n_layers=4, d_model=384, n_heads=6, d_ff=1536,
                          n_frames=1500),
    source="arXiv:2212.04356",
)

REDUCED = ModelConfig(
    name="whisper-reduced",
    family="audio",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_ff=256,
    vocab_size=512,
    attention="gqa",
    activation="gelu",
    frontend="audio_stub",
    n_frontend_tokens=64,
    encoder=EncoderConfig(n_layers=2, d_model=128, n_heads=4, d_ff=256,
                          n_frames=64),
    source="arXiv:2212.04356 (reduced)",
)
