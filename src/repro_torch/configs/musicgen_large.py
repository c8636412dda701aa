"""MusicGen-large — decoder-only transformer over EnCodec tokens.
The EnCodec conv codec is the modality frontend and is STUBBED: the
inputs are precomputed frame embeddings (B, S, d_model); labels are
EnCodec codebook tokens (vocab 2048). [arXiv:2306.05284]
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    input_mode="embeds",
    source="arXiv:2306.05284",
)
