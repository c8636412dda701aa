"""LLaVA-NeXT (Mistral-7B backbone) — VLM with anyres tiling.
The SigLIP/CLIP vision tower + projector is the modality frontend and is
STUBBED: the inputs are precomputed patch embeddings for
embed_prefix_len image tokens (anyres: 5 tiles x 576 patches = 2880),
followed by text tokens. [hf:llava-hf/llava-v1.6-mistral-7b-hf]
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    input_mode="tokens+embeds",
    embed_prefix_len=2880,  # anyres: 5 tiles x 24x24 patches
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
)
