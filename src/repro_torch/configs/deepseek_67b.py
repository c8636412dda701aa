"""DeepSeek 67B — deep (95-layer) dense llama-architecture. [arXiv:2401.02954]

At full size (~134 GB in bfloat16) it does not fit one 80 GB card; it
runs at `reduced()` size.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b",
    family="dense",
    num_layers=95,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22016,
    vocab_size=102400,
    source="arXiv:2401.02954",
)
