"""RWKV-6 "Finch" 3B — attention-free RNN with data-dependent decay.
[arXiv:2404.05892]
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    num_layers=32,
    d_model=2560,
    num_heads=40,  # 2560 / head_size 64
    num_kv_heads=40,
    head_dim=64,
    d_ff=8960,
    vocab_size=65536,
    attention_type="rwkv",
    rwkv_head_size=64,
    source="arXiv:2404.05892",
)
