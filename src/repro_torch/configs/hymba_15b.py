"""Hymba 1.5B — hybrid-head: attention heads and Mamba(SSM) heads run in
PARALLEL inside every block and their outputs are fused. [arXiv:2411.13676]

The whole model (1,474,872,000 parameters, 2.95 GB in bfloat16) serves
at full width and depth on one 80 GB card; its SSM branch is
`models/ssm.py`.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    attention_type="hybrid",
    ssm_state=16,
    source="arXiv:2411.13676",
)
