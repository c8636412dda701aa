"""Snowflake Arctic 480B — dense-MoE hybrid: every block has a dense
residual MLP in PARALLEL with a 128-expert top-2 MoE.
[hf:Snowflake/snowflake-arctic-base]

The whole model (~0.96 TB in bfloat16) does not fit one 80 GB card. It
is served at its published widths with its depth cut to one layer
(`dataclasses.replace(CONFIG, num_layers=1)`, ~28 GB) and trained at
`reduced()` size.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=4864,
    vocab_size=32000,
    moe=True,
    num_experts=128,
    experts_per_token=2,
    moe_d_ff=4864,
    dense_residual=True,
    router_aux_coef=0.01,
    source="hf:Snowflake/snowflake-arctic-base",
)
