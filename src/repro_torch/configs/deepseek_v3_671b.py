"""DeepSeek-V3 671B — MLA attention, 1 shared + 256 routed experts (top-8),
first 3 layers dense, multi-token-prediction aux head. [arXiv:2412.19437]

moe_d_ff=2048 per assignment; the leading dense layers use the model-card
dense FFN width 18432.

The whole model (~1.3 TB in bfloat16) does not fit one 80 GB card. It is
served at its published widths with its depth cut (its 3 dense layers
and 1 MoE layer, `dataclasses.replace(CONFIG, num_layers=4)`, ~32 GB
with the MTP head) and trained at `reduced()` size.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,
    d_ff=18432,  # dense layers (model card); experts use moe_d_ff
    vocab_size=129280,
    moe=True,
    num_experts=256,
    experts_per_token=8,
    num_shared_experts=1,
    moe_d_ff=2048,
    first_dense_layers=3,
    router_aux_coef=0.001,
    attention_type="mla",
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_rope_dim=64,
    qk_nope_dim=128,
    v_head_dim=128,
    mtp=True,
    source="arXiv:2412.19437",
)
