"""StableLM-2 12B — dense GQA decoder. [hf:stabilityai/stablelm-2-1_6b]

At full width its head_dim is 5120 / 32 = 160: the flash kernel's
head_dim-160 form (rows padded to 192 columns in shared memory) runs its
prefill, so it is served at full width and depth on one 80 GB card
(~24 GB of bf16 weights).
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    d_ff=13824,
    vocab_size=100352,
    source="hf:stabilityai/stablelm-2-1_6b",
)
