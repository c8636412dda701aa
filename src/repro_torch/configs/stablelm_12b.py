"""StableLM-2 12B — dense GQA decoder. [hf:stabilityai/stablelm-2-1_6b]

At full width its head_dim is 5120 / 32 = 160, which the flash kernel
does not take: a full-width prefill raises there (ROADMAP queue 3 q).
Training (`--arch stablelm-12b`), which attends with the plain blocked
softmax, and `reduced()` (head_dim 64) run.
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
