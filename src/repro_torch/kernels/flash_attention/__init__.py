from repro_torch.kernels.flash_attention.ops import (
    flash_attention,
    launches,
    reset_launches,
)
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
