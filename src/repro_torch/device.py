"""Device resolution for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(name: str | None = None) -> torch.device:
    """`cuda` unless the caller names `cpu`. Raises when CUDA is asked for
    (or defaulted to) and missing: the port never carries on quietly on
    the CPU."""
    dev = torch.device(name or "cuda")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' (--device cpu) to run the plain versions")
    # The linear-model gradients are fp32 GEMVs: keep them in full fp32.
    # torch.backends.cuda.matmul.allow_tf32 covers cuBLAS matmuls,
    # torch.backends.cudnn.allow_tf32 covers cuDNN (on by default).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev
