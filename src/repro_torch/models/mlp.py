"""SwiGLU MLP (llama-style gated feed-forward), counterpart of
`repro/models/mlp.py`."""
from __future__ import annotations

from repro_torch.models.layers import silu


def mlp_apply(params, x):
    h = silu(x @ params["w1"]) * (x @ params["w3"])
    return h @ params["w2"]
