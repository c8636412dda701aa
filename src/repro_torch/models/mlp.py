"""SwiGLU MLP (llama-style gated feed-forward), counterpart of
`repro/models/mlp.py`."""
from __future__ import annotations

from repro_torch.models.layers import he_init, silu


def mlp_init(gen, d: int, f: int, dtype, device=None):
    return {
        "w1": he_init(gen, (d, f), d, dtype, device),  # gate
        "w3": he_init(gen, (d, f), d, dtype, device),  # up
        "w2": he_init(gen, (f, d), f, dtype, device),  # down
    }


def mlp_apply(params, x):
    h = silu(x @ params["w1"]) * (x @ params["w3"])
    return h @ params["w2"]
