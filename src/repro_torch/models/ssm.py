"""Selective SSM (Mamba-style) branch of the Hymba hybrid block.

Counterpart of `repro/models/ssm.py`: a data-dependent (dt, B, C)
selective scan with a diagonal A and a gated output; the inner width is
d_model (Hymba pairs each attention head with an SSM head of the same
width) and there is no depthwise conv, as in the reference. Its
parameters are drawn in `models/transformer.py` (`_ssm_init`).

The reference scans with `lax.scan` and has no Pallas kernel here, so
the port's scan is plain PyTorch: the decay exp(dt·A) and the input
(dt·u) B are formed for a chunk of steps at once, the recurrence is one
multiply-add a step, and the read-out against C is one product a chunk.
It writes to none of its inputs and stacks its steps, so `torch.func`'s
`vmap(grad_and_value)` goes through it, and a decode step (T = 1) reads
no host value, so a CUDA graph captures it.
"""
from __future__ import annotations

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels import run_plain
from repro_torch.models.layers import silu

# bytes of one (B, chunk, d, st) float32 term of the scan: the decay, the
# input and the stacked states each hold this much at a time (Hymba's
# prefill, (4, 1024, 1600, 16), would need 420 MB for each whole)
SCAN_CHUNK_BYTES = 1 << 26


def softplus(x):
    """`jax.nn.softplus`: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|)),
    with no threshold (`F.softplus` returns x itself above 20)."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def ssm_scan(u, dt, Bm, Cm, A, state0):
    """u, dt: (B,T,di); Bm, Cm: (B,T,st); A: (di,st); state0: (B,di,st),
    all float32.

      h_t = exp(dt_t A) h_{t-1} + (dt_t u_t) B_t ;  y_t = <h_t, C_t>

    Returns y (B,T,di) and the final state (B,di,st)."""
    B, T, di = u.shape
    st = A.shape[-1]
    chunk = max(1, SCAN_CHUNK_BYTES // max(1, B * di * st * 4))
    h, ys = state0, []
    for c0 in range(0, T, chunk):
        sl = slice(c0, min(T, c0 + chunk))
        decay = torch.exp(dt[:, sl, :, None] * A)  # (B,c,di,st)
        inp = (dt[:, sl] * u[:, sl])[..., None] * Bm[:, sl, None, :]
        hs = []
        for t in range(decay.shape[1]):  # one launch a step on the card
            h = torch.addcmul(inp[:, t], decay[:, t], h)
            hs.append(h)
        ys.append(torch.einsum("btds,bts->btd", torch.stack(hs, dim=1),
                               Cm[:, sl]))
    return torch.cat(ys, dim=1), h


def ssm_apply(params, cfg: ModelConfig, x, ssm_state):
    """x: (B,T,d); ssm_state: (B,d,st) float32. Returns (out, new state).

    u = x in_x, z = x in_z, dt = softplus(x w_dt + dt_bias) (in x's
    dtype, then float32), B and C in float32, A = -exp(A_log); the scan's
    y in x's dtype plus D u, gated by silu(z), through `out`."""
    u = x @ params["in_x"]
    z = x @ params["in_z"]
    pre = x @ params["w_dt"] + params["dt_bias"]
    dt = softplus(pre.float()).to(x.dtype).float()
    Bm = (x @ params["w_B"]).float()
    Cm = (x @ params["w_C"]).float()
    A = -torch.exp(params["A_log"])
    y, new_state = run_plain("ssm_scan", ssm_scan, u.float(), dt, Bm, Cm, A,
                             ssm_state)
    y = y.to(x.dtype) + params["D"] * u
    return (y * silu(z)) @ params["out"], new_state


def init_ssm_state(cfg: ModelConfig, batch: int, device=None):
    return torch.zeros((batch, cfg.d_model, cfg.ssm_state),
                       dtype=torch.float32, device=device)
