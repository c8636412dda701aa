"""FedGiA hyper-parameter policies: sigma and H_i (paper Remark IV.1 /
Table III). Counterpart of `repro/core/hparams.py`.

Theory requirements (Lemma IV.1): sigma >= 6 r / m and 0 <= H_i <= r_i I.
  * sigma = t * r / m with t from Table III.
  * H policies: scalar (H_i = r_hat I), diag_ema (clipped diagonal EMA of
    gradient magnitudes) and gram (client Gram matrix, linear models).

`estimate_lipschitz` (the reference's `auto_lipschitz` probe) is not
ported yet: `FedGiA.init` raises on that flag.
"""
from __future__ import annotations

import torch

from repro_torch.core import api

EMA_BETA = 0.9


def sigma_from(t: float, r, m: int):
    return t * r / m


def update_diag_h(h: torch.Tensor, gbar: torch.Tensor, r_hat, m: int):
    """EMA diagonal curvature proxy, clipped to [0, r_hat] (Remark IV.1).

    gbar is the scaled gradient (1/m) grad f_i; rescale to grad f_i before
    normalising so the proxy is invariant to m. Returns a new tensor.
    """
    g2 = torch.square(gbar.float() * m)
    gmax = api.client_scalar_max(torch.clamp_min(g2.max(), 1e-30))
    h_new = EMA_BETA * h + (1 - EMA_BETA) * (r_hat * g2 / gmax)
    return torch.clamp(h_new, min=torch.zeros_like(r_hat), max=r_hat)
