"""FedGiA hyper-parameter policies: sigma and H_i (paper Remark IV.1 /
Table III). Counterpart of `repro/core/hparams.py`.

Theory requirements (Lemma IV.1): sigma >= 6 r / m and 0 <= H_i <= r_i I.
  * sigma = t * r / m with t from Table III.
  * r_hat from the model (`lipschitz`), or probed (`estimate_lipschitz`,
    the `auto_lipschitz` flag the transformer runs set).
  * H policies: scalar (H_i = r_hat I), diag_ema (clipped diagonal EMA of
    gradient magnitudes) and gram (client Gram matrix, linear models).
"""
from __future__ import annotations

import torch

from repro_torch.core import api, prng
from repro_torch.utils import pytree as pt

EMA_BETA = 0.9


def sigma_from(t: float, r, m: int):
    return t * r / m


def _sq_norm(tree: dict, keys) -> torch.Tensor:
    """The reference's `tree_sq_norm`: a vdot a leaf, in the leaf's dtype
    (accumulated in float32, then rounded to it), summed in leaf order
    onto a float32 zero."""
    total = None
    for k in keys:
        v = tree[k].reshape(-1)
        dot = torch.dot(v.float(), v.float()).to(v.dtype)
        total = dot.float() if total is None else total + dot
    return total


def estimate_lipschitz(loss_fn, params: dict, batch: dict, key,
                       probes: int = 4, eps: float = 1e-2) -> torch.Tensor:
    """r_hat = max over random probes of ||g(x+d) - g(x)|| / ||d||, the
    reference's probe: `key` (a threefry key, `core/prng.py`) splits into
    one key a probe, each into one key a leaf in the reference's leaf
    order (`_split_like`); d is eps times a float32 normal draw, cast to
    the leaf's dtype before it is added. Gradients are taken in the
    parameters' own dtype (bf16 for the registered configs, as the
    reference does not cast `params0`). Draws leaf by leaf, so no
    temporary holds more than one leaf. Returns a 0-d float32 tensor."""
    keys = sorted(params, key=lambda k: k.split("/"))
    device = params[keys[0]].device
    grad = torch.func.grad(lambda p: loss_fn(p, batch)[0])
    g0 = grad(params)
    vals = []
    for k in prng.split(key, probes):
        p2, den = {}, None
        for name, lk in zip(keys, prng.split(k, len(keys))):
            a = params[name]
            if device.type == "cpu":
                d = torch.from_numpy(prng.normal(lk, tuple(a.shape)))
            else:
                d = prng.normal_t(prng.key_t(lk, device), tuple(a.shape))
            d = d * eps
            dd = torch.dot(d.reshape(-1), d.reshape(-1))
            den = dd if den is None else den + dd
            p2[name] = a + d.to(a.dtype)
            del d
        g1 = grad(p2)
        del p2
        diff = {n: g1[n] - g0[n] for n in keys}
        del g1
        num = torch.sqrt(_sq_norm(diff, keys))
        vals.append(num / torch.clamp_min(torch.sqrt(den), 1e-12))
    return torch.clamp_min(torch.stack(vals).max(), 1e-8)


def update_diag_h(h, gbar, r_hat, m: int, out: torch.Tensor = None):
    """EMA diagonal curvature proxy, clipped to [0, r_hat] (Remark IV.1).

    gbar is the scaled gradient (1/m) grad f_i; rescale to grad f_i before
    normalising so the proxy is invariant to m. Returns a new tensor, or
    writes `out` (which may be `h`). Every step but the first runs in
    place on one temporary the size of h, the same operations in the same
    order as out of place, so the values are the same bit for bit.

    `h` and `gbar` may be trees of leaves (the per-leaf rounds): one max
    over every leaf, then the same steps leaf by leaf, so each element is
    the flat buffer's; a tree is never written in place."""
    if isinstance(h, dict):
        g2 = pt.tree_map(lambda g: (g.float() * m).square_(), gbar)
        peak = torch.stack([v.max() for v in pt.tree_leaves(g2)]).max()
        gmax = api.client_scalar_max(torch.clamp_min(peak, 1e-30))
        return pt.tree_map(lambda hh, gg: _ema(hh, gg, r_hat, gmax, None),
                           h, g2)
    g2 = gbar.float() * m
    g2.square_()
    gmax = api.client_scalar_max(torch.clamp_min(g2.max(), 1e-30))
    return _ema(h, g2, r_hat, gmax, out)


def _ema(h, g2, r_hat, gmax, out):
    """beta * h + (1 - beta) * (r_hat * g2 / gmax), clipped, with `g2`
    (a temporary) and `out` written in place."""
    g2.mul_(r_hat).div_(gmax).mul_(1 - EMA_BETA)
    if out is None:
        out = EMA_BETA * h
    else:
        out.copy_(h).mul_(EMA_BETA)
    out.add_(g2)
    return out.clamp_(min=torch.zeros_like(r_hat), max=r_hat)
