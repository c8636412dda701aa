"""The paper's own test models (§V Examples V.1–V.3), on tensors.

Counterpart of `repro/models/linear_models.py`. `loss(params, batch)`
is one client's objective (params {"x": (n,)}, batch rows (d, n)), as
in the reference, so `core.api.per_client_value_and_grad` can batch it
with `torch.func.vmap`. `gram` and `lipschitz` take a client-stacked
batch ((m, d, n); an unstacked one works too) and return per-client
results, where the reference vmaps them.

Losses follow the paper's normalisation: per-client
  f_i(x) = (1/d_i) sum_j loss_j  (+ regulariser / d_i)
"""
from __future__ import annotations

import torch


def _masked(batch):
    """Apply the ragged-client mask: zero padded rows, return effective d_i
    (shape (...,), broadcastable against per-client scalars)."""
    A = batch["A"]
    mask = batch.get("mask")
    if mask is None:
        return A, torch.full(A.shape[:-2], float(A.shape[-2]), device=A.device)
    return A * mask[..., :, None], torch.clamp_min(mask.sum(-1), 1.0)


def _sq_spectral_norm(A):
    """||A||_2^2 per client, as the spectral norm of the SMALLER of the two
    Gram matrices A^T A (n, n) and A A^T (d, d): they share their nonzero
    eigenvalues, and with many clients of few rows the (m, n, n) stack
    would not fit on the card."""
    if A.shape[-2] < A.shape[-1]:
        G = A @ A.transpose(-1, -2)
    else:
        G = A.transpose(-1, -2) @ A
    return torch.linalg.matrix_norm(G, ord=2)


def _zeros_params(n, device):
    return {"x": torch.zeros((n,), dtype=torch.float32, device=device)}


class LeastSquares:
    """Example V.1:  f_i(x) = 1/(2 d_i) ||A_i x - b_i||^2."""

    def __init__(self, n: int):
        self.n = n

    def init(self, device):
        return _zeros_params(self.n, device)

    def loss(self, params, batch):
        A, b = batch["A"], batch["b"]
        mask = batch.get("mask")
        r = A @ params["x"] - b
        if mask is None:
            loss = 0.5 * torch.mean(torch.square(r))
        else:
            loss = (0.5 * torch.sum(mask * torch.square(r))
                    / torch.clamp_min(mask.sum(), 1.0))
        return loss, {"loss": loss}

    def gram(self, batch):
        """H_i = B_i / d_i with B_i = A_i^T A_i (paper Table III, Ex. V.1)."""
        A, d = _masked(batch)
        return (A.transpose(-1, -2) @ A) / d[..., None, None]

    def lipschitz(self, batch):
        """r_i = ||B_i|| / d_i (spectral norm of the Hessian)."""
        A, d = _masked(batch)
        return _sq_spectral_norm(A) / d


class LogisticRegression:
    """Example V.2:  l2-regularised logistic loss,
    f_i(x) = (1/d_i) sum_j [ln(1+e^{<a,x>}) - b<a,x>] + mu/(2 d_i) ||x||^2."""

    def __init__(self, n: int, mu: float = 1e-3):
        self.n = n
        self.mu = mu

    def init(self, device):
        return _zeros_params(self.n, device)

    def loss(self, params, batch):
        A, b = batch["A"], batch["b"]
        mask = batch.get("mask")
        z = A @ params["x"]
        per = torch.logaddexp(torch.zeros_like(z), z) - b * z
        if mask is None:
            d = A.shape[0]
            ll = torch.sum(per) / d
        else:
            d = torch.clamp_min(mask.sum(), 1.0)
            ll = torch.sum(mask * per) / d
        reg = 0.5 * self.mu * torch.sum(torch.square(params["x"])) / d
        loss = ll + reg
        return loss, {"loss": loss}

    def gram(self, batch):
        """H_i = B_i/(4 d_i) (paper Table III, Ex. V.2): sigmoid' <= 1/4."""
        A, d = _masked(batch)
        return (A.transpose(-1, -2) @ A) / (4.0 * d[..., None, None])

    def lipschitz(self, batch):
        A, d = _masked(batch)
        return _sq_spectral_norm(A) / (4.0 * d) + self.mu / d


class NonConvexLogistic:
    """Example V.3: logistic loss + non-convex regulariser
    mu/(2 d_i) sum_l x_l^2 / (1 + x_l^2)."""

    def __init__(self, n: int, mu: float = 1e-2):
        self.n = n
        self.mu = mu

    def init(self, device):
        return _zeros_params(self.n, device)

    def loss(self, params, batch):
        A, b = batch["A"], batch["b"]
        mask = batch.get("mask")
        x = params["x"]
        z = A @ x
        per = torch.logaddexp(torch.zeros_like(z), z) - b * z
        if mask is None:
            d = A.shape[0]
            ll = torch.sum(per) / d
        else:
            d = torch.clamp_min(mask.sum(), 1.0)
            ll = torch.sum(mask * per) / d
        x2 = torch.square(x)
        reg = 0.5 * self.mu * torch.sum(x2 / (1.0 + x2)) / d
        loss = ll + reg
        return loss, {"loss": loss}

    def gram(self, batch):
        """Paper Table III, Ex. V.3: B_i/(4 d_i) + mu I / d_i."""
        A, d = _masked(batch)
        eye = torch.eye(self.n, dtype=A.dtype, device=A.device)
        dd = d[..., None, None]
        return (A.transpose(-1, -2) @ A) / (4.0 * dd) + self.mu * eye / dd

    def lipschitz(self, batch):
        """||B_i/(4 d_i) + mu I/d_i|| = ||A_i||^2/(4 d_i) + mu/d_i: the shift
        by mu I/d_i moves every eigenvalue of the PSD Gram by the same."""
        A, d = _masked(batch)
        return _sq_spectral_norm(A) / (4.0 * d) + self.mu / d
