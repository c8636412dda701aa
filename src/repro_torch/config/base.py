"""The `FedConfig` fields that the flat FedGiA round reads
(counterpart of `repro/config/base.py::FedConfig`, same defaults)."""
from __future__ import annotations

import dataclasses

H_POLICIES = ("scalar", "diag_ema", "gram")


@dataclasses.dataclass(frozen=True)
class FedConfig:
    """FedGiA hyper-parameters (paper §V.B)."""

    num_clients: int = 16
    k0: int = 5  # local steps between communications
    alpha: float = 0.5  # |C| / m, client-selection fraction
    sigma_t: float = 0.15  # sigma = t * r / m (paper Table III)
    lipschitz: float = 1.0  # r, replaced by the model's own when it has one
    auto_lipschitz: bool = False
    h_policy: str = "diag_ema"  # diag_ema | scalar | gram (linear models only)
    collapsed: bool = True  # closed-form k0-step round (the kernel's form)
    state_dtype: str = "float32"

    def __post_init__(self):
        if self.h_policy not in H_POLICIES:
            raise ValueError(f"unknown h_policy {self.h_policy!r}: {H_POLICIES}")
        if self.k0 < 1:
            raise ValueError(f"k0 must be >= 1, got {self.k0}")
        if self.num_clients < 1:
            raise ValueError(f"num_clients must be >= 1, got {self.num_clients}")
