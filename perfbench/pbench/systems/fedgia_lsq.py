"""FedGiA on the paper's Example V.1 least squares (`LeastSquares`), the
flat round on the dense store under the chunked CUDA-graph driver."""
from __future__ import annotations

import torch

from pbench import ref_lsq, traffic, yardstick
from pbench.systems.fedgia import Clock, FedGiASystem


class System(FedGiASystem):
    def _sizes(self, cfg, wl, seed, device):
        super()._sizes(cfg, wl, seed, device)
        self.m, self.n = cfg["data"]["clients"], cfg["data"]["features"]

    def __init__(self, cfg: dict, wl: dict, seed: int, device):
        super().__init__(cfg, wl, seed, device)
        from repro_torch.config import FedConfig
        from repro_torch.core.api import make_algorithm
        from repro_torch.core.selection import make_policy
        from repro_torch.models import LeastSquares

        clock = Clock(device)
        self.batch = self.inputs()
        clock.lap("data")
        model = LeastSquares(self.n)
        fed = self.fed
        self.algo = make_algorithm(FedConfig(
            algorithm="fedgia", num_clients=self.m, k0=fed["k0"],
            alpha=fed["alpha"], sigma_t=fed["sigma_t"],
            h_policy=fed["h_policy"], collapsed=True), model.loss,
            model=model)
        self.state0 = self.algo.init(model.init(device), self.key0,
                                     init_batch=self.batch)
        clock.lap("init")
        self.timings = clock.laps
        part = wl.get("participation", "full")
        self.policy = (None if part == "full" else
                       make_policy(part, self.m, wl["alpha"]))
        self.chunk = wl["chunk"]

    def inputs(self):
        data = self.cfg["data"]
        return traffic.lsq_mixture(self.seed, data["samples"],
                                   data["features"], data["clients"],
                                   data["rows"], self.device)

    def x0(self):
        return {"x": torch.zeros(self.n, dtype=torch.float32,
                                 device=self.device)}

    def ref_dtype(self, precision):
        return torch.float64 if precision == "ref" else torch.float32

    def grad_setup(self, precision, half):
        return ref_lsq.setup(self.inputs(),
                             "fp64" if precision == "ref" else "tf32",
                             half=half)

    def round_cost(self):
        """(FLOPs, bytes) one round needs (`yardstick.lsq_round`)."""
        data = self.cfg["data"]
        return yardstick.lsq_round(
            data["samples"], self.n, self.m, data["rows"], self.alpha(),
            self.fed["k0"], self.fed["h_policy"] == "diag_ema")

    def update_bytes(self):
        """Bytes the round's one `fedgia_update` launch must move."""
        return yardstick.fedgia_update_bytes(
            self.m, yardstick.padded(self.n), self.n_selected(),
            scalar_h=self.fed["h_policy"] == "scalar")
