"""What every FedGiA configuration shares: the port's round driver
(`repro_torch.core.engine.run_rounds` over `FedGiA.round_flat`), the
masks the reference works out again, and the readings of the first
rounds that the harness compares with the reference's."""
from __future__ import annotations

import gc
import time

import torch

from pbench import ref_fedgia, threefry

# the first steps run as two calls of the window's driver: one round, and
# two more; the reference follows these three rounds
FIRST_CALLS = (1, 2)


class Clock:
    """Host seconds of set-up's parts, each ending in a synchronise."""

    def __init__(self, device):
        self.device, self.laps, self.t = device, {}, time.perf_counter()

    def lap(self, name: str):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.laps[name] = now - self.t
        self.t = now


class FedGiASystem:
    """Subclasses set `self.algo`, `self.batch`, `self.state0`,
    `self.policy` (None: FedGiA's own α split), `self.chunk`, `self.m`,
    and implement `x0()` and `grad_setup(precision, half)`."""

    round_tokens = 0  # training tokens a round (language models)

    def __init__(self, cfg: dict, wl: dict, seed: int, device):
        self._sizes(cfg, wl, seed, device)

    def _sizes(self, cfg: dict, wl: dict, seed: int, device):
        """What the reference needs: sizes, settings, the seed's key."""
        self.cfg, self.wl, self.seed, self.device = cfg, wl, int(seed), device
        self.fed = cfg["fedgia"]
        self.key0 = threefry.prng_key(self.seed)

    @classmethod
    def for_reference(cls, cfg: dict, wl: dict, seed: int, device):
        """An object that makes the seed's inputs for the reference and
        builds nothing of the program."""
        sut = cls.__new__(cls)
        sut._sizes(cfg, wl, seed, device)
        return sut

    def alpha(self) -> float:
        """The share of ADMM clients a round: FedGiA's own α, or the
        participation policy's."""
        if self.wl.get("participation", "full") == "full":
            return self.fed["alpha"]
        return self.wl["alpha"]

    def n_selected(self) -> int:
        return max(1, min(self.m, int(round(self.alpha() * self.m))))

    # ------------------------------------------------------------ program
    def run(self, state, rounds: int):
        """`rounds` rounds of the window's call from `state` (left as it
        was)."""
        from repro_torch.core.engine import run_rounds
        return run_rounds(self.algo, state, self.batch, rounds, tol=0.0,
                          chunk_size=self.chunk, participation=self.policy)

    def masks(self):
        """The ADMM/GD masks of the three first rounds, worked out again:
        FedGiA's key chain from the seed's key (rounds 0, 1, 2), or the
        cyclic policy's blocks, whose round index each call of the
        driver counts from 0."""
        m, alpha = self.m, self.alpha()
        part = self.wl.get("participation", "full")
        if part == "full":
            key, out = self.key0, []
            for t in range(sum(FIRST_CALLS)):
                key, mk = threefry.fedgia_split(key, t, m, alpha)
                out.append(torch.from_numpy(mk))
            return out
        if part == "cyclic":
            n_sel = self.n_selected()
            out = []
            for calls in FIRST_CALLS:
                for t in range(calls):
                    mk = torch.zeros(m, dtype=torch.bool)
                    idx = (t * n_sel + torch.arange(n_sel)) % m
                    mk[idx] = True
                    out.append(mk)
            return out
        raise ValueError(f"no reference masks for participation {part!r}")

    def first_steps(self, log):
        """Drive the state through the first rounds with the window's own
        call and feed. Returns (the program's readings, the state after
        them, the last call's RoundResult)."""
        masks = self.masks()
        res1 = self.run(self.state0, FIRST_CALLS[0])
        r = float(self.state0["r"])
        self.state0 = None
        f = [float(v) for v in res1.history["f_xbar"]]
        gsq = [float(v) for v in res1.history["grad_sq_norm"]]
        gbar = self._gbar_from_pi(res1.state["pi"], masks[0])
        log(f"first round: {res1.wall_s!r} s (capture {res1.capture_s!r} s)")
        state1 = res1.state
        del res1
        release(self.device)
        res3 = self.run(state1, FIRST_CALLS[1])
        del state1
        release(self.device)
        f += [float(v) for v in res3.history["f_xbar"]]
        gsq += [float(v) for v in res3.history["grad_sq_norm"]]
        x0 = self.x0()
        step = {}
        for k, z in res3.state["z"].items():
            step[k] = float(torch.linalg.vector_norm(
                z.double().mean(0) - x0[k].double(), dtype=torch.float64))
        log(f"rounds 2-3: {res3.wall_s!r} s (capture {res3.capture_s!r} s)")
        prog = {"f": f, "gsq": gsq, "gbar": gbar, "step": step, "r": r}
        return prog, res3.state, res3

    def _gbar_from_pi(self, pi: dict, mask):
        """Row norms of ḡ after the first round, worked out from π¹: with
        π⁰ = 0 the GD branch leaves π = −ḡ_i, and k0 ADMM steps leave
        π = −ḡ_i (1 − q^k0), q = 1 − σ/(r/m + σ) = 1/(1 + σ_t), since
        H_i = r I in the first round under both H policies."""
        q = 1.0 / (1.0 + self.fed["sigma_t"])
        c = torch.where(mask, 1.0 - q ** self.fed["k0"], 1.0).double()
        return {k: torch.linalg.vector_norm(v.flatten(1), dim=1,
                                            dtype=torch.float64).cpu() / c
                for k, v in pi.items()}

    # ---------------------------------------------------------- reference
    def reference(self, precision: str = "ref", half: bool = False):
        """The reference's readings of the three first rounds, from the
        seed's inputs made again (`precision` "ref" or "control")."""
        grad_fn, r = self.grad_setup(precision, half)
        return ref_fedgia.rounds(
            grad_fn, self.x0(), self.m, self.masks(),
            sigma_t=self.fed["sigma_t"], r=r, k0=self.fed["k0"],
            h_policy=self.fed["h_policy"], dtype=self.ref_dtype(precision))

    def free(self):
        """Drop the program's inputs and state."""
        self.algo = self.batch = self.state0 = None


def release(device):
    """Free what a finished driver call left: its CUDA graphs and their
    private memory pools go with its last reference."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
