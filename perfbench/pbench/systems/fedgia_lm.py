"""FedGiA federating a decoder-only transformer through the port's
`--arch` path: `Transformer.loss` under `per_client_value_and_grad`, the
Lipschitz probe in `FedGiA.init`, the scalar-H round with the donated
`fedgia_update`, bf16 weights and gradients, a float32 state."""
from __future__ import annotations

import math

import torch

from pbench import ref_qwen2, threefry, traffic, yardstick
from pbench.systems.fedgia import Clock, FedGiASystem

# the port's Lipschitz probe (`hparams.estimate_lipschitz` defaults)
PROBES, PROBE_EPS = 4, 1e-2


def layout(hf: dict) -> dict:
    """The port's training tree for a dense Qwen2-family model, {name:
    (shape, init)}: the embedding 0.02 normals, matrices He-scaled
    normals (1/sqrt(fan_in)), norms ones, biases zeros."""
    L, d = hf["num_hidden_layers"], hf["hidden_size"]
    f, V = hf["intermediate_size"], hf["vocab_size"]
    he = lambda fan_in: ("normal", fan_in ** -0.5)  # noqa: E731
    g = "groups/dense/"
    return {
        "embed": ((V, d), ("normal", 0.02)),
        "final_norm/scale": ((d,), ("ones",)),
        g + "norm1/scale": ((L, d), ("ones",)),
        g + "attn/wq": ((L, d, d), he(d)),
        g + "attn/wk": ((L, d, d), he(d)),
        g + "attn/wv": ((L, d, d), he(d)),
        g + "attn/wo": ((L, d, d), he(d)),
        g + "attn/bq": ((L, d), ("zeros",)),
        g + "attn/bk": ((L, d), ("zeros",)),
        g + "attn/bv": ((L, d), ("zeros",)),
        g + "norm2/scale": ((L, d), ("ones",)),
        g + "mlp/w1": ((L, d, f), he(d)),
        g + "mlp/w3": ((L, d, f), he(d)),
        g + "mlp/w2": ((L, f, d), he(f)),
    }


def model_config(hf: dict):
    """The port's `ModelConfig` of the published configuration `hf`."""
    from repro_torch.config import ModelConfig
    d, H = hf["hidden_size"], hf["num_attention_heads"]
    return ModelConfig(
        name=hf["name"], family="dense", num_layers=hf["num_hidden_layers"],
        d_model=d, num_heads=H, num_kv_heads=hf["num_key_value_heads"],
        d_ff=hf["intermediate_size"], vocab_size=hf["vocab_size"],
        head_dim=d // H, qkv_bias=True, rope_theta=hf["rope_theta"],
        norm_eps=hf["rms_norm_eps"],
        tie_embeddings=hf["tie_word_embeddings"], dtype=hf["torch_dtype"])


class System(FedGiASystem):
    def _sizes(self, cfg, wl, seed, device):
        super()._sizes(cfg, wl, seed, device)
        self.hf = cfg["model"]
        self.m = self.fed["clients"]
        self.seqs, self.seq_len = wl["seqs_per_client"], wl["seq_len"]
        self.round_tokens = self.m * self.seqs * self.seq_len
        self.params0 = None

    def __init__(self, cfg: dict, wl: dict, seed: int, device):
        super().__init__(cfg, wl, seed, device)
        from repro_torch.config import FedConfig
        from repro_torch.core.api import make_algorithm
        from repro_torch.models import Transformer

        clock = Clock(device)
        self.params0 = traffic.weights(layout(self.hf), self.seed, device)
        clock.lap("weights")
        self.batch = {"tokens": self.tokens()}
        clock.lap("tokens")
        model = Transformer(model_config(self.hf), device)
        fed = self.fed
        self.algo = make_algorithm(FedConfig(
            algorithm="fedgia", num_clients=self.m, k0=fed["k0"],
            alpha=fed["alpha"], sigma_t=fed["sigma_t"],
            h_policy=fed["h_policy"], collapsed=True, auto_lipschitz=True),
            model.loss, model=model)
        self.state0 = self.algo.init(self.params0, self.key0,
                                     init_batch=self.batch)
        clock.lap("init with the probe")
        self.timings = clock.laps
        self.policy = None
        self.chunk = wl["chunk"]

    def tokens(self):
        return traffic.token_stream(self.seed, self.hf["vocab_size"],
                                    self.m, self.seqs, self.seq_len,
                                    self.device)

    def x0(self):
        if self.params0 is None:
            self.params0 = traffic.weights(layout(self.hf), self.seed,
                                           self.device)
        return {k: v.float() for k, v in self.params0.items()}

    def free(self):
        super().free()
        self.params0 = None

    def ref_dtype(self, precision):
        return torch.float32

    def grad_setup(self, precision, half):
        """The per-client gradient of the plain model at x̄ in the served
        dtype (bf16 weights, as the configuration states), and r, the
        probe's max over clients and probes of ‖g(x + εd) − g(x)‖ / ‖εd‖
        with the port's directions (the seed's key split per client, per
        probe, per leaf in path order; float32 normals); the arithmetic
        in `precision`."""
        mm = ref_qwen2.matmul_for("fp32" if precision == "ref" else "fp8")
        x0 = self.x0()
        self.params0 = None
        tokens = self.tokens()
        hf = self.hf

        served = getattr(torch, hf["torch_dtype"])

        def grad_fn(xbar):
            # the model's weights are x̄ as the configuration serves them
            # (in `torch_dtype`); the arithmetic stays in `precision`
            at = {k: v.to(served).float() for k, v in xbar.items()}
            losses, grads = [], {k: [] for k in xbar}
            for i in range(self.m):
                val, g = ref_qwen2.value_and_grad(at, tokens[i], hf, mm=mm,
                                                  half=half)
                losses.append(val)
                for k in grads:
                    grads[k].append(g[k])
                del g
            return torch.stack(losses), {k: torch.stack(v)
                                         for k, v in grads.items()}

        names = sorted(x0, key=lambda k: k.split("/"))
        r = 1e-8
        for i, ckey in enumerate(threefry.split(self.key0, self.m)):
            _, g0 = ref_qwen2.value_and_grad(x0, tokens[i], hf, mm=mm,
                                             half=half)
            for pkey in threefry.split(ckey, PROBES):
                p2, den = {}, 0.0
                for name, lk in zip(names, threefry.split(pkey, len(names))):
                    dlt = threefry.normal_t(lk, tuple(x0[name].shape),
                                            self.device) * PROBE_EPS
                    den += float(torch.dot(dlt.reshape(-1), dlt.reshape(-1)))
                    p2[name] = x0[name] + dlt
                    del dlt
                _, g1 = ref_qwen2.value_and_grad(p2, tokens[i], hf, mm=mm,
                                                 half=half)
                del p2
                num = sum(float(torch.sum((g1[k].double() - g0[k].double())
                                          ** 2)) for k in names)
                del g1
                r = max(r, (num ** 0.5) / max(den ** 0.5, 1e-12))
            del g0
        return grad_fn, r

    def round_cost(self):
        """(FLOPs, bytes) of one round: the model FLOPs of its tokens."""
        flops = self.round_tokens * ref_qwen2.flops_per_token(self.hf,
                                                              self.seq_len)
        return flops, None

    def update_bytes(self):
        """Bytes of the round's donated `fedgia_update` launch: ḡ, π at
        (m, N) (N the lane-padded parameter count), the 0-d h."""
        n = sum(math.prod(shape) for shape, _ in layout(self.hf).values())
        return yardstick.fedgia_update_bytes(self.m, yardstick.padded(n),
                                             self.n_selected(), scalar_h=True)
