"""FedGiA rounds on a transformer: the port's engine against the JAX
package's on reduced tinyllama-1.1b in float32 (m = 4 clients, k0 = 3,
alpha = 0.5, sigma_t = 30, `auto_lipschitz`, 5 rounds), under the scalar
and the diag_ema H, the port in both drivers.

* the port's chunked driver and legacy loop: bit for bit (state and
  history);
* per-round f against the reference's at rtol 1e-5 (measured at most
  5e-6 under diag_ema), r and sigma at rtol 1e-4 (the probe's float32
  norms, tests/test_torch_train_arch.py), the final x̄ normwise at 1e-5;
* |grad|^2 at rtol 1e-2: inside its compiled round the reference sums
  the squares of each leaf in float32 in an order that loses 0.4 % of
  the embedding's 131072 terms (its eager `tree_sq_norm` of the same
  gradients is 2e-5 from the port's, measured).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import FedConfig as JaxFedConfig
from repro.configs import get_config as jax_get_config
from repro.core import make_algorithm as jax_make_algorithm
from repro.core import run_rounds as jax_run_rounds
from repro.data.tokens import synthetic_batch_for as jax_batch_for
from repro.models import Transformer as JaxTransformer
from repro_torch.config import FedConfig
from repro_torch.configs import get_config
from repro_torch.core.api import make_algorithm
from repro_torch.core.engine import run_rounds
from repro_torch.core.prng import prng_key
from repro_torch.data import synthetic_batch_for, to_torch
from repro_torch.models import Transformer
from repro_torch.utils.convert import training_tree_from_numpy
from repro_torch.utils.pytree import ravel_spec

M, B, S, ROUNDS = 4, 2, 16, 5
GSQ_RTOL = 1e-2


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("h_policy", ["scalar", "diag_ema"])
def test_fedgia_rounds_match_reference(h_policy):
    arch = "tinyllama-1.1b"
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(),
                               dtype="float32")
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    kw = dict(algorithm="fedgia", num_clients=M, k0=3, alpha=0.5,
              sigma_t=30.0, h_policy=h_policy, auto_lipschitz=True)
    jmodel = JaxTransformer(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    jbatch = jax.tree.map(jnp.asarray, jax_batch_for(jcfg, M, B, S))
    jalgo = jax_make_algorithm(JaxFedConfig(**kw), jmodel.loss, model=jmodel)
    jstate = jalgo.init(jparams, jax.random.PRNGKey(1), init_batch=jbatch)
    want = jax_run_rounds(jalgo, jstate, jbatch, ROUNDS, tol=0.0)

    model = Transformer(cfg, "cpu")
    algo = make_algorithm(FedConfig(**kw), model.loss, model=model)
    state = algo.init(training_tree_from_numpy(jax.device_get(jparams), "cpu"),
                      prng_key(1), init_batch=to_torch(
                          synthetic_batch_for(cfg, M, B, S), "cpu"))
    batch = to_torch(synthetic_batch_for(cfg, M, B, S), "cpu")
    got = run_rounds(algo, state, batch, ROUNDS, tol=0.0)
    eager = run_rounds(algo, state, batch, ROUNDS, tol=0.0, scan=False)

    for k in got.history:
        np.testing.assert_array_equal(got.history[k], eager.history[k], k)
    for k in ("x", "z", "pi") + (("h",) if h_policy == "diag_ema" else ()):
        for leaf, v in got.state[k].items():
            assert torch.equal(v, eager.state[k][leaf]), (k, leaf)

    for k in ("r", "sigma"):
        np.testing.assert_allclose(float(state[k]), float(jstate[k]),
                                   rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(got.history["f_xbar"],
                               np.asarray(want.history["f_xbar"]), rtol=1e-5)
    np.testing.assert_allclose(got.history["grad_sq_norm"],
                               np.asarray(want.history["grad_sq_norm"]),
                               rtol=GSQ_RTOL)
    np.testing.assert_array_equal(got.history["selected"],
                                  np.asarray(want.history["selected"]))
    spec = ravel_spec(got.state["x"])
    x = spec.ravel(got.state["x"])
    wx = spec.ravel(training_tree_from_numpy(
        jax.device_get(want.state["x"]), "cpu"))
    assert float((x - wx).norm() / wx.norm()) <= 1e-5
