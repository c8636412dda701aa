"""The port's data, layout and model modules against the JAX package's.

* `data.synthetic`: the same numpy code from the same seed, so bitwise.
* `utils.pytree.RavelSpec`: the same layout, so bitwise (mirrors
  tests/test_flat.py's RavelSpec tests).
* `models.linear_models`: loss, gradient and Gram at rtol 1e-5 / atol
  1e-6 (float32 reductions in another order); the Lipschitz constant at
  rtol 1e-5 (the port takes the spectral norm of the smaller Gram side).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import linreg_noniid as jax_linreg
from repro.data import logreg_data as jax_logreg
from repro.models import linear_models as jax_models
from repro.utils import pytree as jpt
from repro_torch.core import api
from repro_torch.data import linreg_noniid, logreg_data, to_torch
from repro_torch.models import linear_models as models
from repro_torch.utils import pytree as pt


@pytest.mark.parametrize("fn,jfn", [(linreg_noniid, jax_linreg),
                                    (logreg_data, jax_logreg)],
                         ids=["linreg", "logreg"])
@pytest.mark.parametrize("seed,d,n,m", [(0, 400, 20, 8), (3, 1000, 7, 16),
                                        (5, 300, 30, 1)])
def test_synthetic_data_bitwise(fn, jfn, seed, d, n, m):
    got, want = fn(seed, d, n, m), jfn(seed, d, n, m)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_to_torch_keeps_values_and_dtypes():
    raw = linreg_noniid(0, 100, 5, 4)
    batch = to_torch(raw, torch.device("cpu"))
    for k, v in raw.items():
        assert batch[k].dtype == torch.float32
        np.testing.assert_array_equal(batch[k].numpy(), v)


# ---------------------------------------------------------------- RavelSpec
def _tree():
    return {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": np.arange(3, dtype=np.float32) + 10.0}


def test_ravel_spec_layout_and_roundtrip():
    tree = _tree()
    spec = pt.ravel_spec({k: torch.from_numpy(v) for k, v in tree.items()})
    jspec = jpt.ravel_spec({k: jnp.asarray(v) for k, v in tree.items()})
    assert spec.size == jspec.size == 9
    assert spec.padded_size == jspec.padded_size == pt.LANES
    assert spec.offsets == jspec.offsets
    flat = spec.ravel({k: torch.from_numpy(v) for k, v in tree.items()})
    assert flat.shape == (pt.LANES,)
    assert float(flat[spec.size:].abs().max()) == 0.0  # zero tail
    want = jspec.ravel({k: jnp.asarray(v) for k, v in tree.items()})
    np.testing.assert_array_equal(flat.numpy(), np.asarray(want))
    back = spec.unravel(flat)
    for k, v in tree.items():
        np.testing.assert_array_equal(back[k].numpy(), v)


def test_ravel_spec_stacked_roundtrip():
    rng = np.random.default_rng(0)
    tree = {"w": rng.standard_normal((4, 2, 3)).astype(np.float32),
            "b": rng.standard_normal((4, 5)).astype(np.float32)}
    ttree = {k: torch.from_numpy(v) for k, v in tree.items()}
    spec = pt.ravel_spec({k: v[0] for k, v in ttree.items()})
    jspec = jpt.ravel_spec({k: jnp.asarray(v[0]) for k, v in tree.items()})
    flat = spec.ravel_stacked(ttree)
    assert flat.shape == (4, spec.padded_size)
    want = jspec.ravel_stacked({k: jnp.asarray(v) for k, v in tree.items()})
    np.testing.assert_array_equal(flat.numpy(), np.asarray(want))
    back = spec.unravel_stacked(flat)
    for k, v in tree.items():
        np.testing.assert_array_equal(back[k].numpy(), v)


def test_ravel_exact_lane_multiple_not_padded():
    spec = pt.ravel_spec({"w": torch.ones((pt.LANES,))})
    assert spec.size == spec.padded_size == pt.LANES


# ------------------------------------------------------------------- models
M, N, D = 6, 12, 300
MODELS = ["LeastSquares", "LogisticRegression", "NonConvexLogistic"]


@pytest.fixture(scope="module")
def batches():
    return {"linreg": linreg_noniid(1, D, N, M), "logreg": logreg_data(1, D, N, M)}


def _models(name, batches):
    raw = batches["linreg" if name == "LeastSquares" else "logreg"]
    return (getattr(models, name)(N), getattr(jax_models, name)(N), raw)


@pytest.mark.parametrize("name", MODELS)
def test_model_loss_and_grad_per_client(name, batches):
    model, jmodel, raw = _models(name, batches)
    x = np.random.default_rng(2).standard_normal(N).astype(np.float32) * 0.3
    jvg = jax.vmap(jax.value_and_grad(lambda p, b: jmodel.loss(p, b)[0]),
                   in_axes=(None, 0))
    jl, jg = jvg({"x": jnp.asarray(x)}, {k: jnp.asarray(v) for k, v in raw.items()})
    vg = api.per_client_value_and_grad(model.loss)
    tl, tg = vg({"x": torch.from_numpy(x)}, to_torch(raw, "cpu"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tg["x"].numpy(), np.asarray(jg["x"]),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", MODELS)
def test_model_gram_and_lipschitz(name, batches):
    model, jmodel, raw = _models(name, batches)
    jb = {k: jnp.asarray(v) for k, v in raw.items()}
    tb = to_torch(raw, "cpu")
    np.testing.assert_allclose(model.gram(tb).numpy(),
                               np.asarray(jax.vmap(jmodel.gram)(jb)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(model.lipschitz(tb).numpy(),
                               np.asarray(jax.vmap(jmodel.lipschitz)(jb)),
                               rtol=1e-5)


def test_lipschitz_small_gram_side_equals_large():
    """Clients with fewer rows than features take the (d, d) Gram side:
    the same spectral norm as the reference's (n, n) Gram."""
    raw = linreg_noniid(4, 40, 32, 4)  # ~10 rows per client, 32 features
    jb = {k: jnp.asarray(v) for k, v in raw.items()}
    want = jax.vmap(jax_models.LeastSquares(32).lipschitz)(jb)
    got = models.LeastSquares(32).lipschitz(to_torch(raw, "cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
