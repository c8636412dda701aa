"""The port's `fedgia_update` module against the JAX package's.

The plain versions in `repro_torch.kernels.fedgia_update` are held to the
Pallas kernels run in interpret mode (as tests/test_kernels.py runs them)
and to the unrolled jnp oracle `fedgia_update_ref`. The CUDA kernel
itself cannot run here; chip_smoke.py holds it to these plain versions on
the card. Tolerances:

* collapsed plain vs Pallas kernel: rtol 1e-6, atol 2e-6 (a few float32
  ulps at the operands' scale, |z| < 16). Both sides run the same closed
  form in the same operation order, but XLA:CPU contracts each a*b+c
  into one FMA, while the port rounds the product and the sum apart, as
  its CUDA kernel does (built with --fmad=false, so that the kernel
  matches the plain version bit for bit on the card);
* collapsed plain vs the unrolled oracle (either package's): rtol/atol
  2e-5, the reference's own kernel-vs-oracle tolerance;
* unrolled port oracle vs unrolled JAX oracle: rtol 1e-6, atol 1e-6
  (the same FMA contraction, through the cancellation in x - xbar);
* donated vs undonated plain wrapper: bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fedgia_update import fedgia_update as jax_fedgia_update
from repro.kernels.fedgia_update import fedgia_update_flat as jax_update_flat
from repro.kernels.fedgia_update import fedgia_update_ref as jax_update_ref
from repro.kernels.fedgia_update.kernel import fedgia_update_batched_kernel
from repro_torch.kernels import _build
from repro_torch.kernels.fedgia_update import ops, ref

LANES = 128
RTOL, ATOL = 1e-6, 2e-6  # port vs the Pallas kernel (see above)
SIGMA = 0.7


def _inputs(seed, shape, sel=None):
    rng = np.random.default_rng(seed)
    xbar, g, pi = (rng.standard_normal(shape).astype(np.float32)
                   for _ in range(3))
    h = rng.uniform(0.05, 3.0, shape).astype(np.float32)
    if sel is None:
        sel = rng.uniform(size=shape[0]) < 0.5
        sel[0], sel[-1] = True, False  # both branches, always
    return xbar, g, pi, h, np.asarray(sel)


def _torch(*arrs):
    return [torch.from_numpy(np.array(a)) for a in arrs]


def _close(out, want, rtol, atol, what):
    for a, b, name in zip(out, want, ("x", "pi", "z")):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                                   atol=atol, err_msg=f"{what}: {name}")


@pytest.mark.parametrize("k0", [1, 2, 5])
@pytest.mark.parametrize("n", [LANES, 3 * LANES])
def test_batched_plain_matches_pallas_kernel(k0, n):
    """Hazard c: the port's plain version is the Pallas kernel's form
    (h * (1/m), pi'/sigma), so it is held to the kernel, not to the jnp
    twin in repro/core/fedgia.py."""
    m = 6
    xbar, g, pi, h, sel = _inputs(k0 * 100 + n, (m, n))
    want = fedgia_update_batched_kernel(
        *map(jnp.asarray, (xbar, g, pi, h, sel)), jnp.float32(SIGMA), m,
        k0=k0, interpret=True)
    out = ops.fedgia_update_batched(*_torch(xbar, g, pi, h, sel),
                                    torch.tensor(SIGMA), m, k0=k0)
    _close(out, want, RTOL, ATOL, f"k0={k0} n={n}")


@pytest.mark.parametrize("k0", [1, 2, 5])
def test_batched_plain_matches_unrolled_oracles(k0):
    m, n = 5, 2 * LANES
    xbar, g, pi, h, sel = _inputs(k0, (m, n))
    jref = jax_update_ref(*map(jnp.asarray, (xbar, g, pi, h)),
                          jnp.asarray(sel)[:, None], jnp.float32(SIGMA), m,
                          k0=k0)
    tx = _torch(xbar, g, pi, h, sel)
    sigma = torch.tensor(SIGMA)
    tref = ref.fedgia_update_ref(*tx[:4], tx[4][:, None], sigma, m, k0=k0)
    _close(tref, jref, 1e-6, 1e-6, "unrolled port vs unrolled JAX")
    out = ops.fedgia_update_batched(*tx, sigma, m, k0=k0)
    _close(out, jref, 2e-5, 2e-5, "collapsed vs unrolled")


@pytest.mark.parametrize("k0", [1, 5])
@pytest.mark.parametrize("sel", [True, False])
def test_single_matches_pallas_single(k0, sel):
    n = 2 * LANES
    xbar, g, pi, h, _ = _inputs(7 + k0, (1, n))
    xbar, g, pi, h = (a[0] for a in (xbar, g, pi, h))
    want = jax_fedgia_update(*map(jnp.asarray, (xbar, g, pi, h)), sel,
                             jnp.float32(SIGMA), 8, k0=k0, interpret=True)
    out = ops.fedgia_update_single(*_torch(xbar, g, pi, h),
                                   torch.tensor(sel), torch.tensor(SIGMA), 8,
                                   k0=k0)
    _close(out, want, RTOL, ATOL, f"single k0={k0} sel={sel}")


@pytest.mark.parametrize("n", [2 * LANES + 1, 3 * LANES - 1, 1000])
def test_ragged_n_padding(n):
    """N % LANES != 0: the lane padding of both wrappers is invisible —
    the result equals JAX's padded kernel path, shapes included."""
    m = 4
    xbar, g, pi, h, sel = _inputs(n, (m, n))
    jargs = (*map(jnp.asarray, (xbar, g, pi, h, sel)), jnp.float32(SIGMA), m)
    want = jax_update_flat(*jargs, k0=4, use_kernel=True, interpret=True)
    tx = _torch(xbar, g, pi, h, sel)
    out = ops.fedgia_update_flat(*tx, torch.tensor(SIGMA), m, k0=4,
                                 donate=True)
    assert all(o.shape == (m, n) for o in out)
    _close(out, want, RTOL, ATOL, f"flat n={n}")
    # no aliasing happened on the padded path: the inputs are intact
    np.testing.assert_array_equal(tx[0].numpy(), xbar)
    np.testing.assert_array_equal(tx[2].numpy(), pi)
    want1 = jax_fedgia_update(*map(jnp.asarray, (xbar[0], g[0], pi[0], h[0])),
                              True, jnp.float32(SIGMA), m, k0=4,
                              interpret=True)
    out1 = ops.fedgia_update(*(t[0] for t in tx[:4]), True,
                             torch.tensor(SIGMA), m, k0=4)
    assert all(o.shape == (n,) for o in out1)
    _close(out1, want1, RTOL, ATOL, f"single n={n}")


def test_donated_plain_writes_into_its_inputs():
    """The CPU plain version of the donated wrapper really overwrites
    xbar (x'), pi (pi') and gbar (z'), as the kernel does on the card, so
    a caller that reads gbar after the update sees z' here too."""
    m, n = 6, 2 * LANES
    xbar, g, pi, h, sel = _inputs(3, (m, n))
    tx = _torch(xbar, g, pi, h, sel)
    sigma = torch.tensor(SIGMA)
    want = ops.fedgia_update_batched(*tx, sigma, m, k0=3)
    ptrs = [t.data_ptr() for t in (tx[0], tx[2], tx[1])]
    out = ops.fedgia_update_batched_donated(*tx, sigma, m, k0=3)
    assert [t.data_ptr() for t in out] == ptrs
    for a, b in zip(out, want):
        assert torch.equal(a, b)
    assert torch.equal(tx[1], want[2])  # gbar now holds z'
    np.testing.assert_array_equal(tx[3].numpy(), h)  # h is only read
    # through fedgia_update_flat(donate=True) the same buffers come back
    tx = _torch(xbar, g, pi, h, sel)
    out = ops.fedgia_update_flat(*tx, sigma, m, k0=3, donate=True)
    assert [t.data_ptr() for t in out] == [t.data_ptr() for t in
                                           (tx[0], tx[2], tx[1])]


def test_one_client_runs_the_single_launch_form():
    """One client takes the single-client form (its inputs read before
    the donated call overwrites them)."""
    n = LANES
    xbar, g, pi, h, _ = _inputs(11, (1, n))
    sigma = torch.tensor(SIGMA)
    for s in (True, False):
        sel = torch.tensor([s])
        want = ops.fedgia_update_single(*(t[0] for t in _torch(xbar, g, pi,
                                                                h)),
                                        sel[0], sigma, 1, k0=3)
        out = ops.fedgia_update_flat(*_torch(xbar, g, pi, h), sel, sigma, 1,
                                     k0=3, donate=True)
        for a, b in zip(out, want):
            assert a.shape == (1, n) and torch.equal(a[0], b)


@pytest.mark.parametrize("scalar_h", [False, True])
def test_one_client_donates_into_pi_and_gbar(scalar_h):
    """mb = 1 with donate=True: π' comes back in `pi` and z' in `gbar`
    (the same buffers), as the batched donated form writes them, with the
    undonated call's values bit for bit; the round's (N,) anchor is not
    written."""
    n = 2 * LANES
    xbar, g, pi, h, _ = _inputs(13, (1, n))
    sigma = torch.tensor(SIGMA)
    sel = torch.tensor([True])

    def args():
        tx, tg, tp, th = _torch(xbar[0], g, pi, h)
        return tx, tg, tp, (torch.tensor(1.3) if scalar_h else th)

    want = ops.fedgia_update_flat(*args(), sel, sigma, 1, k0=3,
                                  want_x=False)
    tx, tg, tp, th = args()
    out = ops.fedgia_update_flat(tx, tg, tp, th, sel, sigma, 1, k0=3,
                                 donate=True, want_x=False)
    assert out[0] is None
    assert out[1].data_ptr() == tp.data_ptr()
    assert out[2].data_ptr() == tg.data_ptr()
    assert torch.equal(out[1], want[1]) and torch.equal(out[2], want[2])
    np.testing.assert_array_equal(tx.numpy(), xbar[0])  # the anchor


def test_cpu_plain_versions_count_no_launches():
    ops.reset_launches()
    xbar, g, pi, h, sel = _inputs(5, (4, LANES))
    tx = _torch(xbar, g, pi, h, sel)
    ops.fedgia_update_flat(*tx, torch.tensor(SIGMA), 4, k0=2)
    ops.fedgia_update_flat(*tx, torch.tensor(SIGMA), 4, k0=2, donate=True)
    assert all(v == 0 for v in ops.launches.values())


@pytest.mark.parametrize("wrapper", ["fedgia_update_batched",
                                     "fedgia_update_batched_donated",
                                     "fedgia_update_single"])
def test_non_cpu_tensor_never_falls_back(wrapper):
    """Only a CPU tensor gets the plain version: any other device goes to
    the kernel path, which raises unless the tensors are on a CUDA
    device — nothing quietly runs the plain version instead."""
    shape = (LANES,) if wrapper.endswith("single") else (4, LANES)
    t = torch.empty(shape, device="meta")
    sel = torch.ones(shape[:-1] or (), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        getattr(ops, wrapper)(t, t, t, t, sel, torch.tensor(SIGMA), 4, k0=2)
    assert all(v == 0 for v in ops.launches.values())


def test_kernel_module_imports_and_build_needs_nvcc(monkeypatch, tmp_path):
    """The CUDA kernel's modules import without nvcc (the build happens at
    first launch), and the build raises when nvcc is missing."""
    import importlib

    for mod in ("repro_torch.kernels._build",
                "repro_torch.kernels.fedgia_update.ops"):
        importlib.import_module(mod)
    assert _build.SOURCES["fedgia_update"].is_file()
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()


@pytest.mark.parametrize("k", range(0, 10))
def test_int_pow_order_matches_lax_integer_pow(k):
    """Hazard b: a**(k0-1). The port's square-and-multiply order is JAX's
    `lax.integer_pow` order, so the two agree bitwise on the CPU."""
    a = np.random.default_rng(k).uniform(-1.0, 1.0, 4096).astype(np.float32)
    want = np.asarray(jax.jit(lambda v: jax.lax.integer_pow(v, k))(a))
    got = ref.int_pow(torch.from_numpy(a), k).numpy()
    np.testing.assert_array_equal(got, want)


# ------------------------------------------- the round's operand forms
def _round_forms(seed, m, n, scalar_h):
    """Inputs in the forms round_flat passes: one (N,) anchor for every
    row, and h the 0-d r (scalar H) or an (m, N) buffer (diag_ema)."""
    xbar, g, pi, h, sel = _inputs(seed, (m, n))
    h = np.float32(1.7) if scalar_h else h
    return [torch.from_numpy(np.array(a)) for a in (xbar[0], g, pi, h, sel)]


def _full(t, shape):
    return t.expand(shape).contiguous()


@pytest.mark.parametrize("want_x", [True, False])
@pytest.mark.parametrize("donate", [False, True])
@pytest.mark.parametrize("scalar_h", [False, True])
@pytest.mark.parametrize("n", [2 * LANES, 2 * LANES + 5])
def test_round_forms_equal_materialised_forms_bitwise(n, scalar_h, donate,
                                                      want_x):
    """The (N,) anchor, the 0-d h and want_x=False give the values of the
    materialised (m, N) operands bit for bit (CPU plain version); donated,
    π' and z' land in π and ḡ, and the anchor is never written."""
    m = 6
    anchor, g, pi, h, sel = _round_forms(n + scalar_h, m, n, scalar_h)
    sigma = torch.tensor(SIGMA)
    want = ops.fedgia_update_flat(_full(anchor, (m, n)), g.clone(),
                                  pi.clone(), _full(h, (m, n)), sel, sigma,
                                  m, k0=3)
    a0 = anchor.clone()
    gb, pb = g.clone(), pi.clone()
    x, p, z = ops.fedgia_update_flat(anchor, gb, pb, h, sel, sigma, m, k0=3,
                                     donate=donate, want_x=want_x)
    if want_x:
        assert torch.equal(x, want[0]) and x.shape == (m, n)
    else:
        assert x is None
    assert torch.equal(p, want[1]) and torch.equal(z, want[2])
    assert torch.equal(anchor, a0)
    if donate and n % LANES == 0:
        assert p.data_ptr() == pb.data_ptr() and z.data_ptr() == gb.data_ptr()
    else:
        assert torch.equal(pb, pi) and torch.equal(gb, g)


@pytest.mark.parametrize("k0", [1, 5])
@pytest.mark.parametrize("scalar_h", [False, True])
def test_round_forms_match_pallas_kernel(k0, scalar_h):
    """The round's forms against the Pallas kernel in interpret mode on
    the materialised operands, at the file's kernel tolerances."""
    m, n = 6, 2 * LANES
    anchor, g, pi, h, sel = _round_forms(k0, m, n, scalar_h)
    jargs = [jnp.asarray(_full(t, (m, n)).numpy()) for t in (anchor, g, pi, h)]
    want = fedgia_update_batched_kernel(*jargs, jnp.asarray(sel.numpy()),
                                        jnp.float32(SIGMA), m, k0=k0,
                                        interpret=True)
    x, p, z = ops.fedgia_update_flat(anchor, g, pi, h, sel,
                                     torch.tensor(SIGMA), m, k0=k0,
                                     want_x=False)
    assert x is None
    _close((p, z), want[1:], RTOL, ATOL, f"round forms k0={k0}")


def test_single_takes_a_scalar_h():
    """The one-client launch reads a 0-d h as the (N,) one."""
    n = 2 * LANES
    xbar, g, pi, _, _ = _inputs(13, (1, n))
    tx = _torch(xbar[0], g[0], pi[0])
    sigma = torch.tensor(SIGMA)
    r = torch.tensor(np.float32(0.9))
    for s in (True, False):
        got = ops.fedgia_update_single(*tx, r, torch.tensor(s), sigma, 4,
                                       k0=3)
        want = ops.fedgia_update_single(*tx, _full(r, (n,)), torch.tensor(s),
                                        sigma, 4, k0=3)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("wrapper", ["fedgia_update_flat",
                                     "fedgia_update_batched"])
@pytest.mark.parametrize("bad", ["anchor (N+1,)", "anchor (1, N)",
                                 "anchor (m, N, 1)", "h (N,)", "h (1, N)",
                                 "h (m, 2N)", "h (1,)"])
def test_wrappers_raise_on_a_wrongly_shaped_anchor_or_h(device, wrapper,
                                                        bad):
    """A shape the kernel does not take raises on any device, before the
    device is looked at (meta tensors reach the kernel path's checks), so
    nothing broadcasts it quietly."""
    m, n = 4, LANES
    shapes = {"anchor (N+1,)": (n + 1,), "anchor (1, N)": (1, n),
              "anchor (m, N, 1)": (m, n, 1), "h (N,)": (n,),
              "h (1, N)": (1, n), "h (m, 2N)": (m, 2 * n), "h (1,)": (1,)}
    what = bad.split()[0]
    t = lambda shape: torch.zeros(shape, device=device)  # noqa: E731
    anchor = t(shapes[bad] if what == "anchor" else (n,))
    h = t(shapes[bad] if what == "h" else ())
    sel = torch.ones(m, dtype=torch.bool, device=device)
    with pytest.raises(ValueError, match="anchor" if what == "anchor"
                       else "h must"):
        getattr(ops, wrapper)(anchor, t((m, n)), t((m, n)), h, sel,
                              torch.tensor(SIGMA), m, k0=2)
    assert all(v == 0 for v in ops.launches.values())


def test_kernel_path_refuses_a_non_bool_sel():
    """The kernel reads sel as the bool tensor it is (one byte a row, no
    cast kernel): another dtype is refused before anything launches."""
    m, n = 4, LANES
    t = torch.zeros((m, n), device="meta")
    sel = torch.ones(m, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="sel must be"):
        ops.fedgia_update_batched(t, t, t, t, sel, torch.tensor(SIGMA), m,
                                  k0=2)
    assert all(v == 0 for v in ops.launches.values())
