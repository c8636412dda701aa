"""Shared machinery of the port's multi-rank tests
(tests/test_torch_sharded_*.py, tests/test_torch_overlap.py).

Each test file runs the reference's sharded configurations ONCE, in a
subprocess on 8 fake CPU devices (`conftest.fake_device_env`), and the
port's in another subprocess that launches its gloo ranks
(`repro_torch.launch.mesh.launch`); a module fixture starts both
together and loads what each saved (an npz of named arrays). The pytest
process never initialises a process group.

A script is a body (its configurations) between a prelude and an
epilogue. The JAX body calls ``put(prefix, result)``; the port body
defines ``rank_fn(OUT)``, which every rank runs and which fills OUT
(rank 0's is saved), with ``put`` and ``same_on_every_rank`` (the
bitwise check of a replicated tensor across all ranks).
"""
from __future__ import annotations

import os
import subprocess
import sys
import textwrap

import numpy as np

from conftest import SRC, fake_device_env

JAX_PRELUDE = textwrap.dedent('''
    import sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.config import FedConfig
    from repro.core import api, engine, make_algorithm, make_policy, run_rounds
    from repro.data import linreg_noniid
    from repro.launch.mesh import make_host_mesh
    from repro.models import LeastSquares
    from repro.utils import pytree as pt

    OUT = {}

    def put(prefix, res):
        for k, v in res.history.items():
            OUT[prefix + "/hist/" + k] = np.asarray(v)
        for k, v in res.state.items():
            if isinstance(v, dict):
                for kk, vv in v.items():
                    OUT[prefix + "/state/" + k + "/" + kk] = np.asarray(vv)

    def setup(name, m=8, n=24, d=320, **kw):
        batch = {k: jnp.asarray(v)
                 for k, v in linreg_noniid(0, d, n, m).items()}
        model = LeastSquares(n)
        fed = FedConfig(algorithm=name, num_clients=m, **kw)
        algo = make_algorithm(fed, model.loss, model=model)
        s0 = algo.init(model.init(jax.random.PRNGKey(0)),
                       jax.random.PRNGKey(1), init_batch=batch)
        return algo, s0, batch
''')

JAX_EPILOGUE = "\nnp.savez(sys.argv[1], **OUT)\n"

PORT_PRELUDE = textwrap.dedent('''
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.config import FedConfig
    from repro_torch.core import api
    from repro_torch.core.api import make_algorithm
    from repro_torch.core.clock import ComputeClock
    from repro_torch.core.engine import (
        flatten_state, make_round_fn, run_rounds, shard_inputs)
    from repro_torch.core.prng import prng_key
    from repro_torch.core.selection import (
        AvailabilityParticipation, UniformParticipation, make_policy)
    from repro_torch.data import linreg_noniid, to_torch
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import LeastSquares
    from repro_torch.utils import pytree as pt

    KINDS = ("all_reduce", "all_reduce_model", "reduce_scatter",
             "reduce_scatter_model", "all_gather", "all_gather_model")

    def put(out, prefix, res):
        for k, v in res.history.items():
            out[prefix + "/hist/" + k] = np.asarray(v)
        for k, v in res.state.items():
            if isinstance(v, dict):
                for kk, vv in v.items():
                    out[prefix + "/state/" + k + "/" + kk] = vv.numpy()

    def setup(name, m=8, n=24, d=320, **kw):
        batch = to_torch(linreg_noniid(0, d, n, m), "cpu")
        model = LeastSquares(n)
        fed = FedConfig(algorithm=name, num_clients=m, **kw)
        algo = make_algorithm(fed, model.loss, model=model)
        s0 = algo.init(model.init("cpu"), prng_key(1), init_batch=batch)
        return algo, s0, batch

    def same_on_every_rank(t):
        """Whether `t` has the same bits on every rank (all ranks call)."""
        t = t.contiguous()
        outs = [torch.empty_like(t) for _ in range(dist.get_world_size())]
        dist.all_gather(outs, t)
        return all(torch.equal(outs[0], o) for o in outs)

    def replicated(out, prefix, res):
        """Record whether x (and a run's history) is bitwise the same on
        every rank."""
        ok = all(same_on_every_rank(v) for v in res.state["x"].values())
        for k, v in res.history.items():
            ok = same_on_every_rank(torch.as_tensor(np.asarray(v))) and ok
        out[prefix + "/replicated"] = np.array(ok)

    def budget(fn, n_model):
        return np.array([mesh_mod.profile_collectives(fn, n_model)[1][k]
                         for k in KINDS])
''')

PORT_EPILOGUE = textwrap.dedent('''

    def _main(world):
        OUT = {}
        rank_fn(OUT)
        return OUT

    if __name__ == "__main__":
        out = mesh_mod.launch(_main, int(sys.argv[2]), int(sys.argv[2]))
        np.savez(sys.argv[1], **out)
''')

KINDS = ("all_reduce", "all_reduce_model", "reduce_scatter",
         "reduce_scatter_model", "all_gather", "all_gather_model")


def counts(arr) -> dict:
    """A saved collective budget as {kind: count}."""
    return dict(zip(KINDS, (int(v) for v in arr)))


def _env(extra=None):
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.path.dirname(os.path.abspath(__file__)))
    env.update(extra or {})
    return env


def run_both(tmp_dir, jax_body: str, port_body: str, world: int,
             timeout: float = 600):
    """Write the JAX script (8 fake devices) and the port's (`world` gloo
    ranks), run them side by side and return (jax arrays, port arrays),
    each a dict of the npz it saved. Raises with a script's output when
    it fails."""
    jobs = []
    for name, body, env, args in (
            ("jax", JAX_PRELUDE + textwrap.dedent(jax_body) + JAX_EPILOGUE,
             fake_device_env(8), ()),
            ("port", PORT_PRELUDE + textwrap.dedent(port_body)
             + PORT_EPILOGUE, _env({"JAX_PLATFORMS": "cpu"}),
             (str(world),))):
        script = os.path.join(tmp_dir, f"{name}_runs.py")
        out = os.path.join(tmp_dir, f"{name}.npz")
        with open(script, "w") as f:
            f.write(body)
        proc = subprocess.Popen([sys.executable, script, out, *args],
                                env=env, cwd=tmp_dir,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, proc, out))
    results = {}
    for name, proc, out in jobs:
        try:
            log, _ = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for _, p, _ in jobs:
                p.kill()
            raise
        assert proc.returncode == 0, f"{name} runs failed:\n{log[-8000:]}"
        with np.load(out) as z:
            results[name] = {k: z[k] for k in z.files}
    return results["jax"], results["port"]


def assert_run_close(port: dict, ref: dict, prefix: str, rtol: float,
                     atol: float, state_keys=None):
    """The port's run `prefix` against the reference's: every history key
    of the reference, and the state entries (`state_keys`, default all
    the reference saved), at rtol/atol."""
    hist = [k for k in ref if k.startswith(prefix + "/hist/")]
    state = [k for k in ref if k.startswith(prefix + "/state/")]
    assert hist, f"no reference run {prefix!r}"
    for k in hist:
        np.testing.assert_allclose(port[k], ref[k], rtol=rtol, atol=atol,
                                   err_msg=k)
    for k in state:
        if state_keys is not None and k.split("/")[2] not in state_keys:
            continue
        np.testing.assert_allclose(port[k], ref[k], rtol=rtol, atol=atol,
                                   err_msg=k)
