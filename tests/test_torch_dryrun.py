"""The port's planning dry run (`repro_torch/launch/dryrun.py`) against
the JAX package's (`repro/launch/dryrun.py`).

The reference side runs as its own tests run it: `input_specs` in this
process, and its builders compiled on a (data 4, model 2) mesh of 8 fake
CPU devices in a subprocess (`torch_sharded.run_both`), whose
`compiled.memory_analysis().argument_size_in_bytes` the port's record
is held to. Beside it, 4 gloo ranks run the port's real sharded round,
whose collectives `launch/mesh.py::profile_collectives` counts. The
port's dry runs trace in this process on fake tensors, under a fake
process group that they destroy.

Tolerances:

* `input_specs`: shapes and dtypes equal.
* argument bytes: equal, byte for byte, once the leaves that only one
  side holds are added to the other; each is named below with its bytes.
  JAX's jit drops the arguments a step does not read (`keep_unused=False`),
  so the reference's compiled size leaves out FedGiA's x (its round
  recomputes x̄ from z) and a decode cache's `pos` (int32, one a layer);
  the port keeps `round` (int32) and `rng` (uint32[2]) on the host
  (`core/fedgia.py`), which the reference's arguments hold. XLA pads
  none of these arguments on the CPU.
* traced FLOPs of a reduced dense prefill and train round: equal to the
  products' count from the config (`_product_flops`), exactly, and so
  0.858 (prefill) and 0.928 (train) of the reference's MODEL_FLOPS (2
  N_active tokens, 6 for a round). The traced count adds the quadratic
  attention, which the plain attention computes unmasked; it lacks the
  embedding's share of N (a gather, no FLOPs) and, in prefill, the
  lm_head's product for every position but the last (the port's prefill
  takes only the last through the head).
* traced FLOPs against the reference's `extrapolated_costs` (XLA's
  `compiled.cost_analysis()["flops"]`, scan-corrected) of the same
  reduced case on the same mesh: within [0.80, 0.90] of it at model 1
  and at model 2 (XLA also counts every elementwise op: norms, softmax,
  activations, the update; FlopCounterMode counts the products), and the
  model-2 ratio within 5 % of the model-1 ratio, which holds the modelled
  model axis to XLA's own SPMD partition of the step (measured 0.973 for
  the train round, 0.994 prefill, 0.982 the MoE decode: XLA keeps some
  elementwise work, such as the norms of the replicated residual, whole
  on each device).
* the client axis's collectives at model 1: equal counts by kind.
"""
import concurrent.futures
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from conftest import SRC
from torch_sharded import counts, run_both

from repro_torch.config import INPUT_SHAPES, ShapeConfig
from repro_torch.configs import get_config, list_architectures
from repro_torch.launch import dryrun as dr
from repro_torch.launch.mesh import AbstractMesh

MESH = AbstractMesh(("data", "model"), (4, 2))
SHAPES = {"train": ShapeConfig("train_small", 32, 8, "train"),
          "prefill": ShapeConfig("prefill_small", 64, 8, "prefill"),
          "decode": ShapeConfig("decode_small", 64, 8, "decode"),
          "long": ShapeConfig("long_500k", 256, 1, "decode")}
CASES = ("tinyllama-1.1b:train", "tinyllama-1.1b:prefill",
         "tinyllama-1.1b:decode", "tinyllama-1.1b:long", "rwkv6-3b:train",
         "hymba-1.5b:long", "deepseek-v3-671b:decode")
# cases whose FLOPs are held to the reference's at model 1 and 2
FLOP_CASES = ("tinyllama-1.1b:train", "tinyllama-1.1b:prefill",
              "deepseek-v3-671b:decode")
SHAPES_SRC = ('{"train": ShapeConfig("train_small", 32, 8, "train"), '
              '"prefill": ShapeConfig("prefill_small", 64, 8, "prefill"), '
              '"decode": ShapeConfig("decode_small", 64, 8, "decode"), '
              '"long": ShapeConfig("long_500k", 256, 1, "decode")}')

JAX_BODY = f'''
from repro.config import ShapeConfig
from repro.configs import get_config
from repro.launch import dryrun as jdr
mesh = make_host_mesh(model=2, data=4)
SHAPES = {SHAPES_SRC}
for case in {CASES!r}:
    arch, kind = case.split(":")
    cfg, shape = get_config(arch).reduced(), SHAPES[kind]
    fed = FedConfig(algorithm="fedgia", num_clients=4, k0=5, alpha=0.5,
                    collapsed=True, h_policy="scalar", client_axes=("data",),
                    state_dtype="bfloat16")
    with jax.set_mesh(mesh):
        if shape.kind == "train":
            fn, args = jdr.build_train(cfg, shape, fed, mesh)
        elif shape.kind == "prefill":
            fn, args = jdr.build_prefill(cfg, shape, mesh)
        else:
            fn, args = jdr.build_decode(cfg, shape, mesh)
        ma = fn.lower(*args).compile().memory_analysis()
    OUT["args/" + case] = np.array(ma.argument_size_in_bytes)
for model in (1, 2):
    fmesh = make_host_mesh(model=model, data=4)
    for case in {FLOP_CASES!r}:
        arch, kind = case.split(":")
        cfg, shape = get_config(arch).reduced(), SHAPES[kind]
        fed = FedConfig(algorithm="fedgia", num_clients=4, k0=5, alpha=0.5,
                        collapsed=True, h_policy="scalar",
                        client_axes=("data",), state_dtype="bfloat16")
        cost = jdr.extrapolated_costs(cfg, shape, fed, fmesh, "fedgia", 4)
        OUT[f"flops/{{case}}@{{model}}"] = np.array(cost["flops"])
'''

PORT_BODY = '''
from repro_torch.configs import get_config
from repro_torch.models.transformer import Transformer


def rank_fn(OUT):
    cfg = get_config("tinyllama-1.1b").reduced()
    model = Transformer(cfg, "cpu").init(prng_key(0))
    fed = FedConfig(algorithm="fedgia", num_clients=4, k0=5, alpha=0.5,
                    h_policy="scalar", client_axes=("data",),
                    state_dtype="bfloat16")
    algo = make_algorithm(fed, model.loss, model=model)
    state = algo.init(model.params, prng_key(1))
    gen = torch.Generator().manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 2, 33),
                                     generator=gen)}
    mesh = mesh_mod.make_host_mesh(data=4)
    st, b = shard_inputs(algo, state, batch, mesh, "data")
    spec = pt.ravel_spec(st["x"])
    st = flatten_state(algo, st, spec)
    axis = mesh.client_axis("data")

    def one_round():
        with api.client_sharding(axis):
            return algo.round_flat(st, b, spec, donate_kernel=True)

    OUT["budget"] = budget(one_round, spec.size)
'''


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """The reference's compiled argument sizes and the gloo ranks'
    collective budget (subprocesses), and the port's records of the same
    cases on the same mesh (this process)."""
    tmp = str(tmp_path_factory.mktemp("dryrun"))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        subs = pool.submit(run_both, tmp, JAX_BODY, PORT_BODY, 4)
        port = {c: dr.dryrun_one(get_config(c.split(":")[0]).reduced(),
                                 SHAPES[c.split(":")[1]], mesh=MESH,
                                 verbose=False) for c in CASES}
        ref, gloo = subs.result()
    return ref, gloo, port


def _jax_dryrun():
    """The reference's dry-run module, imported without keeping the
    512-device XLA_FLAGS it sets at import (a later subprocess of this
    worker would inherit them)."""
    saved = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as jdr
    if saved is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = saved
    return jdr


@pytest.mark.parametrize("arch", list_architectures())
def test_input_specs_match_the_reference(arch):
    import jax
    from repro.config import INPUT_SHAPES as JSHAPES
    from repro.configs import get_config as jget

    jdr = _jax_dryrun()
    for name, shape in INPUT_SHAPES.items():
        port = dr.input_specs(get_config(arch), shape, num_clients=16)
        ref = jdr.input_specs(jget(arch), JSHAPES[name], num_clients=16)
        assert set(port) == set(ref)
        for k, s in ref.items():
            assert isinstance(s, jax.ShapeDtypeStruct)
            assert port[k].shape == tuple(s.shape), (arch, name, k)
            assert str(port[k].dtype) == f"torch.{s.dtype}", (arch, name, k)


def _param_bytes(cfg, keep, dtype=None):
    """Per-device bytes of the training tree's leaves `keep(key)` under
    the sanitized param specs on MESH (in `dtype` where given)."""
    from repro_torch.sharding import specs as sp
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        params = dr.fake_params(cfg)
    specs = sp.sanitize_specs(sp.param_specs(cfg, params), params, MESH)
    return sum(dr._shard_bytes(dr.Shaped(tuple(v.shape), dtype or v.dtype),
                               specs[k], MESH)
               for k, v in params.items() if keep(k))


def _only_one_side(case):
    """(bytes only the port's arguments hold, bytes only the
    reference's hold) of a case, the leaves named."""
    arch, kind = case.split(":")
    cfg = get_config(arch).reduced()
    if kind == "train":
        # x: FedGiA's server copy, which the round does not read (JAX
        # drops it; bf16 as the state, laid out as the parameters, which
        # the state specs give it); round (int32) and rng (uint32[2]):
        # the port keeps them on the host
        x = _param_bytes(cfg, lambda k: True, torch.bfloat16)
        return x, 4 + 8
    only_port = 0
    if kind in ("decode", "long") and cfg.attention_type != "rwkv":
        # the cache's pos (int32, one a layer), which decode does not read
        only_port += 4 * cfg.num_layers
    if cfg.mtp:  # the MTP head's leaves, which serving does not read
        only_port += _param_bytes(cfg, lambda k: k.startswith("mtp/"))
    return only_port, 0


@pytest.mark.parametrize("case", CASES)
def test_argument_bytes_equal_the_reference_compiled_size(both, case):
    ref, _, port = both
    only_port, only_ref = _only_one_side(case)
    got = port[case]["per_device"]["argument_bytes"]
    assert got - only_port == int(ref["args/" + case]) - only_ref, (
        got, only_port, int(ref["args/" + case]), only_ref)


def test_client_axis_collectives_equal_the_gloo_round(both):
    _, gloo, port = both
    rec = port["tinyllama-1.1b:train"]
    assert rec["model_axis"] == "modelled"
    # the same round at model 1: nothing modelled, the client axis only
    one = dr.dryrun_one(get_config("tinyllama-1.1b").reduced(),
                        SHAPES["train"],
                        mesh=AbstractMesh(("data", "model"), (4, 1)),
                        verbose=False)
    assert one["model_axis"] == "none"
    got = one["collectives"]["counts"]
    want = counts(gloo["budget"])
    assert got["all-reduce"] == want["all_reduce"]
    assert got["reduce-scatter"] == want["reduce_scatter"]
    assert got["all-gather"] == want["all_gather"]
    assert got["all-to-all"] == got["collective-permute"] == 0
    assert sum(got.values()) > 0
    assert set(one["collectives"]["wire_by_axis"]) == {"data"}


def test_model_axis_adds_its_collectives_and_divides_the_work(both):
    _, _, port = both
    rec = port["tinyllama-1.1b:prefill"]
    one = dr.dryrun_one(get_config("tinyllama-1.1b").reduced(),
                        SHAPES["prefill"],
                        mesh=AbstractMesh(("data", "model"), (4, 1)),
                        verbose=False)
    # every product of the reduced dense model takes a model-sharded weight
    # or a sharded activation: the FLOPs halve at model 2
    assert rec["per_device"]["flops"] == pytest.approx(
        one["per_device"]["flops"] / 2, rel=0.02)
    # wo and w2 contract their sharded dim: two all-reduces a layer
    assert rec["collectives"]["counts"]["all-reduce"] == 2 * 2
    assert one["collectives"]["total"] == 0
    moe = port["deepseek-v3-671b:decode"]
    # its 4 experts split over model 2: the one MoE layer's dispatch and
    # combine
    assert moe["collectives"]["counts"]["all-to-all"] == 2


def _product_flops(cfg, kind, B, S):
    """The products of a dense GQA model's step on B sequences of S
    tokens, counted from the config: each weight 2 FLOPs a token, QK^T
    and PV over every key (the plain attention masks, it skips nothing),
    the lm_head on the last position in prefill and on every one in a
    round, whose backward doubles each product."""
    d, H, Kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    weights = cfg.num_layers * (2 * d * H * hd + 2 * d * Kv * hd
                                + 3 * d * cfg.d_ff)
    attention = cfg.num_layers * 4 * B * H * S * S * hd
    head = 2 * d * cfg.vocab_size
    if kind == "prefill":
        return 2 * B * S * weights + attention + B * head
    return 3 * (2 * B * S * weights + attention + B * S * head)


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_traced_flops_lie_in_a_band_of_model_flops(kind):
    cfg = get_config("tinyllama-1.1b").reduced()
    shape = SHAPES[kind]
    mesh = AbstractMesh(("data", "model"), (1, 1))
    rec = dr.dryrun_one(cfg, shape, mesh=mesh, num_clients=4, verbose=False)
    flops = rec["per_device"]["flops"]
    # the device holds every client: the whole global batch
    assert flops == _product_flops(cfg, kind, shape.global_batch,
                                   shape.seq_len)
    tokens = shape.global_batch * shape.seq_len
    model = (6.0 if kind == "train" else 2.0) * cfg.active_param_count() \
        * tokens
    want = {"prefill": 0.858, "train": 0.928}[kind]
    assert flops / model == pytest.approx(want, abs=5e-4)


def test_flops_track_the_reference_compiled_count(both):
    ref, _, port = both
    for case in FLOP_CASES:
        arch, kind = case.split(":")
        one = dr.dryrun_one(get_config(arch).reduced(), SHAPES[kind],
                            mesh=AbstractMesh(("data", "model"), (4, 1)),
                            verbose=False)
        r1 = one["per_device"]["flops"] / float(ref[f"flops/{case}@1"])
        r2 = (port[case]["per_device"]["flops"]
              / float(ref[f"flops/{case}@2"]))
        assert 0.80 <= r1 <= 0.90 and 0.80 <= r2 <= 0.90, (case, r1, r2)
        assert 0.95 <= r2 / r1 <= 1.0, (case, r1, r2)


def test_recurrences_are_added_analytically():
    cfg = get_config("rwkv6-3b").reduced()
    mesh = AbstractMesh(("data", "model"), (1, 1))
    short = dr.dryrun_one(cfg, ShapeConfig("p", dr.T_PROBE, 2, "prefill"),
                          mesh=mesh, verbose=False)
    long = dr.dryrun_one(cfg, ShapeConfig("p", 4 * dr.T_PROBE, 2, "prefill"),
                         mesh=mesh, verbose=False)
    assert short["recurrence"] == "traced"
    assert long["recurrence"] == "analytic"
    corr = dr._recurrence_correction(
        cfg, ShapeConfig("p", 4 * dr.T_PROBE, 2, "prefill"), 2)
    assert corr["flops"] == (cfg.num_layers * 3 * dr.T_PROBE * 10.0 * 2
                             * cfg.num_heads * cfg.rwkv_head_size ** 2)
    assert long["per_device"]["flops"] > short["per_device"]["flops"]


def test_cli_writes_a_record_with_the_reference_keys(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "tinyllama-1.1b", "--shape", "decode_32k", "--no-costs", "--out",
         str(tmp_path)],
        env=dict(os.environ, PYTHONPATH=SRC), capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "all 1 dry runs traced OK" in out.stdout
    rec = json.loads(
        (tmp_path / "tinyllama-1.1b_decode_32k_1pod_fedgia.json").read_text())
    ref_keys = {"arch", "shape", "mesh", "algo", "collapsed", "client_axes",
                "fsdp", "replicate_params", "num_clients", "t_lower_s",
                "t_compile_s", "per_device", "collectives", "roofline"}
    assert set(rec) == (ref_keys - {"t_lower_s", "t_compile_s"}) | {
        "t_trace_s", "model_axis", "recurrence"}
    assert set(rec["per_device"]) == {"argument_bytes", "output_bytes",
                                      "temp_bytes", "flops", "hbm_bytes"}
    assert set(rec["roofline"]) == {"t_compute_s", "t_memory_s",
                                    "t_collective_s", "bottleneck"}
    assert rec["mesh"] == "16x16" and rec["model_axis"] == "modelled"


def test_a_full_width_dry_run_allocates_no_model_memory():
    """deepseek-v3-671b decode at full width on the 2x16x16 mesh: its
    arguments are hundreds of GB a card's worth of the model; the
    process's peak resident set stays a small fraction of them."""
    code = textwrap.dedent('''
        import json, resource
        from repro_torch.launch import dryrun as dr
        rec = dr.dryrun_one("deepseek-v3-671b", "decode_32k", multi_pod=True,
                            with_costs=False, verbose=False)
        print(json.dumps({"args": rec["per_device"]["argument_bytes"],
              "rss": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss}))
    ''')
    out = subprocess.run([sys.executable, "-c", code],
                         env=dict(os.environ, PYTHONPATH=SRC),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["args"] > 40 * 2**30
    assert got["rss"] * 1024 < 3 * 2**30  # ru_maxrss is in KiB on Linux


def test_fake_process_group_refuses_a_live_group_and_leaves_none():
    import torch.distributed as dist
    from repro_torch.launch.mesh import fake_process_group

    with fake_process_group(MESH) as m:
        assert dist.get_world_size() == 8 and m.rank == 0
        axis = m.client_axis("data")
        assert (axis.shards, axis.index) == (4, 0)
        with pytest.raises(RuntimeError, match="already"):
            with fake_process_group(MESH):
                pass
    assert not dist.is_initialized()


@pytest.mark.parametrize("variant", ["fedavg", "scaffold", "unrolled",
                                     "replicate", "fsdp", "fp8_cache"])
def test_every_cli_variant_traces(variant):
    """The CLI's --algo, --unrolled, --replicate-params, --fsdp (with
    --client-axes pod) and --cache-dtype variants trace at the reduced
    size; --replicate-params splits each client's batch over `model`
    (data parallelism), so its FLOPs are the tensor-parallel record's."""
    cfg = get_config("tinyllama-1.1b").reduced()
    kw, mesh, shape = {}, MESH, SHAPES["train"]
    if variant in ("fedavg", "scaffold"):
        kw["algo"] = variant
    elif variant == "unrolled":
        kw["collapsed"] = False
    elif variant == "replicate":
        kw["replicate_params"] = True
    elif variant == "fsdp":
        mesh = AbstractMesh(("pod", "data", "model"), (2, 2, 2))
        kw.update(client_axes=("pod",), fsdp=True)
    else:
        kw["cache_dtype"] = "float8_e4m3fn"
        shape = SHAPES["decode"]
    rec = dr.dryrun_one(cfg, shape, mesh=mesh, verbose=False, **kw)
    pd = rec["per_device"]
    assert pd["flops"] > 0 and pd["argument_bytes"] > 0
    if variant == "replicate":
        tp = dr.dryrun_one(cfg, shape, mesh=mesh, verbose=False)
        assert pd["flops"] == pytest.approx(tp["per_device"]["flops"],
                                            rel=0.1)
    if variant == "fsdp":
        # the client axis is pod; the batch splits over data, whose
        # gradients are summed once
        assert set(rec["collectives"]["wire_by_axis"]) == {
            "pod", "data", "model"}
    if variant == "fp8_cache":
        bf16 = dr.dryrun_one(cfg, shape, mesh=mesh, verbose=False)
        assert pd["argument_bytes"] < bf16["per_device"]["argument_bytes"]
