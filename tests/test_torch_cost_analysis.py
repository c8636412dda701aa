"""The port's roofline terms (`repro_torch/launch/cost_analysis.py`)
against the JAX package's (`repro/launch/hlo_analysis.py`): the
reference's test HLO (tests/test_system.py::test_hlo_collective_parser),
written as the collective records that the port's dry run hands over,
gives the reference's bytes by kind and wire bytes exactly; the terms
carry the reference's keys, at the H100's datasheet rates.

Tolerance: exact for bytes and counts; the roofline times at rel 1e-12
(one float division each).
"""
import pytest
import torch

from repro.launch import hlo_analysis as jha
from repro_torch.launch import cost_analysis as ca
from repro_torch.launch.mesh import AbstractMesh, make_production_mesh

HLO = """
  %all-reduce.1 = f32[8,4096]{1,0} all-reduce(f32[8,4096]{1,0} %x), replica_groups={}
  %ag = bf16[16,128]{1,0} all-gather(bf16[8,128]{1,0} %y), dimensions={0}
  %arstart = f32[100]{0} all-reduce-start(f32[100]{0} %z)
  %ardone = f32[100]{0} all-reduce-done(f32[100]{0} %arstart)
  %add.5 = f32[4]{0} add(f32[4]{0} %a, f32[4]{0} %b)
"""
RECORDS = [("all-reduce", torch.float32, (8, 4096)),
           ("all-gather", torch.bfloat16, (16, 128)),
           ("all-reduce-start", torch.float32, (100,)),
           ("all-reduce-done", torch.float32, (100,))]


def test_collective_bytes_equal_the_reference_parser():
    got, want = ca.collective_bytes(RECORDS), jha.collective_bytes(HLO)
    for k in list(ca.COLLECTIVES) + ["total", "wire_bytes"]:
        assert got[k] == want[k], k
    assert got["all-reduce"] == 8 * 4096 * 4 + 400  # start counted once
    assert got["all-gather"] == 16 * 128 * 2
    assert got["wire_bytes"] == 2 * got["all-reduce"] + got["all-gather"]


def test_roofline_terms_keep_the_reference_keys():
    cost = {"flops": 1e12, "bytes accessed": 1e9}
    got = ca.roofline_terms(cost, ca.collective_bytes(RECORDS))
    want = jha.roofline_terms(cost, jha.collective_bytes(HLO))
    assert set(got) == set(want)
    assert got["t_compute_s"] == pytest.approx(1e12 / 989e12, rel=1e-12)
    assert got["t_memory_s"] == pytest.approx(1e9 / 3.35e12, rel=1e-12)
    # records without an axis go at the NIC rate
    assert got["t_collective_s"] == pytest.approx(
        want["wire_bytes"] / 50e9, rel=1e-12)
    assert got["bottleneck"] == "compute"  # 1.01 ms against 0.30 ms
    assert (got["hlo_flops"], got["hlo_bytes"]) == (1e12, 1e9)
    assert got["collective_bytes"] == want["collective_bytes"]


def test_each_axis_goes_at_its_own_rate():
    recs = [("all-reduce", torch.bfloat16, (1000,), "model"),
            ("reduce-scatter", torch.float32, (10,), ("pod", "data"))]
    coll = ca.collective_bytes(recs)
    assert coll["wire_by_axis"] == {"model": 4000.0, "pod,data": 40.0}
    small = AbstractMesh(("data", "model"), (4, 2))
    bw = ca.axis_bandwidth(small)
    # (4, 2) fits one 8-card node: every axis over NVLink
    assert bw == {"data": 450e9, "data,model": 450e9, "model": 450e9}
    t = ca.roofline_terms({}, coll, bw)["t_collective_s"]
    assert t == pytest.approx(4000 / 450e9 + 40 / 50e9, rel=1e-12)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_meshes_cross_nodes_on_every_axis(multi_pod):
    mesh = make_production_mesh(multi_pod=multi_pod)
    bw = ca.axis_bandwidth(mesh)
    assert set(bw.values()) == {50e9}  # 16 model ranks span two nodes
    assert "data" in bw and "model" in bw
    four = AbstractMesh(("data", "model"), (2, 4))
    assert ca.axis_bandwidth(four)["model"] == 450e9
    assert ca.axis_bandwidth(AbstractMesh(("data", "model"), (4, 4)))[
        "data"] == 50e9


def test_unknown_collective_raises_and_dtypes_size():
    with pytest.raises(ValueError, match="unknown collective"):
        ca.collective_bytes([("all-sum", torch.float32, (1,))])
    # a float8 cache's all-to-all: one byte an element
    coll = ca.collective_bytes([("all-to-all", torch.float8_e4m3fn, (3, 5))])
    assert coll["all-to-all"] == coll["total"] == 15
