"""Client meshes on `torch.distributed`, the launcher of their ranks, and
the production meshes of the planning dry run (counterpart of
`repro/launch/mesh.py::make_host_mesh` and `::make_production_mesh`).

A mesh lays its ranks out row-major over ``("data", "model")`` or
``("pod", "data", "model")``, as `jax.make_mesh` orders devices: rank r
of a (data 4, model 2) mesh sits at data r // 2, model r % 2. The client
axis (``"data"``, or the compound ``("pod", "data")``) splits the
client rows: shard s holds clients ``[s·m_local, (s+1)·m_local)``. Ranks
that differ only in ``model`` hold the same rows and run the same
rounds in their own process group, as `shard_map` replicates a round
over a mesh axis it does not name.

`launch(fn, world, ...)` runs ``fn(*args)`` on `world` ranks through
`torch.multiprocessing.spawn`, with a ``file://`` rendezvous in a
temporary directory and a timeout on every collective: gloo on the CPU
(one torch thread a rank), NCCL on the card with rank r on ``cuda:r``,
which needs one device a rank (NCCL refuses two ranks on one device).
A rank's exception makes `launch` raise.

`make_production_mesh` gives the reference's 256- and 512-chip meshes,
``(data 16, model 16)`` and ``(pod 2, data 16, model 16)``, as an
`AbstractMesh`: axis names, shape and the same row-major rank layout,
with no process group and no device. `fake_process_group(mesh)` runs a
block under a fake default process group of the mesh's world size in
this one process and gives it rank 0's `Mesh`, so that the dry run
traces a sharded round's collectives at 256 or 512 ranks on fake
tensors.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import math
import os
import tempfile
from typing import Any, Dict, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.api import ClientAxis

# a collective that waits longer than this raises on every rank, so a
# rank that misses one fails the run instead of hanging it
DEFAULT_TIMEOUT_S = 120


@dataclasses.dataclass
class Mesh:
    """This rank's place in a mesh of all the ranks of the default process
    group: the axis names and sizes, its coordinate on each, and its
    device. `client_axis` builds the process group of a client axis."""

    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    rank: int
    device: torch.device
    _axes: Dict[Tuple[str, ...], ClientAxis] = dataclasses.field(
        default_factory=dict, repr=False)

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def coords(self) -> Dict[str, int]:
        """This rank's coordinate on each axis (row-major layout)."""
        return self._coords(self.rank)

    def _coords(self, rank) -> Dict[str, int]:
        out = {}
        for name, n in zip(reversed(self.axis_names), reversed(self.shape)):
            out[name] = rank % n
            rank //= n
        return out

    def axis_size(self, name: str) -> int:
        return self.shape[self.axis_names.index(name)]

    def client_axis(self, client_axis="data") -> ClientAxis:
        """The `api.ClientAxis` of `client_axis` (one mesh axis or a tuple
        of them, in mesh order): the shard count is the product of their
        sizes, this rank's shard the row-major index of its coordinates on
        them, and the group the ranks that share its coordinates on every
        other axis. Every rank must call it, with the same argument: each
        group of the partition is made on every rank."""
        axes = client_axis if isinstance(client_axis, tuple) else (
            client_axis,)
        for a in axes:
            if a not in self.axis_names:
                raise ValueError(f"mesh has no axis {a!r}: {self.axis_names}")
        order = [self.axis_names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"client axes {axes} must be in mesh order "
                             f"{self.axis_names}")
        if axes in self._axes:
            return self._axes[axes]
        coords = self.coords
        shards = math.prod(self.axis_size(a) for a in axes)
        index = 0
        for a in axes:
            index = index * self.axis_size(a) + coords[a]
        groups, mine = {}, None
        for r in range(self.size):  # keyed by the coordinates off `axes`
            c = self._coords(r)
            groups.setdefault(tuple(c[a] for a in self.axis_names
                                    if a not in axes), []).append(r)
        for _, ranks in sorted(groups.items()):  # the same order everywhere
            g = dist.new_group(ranks, timeout=datetime.timedelta(
                seconds=DEFAULT_TIMEOUT_S))
            if self.rank in ranks:
                mine = g
        self._axes[axes] = ClientAxis(mine, shards, index)
        return self._axes[axes]


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis names and sizes, ranks laid out row-major as in
    `Mesh`; it holds no process group and no device."""

    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def tag(self) -> str:
        """"16x16", "2x16x16": the dry run's name of the mesh."""
        return "x".join(str(n) for n in self.shape)


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """The reference's production meshes: one pod 16x16 = 256 chips
    (data, model); two pods 2x16x16 = 512 chips (pod, data, model)."""
    if multi_pod:
        return AbstractMesh(("pod", "data", "model"), (2, 16, 16))
    return AbstractMesh(("data", "model"), (16, 16))


@contextlib.contextmanager
def fake_process_group(mesh: AbstractMesh):
    """Within the block, a fake default process group of `mesh.size`
    ranks in this process (torch's test backend: every collective returns
    at once and moves nothing) and rank 0's `Mesh` on the CPU, which
    the block receives; its `client_axis` groups are made on the fake
    group. Raises where a process group is already initialised; destroys
    its own on leaving."""
    if dist.is_initialized():
        raise RuntimeError("fake_process_group needs no process group to "
                           "be initialised: one already is")
    # the fake backend registers itself on this import (torch ships it
    # with its test utilities; nothing else of the port imports it)
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=mesh.size)
    try:
        yield Mesh(tuple(mesh.axis_names), tuple(mesh.shape), 0,
                   torch.device("cpu"))
    finally:
        dist.destroy_process_group()


def make_host_mesh(model: int = 1, data: int = 1, pod: int = 0,
                   device=None) -> Mesh:
    """The mesh of the reference's signature over the ranks of the default
    process group (its world size must be the mesh's size): ``(pod, data,
    model)`` with `pod`, else ``(data, model)``. `device`: this rank's
    device (default: ``cuda:rank`` under NCCL, else the CPU)."""
    if pod:
        names, shape = ("pod", "data", "model"), (pod, data, model)
    else:
        names, shape = ("data", "model"), (data, model)
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs an initialised process "
                           "group: run under launch(fn, world)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if math.prod(shape) != world:
        raise ValueError(f"a {dict(zip(names, shape))} mesh needs "
                         f"{math.prod(shape)} ranks, the group has {world}")
    if device is None:
        device = (torch.device("cuda", rank)
                  if dist.get_backend() == "nccl" else torch.device("cpu"))
    return Mesh(names, shape, rank, torch.device(device))


def check_devices(world: int, device: str) -> None:
    """Raise unless `world` ranks can run on `device`: on the card each
    rank needs its own CUDA device."""
    if torch.device(device).type != "cuda":
        return
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count < world:
        raise RuntimeError(
            f"{world} ranks on CUDA need {world} devices, one a rank (NCCL "
            f"refuses two ranks on one device); this machine has {count}")


def _rank_main(rank, world, device, init_file, out, timeout_s, fn, args):
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(rank)
        backend = "nccl"
    else:
        torch.set_num_threads(1)
        backend = "gloo"
    dist.init_process_group(
        backend, init_method=f"file://{init_file}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
    try:
        result = fn(*args)
        if rank == 0:
            torch.save(result, out)
    finally:
        dist.destroy_process_group()


def launch(fn, world: int, *args, device: str = "cpu",
           timeout_s: float = DEFAULT_TIMEOUT_S) -> Any:
    """Run ``fn(*args)`` on `world` ranks (processes) and return rank 0's
    result. `fn` must be picklable (a module-level function). Each rank
    initialises the default process group (gloo on the CPU, NCCL on the
    card with rank r on ``cuda:r``) from a ``file://`` rendezvous in a
    temporary directory, with `timeout_s` on every collective, and
    destroys it before it exits. Raises where `device` is CUDA with fewer
    than `world` devices, and where any rank raises."""
    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    check_devices(world, device)
    with tempfile.TemporaryDirectory() as tmp:
        init_file = os.path.join(tmp, "rendezvous")
        out = os.path.join(tmp, "rank0.pt")
        torch.multiprocessing.spawn(
            _rank_main, args=(world, device, init_file, out, timeout_s, fn,
                              args), nprocs=world, join=True)
        return torch.load(out, map_location="cpu", weights_only=False)


_KINDS = {"c10d::allreduce_": "all_reduce",
          "c10d::_reduce_scatter_base_": "reduce_scatter",
          "c10d::_allgather_base_": "all_gather"}


def _numel(shape) -> int:
    return math.prod(shape) if shape else 1


def collective_counts(events, n_model: int) -> Dict[str, int]:
    """Count the collectives in `torch.profiler` events (`prof.events()`,
    recorded with ``record_shapes=True``) at the c10d level: each
    ``c10d::allreduce_`` / ``_reduce_scatter_base_`` / ``_allgather_base_``
    is one all-reduce / reduce-scatter / all-gather. A c10d all-reduce
    records no input shapes, so its size is read off the backend's event
    (``gloo:*`` or ``nccl:*``) that it issued: the first one after it in
    time (its child where the backend records it on the calling
    thread). "model-size" means at least `n_model` elements, the
    counterpart of the reference's HLO classifier. Returns the counts of
    each kind, and of each kind's model-size ones under ``<kind>_model``.
    On gloo a reduce-scatter runs as a whole-buffer all-reduce underneath:
    it counts once, as a reduce-scatter."""
    evs = sorted(events, key=lambda e: e.time_range.start)
    backend = [e for e in evs if e.name.split(":")[0] in ("gloo", "nccl")]
    used = set()
    counts = {k: 0 for v in _KINDS.values() for k in (v, v + "_model")}
    for e in evs:
        kind = _KINDS.get(e.name)
        if kind is None:
            continue
        sizes = [_numel(s) for s in (e.input_shapes or []) if s]
        own = [c for c in e.cpu_children
               if c.name.split(":")[0] in ("gloo", "nccl")]
        if not own:
            own = [b for b in backend if id(b) not in used
                   and b.time_range.start >= e.time_range.start][:1]
        for b in own:
            used.add(id(b))
            sizes += [_numel(s) for s in (b.input_shapes or []) if s]
        counts[kind] += 1
        if sizes and max(sizes) >= n_model:
            counts[kind + "_model"] += 1
    return counts


def profile_collectives(fn, n_model: int):
    """Run ``fn()`` under `torch.profiler` (CPU activity, shapes
    recorded) and count its collectives (`collective_counts`). Returns
    (fn's result, the counts)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        out = fn()
    return out, collective_counts(prof.events(), n_model)
