"""CUDA-graph helpers: conditional bodies and the replayed step loop.

`skip_if(flag, body)` makes the work that its block enqueues the body of a
conditional node of the graph being captured on the current stream
(`csrc/graph_if.cu`): at each replay the body runs only while the 0-d
bool `flag` on the card is False. The round driver (`engine.py`) wraps
each round of a captured chunk in it, so the rounds after the eq. (35)
stop launch nothing. Capture only: outside a capture `graph_if_begin`
fails and this raises.

`scan_steps(step_fn, n)` is the counterpart of the reference's
`core/engine.py::scan_steps`, which compiles n applications of a step
into one `lax.scan` dispatch: on the card the step is captured once as a
CUDA graph and replayed n times (the serving decode loop).
"""
from __future__ import annotations

import contextlib
import ctypes
import time

import torch

from repro_torch.kernels import _build

_CAPTURE_MODE_GLOBAL = 0  # cudaStreamCaptureModeGlobal, as torch.cuda.graph


def _lib():
    lib = _build.load("graph_if")
    if lib.graph_if_begin.argtypes is None:
        p = ctypes.c_void_p
        lib.graph_if_begin.argtypes = [p, p, ctypes.c_int, p, ctypes.c_int]
        lib.graph_if_begin.restype = ctypes.c_int
        lib.graph_if_end.argtypes = [p]
        lib.graph_if_end.restype = ctypes.c_int
    return lib


class Body:
    """Where conditional bodies are captured: a side stream, and a private
    memory pool for the tensors they allocate. PyTorch routes a capture's
    allocations to the graph's pool by the capturing stream's capture id,
    which a body's stream does not share, so without this pool they would
    come from (and go back to) the shared cache that eager code reuses.
    Keep the object alive as long as the graph."""

    def __init__(self, device):
        self.stream = torch.cuda.Stream(device)
        self.pool = torch.cuda.MemPool()


@contextlib.contextmanager
def skip_if(flag: torch.Tensor, body: Body):
    """Capture the block's work as the body of an IF node that runs while
    `flag` (0-d bool, on the card) is False at replay."""
    if flag.dtype != torch.bool or flag.numel() != 1 or not flag.is_cuda:
        raise ValueError("skip_if: flag must be one bool on a CUDA device")
    lib = _lib()
    stream = torch.cuda.current_stream(flag.device)
    err = lib.graph_if_begin(stream.cuda_stream, flag.data_ptr(), 1,
                             body.stream.cuda_stream, _CAPTURE_MODE_GLOBAL)
    if err != 0:
        raise RuntimeError(f"graph_if_begin failed with cudaError {err} "
                           "(is the current stream capturing a graph?)")
    try:
        with torch.cuda.stream(body.stream), torch.cuda.use_mem_pool(
                body.pool, flag.device):
            yield
    finally:
        err = lib.graph_if_end(body.stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"graph_if_end failed with cudaError {err}")


# ------------------------------------------------------------ scan_steps
def _leaves(tree):
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        for t in tree:
            yield from _leaves(t)


def _commit(dst, src):
    """Copy a step's new carry into the static carry buffers; a leaf the
    step updated in place (the KV cache) is already there."""
    for d, s in zip(_leaves(dst), _leaves(src)):
        if s is not d:
            d.copy_(s)


def _clone(tree):
    if torch.is_tensor(tree):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return type(tree)(_clone(t) for t in tree)


class ScanSteps:
    """`num_steps` applications of `step_fn(carry, *args) -> (carry,
    out)`. `run(carry, *args)` returns (carry, outs): the carry after the
    last step (the caller's own buffers, advanced in place) and `out` (a
    tensor or a tuple of tensors) with each tensor stacked on a leading
    (num_steps,) axis.

    The carry is a tensor or a tuple, list or dict of them, and every
    step's carry has the first one's shapes and dtypes: its tensors are
    the static buffers that the steps read and write in place (a leaf
    that the step returns anew is copied back into its buffer). A step
    must read no host value: a counter it needs is a 0-d device tensor
    in the carry.

    On a CUDA device the step is captured once as a CUDA graph and
    replayed `num_steps` times with no host sync between replays; a step
    counter on the card tells each replay where in the (num_steps, …)
    output buffers its out goes. Before the capture the step runs once
    eagerly on copies of the carry, on the capture stream (cuBLAS's
    handles and workspaces; the out's shapes), so the real carry
    advances only in the replays. `capture_s` is the host time of that
    warm-up and the capture, to the end of a device sync. A failed
    capture raises. On the CPU the same step function runs eagerly,
    `num_steps` times, and `capture_s` is 0.
    """

    def __init__(self, step_fn, num_steps: int):
        if num_steps < 1:
            raise ValueError(f"num_steps must be >= 1, got {num_steps}")
        self.step_fn = step_fn
        self.num_steps = num_steps
        self.capture_s = 0.0

    def __call__(self, carry, *args):
        device = next(_leaves(carry)).device
        if device.type != "cuda":
            outs = []
            for _ in range(self.num_steps):
                new, out = self.step_fn(carry, *args)
                outs.append(tuple(o.clone() for o in _leaves(out)))
                _commit(carry, new)
            return carry, self._shape(out, [torch.stack(o)
                                            for o in zip(*outs)])
        t0 = time.perf_counter()
        main = torch.cuda.current_stream(device)
        stream = torch.cuda.Stream(device)
        stream.wait_stream(main)
        with torch.cuda.stream(stream):
            _, out = self.step_fn(_clone(carry), *args)
        main.wait_stream(stream)
        bufs = [torch.empty((self.num_steps,) + o.shape, dtype=o.dtype,
                            device=device) for o in _leaves(out)]
        counter = torch.zeros((1,), dtype=torch.long, device=device)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            new, out = self.step_fn(carry, *args)
            for buf, o in zip(bufs, _leaves(out)):
                buf.index_copy_(0, counter, o.unsqueeze(0))
            _commit(carry, new)
            counter.add_(1)
        torch.cuda.synchronize(device)
        self.capture_s = time.perf_counter() - t0
        for _ in range(self.num_steps):
            graph.replay()
        self.graph = graph  # the replays may still be running
        return carry, self._shape(out, bufs)

    @staticmethod
    def _shape(out, stacked):
        """The stacked leaves in the structure of `out` (a tensor or a
        tuple of tensors)."""
        return stacked[0] if torch.is_tensor(out) else tuple(stacked)


def scan_steps(step_fn, num_steps: int) -> ScanSteps:
    """The reference's `scan_steps(step_fn, num_steps)`: returns `run`,
    with `run(carry, *args) -> (carry, outs)` (see `ScanSteps`)."""
    return ScanSteps(step_fn, num_steps)
