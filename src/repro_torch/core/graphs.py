"""Conditional bodies inside a CUDA-graph capture (`csrc/graph_if.cu`).

`skip_if(flag, body)` makes the work that its block enqueues the body of a
conditional node of the graph being captured on the current stream: at
each replay the body runs only while the 0-d bool `flag` on the card is
False. The round driver (`engine.py`) wraps each round of a captured
chunk in it, so the rounds after the eq. (35) stop launch nothing. Capture
only: outside a capture `graph_if_begin` fails and this raises.
"""
from __future__ import annotations

import contextlib
import ctypes

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
