"""Wrapper of the CUDA RWKV-6 scan kernel.

Counterpart of `repro/kernels/rwkv6_scan/ops.py` and of the Pallas
`rwkv6_scan_kernel` in its `kernel.py`. Dispatch goes by the device of
the tensors: on the CPU the wrapper runs the plain version
(`ref.rwkv6_scan_ref`); on a CUDA tensor it launches the hand-written
kernel (`csrc/rwkv6_scan.cu`) or raises. `launches` counts the kernel's
launches, and nothing else.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build, run_plain
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref

HEAD_DIMS = (32, 64)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = {"rwkv6_scan": 0}
COPY_ALIGN = 16  # bytes: the kernel stages r, k, v, w by 16-byte cp.async


class ColumnSplit(NamedTuple):
    """How the kernel spreads one head's (hd x hd) state over threads (the
    constants of `csrc/rwkv6_scan.cu`): a head takes `groups` blocks of
    `cols` value columns each; the key rows are cut in `parts` parts of
    `rows` rows, one a half-warp, and lane c of a half-warp keeps its
    part's entries in columns c and c + cols / 2."""
    cols: int
    parts: int
    rows: int
    groups: int

    @property
    def threads(self) -> int:
        return self.cols // 2 * self.parts

    def owner(self, i: int, j: int):
        """(block column group, thread in the block, register) holding
        S[i][j], registers counted row-major over (row, column pair)."""
        half = self.cols // 2
        jc = j % self.cols
        return (j // self.cols, i // self.rows * half + jc % half,
                i % self.rows * 2 + jc // half)

    def warps(self, B: int, H: int) -> int:
        """Warps the launch puts on the card for B x H heads."""
        return B * H * self.groups * self.threads // 32


def column_split(hd: int) -> ColumnSplit:
    cols, parts = 32, 16
    if hd not in HEAD_DIMS:
        raise ValueError(f"rwkv6_scan: head_dim {hd} not in {HEAD_DIMS}")
    return ColumnSplit(cols, parts, hd // parts, hd // cols)


def check_copy_alignment(t, name: str = "r") -> None:
    """Raise unless the kernel can stage `t` (B,H,T,hd) by 16-byte copies:
    its start and its b, h, t strides multiples of 16 bytes."""
    if t.data_ptr() % COPY_ALIGN:
        raise ValueError(f"rwkv6_scan: {name} must start on a {COPY_ALIGN}-"
                         f"byte boundary, got address {t.data_ptr():#x}")
    if any(t.stride(i) * t.element_size() % COPY_ALIGN for i in range(3)):
        raise ValueError(f"rwkv6_scan: the strides of {name} must be "
                         f"multiples of {COPY_ALIGN} bytes, got "
                         f"{t.stride()} of {t.element_size()}-byte values")


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _lib():
    fn = _build.load("rwkv6_scan").rwkv6_scan_launch
    if fn.argtypes is None:  # without them ctypes would pass 32-bit ints
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p] * 7 + [i] * 5 + [ll] * 16 + [p]
        fn.restype = ctypes.c_int
    return fn


def _launch(r, k, v, w, u):
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, w)):
        raise ValueError(f"rwkv6_scan: r, k, v, w must all be (B,H,T,hd), "
                         f"got {[tuple(t.shape) for t in (r, k, v, w)]}")
    B, H, T, hd = r.shape
    if tuple(u.shape) != (H, hd):
        raise ValueError(f"rwkv6_scan: u must be {(H, hd)}, "
                         f"got {tuple(u.shape)}")
    column_split(hd)  # raises for a head_dim the kernel has no form for
    if r.dtype not in _DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise ValueError(f"rwkv6_scan: r, k, v must share one dtype of "
                         f"{list(_DTYPES)}, got {r.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if w.dtype != torch.float32 or u.dtype != torch.float32:
        raise ValueError(f"rwkv6_scan: w and u must be float32, got "
                         f"{w.dtype}, {u.dtype}")
    if r.numel():  # layout, checked before the device: a meta tensor
        for name, t in zip("rkvw", (r, k, v, w)):  # reaches it too
            check_copy_alignment(t, name)
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_scan: the kernel takes CUDA tensors, "
                         f"got {r.device}")
    for t in (k, v, w, u):
        if t.device != r.device:
            raise ValueError(f"rwkv6_scan: tensors on {r.device} and "
                             f"{t.device}")
    y = torch.empty_like(r)  # r's layout, so a transposed view stays free
    s = torch.empty((B, H, hd, hd), dtype=torch.float32, device=r.device)
    for t in (r, k, v, w, u, y):
        if t.stride(-1) != 1:
            raise ValueError("rwkv6_scan: head_dim must have stride 1")
    if T == 0 or B * H == 0:
        return y, s.zero_()
    strides = [t.stride(i) for t in (r, k, v, w, y) for i in range(3)]
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = _lib()(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                     u.data_ptr(), y.data_ptr(), s.data_ptr(),
                     _DTYPES[r.dtype], B, H, T, hd, *strides, u.stride(0),
                     stream)
    if err != 0:
        raise RuntimeError(
            f"rwkv6_scan: kernel launch failed with cudaError {err}")
    launches["rwkv6_scan"] += 1
    return y, s


def rwkv6_scan(r, k, v, w, u):
    """The RWKV-6 WKV recurrence from a zero state, port of
    `rwkv6_scan_kernel`.

    r,k,v,w: (B,H,T,hd); u: (H,hd). Returns (y (B,H,T,hd) in r's dtype,
    final state S (B,H,hd,hd) float32, laid out [key, value]). Any strides
    with a unit stride on hd (the model passes `transpose(1, 2)` views of
    its (B,T,H,hd) tensors). On CUDA: head_dim 32 or 64, r, k, v float32
    or bfloat16, w and u float32; all of the scan's math is fp32.
    """
    if r.device.type == "cpu":
        return run_plain("rwkv6_scan", rwkv6_scan_ref, r, k, v, w, u)
    return _launch(r, k, v, w, u)
