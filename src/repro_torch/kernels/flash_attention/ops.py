"""Wrapper of the CUDA flash attention kernel.

Counterpart of `repro/kernels/flash_attention/ops.py` and of the Pallas
`flash_attention_kernel` in its `kernel.py`. Dispatch goes by the device
of the tensors: on the CPU the wrapper runs the plain version
(`ref.flash_attention_ref`); on a CUDA tensor it launches the
hand-written kernel (`csrc/flash_attention.cu`) or raises. `launches`
counts the kernel's launches, and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, run_plain
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

HEAD_DIMS = (64, 128, 160)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# (queries per block, keys per tile) of each form of the kernel, by dtype
# and head_dim: the bfloat16 forms run on the tensor cores (wgmma, TMA;
# head_dim 160 in rows padded to 192 columns), the float32 forms on the
# CUDA cores
TILES = {(torch.bfloat16, 64): (128, 128), (torch.bfloat16, 128): (128, 64),
         (torch.bfloat16, 160): (128, 64),
         (torch.float32, 64): (64, 64), (torch.float32, 128): (64, 64),
         (torch.float32, 160): (64, 64)}
TMA_ALIGN = 16  # bytes: TMA's alignment of base pointers and strides

launches = {"flash_attention": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def kv_tiles(q_tile: int, S: int, bq: int, bk: int, causal: bool = True,
             window=None):
    """The key tiles [lo, hi) that the block of query tile `q_tile` walks,
    as the kernel computes them: tiles that the causal and window masks
    hide from every query of the block are skipped. (The bfloat16 kernel
    takes query tiles in reverse, gridDim.x - 1 - blockIdx.x, so that the
    causal grid starts with its heaviest blocks.)"""
    q0 = q_tile * bq
    hi = -(-S // bk)
    if causal:
        hi = min(hi, (q0 + bq - 1) // bk + 1)
    lo = max(0, q0 - window + 1) // bk if window else 0
    return lo, hi


def tma_strides(t) -> tuple:
    """Byte strides of the s, h and b dimensions of a (B,heads,S,hd)
    bfloat16 tensor, innermost first, as its TMA tensor map takes them.
    Raises where TMA cannot read the tensor: a base pointer or a stride
    that is not a multiple of 16 bytes, or a head_dim that is not unit
    stride."""
    if t.stride(-1) != 1:
        raise ValueError("flash_attention: head_dim must have stride 1")
    if t.data_ptr() % TMA_ALIGN:
        raise ValueError(f"flash_attention: bfloat16 tensors must start on "
                         f"a {TMA_ALIGN}-byte boundary (TMA), got address "
                         f"{t.data_ptr():#x}")
    strides = tuple(t.stride(i) * t.element_size() for i in (2, 1, 0))
    if any(x % TMA_ALIGN for x in strides):
        raise ValueError(f"flash_attention: bfloat16 strides must be "
                         f"multiples of {TMA_ALIGN // t.element_size()} "
                         f"elements (TMA), got {t.stride()}")
    return strides


def _lib():
    fn = _build.load("flash_attention").flash_attention_launch
    if fn.argtypes is None:  # without them ctypes would pass 32-bit ints
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([p, p, p, p, i, i, i, i, i, i] + [ll] * 12
                       + [ctypes.c_float, i, i, p])
        fn.restype = ctypes.c_int
    return fn


def _launch(q, k, v, causal, window):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("flash_attention: want q (B,H,S,hd) and k, v "
                         f"(B,Kv,T,hd), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, S, hd = q.shape
    Kv, T = k.shape[1], k.shape[2]
    if k.shape[0] != B or T != S or k.shape[3] != hd or Kv < 1 or H % Kv:
        raise ValueError(f"flash_attention: need matching B and hd, S == T "
                         f"and H % Kv == 0, got q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} not in {HEAD_DIMS}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: q, k, v must share one dtype of "
                         f"{list(_DTYPES)}, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    for t in (q, k, v):  # layout, checked before the device: a meta
        if t.stride(-1) != 1:  # tensor reaches these checks too
            raise ValueError("flash_attention: head_dim must have stride 1")
        if q.dtype == torch.bfloat16 and t.numel():
            tma_strides(t)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: the kernel takes CUDA tensors, "
                         f"got {q.device}")
    for t in (k, v):
        if t.device != q.device:
            raise ValueError(f"flash_attention: tensors on {q.device} and "
                             f"{t.device}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got {window}")
    out = torch.empty_like(q)  # q's layout, so a transposed view stays free
    if out.stride(-1) != 1:  # out is written by plain stores, not TMA
        raise ValueError("flash_attention: head_dim must have stride 1")
    if S == 0 or B * H == 0:
        return out
    strides = [t.stride(i) for t in (q, k, v, out) for i in range(3)]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     _DTYPES[q.dtype], B, H, Kv, S, hd, *strides,
                     float(1.0 / hd ** 0.5), int(causal),
                     0 if window is None else int(window), stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention: kernel launch failed with cudaError {err}")
    launches["flash_attention"] += 1
    return out


def flash_attention(q, k, v, *, causal: bool = True, window=None):
    """Blocked streaming-softmax attention, port of `flash_attention_kernel`.

    q: (B,H,S,hd); k,v: (B,Kv,T,hd) with S == T and H % Kv == 0; query
    head h reads kv head h // (H/Kv). Masks are computed from indices:
    key j is visible to query i iff j <= i (causal) and i - j < window.
    Any strides with a unit stride on hd (the model passes
    `transpose(1, 2)` views of its (B,S,H,hd) tensors). On CUDA: head_dim
    64, 128 or 160, float32 or bfloat16, fp32 accumulation; the output is in
    q's dtype and q's layout. bfloat16 runs on the tensor cores and reads
    q, k, v by TMA, so their base pointers and strides must be multiples
    of 16 bytes (`tma_strides`); float32 takes any strides.
    """
    if q.device.type == "cpu":
        return run_plain("flash_attention", flash_attention_ref, q, k, v,
                         causal=causal, window=window)
    return _launch(q, k, v, causal, window)
