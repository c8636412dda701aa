"""Wrappers of the CUDA `fedgia_update` kernel, with the lane padding.

Counterpart of `repro/kernels/fedgia_update/ops.py` and of the three
Pallas entries in its `kernel.py`. Dispatch goes by the device of the
tensors: on the CPU every wrapper runs the plain version
(`ref.fedgia_update_collapsed`); on a CUDA tensor it launches the
hand-written kernel (`csrc/fedgia_update.cu`) or raises. `launches`
counts the kernel launches of each wrapper, and nothing else.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.fedgia_update.ref import fedgia_update_collapsed

LANES = 128

launches = {
    "fedgia_update_batched": 0,
    "fedgia_update_batched_donated": 0,
    "fedgia_update_single": 0,
}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _lib():
    lib = _build.load("fedgia_update")
    fn = lib.fedgia_update_launch
    if fn.argtypes is None:  # without them ctypes would pass 32-bit ints
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, p, p, p, p, p, p, ctypes.c_float, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_longlong, p]
        fn.restype = ctypes.c_int
    return fn


def _launch(name, xbar, gbar, pi, h, outs, sel, sigma, m, k0):
    """Validate and launch one kernel over (mb, N) buffers `xbar, gbar,
    pi, h` into `outs` = (x', pi', z'), which may be the inputs."""
    dev = xbar.device
    shape = xbar.shape
    if dev.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got {dev}")
    if len(shape) != 2 or shape[1] % LANES:
        raise ValueError(f"{name}: want (m, N) with N % {LANES} == 0, "
                         f"got {tuple(shape)}")
    for t in (xbar, gbar, pi, h, *outs):
        if t.device != dev or t.dtype != torch.float32 or t.shape != shape:
            raise ValueError(f"{name}: every buffer must be float32 "
                             f"{tuple(shape)} on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: buffers must be contiguous and "
                             "16-byte aligned (materialise broadcast views)")
    sel = torch.as_tensor(sel, device=dev).reshape(-1).to(torch.int32)
    if sel.shape != (shape[0],):
        raise ValueError(f"{name}: sel must have {shape[0]} entries, "
                         f"got {tuple(sel.shape)}")
    sigma = torch.as_tensor(sigma, dtype=torch.float32, device=dev)
    if sigma.numel() != 1:
        raise ValueError(f"{name}: sigma must be a scalar")
    sigma = sigma.reshape(()).contiguous()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib()(xbar.data_ptr(), gbar.data_ptr(), pi.data_ptr(),
                     h.data_ptr(), *(o.data_ptr() for o in outs),
                     sel.data_ptr(), sigma.data_ptr(), float(1.0 / m), k0,
                     shape[0], shape[1], stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError {err}")
    launches[name] += 1
    return outs


def _plain(xbar, gbar, pi, h, sel, sigma, m, k0):
    sel = torch.as_tensor(sel, device=xbar.device)
    sel = sel.reshape(sel.shape + (1,) * (xbar.dim() - sel.dim()))
    return fedgia_update_collapsed(xbar, gbar, pi, h, sel, sigma,
                                   float(1.0 / m), k0=k0)


def fedgia_update_batched(xbar, gbar, pi, h, sel, sigma, m, *, k0: int):
    """Port of `fedgia_update_batched_kernel`: all inputs (mb, N), N % 128
    == 0; sel (mb,) bool; sigma () float32; m the global client count.
    Returns fresh (x', pi', z')."""
    if xbar.device.type == "cpu":
        return _plain(xbar, gbar, pi, h, sel, sigma, m, k0)
    outs = tuple(torch.empty_like(xbar) for _ in range(3))
    return _launch("fedgia_update_batched", xbar, gbar, pi, h, outs, sel,
                   sigma, m, k0)


def fedgia_update_batched_donated(xbar, gbar, pi, h, sel, sigma, m, *,
                                  k0: int):
    """Port of `fedgia_update_batched_kernel_donated`: the same update in
    place — x' into `xbar`, pi' into `pi`, z' into `gbar` (h is only
    read). The caller must treat those three as consumed. Returns
    (xbar, pi, gbar), now holding (x', pi', z')."""
    outs = (xbar, pi, gbar)
    if xbar.device.type == "cpu":
        for o, v in zip(outs, _plain(xbar, gbar, pi, h, sel, sigma, m, k0)):
            o.copy_(v)
        return outs
    return _launch("fedgia_update_batched_donated", xbar, gbar, pi, h, outs,
                   sel, sigma, m, k0)


def fedgia_update_single(xbar, gbar, pi, h, sel, sigma, m, *, k0: int):
    """Port of `fedgia_update_kernel`: one client, all inputs (N,) with
    N % 128 == 0, sel a scalar bool. The m = 1 launch of the kernel."""
    if xbar.device.type == "cpu":
        return _plain(xbar, gbar, pi, h, sel, sigma, m, k0)
    outs = tuple(torch.empty_like(xbar)[None] for _ in range(3))
    x, p, z = _launch("fedgia_update_single", xbar[None], gbar[None],
                      pi[None], h[None], outs, sel, sigma, m, k0)
    return x[0], p[0], z[0]


def _pad_lanes(ts, n):
    pad = (-n) % LANES
    return [F.pad(t, (0, pad)) for t in ts] if pad else list(ts)


def fedgia_update(xbar, gbar, pi, h, sel, sigma, m, *, k0: int):
    """Flattened-vector round update of one client. All arrays (N), any N:
    pads to the lane width, runs the single-client kernel, slices back."""
    n = xbar.shape[0]
    x, p, z = fedgia_update_single(*_pad_lanes((xbar, gbar, pi, h), n), sel,
                                   sigma, m, k0=k0)
    return x[:n], p[:n], z[:n]


def fedgia_update_flat(xbar_c, gbar, pi, h, sel, sigma, m, *, k0: int,
                       donate: bool = False):
    """Batched flat-buffer round update of the whole (mb, N) client state.

    `xbar_c` is the per-client anchor and `sel` the (mb,) branch select.
    The kernel takes contiguous buffers: a broadcast view must be
    materialised by the caller. `donate=True` writes the result into
    xbar_c / pi / gbar (see `fedgia_update_batched_donated`); a ragged N
    needs a padded copy, which defeats the alias, so it then runs the
    undonated kernel.

    A one-client buffer (mb == 1) runs the single-client launch
    (`fedgia_update_single`) and never donates: its results come back in
    fresh buffers even with `donate=True`. This departs from the
    reference's `fedgia_update_flat`, which runs the batched kernel (or
    its donated form) for one client too; the values are the same.
    """
    mb, n = xbar_c.shape
    if mb == 1:
        out = fedgia_update(xbar_c[0], gbar[0], pi[0], h[0], sel.reshape(()),
                            sigma, m, k0=k0)
        return tuple(t[None] for t in out)
    if donate and n % LANES == 0:
        return fedgia_update_batched_donated(xbar_c, gbar, pi, h, sel, sigma,
                                             m, k0=k0)
    x, p, z = fedgia_update_batched(*_pad_lanes((xbar_c, gbar, pi, h), n),
                                    sel, sigma, m, k0=k0)
    return x[:, :n], p[:, :n], z[:, :n]
