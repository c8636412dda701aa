"""Wrappers of the CUDA `fedgia_update` kernel, with the lane padding.

Counterpart of `repro/kernels/fedgia_update/ops.py` and of the three
Pallas entries in its `kernel.py`. Dispatch goes by the device of the
tensors: on the CPU every wrapper runs the plain version
(`ref.fedgia_update_collapsed`); on a CUDA tensor it launches the
hand-written kernel (`csrc/fedgia_update.cu`) or raises. `launches`
counts the kernel launches of each wrapper, and nothing else.

Operand forms (`fedgia_update_flat`, and the wrappers below it): ḡ and π
are (mb, N); the anchor x̄ is (mb, N) or one (N,) vector for every row;
h is (mb, N) or a 0-d tensor (scalar H); x' is returned only when asked
(`want_x`). Each wrapper call is one launch: sel is read as the bool
tensor it is and σ from the device, so nothing else runs on the card.
`anchor_forms` counts the same launches by the anchor's form: "(N,)"
for the round's shared x̄, "(mb, N)" for an async round's per-client
anchors.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build, run_plain
from repro_torch.kernels.fedgia_update.ref import fedgia_update_collapsed

LANES = 128

launches = {
    "fedgia_update_batched": 0,
    "fedgia_update_batched_donated": 0,
    "fedgia_update_single": 0,
}
anchor_forms = {"(N,)": 0, "(mb, N)": 0}


def reset_launches() -> None:
    for counts in (launches, anchor_forms):
        for k in counts:
            counts[k] = 0


def _lib():
    lib = _build.load("fedgia_update")
    fn = lib.fedgia_update_launch
    if fn.argtypes is None:  # without them ctypes would pass 32-bit ints
        p, i64 = ctypes.c_void_p, ctypes.c_longlong
        fn.argtypes = [p, i64, p, p, p, ctypes.c_int, p, p, p, p, p,
                       ctypes.c_float, ctypes.c_int, i64, i64, p]
        fn.restype = ctypes.c_int
    return fn


def _check_forms(name, xbar, gbar, pi, h):
    """Raise unless the operands have forms the kernel takes (any device)."""
    if gbar.dim() != 2 or pi.shape != gbar.shape:
        raise ValueError(f"{name}: ḡ and π must be (mb, N), got "
                         f"{tuple(gbar.shape)} and {tuple(pi.shape)}")
    mb, n = gbar.shape
    if tuple(xbar.shape) not in ((n,), (mb, n)):
        raise ValueError(f"{name}: the anchor must be ({n},) or ({mb}, {n}),"
                         f" got {tuple(xbar.shape)}")
    if tuple(h.shape) not in ((), (mb, n)):
        raise ValueError(f"{name}: h must be 0-d (scalar H) or ({mb}, {n}), "
                         f"got {tuple(h.shape)}")


def _launch(name, xbar, gbar, pi, h, outs, sel, sigma, m, k0):
    """Validate and launch one kernel into `outs` = (x' or None, π', z'),
    (mb, N) buffers that may be the inputs."""
    _check_forms(name, xbar, gbar, pi, h)
    dev = gbar.device
    mb, n = gbar.shape
    sel = torch.as_tensor(sel, device=dev)
    if sel.dtype != torch.bool or sel.numel() != mb or \
            not sel.is_contiguous():
        raise ValueError(f"{name}: sel must be a contiguous bool tensor of "
                         f"{mb} entries, got {sel.dtype} {tuple(sel.shape)}")
    if dev.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got {dev}")
    if n % LANES:
        raise ValueError(f"{name}: want N % {LANES} == 0, got {n}")
    for t in (xbar, gbar, pi, h, *(o for o in outs if o is not None)):
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"{name}: every buffer must be float32 on {dev}"
                             f", got {t.dtype} on {t.device}")
        if not t.is_contiguous() or (t.dim() and t.data_ptr() % 16):
            raise ValueError(f"{name}: buffers must be contiguous and "
                             "16-byte aligned (materialise strided views)")
    for o in outs:
        if o is not None and o.shape != gbar.shape:
            raise ValueError(f"{name}: outputs must be {tuple(gbar.shape)}, "
                             f"got {tuple(o.shape)}")
    sigma = torch.as_tensor(sigma, dtype=torch.float32, device=dev)
    if sigma.numel() != 1:
        raise ValueError(f"{name}: sigma must be a scalar")
    x_out, pi_out, z_out = outs
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib()(xbar.data_ptr(), 0 if xbar.dim() == 1 else n,
                     gbar.data_ptr(), pi.data_ptr(), h.data_ptr(),
                     int(h.dim() == 0),
                     None if x_out is None else x_out.data_ptr(),
                     pi_out.data_ptr(), z_out.data_ptr(), sel.data_ptr(),
                     sigma.data_ptr(), float(1.0 / m), k0, mb, n, stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError {err}")
    launches[name] += 1
    anchor_forms["(N,)" if xbar.dim() == 1 else "(mb, N)"] += 1
    return outs


def _plain(xbar, gbar, pi, h, sel, sigma, m, k0):
    sel = torch.as_tensor(sel, device=gbar.device)
    sel = sel.reshape(sel.shape + (1,) * (gbar.dim() - sel.dim()))
    return fedgia_update_collapsed(xbar, gbar, pi, h, sel, sigma,
                                   float(1.0 / m), k0=k0)


def _update(name, xbar, gbar, pi, h, sel, sigma, m, k0, outs):
    """The update into `outs` (see `_launch`): the plain version on a CPU
    tensor, the kernel on a CUDA one. Returns `outs`."""
    if gbar.device.type != "cpu":
        return _launch(name, xbar, gbar, pi, h, outs, sel, sigma, m, k0)
    return run_plain("fedgia_update", _plain_into, name, xbar, gbar, pi, h,
                     sel, sigma, m, k0, outs)


def _plain_into(name, xbar, gbar, pi, h, sel, sigma, m, k0, outs):
    """The plain version's results copied into `outs`, as the kernel
    writes them."""
    _check_forms(name, xbar, gbar, pi, h)
    for o, v in zip(outs, _plain(xbar, gbar, pi, h, sel, sigma, m, k0)):
        if o is not None:
            o.copy_(v)
    return outs


def _fresh(like, want_x=True, z_out=None):
    return (torch.empty_like(like) if want_x else None, torch.empty_like(like),
            torch.empty_like(like) if z_out is None else z_out)


def fedgia_update_batched(xbar, gbar, pi, h, sel, sigma, m, *, k0: int):
    """Port of `fedgia_update_batched_kernel`: all inputs (mb, N), N % 128
    == 0; sel (mb,) bool; sigma () float32; m the global client count.
    Returns fresh (x', pi', z')."""
    return _update("fedgia_update_batched", xbar, gbar, pi, h, sel, sigma, m,
                   k0, _fresh(gbar))


def fedgia_update_batched_donated(xbar, gbar, pi, h, sel, sigma, m, *,
                                  k0: int):
    """Port of `fedgia_update_batched_kernel_donated`: the same update in
    place — x' into `xbar`, pi' into `pi`, z' into `gbar` (h is only
    read). The caller must treat those three as consumed. Returns
    (xbar, pi, gbar), now holding (x', pi', z')."""
    return _update("fedgia_update_batched_donated", xbar, gbar, pi, h, sel,
                   sigma, m, k0, (xbar, pi, gbar))


def fedgia_update_single(xbar, gbar, pi, h, sel, sigma, m, *, k0: int):
    """Port of `fedgia_update_kernel`: one client, all inputs (N,) with
    N % 128 == 0 (h may be 0-d), sel a scalar bool. The m = 1 launch of
    the kernel."""
    row = lambda t: t if t.dim() == 0 else t[None]  # noqa: E731
    x, p, z = _update("fedgia_update_single", xbar, row(gbar), row(pi),
                      row(h), sel, sigma, m, k0, _fresh(row(gbar)))
    return x[0], p[0], z[0]


def _pad_lanes(ts, n):
    """Pad the operands whose last axis is N to the lane width (0-d ones,
    a scalar h, pass through)."""
    pad = (-n) % LANES
    return [F.pad(t, (0, pad)) if pad and t.dim() else t for t in ts]


def fedgia_update(xbar, gbar, pi, h, sel, sigma, m, *, k0: int):
    """Flattened-vector round update of one client. All arrays (N), any N
    (h may be 0-d): pads to the lane width, runs the single-client kernel,
    slices back."""
    n = xbar.shape[0]
    x, p, z = fedgia_update_single(*_pad_lanes((xbar, gbar, pi, h), n), sel,
                                   sigma, m, k0=k0)
    return x[:n], p[:n], z[:n]


def fedgia_update_flat(xbar_c, gbar, pi, h, sel, sigma, m, *, k0: int,
                       donate: bool = False, want_x: bool = True,
                       use_kernel=None, z_out=None):
    """Batched flat-buffer round update of the whole (mb, N) client state.

    ḡ and π are (mb, N); the anchor `xbar_c` is (mb, N) or the round's
    (N,) x̄, which the kernel reads for every row (no broadcast copy); h
    is (mb, N) or 0-d (the scalar policy's r); `sel` is the (mb,) bool
    branch select. Returns (x', π', z'), with None for x' when
    `want_x=False` (the kernel then does not write it).

    `donate=True` writes π' into `pi`, z' into `gbar` and, for an (mb, N)
    anchor, x' into `xbar_c` (see `fedgia_update_batched_donated`); an
    (N,) anchor is never written, and a wanted x' then comes back in a
    fresh buffer. A ragged N needs padded copies, which defeat the
    aliases, so it then runs the undonated kernel.

    A one-client buffer (mb == 1) runs the single-client launch
    (`fedgia_update_single`, counted under that name); with `donate=True`
    it writes π' into `pi` and z' into `gbar` as the batched donated form
    does, as the reference's `fedgia_update_flat` donates for one client
    too. The launch is the same kernel source either way, so the values
    are the same.

    `z_out`: an (mb, N) buffer, none of the operands, that the undonated
    kernel writes z' into instead of a fresh one (diag_ema's round, whose
    ḡ is read again after the update, writes into the state's dead z).

    `use_kernel` (`FedConfig.use_kernel`): None runs the kernel on a CUDA
    tensor and its plain version on the CPU; True the kernel, which the
    CPU has not, so there it raises; False the plain version
    (`ref.fedgia_update_collapsed`) on any device, the same values, an
    A/B switch that launches nothing.
    """
    _check_forms("fedgia_update_flat", xbar_c, gbar, pi, h)
    mb, n = gbar.shape
    if use_kernel and gbar.device.type == "cpu":
        raise ValueError("use_kernel=True: the CPU has no fedgia_update "
                         "kernel (use_kernel=None runs its plain version)")
    if use_kernel is False:
        x, p, z = _plain(xbar_c, gbar, pi, h, sel, sigma, m, k0)
        if z_out is not None:
            z = z_out.copy_(z)
        return (x if want_x else None), p, z
    donate = donate and n % LANES == 0
    if mb == 1:
        name = "fedgia_update_single"
    elif donate:
        name = "fedgia_update_batched_donated"
    else:
        name = "fedgia_update_batched"
    if donate:
        x_out = None
        if want_x:
            x_out = xbar_c if xbar_c.dim() == 2 else torch.empty_like(gbar)
        return _update(name, xbar_c, gbar, pi, h, sel, sigma, m, k0,
                       (x_out, pi, gbar))
    ins = _pad_lanes((xbar_c, gbar, pi, h), n)
    if z_out is not None and z_out.shape != ins[1].shape:
        raise ValueError(f"z_out must be {tuple(ins[1].shape)}, got "
                         f"{tuple(z_out.shape)}")
    outs = _fresh(ins[1], want_x, z_out)
    x, p, z = _update(name, *ins, sel, sigma, m, k0, outs)
    if ins[1].shape[1] != n:
        x, p, z = (None if t is None else t[:, :n] for t in (x, p, z))
    return x, p, z
