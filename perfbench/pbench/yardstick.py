"""The card's published peaks and the arithmetic of what a round needs:
bytes and FLOPs from shapes, never from a measurement."""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates, at its 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12  # outside the tensor cores (the port keeps TF32 off)
PEAK_HBM_BYTES = 3.35e12
LANES = 128  # the port's flat buffers pad the parameter count to this


def padded(n: int) -> int:
    return -(-n // LANES) * LANES


def fedgia_update_bytes(m: int, n: int, n_sel: int, scalar_h: bool,
                        anchor_rows: int = 1) -> int:
    """Bytes the fused FedGiA update must move for (m, n) float32 client
    buffers: ḡ read and π', z' written on every row; π, and h unless it
    is one scalar, read on the n_sel ADMM rows only (the GD branch needs
    neither); the anchor x̄ ((n,) a row of it, `anchor_rows` of them), the
    selection (a byte a row) and σ."""
    row = 4 * n
    nbytes = 3 * m * row + n_sel * row
    nbytes += 4 if scalar_h else n_sel * row
    return nbytes + anchor_rows * row + m + 4


def lsq_round(d: int, n: int, m: int, rows: int, alpha: float, k0: int,
              diag_h: bool):
    """(FLOPs, bytes) one FedGiA round on Example V.1 needs. FLOPs: the
    residual A x̄ − b and the gradient Aᵀ r over the d real rows (4 d n),
    and per element of the (m, n) buffers eq. (11) (1), ḡ = g/m (1), the
    GD branch (3), the k0 ADMM steps on the α m selected rows (6 k0 + 2)
    and, under diag_ema, the H refresh (8). Bytes: each input read once,
    each output written once: A's real rows and b, the masks, z, π of the
    selected rows, h (diag_ema), z', π', h' and x̄'."""
    n_sel = max(1, min(m, int(round(alpha * m))))
    flops = 4 * d * n + m * n * (5 + (8 if diag_h else 0)) \
        + n_sel * n * (6 * k0 + 2)
    buf = 4 * m * n
    nbytes = 4 * d * n + 4 * d + 4 * m * rows + m
    nbytes += buf + 4 * n_sel * n + 2 * buf + 4 * n
    if diag_h:
        nbytes += 2 * buf
    return float(flops), float(nbytes)


def least_time_s(flops: float, nbytes: float, peak_flops: float):
    """(seconds, which bound binds) at the card's peaks."""
    tc = flops / peak_flops
    tm = nbytes / PEAK_HBM_BYTES if nbytes is not None else 0.0
    return (tc, "flops") if tc >= tm else (tm, "bytes")
