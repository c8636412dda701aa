"""Uplink compression of eq. (11)'s flat communication buffer
(counterpart of `repro/core/compress.py`).

Each round every participating client uploads its (N,) contribution
(FedGiA: z_i; the baselines: their local trajectory). A codec here is an
encode+decode round trip on the (rows, N) buffer: the server sees the
fp32 decode C(u_i), which enters the round's aggregation unchanged
(decompress-before-reduce). `bf16` and `int8` quantize, `topk`
sparsifies; with error feedback each client carries the residual
e_i = u_i - C(u_i) into its next upload, so the codec error telescopes
instead of accumulating.

* The identity codec never touches a round: the engine resolves
  ``compression="none"`` without error feedback to no compressor, so the
  round is the uncompressed one bit for bit. The codec object still
  prices the uncompressed wire for the byte-accurate clock.
* The wire carries the ``n`` logical lanes only; `api.compress_upload`
  re-zeros the lane-padded tail after the decode, since affine int8
  decodes 0 to lo + q*scale.
* The stochastic codecs draw their noise on the device from the
  reference's threefry chains (`prng.randint_u32_t`, `prng.uniform_t`)
  with one key a client row, so the round reads nothing back to the host
  and a captured chunk can run it.

Wire-byte model (`wire_bytes`): a fixed ``HEADER_BYTES`` a message plus
the payload: ``none`` 4n, ``bf16`` 2n, ``int8`` n + 8 (a row's fp32
scale and zero-point), ``topk`` 8k (a 4-byte lane index and a 4-byte
fp32 value a kept lane).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import prng

# Fixed per-upload framing overhead (client id, round index, codec tag).
HEADER_BYTES = 8

COMPRESSORS = ("none", "bf16", "int8", "topk")


def round_key(rng, round_idx):
    """The round's stochastic-rounding base key: the round counter folded
    into the algorithm's key WITHOUT advancing its stream, so the
    selection split is the same whatever the codec. `rng` is the host's
    (2,) uint32 key and `round_idx` an int: the result is a (2,) uint32
    numpy key (`prng.fold_in`); the engine's chunked driver computes a
    chunk's keys this way on the host and uploads them."""
    return prng.fold_in(rng, int(round_idx))


class Compressor:
    """Base codec: a pure encode+decode round trip on a (rows, N) buffer.

    ``error_feedback`` tells the engine to carry the per-client residual
    (``state["ef"]``, one more (m, N) flat client buffer, which every
    store carries like the others) and `api.compress_upload` to fold it
    into the upload. ``stochastic`` codecs take per-row keys, made from
    global row ids, so the three stores draw the same noise."""

    name = "abstract"
    stochastic = False

    def __init__(self, error_feedback: bool = False):
        self.error_feedback = bool(error_feedback)

    @property
    def identity(self) -> bool:
        """True when decode(encode(u)) == u bitwise for every u: the
        engine drops an identity codec without error feedback from the
        round altogether."""
        return False

    def encode_decode(self, u: torch.Tensor, *,
                      keys: Optional[torch.Tensor] = None,
                      n: Optional[int] = None) -> torch.Tensor:
        """The server-visible decode of each row of `u`. `keys`: (rows, 2)
        int64 threefry keys (stochastic codecs only). `n`: the LOGICAL
        lane count (`spec.size`), which a codec that sizes its payload
        from the model (top-k) must use instead of the padded width."""
        raise NotImplementedError

    def wire_bytes(self, n: int) -> int:
        """Exact uplink bytes of one client's upload of n logical lanes
        (header and payload; the padded tail is never sent)."""
        raise NotImplementedError

    def __repr__(self):
        ef = ", error_feedback=True" if self.error_feedback else ""
        return f"{type(self).__name__}({self.name!r}{ef})"


class NoneCompressor(Compressor):
    """The fp32 uplink. Exists so the byte clock can price the
    uncompressed wire; the engine never routes a round through it."""

    name = "none"

    @property
    def identity(self) -> bool:
        return True

    def encode_decode(self, u, *, keys=None, n=None):
        return u

    def wire_bytes(self, n: int) -> int:
        return HEADER_BYTES + 4 * n


class Bf16Compressor(Compressor):
    """bfloat16 quantization, 2 bytes a lane. ``rounding="nearest"`` is
    the round-to-nearest-even cast (XLA's, bit for bit);
    ``"stochastic"`` adds 16 uniform noise bits to the fp32 bit pattern
    and truncates the low 16, so E[C(u)] = u. Values already on the bf16
    lattice (zeros too) come back exactly under both."""

    name = "bf16"

    def __init__(self, error_feedback: bool = False,
                 rounding: str = "nearest"):
        super().__init__(error_feedback)
        if rounding not in ("nearest", "stochastic"):
            raise ValueError(
                f"bf16 rounding must be 'nearest' or 'stochastic', "
                f"got {rounding!r}")
        self.rounding = rounding

    @property
    def stochastic(self) -> bool:
        return self.rounding == "stochastic"

    def encode_decode(self, u, *, keys=None, n=None):
        if self.rounding == "nearest":
            return u.to(torch.bfloat16).to(u.dtype)
        assert keys is not None, "stochastic bf16 needs per-row keys"
        # the uint32 sum of the reference, in int64 lanes: the carry into
        # bit 32 falls off with the mask, as the uint32 add wraps
        bits = u.to(torch.float32).view(torch.int32).to(torch.int64)
        noise = prng.randint_u32_t(keys, u.shape[-1], 0, 1 << 16)
        out = (bits + noise) & 0xFFFF0000
        return out.to(torch.int32).view(torch.float32).to(u.dtype)

    def wire_bytes(self, n: int) -> int:
        return HEADER_BYTES + 2 * n


class Int8Compressor(Compressor):
    """Per-row affine 8-bit quantization: a row maps onto 256 levels
    between its minimum (the zero-point) and maximum, q = round((u -
    lo)/scale) in [0, 255], decoded lo + q*scale; 1 byte a lane plus the
    two fp32 row constants. The decode error is at most scale/2 under
    nearest rounding and below scale under stochastic rounding
    (floor(t + U[0, 1)), unbiased). A constant row (scale 0) decodes
    exactly. `lo` and `hi` range over the whole lane-padded row, padding
    zeros included, as the reference's."""

    name = "int8"

    def __init__(self, error_feedback: bool = False,
                 rounding: str = "stochastic"):
        super().__init__(error_feedback)
        if rounding not in ("nearest", "stochastic"):
            raise ValueError(
                f"int8 rounding must be 'nearest' or 'stochastic', "
                f"got {rounding!r}")
        self.rounding = rounding

    @property
    def stochastic(self) -> bool:
        return self.rounding == "stochastic"

    def quantize(self, u, keys=None):
        """The encode: (q, lo, scale), q the float32 levels in [0, 255]
        and lo, scale (rows, 1)."""
        f = u.to(torch.float32)
        lo = torch.amin(f, dim=-1, keepdim=True)
        hi = torch.amax(f, dim=-1, keepdim=True)
        # a tensor divisor: PyTorch's CUDA division by a Python scalar
        # multiplies by its reciprocal, which rounds apart from the IEEE
        # division the reference (and the CPU) make
        scale = (hi - lo) / torch.full_like(hi, 255.0)
        safe = torch.where(scale > 0, scale, 1.0)
        t = (f - lo) / safe
        if self.rounding == "stochastic":
            assert keys is not None, "stochastic int8 needs per-row keys"
            q = torch.floor(t + prng.uniform_t(keys, u.shape[-1]))
        else:
            q = torch.round(t)  # half to even, as jnp.round
        return torch.clamp(q, 0.0, 255.0), lo, scale

    def encode_decode(self, u, *, keys=None, n=None):
        q, lo, scale = self.quantize(u, keys)
        # lo + q*scale in two roundings; XLA:CPU fuses them into one FMA,
        # so the reference's decode is within an ulp of this one
        dec = lo + q * torch.where(scale > 0, scale, 0.0)
        return dec.to(u.dtype)

    def wire_bytes(self, n: int) -> int:
        return HEADER_BYTES + 8 + n  # fp32 scale + zero-point, 1B/lane


class TopKCompressor(Compressor):
    """Magnitude top-k sparsification: each row keeps its k largest-|.|
    lanes exactly and zeroes the rest; the wire carries k (index, value)
    pairs. k = max(1, round(frac * n)) over the LOGICAL lane count. Ties
    go to the lower lane, as `jax.lax.top_k`'s: the kept set is the head
    of a stable descending sort of |u| (`torch.topk` promises no order
    among equal values). A padded-tail zero is kept only when a row has
    fewer than k nonzeros, and then decodes to 0 all the same."""

    name = "topk"

    def __init__(self, frac: float = 0.1, error_feedback: bool = False):
        super().__init__(error_feedback)
        if not (0.0 < frac <= 1.0):
            raise ValueError(f"topk frac must be in (0, 1], got {frac}")
        self.frac = float(frac)

    def k_for(self, n: int) -> int:
        return max(1, min(n, int(round(self.frac * n))))

    def kept(self, u, n=None) -> torch.Tensor:
        """The (rows, k) lanes each row keeps, lowest lane first among
        equal magnitudes."""
        k = self.k_for(n if n is not None else u.shape[-1])
        flat = u.reshape(-1, u.shape[-1])
        order = torch.sort(torch.abs(flat), dim=-1, descending=True,
                           stable=True).indices
        return order[:, :k]

    def encode_decode(self, u, *, keys=None, n=None):
        flat = u.reshape(-1, u.shape[-1])
        idx = self.kept(flat, n)
        dec = torch.zeros_like(flat).scatter_(
            -1, idx, torch.gather(flat, -1, idx))
        return dec.reshape(u.shape)

    def wire_bytes(self, n: int) -> int:
        return HEADER_BYTES + 8 * self.k_for(n)  # 4B index + 4B value


def downlink_bytes(n: int) -> int:
    """A client's download of the fresh x̄: fp32, never compressed."""
    return HEADER_BYTES + 4 * n


def uplink_bytes(compressor: Optional[Compressor], n: int) -> int:
    """A client's upload bytes under `compressor` (None: raw fp32)."""
    if compressor is None:
        return NoneCompressor().wire_bytes(n)
    return compressor.wire_bytes(n)


def make_compressor(name: str, *, error_feedback: bool = False,
                    topk_frac: float = 0.1,
                    rounding: Optional[str] = None) -> Compressor:
    """CLI-level factory (`run_rounds(compression=...)`, `--compression`).
    ``rounding=None`` keeps each codec's default (bf16: nearest, int8:
    stochastic)."""
    if name == "none":
        if error_feedback:
            raise ValueError(
                "error feedback with the identity codec is a residual "
                "that is always zero — drop --error-feedback or pick a "
                "lossy codec (bf16/int8/topk)")
        return NoneCompressor()
    if name == "bf16":
        kw = {} if rounding is None else {"rounding": rounding}
        return Bf16Compressor(error_feedback, **kw)
    if name == "int8":
        kw = {} if rounding is None else {"rounding": rounding}
        return Int8Compressor(error_feedback, **kw)
    if name == "topk":
        return TopKCompressor(topk_frac, error_feedback)
    raise KeyError(f"unknown compression {name!r}: {COMPRESSORS}")


def as_compressor(compression, *, error_feedback: bool = False,
                  topk_frac: float = 0.1) -> Optional[Compressor]:
    """Engine-boundary resolution: None passes through, a string goes
    through `make_compressor`, a `Compressor` is used as it is (its
    ``error_feedback`` and ``frac`` then hold)."""
    if compression is None:
        if error_feedback:
            raise ValueError(
                "error_feedback=True needs a lossy compression codec "
                "(bf16/int8/topk)")
        return None
    if isinstance(compression, Compressor):
        return compression
    return make_compressor(compression, error_feedback=error_feedback,
                           topk_frac=topk_frac)
