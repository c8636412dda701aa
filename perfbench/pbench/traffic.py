"""The benchmark's inputs, made from `--seed` on the run's device: the
paper's Example V.1 least-squares mixture, the transformer's weights and
its token stream. Every draw comes from one `torch.Generator` on the
device (the client sizes from a numpy generator on the host), in a fixed
order, so one seed gives the same tensors on one device. The port and
the reference are handed the same tensors."""
from __future__ import annotations

import math

import numpy as np
import torch


def _gen(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def client_sizes(seed: int, d: int, m: int, rows: int) -> np.ndarray:
    """Heterogeneous client sizes d_i in [floor(d/2m), rows], summing to
    d (Example V.1: d_i ~ uniform around d/m, here lo = 0.5 d/m and hi =
    1.5 d/m, which `rows` is). Uniform draws, then whole sweeps of ±1
    on random clients still inside the range until the sum is d."""
    rng = np.random.default_rng(int(seed))
    lo = max(1, int(0.5 * d / m))
    if not (lo * m <= d <= rows * m):
        raise ValueError(f"d={d} rows cannot split over m={m} clients of "
                         f"{lo}..{rows} rows")
    sizes = rng.integers(lo, rows + 1, size=m)
    while (gap := int(sizes.sum()) - d) != 0:
        step = 1 if gap < 0 else -1
        cand = np.flatnonzero(sizes < rows if gap < 0 else sizes > lo)
        pick = rng.choice(cand, size=min(abs(gap), len(cand)), replace=False)
        sizes[pick] += step
    return sizes


def lsq_mixture(seed: int, d: int, n: int, m: int, rows: int, device):
    """Example V.1 on the device: d samples with n features, a third
    each standard normal, Student's t with 5 degrees of freedom and
    uniform on [-5, 5], rows shuffled; b = A x* + 0.1 noise; split over m
    clients of `client_sizes` rows each, padded with zero rows to `rows`.
    Returns {"A": (m, rows, n), "b": (m, rows), "mask": (m, rows)}, all
    float32."""
    g = _gen(seed, device)
    f32 = torch.float32
    t = [d // 3, d // 3, d - 2 * (d // 3)]
    A = torch.empty((d, n), dtype=f32, device=device)
    A[:t[0]].normal_(generator=g)
    # t(5) = Z / sqrt(chi2_5 / 5), chi2_5 the sum of 5 squared normals
    part = A[t[0]:t[0] + t[1]]
    part.normal_(generator=g)
    chi = torch.zeros_like(part)
    for _ in range(5):
        chi.add_(torch.randn(part.shape, generator=g, device=device,
                             dtype=f32).square_())
    part.div_(chi.div_(5.0).sqrt_())
    del chi
    A[t[0] + t[1]:].uniform_(-5.0, 5.0, generator=g)
    A = A[torch.randperm(d, generator=g, device=device)]
    x_star = torch.randn(n, generator=g, device=device, dtype=f32)
    b = A @ x_star + 0.1 * torch.randn(d, generator=g, device=device,
                                       dtype=f32)
    sizes = torch.as_tensor(client_sizes(seed, d, m, rows), device=device)
    starts = torch.cumsum(sizes, 0) - sizes
    slot = torch.arange(rows, device=device)
    mask = slot[None, :] < sizes[:, None]
    idx = torch.where(mask, starts[:, None] + slot[None, :], 0)
    maskf = mask.to(f32)
    A_pad = A[idx]
    A_pad.mul_(maskf[..., None])
    return {"A": A_pad, "b": b[idx] * maskf, "mask": maskf}


def weights(layout, seed: int, device, dtype=torch.bfloat16):
    """The transformer's weights from the seed, in `dtype`, made in one
    draw: one flat buffer of standard normals, carved into the leaves of
    `layout` ({name: (shape, init)}), each scaled by its init: ("normal",
    std), ("ones",) or ("zeros",). Returns {name: tensor} views of that
    buffer, in `layout`'s order."""
    total = sum(math.prod(shape) for shape, _ in layout.values())
    flat = torch.empty(total, dtype=dtype, device=device)
    flat.normal_(generator=_gen(seed, device))
    out, off = {}, 0
    for name, (shape, init) in layout.items():
        size = math.prod(shape)
        leaf = flat[off:off + size].view(shape)
        off += size
        if init[0] == "normal":
            leaf.mul_(init[1])
        else:
            leaf.fill_(1.0 if init[0] == "ones" else 0.0)
        out[name] = leaf
    return out


def token_stream(seed: int, vocab: int, m: int, seqs: int, seq_len: int,
                 device) -> torch.Tensor:
    """(m, seqs, seq_len + 1) int32 tokens with a planted bigram per
    client (non-i.i.d. clients): tokens uniform on the vocabulary, and
    at half the positions, drawn at random, the token is the one before
    plus the client's shift (mod vocab), so the loss can fall. Drawn
    after the weights from a generator of its own (seed + 1)."""
    g = _gen(int(seed) + 1, device)
    shift = torch.randint(1, max(vocab // 2, 2), (m, 1), generator=g,
                          device=device)
    toks = torch.randint(0, vocab, (m, seqs, seq_len + 1), generator=g,
                         device=device)
    follow = torch.rand((m, seqs, seq_len), generator=g,
                        device=device) < 0.5
    for j in range(seq_len):
        nxt = (toks[:, :, j] + shift) % vocab
        toks[:, :, j + 1] = torch.where(follow[:, :, j], nxt,
                                        toks[:, :, j + 1])
    return toks.to(torch.int32)
