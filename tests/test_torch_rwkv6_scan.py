"""The port's RWKV-6 scan module against the JAX package's.

Mirrors tests/test_kernels.py's rwkv6_scan tests: the same three shapes
in float32 and bfloat16 r, k, v (w and u float32), inputs made with
numpy from a seed. The port's wrapper on CPU tensors runs its plain
version (the per-step recurrence of `ref.py`); it is held to the Pallas
kernel run in interpret mode and to the JAX oracle. The CUDA kernel
cannot run here; chip_smoke.py holds it to the same plain version on the
card. Tolerances are the reference's: y to 1e-4 in float32 and 3e-2 in
bfloat16 (one bf16 rounding of y), the fp32 state to rtol 1e-4 /
atol 1e-3 (the sums run in other orders). The model's own recurrence
(`models.rwkv.wkv6_scan`, which decode runs from a carried state) is
held to the JAX model's at 1e-5 and to the kernel's plain version across
chunk boundaries.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv6_scan import rwkv6_scan as jax_scan
from repro.kernels.rwkv6_scan import rwkv6_scan_ref as jax_scan_ref
from repro.models.rwkv import wkv6_scan as jax_wkv6_scan
from repro_torch.kernels.rwkv6_scan import ops, rwkv6_scan_ref
from repro_torch.models.rwkv import wkv6_scan

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _inputs(seed, B, H, T, hd, jdt=jnp.float32, scale=0.5, wlo=0.85):
    rng = np.random.default_rng(seed)
    r, k, v = (np.array(jnp.asarray(rng.standard_normal((B, H, T, hd))
                                    * scale, jdt).astype(jnp.float32))
               for _ in range(3))
    w = rng.uniform(wlo, 0.999, (B, H, T, hd)).astype(np.float32)
    u = (rng.standard_normal((H, hd)) * scale).astype(np.float32)
    return r, k, v, w, u


@pytest.mark.parametrize("B,H,T,hd,bt",
                         [(2, 3, 64, 32, 32), (1, 4, 100, 64, 64),
                          (2, 2, 128, 64, 16)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rwkv6_scan_matches_reference(B, H, T, hd, bt, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    r, k, v, w, u = _inputs(T + hd, B, H, T, hd, jdt)
    jr, jk, jv = (jnp.asarray(a, jdt) for a in (r, k, v))
    y, s = ops.rwkv6_scan(*(torch.from_numpy(a).to(tdt) for a in (r, k, v)),
                          torch.from_numpy(w), torch.from_numpy(u))
    assert y.dtype == tdt and s.dtype == torch.float32
    assert tuple(s.shape) == (B, H, hd, hd)
    assert ops.launches["rwkv6_scan"] == 0  # the plain version ran
    for yk, sk, what in (
            (*jax_scan(jr, jk, jv, jnp.asarray(w), jnp.asarray(u),
                       interpret=True, block_t=bt), "Pallas kernel"),
            (*jax_scan_ref(jr, jk, jv, jnp.asarray(w), jnp.asarray(u)),
             "JAX oracle")):
        np.testing.assert_allclose(y.float().numpy(),
                                   np.asarray(yk, np.float32), rtol=tol,
                                   atol=tol, err_msg=f"y vs {what}")
        np.testing.assert_allclose(s.numpy(), np.asarray(sk), rtol=1e-4,
                                   atol=1e-3, err_msg=f"state vs {what}")


def test_rwkv6_state_carry_is_chunk_invariant():
    """The kernel's plain version from a zero state equals the model's
    step-by-step recurrence run in chunks that carry the state (how a
    prefill followed by decode steps splits the sequence), whatever the
    split."""
    B, H, T, hd = 1, 2, 96, 32
    r, k, v, w, u = (torch.from_numpy(a) for a in
                     _inputs(3, B, H, T, hd, scale=0.3, wlo=0.9))
    y, s = rwkv6_scan_ref(r, k, v, w, u)
    tm = [a.transpose(1, 2) for a in (r, k, v, w)]  # the model's (B,T,H,hd)
    for split in (16, 48):
        state = torch.zeros((B, H, hd, hd))
        ys = []
        for lo, hi in ((0, split), (split, T)):
            yc, state = wkv6_scan(*(a[:, lo:hi] for a in tm), u, state)
            ys.append(yc)
        np.testing.assert_allclose(state.numpy(), s.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=f"split {split}")
        np.testing.assert_allclose(torch.cat(ys, 1).transpose(1, 2).numpy(),
                                   y.numpy(), rtol=1e-5, atol=1e-5)


def test_model_recurrence_matches_reference_from_a_carried_state():
    """The decode path's recurrence, from a nonzero state, against the
    JAX model's `wkv6_scan`."""
    B, H, T, hd = 2, 3, 5, 16
    rng = np.random.default_rng(11)
    r, k, v = (rng.standard_normal((B, T, H, hd)).astype(np.float32) * 0.5
               for _ in range(3))
    w = rng.uniform(0.85, 0.999, (B, T, H, hd)).astype(np.float32)
    u = rng.standard_normal((H, hd)).astype(np.float32) * 0.5
    s0 = rng.standard_normal((B, H, hd, hd)).astype(np.float32)
    yj, sj = jax_wkv6_scan(*map(jnp.asarray, (r, k, v, w, u, s0)))
    y, s = wkv6_scan(*map(torch.from_numpy, (r, k, v, w, u, s0)))
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(sj), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("case,match", [
    (dict(hd=48), "head_dim"),
    (dict(wdtype=torch.bfloat16), "float32"),
    (dict(ushape=(3, 64)), "u must be"),
    (dict(), "CUDA"),
])
def test_kernel_path_validates_and_never_falls_back(case, match):
    """A tensor that is not on the CPU goes to the kernel path, which
    checks shape, dtype and device and raises: nothing quietly runs the
    plain version instead."""
    hd = case.get("hd", 64)
    r = torch.empty((1, 2, 10, hd), device="meta")
    w = torch.empty((1, 2, 10, hd), device="meta",
                    dtype=case.get("wdtype", torch.float32))
    u = torch.empty(case.get("ushape", (2, hd)), device="meta")
    with pytest.raises(ValueError, match=match):
        ops.rwkv6_scan(r, r, r, w, u)
    assert ops.launches["rwkv6_scan"] == 0


@pytest.mark.parametrize("what,match", [
    ("misaligned r", "16-byte boundary"),
    ("misaligned w", "16-byte boundary"),
    ("odd t stride", "multiples of 16 bytes"),
])
def test_kernel_checks_its_copy_alignment_and_never_falls_back(what, match):
    """The kernel stages r, k, v, w by 16-byte copies: a start or a stride
    off 16 bytes raises on the kernel path (meta tensors take it)."""
    B, H, T, hd = 1, 2, 10, 64
    ts = H * hd + (2 if what == "odd t stride" else 0)

    def make(offset=0):
        flat = torch.empty(B * T * ts + offset, device="meta")
        return flat.as_strided((B, H, T, hd), (T * ts, hd, ts, 1), offset)

    r = make(1 if what == "misaligned r" else 0)
    w = make(3 if what == "misaligned w" else 0)
    u = torch.empty((H, hd), device="meta")
    with pytest.raises(ValueError, match=match):
        ops.rwkv6_scan(r, make(), make(), w, u)
    assert ops.launches["rwkv6_scan"] == 0


@pytest.mark.parametrize("hd", ops.HEAD_DIMS)
def test_column_split_gives_each_state_entry_one_owner(hd):
    """The kernel's split of a head's state: every entry S[i][j] has one
    (block, thread, register); the 16 lanes of a half-warp share their key
    rows, and a thread's two columns are 16 apart. At head_dim 32 one
    block holds the whole head, fewer columns than hd 64's two groups."""
    split = ops.column_split(hd)
    assert split.threads == 256 and split.groups == hd // 32
    owners = {}
    for i in range(hd):
        for j in range(hd):
            g, t, reg = split.owner(i, j)
            assert 0 <= g < split.groups and 0 <= t < split.threads
            assert 0 <= reg < 2 * split.rows
            owners.setdefault((g, t), []).append((i, j))
    assert len(owners) == split.groups * split.threads
    for (g, t), cells in owners.items():
        assert len(cells) == 2 * split.rows  # rows x two columns
        cols = sorted({j for _, j in cells})
        assert cols[1] - cols[0] == 16
        assert {i // split.rows for i, _ in cells} == {2 * (t // 32)
                                                        + t % 32 // 16}


def test_column_split_puts_4x_the_warps_of_one_block_per_head():
    """At the RWKV-6-3B prefill (B 4, H 40, hd 64) the split launches 2560
    warps, eight times the 320 of one 64-thread block per head."""
    assert ops.column_split(64).warps(4, 40) == 2560 >= 4 * 4 * 40 * 2
