"""The port's flash attention module against the JAX package's.

Mirrors tests/test_kernels.py's flash attention tests: the same four
shapes in float32 and bfloat16, inputs made with numpy from a seed. The
port's wrapper on CPU tensors runs its plain version (the full softmax of
`ref.py`); it is held to the JAX full-softmax oracle, to the port's own
`blocked_attention` and to the Pallas kernel run in interpret mode. The
CUDA kernel cannot run here; chip_smoke.py holds it to the same plain
version on the card. Tolerances are the reference's kernel-vs-oracle
ones: 2e-5 in float32 (the sums run in other orders), 2.5e-2 in bfloat16
(one bf16 rounding of outputs of size ~1).

The interpret-mode kernel runs alone in a fresh subprocess, once for
every case (`interpret_outputs`): in a full tier-1 run it shares its
worker with the reference's tests, and there it once came out 6.3e-5
from the port's float32 output (174 of 65536 elements past 2e-5) where
it is 4.8e-7 on its own, a state that the worker's earlier tests leave
in the process; the port itself is held in-process to the oracle and to
`blocked_attention`, first.
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_ref as jax_flash_ref
from repro.models.attention import blocked_attention as jax_blocked
from repro_torch.kernels.flash_attention import ops
from repro_torch.models.attention import blocked_attention

SHAPES = [
    (2, 4, 4, 128, 64, None, 64, 64),
    (1, 8, 2, 200, 64, None, 64, 64),   # GQA, unaligned seq
    (2, 4, 1, 192, 128, None, 128, 64), # MQA
    (1, 4, 4, 256, 64, 64, 64, 64),     # sliding window
    (1, 4, 2, 160, 160, None, 64, 64),  # head_dim 160 (stablelm-12b's)
]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2.5e-2)}


def _inputs(seed, B, H, Kv, S, hd, jdt):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((B, n, S, hd)) for n in (H, Kv, Kv)]
    # round through the dtype once, so both packages see the same values
    return [np.array(jnp.asarray(a, jdt).astype(jnp.float32)) for a in arrs]


# the Pallas kernel in interpret mode for every case, in a fresh process
# (no XLA_FLAGS, nothing of another test's state), saved to an npz
_INTERPRET = """
import sys
import jax.numpy as jnp
import numpy as np
from repro.kernels.flash_attention import flash_attention
from test_torch_flash_attention import DTYPES, SHAPES, _inputs

out = {}
for dtype, (jdt, _, _) in DTYPES.items():
    for B, H, Kv, S, hd, window, bq, bk in SHAPES:
        q, k, v = (jnp.asarray(a, jdt)
                   for a in _inputs(S + hd, B, H, Kv, S, hd, jdt))
        o = flash_attention(q, k, v, window=window, interpret=True,
                            block_q=bq, block_k=bk)
        out[f"{dtype}-{B}-{H}-{Kv}-{S}-{hd}"] = np.asarray(o, np.float32)
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def interpret_outputs(tmp_path_factory):
    here = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(here, "..", "src"), here])
    path = tmp_path_factory.mktemp("flash") / "interpret.npz"
    subprocess.run([sys.executable, "-c", _INTERPRET, str(path)], env=env,
                   check=True, timeout=600)
    with np.load(path) as data:
        return dict(data)


def _close(got, want, tol, what):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol, err_msg=what)


@pytest.mark.parametrize("B,H,Kv,S,hd,window,bq,bk", SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_attention_matches_reference(B, H, Kv, S, hd, window, bq, bk,
                                           dtype, interpret_outputs):
    jdt, tdt, tol = DTYPES[dtype]
    arrs = _inputs(S + hd, B, H, Kv, S, hd, jdt)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in arrs)
    q, k, v = (torch.from_numpy(a).to(tdt) for a in arrs)
    out = ops.flash_attention(q, k, v, window=window)
    assert out.dtype == tdt and out.shape == q.shape
    assert ops.launches["flash_attention"] == 0  # the plain version ran
    _close(out, jax_flash_ref(jq, jk, jv, window=window), tol,
           "vs JAX oracle")
    # the model's own streaming softmax, in its (B,S,H,hd) layout
    pos = torch.arange(S)
    blocked = blocked_attention(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), pos, pos, window=window,
                                block_k=bk).transpose(1, 2)
    _close(out, blocked.float().numpy(), tol, "vs port blocked_attention")
    _close(out, interpret_outputs[f"{dtype}-{B}-{H}-{Kv}-{S}-{hd}"], tol,
           "vs Pallas kernel (interpret, in a fresh process)")


# the new slice's GQA groups: Hymba's group of 5 (25 heads over 5; here
# 10 over 2) on a ragged length, and MusicGen's plain MHA (group 1)
GROUPS = [(1, 10, 2, 75, 64), (2, 4, 4, 61, 64), (1, 5, 5, 40, 128)]


@pytest.mark.parametrize("B,H,Kv,S,hd", GROUPS)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_version_at_groups_5_and_1_matches_blocked_attention(
        B, H, Kv, S, hd, dtype):
    """The wrapper's plain version (what the kernel is held to on the card)
    against the reference's `blocked_attention`, the model's own
    attention, in its (B,S,H,hd) layout, at the tolerances above."""
    jdt, tdt, tol = DTYPES[dtype]
    arrs = _inputs(S + H, B, H, Kv, S, hd, jdt)
    q, k, v = (torch.from_numpy(a).to(tdt) for a in arrs)
    out = ops.flash_attention(q, k, v)
    assert out.dtype == tdt and ops.launches["flash_attention"] == 0
    pos = jnp.arange(S, dtype=jnp.int32)
    want = jax_blocked(*(jnp.asarray(a, jdt).swapaxes(1, 2) for a in arrs),
                       pos, pos, block_k=32).swapaxes(1, 2)
    _close(out, want, tol, "vs the reference's blocked_attention")


def test_blocked_attention_matches_reference_over_a_ring_cache():
    """The decode form: one query against a cache whose slots are out of
    order and partly empty (slot_pos -1), with a window."""
    rng = np.random.default_rng(7)
    B, H, Kv, T, hd = 2, 4, 2, 40, 32
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, T, Kv, hd)).astype(np.float32)
    v = rng.standard_normal((B, T, Kv, hd)).astype(np.float32)
    slot = np.full(T, -1, np.int32)
    slot[:30] = (np.arange(30) + 17) % 30 + 5  # positions 5..34, wrapped
    qpos = np.array([34], np.int32)
    want = jax_blocked(*map(jnp.asarray, (q, k, v, qpos, slot)), window=20,
                       block_k=16)
    got = blocked_attention(*map(torch.from_numpy, (q, k, v, qpos, slot)),
                            window=20, block_k=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("case,match", [
    (dict(hd=32), "head_dim"),
    (dict(kdtype=torch.float16), "dtype"),
    (dict(T=96), "S == T"),
    (dict(Kv=3), "H % Kv"),
    (dict(), "CUDA"),
])
def test_kernel_path_validates_and_never_falls_back(case, match):
    """A tensor that is not on the CPU goes to the kernel path, which
    checks shape, dtype and device and raises: nothing quietly runs the
    plain version instead."""
    hd, T, Kv = case.get("hd", 64), case.get("T", 128), case.get("Kv", 2)
    q = torch.empty((1, 4, 128, hd), device="meta")
    k = torch.empty((1, Kv, T, hd), device="meta",
                    dtype=case.get("kdtype", torch.float32))
    with pytest.raises(ValueError, match=match):
        ops.flash_attention(q, k, k.clone())
    assert ops.launches["flash_attention"] == 0


def _meta_bf16(B, H, S, hd, seq_stride=None, offset=0):
    """A (B,H,S,hd) bfloat16 meta tensor laid out as the model's
    transposed (B,S,H,hd) view, with a chosen sequence stride and a
    storage offset in elements."""
    ss = H * hd if seq_stride is None else seq_stride
    flat = torch.empty(B * S * ss + offset, device="meta",
                       dtype=torch.bfloat16)
    return flat.as_strided((B, H, S, hd), (S * ss, hd, ss, 1), offset)


@pytest.mark.parametrize("what,match", [
    ("misaligned q", "16-byte boundary"),
    ("misaligned v", "16-byte boundary"),
    ("sequence stride", "multiples of 8 elements"),
    ("head_dim 96", "head_dim"),
    ("head_dim 32", "head_dim"),
])
def test_bf16_kernel_checks_its_tma_layout_and_never_falls_back(what, match):
    """The bfloat16 kernel reads q, k, v by TMA: a base pointer or a stride
    off 16 bytes, or a head_dim without a form, raises before anything
    runs, on the kernel path (meta tensors take it)."""
    hd = {"head_dim 96": 96, "head_dim 32": 32}.get(what, 64)
    q = _meta_bf16(1, 4, 130, hd, offset=4 if what == "misaligned q" else 0,
                   seq_stride=4 * hd + 4 if what == "sequence stride" else None)
    k = _meta_bf16(1, 2, 130, hd)
    v = _meta_bf16(1, 2, 130, hd, offset=1 if what == "misaligned v" else 0)
    with pytest.raises(ValueError, match=match):
        ops.flash_attention(q, k, v)
    assert ops.launches["flash_attention"] == 0


@pytest.mark.parametrize("seq_stride", [None, 32 * 160])
def test_bf16_kernel_takes_head_dim_160(seq_stride):
    """head_dim 160 (stablelm-12b: 5120 / 32) has a bfloat16 form: the
    model's transposed views pass the TMA checks (row strides of 320
    bytes) and stop only at the device, where the kernel path would run
    (a meta tensor has none). It raised at the head_dim check before
    the form existed."""
    q = _meta_bf16(2, 32, 130, 160, seq_stride=seq_stride)
    k = _meta_bf16(2, 8, 130, 160)
    assert ops.TILES[(torch.bfloat16, 160)] == (128, 64)
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(q, k, k.clone())
    assert ops.launches["flash_attention"] == 0


def test_tma_layout_checks_are_bf16_only():
    """float32 keeps the CUDA-core body, which takes any strides: the same
    odd layout passes the layout checks and stops only at the device."""
    flat = torch.empty(4 * 130 * 260 + 1, device="meta")
    q = flat.as_strided((1, 4, 130, 64), (130 * 260, 64, 260, 1), 1)
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(q, q, q)


def test_tma_strides_of_the_models_transposed_views():
    """The model's (B,S,H,hd) tensors, transposed to (B,H,S,hd), give TMA
    byte strides (s, h, b), innermost first."""
    B, S, H, hd = 2, 130, 32, 64
    q = torch.empty((B, S, H, hd), dtype=torch.bfloat16).transpose(1, 2)
    assert ops.tma_strides(q) == (H * hd * 2, hd * 2, S * H * hd * 2)
    kv = torch.empty((B, S, 4, 128), dtype=torch.bfloat16).transpose(1, 2)
    assert ops.tma_strides(kv) == (4 * 128 * 2, 128 * 2, S * 4 * 128 * 2)


def _visible(S, causal, window):
    i = np.arange(S)[:, None]
    j = np.arange(S)[None, :]
    m = np.ones((S, S), bool)
    if causal:
        m &= j <= i
    if window is not None:
        m &= i - j < window
    return m


@pytest.mark.parametrize("S", [1, 127, 128, 130, 300, 1000])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 256),
                                           (True, 64), (False, None),
                                           (False, 100)])
@pytest.mark.parametrize("dtype,hd", [(torch.bfloat16, 64),
                                      (torch.bfloat16, 128),
                                      (torch.float32, 64)])
def test_kv_tiles_cover_every_visible_key_and_skip_only_hidden_tiles(
        S, causal, window, dtype, hd):
    """The tile skip of each form of the kernel, ragged edges included:
    the key tiles a block walks hold every key visible to its queries,
    and each tile it skips holds none; its first and last tiles hold
    some."""
    bq, bk = ops.TILES[(dtype, hd)]
    vis = _visible(S, causal, window)
    for qt in range(-(-S // bq)):
        rows = vis[qt * bq:(qt + 1) * bq]
        lo, hi = ops.kv_tiles(qt, S, bq, bk, causal, window)
        assert 0 <= lo < hi <= -(-S // bk)
        for kt in range(-(-S // bk)):  # no tile with a visible key skipped
            if rows[:, kt * bk:(kt + 1) * bk].any():
                assert lo <= kt < hi, (qt, kt)
        assert rows[:, lo * bk:(lo + 1) * bk].any()
        assert rows[:, (hi - 1) * bk:hi * bk].any()


@pytest.mark.parametrize("S", [1, 130, 2048, 2100])
def test_reversed_query_tiles_put_the_heaviest_causal_blocks_first(S):
    """The bfloat16 kernel's blocks take query tiles in reverse
    (gridDim.x - 1 - blockIdx.x): a causal grid's work then falls along
    the launch order, and its tail is the lightest tiles."""
    bq, bk = ops.TILES[(torch.bfloat16, 64)]
    order = range(-(-S // bq) - 1, -1, -1)
    work = [hi - lo for lo, hi in (ops.kv_tiles(qt, S, bq, bk)
                                   for qt in order)]
    assert work == sorted(work, reverse=True) and work[-1] == 1
