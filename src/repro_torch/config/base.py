"""The port's configs: `ModelConfig` for the serving path, the four input
shapes of the planning dry run (`ShapeConfig`, `INPUT_SHAPES`) and the
`FedConfig` fields that the flat rounds of the five algorithms read
(counterparts of `repro/config/base.py::ModelConfig`, `::ShapeConfig`,
`::INPUT_SHAPES` and `::FedConfig`, same fields and defaults)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

H_POLICIES = ("scalar", "diag_ema", "gram")
ALGORITHMS = ("fedgia", "fedavg", "fedprox", "fedpd", "scaffold")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture definition (decoder-only backbone).

    Families: dense | moe | ssm | hybrid | vlm | audio.
    attention_type: gqa | mla | rwkv | hybrid (parallel attn+mamba heads).
    input_mode: tokens | embeds (audio frontend stub) | tokens+embeds (vlm).
    The port runs the dense GQA and RWKV kinds; the other fields are kept
    so that every config keeps the reference's shape and accounting.
    """

    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # --- MoE ---
    moe: bool = False
    num_experts: int = 0
    experts_per_token: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0  # per-expert hidden dim (0 -> d_ff)
    dense_residual: bool = False  # arctic: dense MLP in parallel with MoE
    first_dense_layers: int = 0  # deepseek-v3: leading dense layers
    router_aux_coef: float = 0.0

    # --- MLA (deepseek-v3) ---
    attention_type: str = "gqa"
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_dim: int = 0
    qk_nope_dim: int = 0
    v_head_dim: int = 0

    # --- SSM / hybrid ---
    ssm_state: int = 0
    rwkv_head_size: int = 64

    # --- long-context policy ---
    sliding_window: int = 8192  # used ONLY when long_context mode is on

    # --- multi-token prediction aux head (deepseek-v3) ---
    mtp: bool = False

    # --- modality frontend stub ---
    input_mode: str = "tokens"
    embed_prefix_len: int = 0  # vlm: number of patch-embedding tokens

    dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True
    source: str = ""  # citation (hf model card / arXiv id)

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.num_heads, 1))
        if self.moe and self.moe_d_ff == 0:
            object.__setattr__(self, "moe_d_ff", self.d_ff)
        if self.num_heads and self.num_heads % max(self.num_kv_heads, 1):
            raise ValueError(
                f"{self.name}: num_heads={self.num_heads} not divisible by "
                f"num_kv_heads={self.num_kv_heads}")

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: 2 layers, d_model<=256, <=4 experts, the
        same family and attention type as the full config."""
        d_model = min(self.d_model, 256)
        n_heads = max(2, min(self.num_heads, 4))
        ratio = max(1, self.num_heads // max(self.num_kv_heads, 1))
        n_kv = max(1, n_heads // min(ratio, n_heads))
        changes = dict(
            name=self.name + "-reduced",
            num_layers=2,
            d_model=d_model,
            num_heads=n_heads,
            num_kv_heads=n_kv,
            head_dim=d_model // n_heads,
            d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 512),
            sliding_window=64,
            embed_prefix_len=min(self.embed_prefix_len, 8),
        )
        if self.moe:
            changes.update(
                num_experts=min(self.num_experts, 4),
                experts_per_token=min(self.experts_per_token, 2),
                moe_d_ff=min(self.moe_d_ff, 256),
                first_dense_layers=min(self.first_dense_layers, 1),
            )
        if self.attention_type == "mla":
            changes.update(
                q_lora_rank=min(self.q_lora_rank, 64),
                kv_lora_rank=min(self.kv_lora_rank, 32),
                qk_rope_dim=16,
                qk_nope_dim=16,
                v_head_dim=d_model // n_heads,
            )
        if self.ssm_state:
            changes.update(ssm_state=min(self.ssm_state, 8))
        return dataclasses.replace(self, **changes)

    def param_count(self) -> int:
        """Analytic parameter count, the reference's formula."""
        d, L, V = self.d_model, self.num_layers, self.vocab_size
        n_emb = V * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.attention_type in ("gqa", "hybrid"):
            hd = self.head_dim
            per_layer += (d * self.num_heads * hd
                          + 2 * d * self.num_kv_heads * hd
                          + self.num_heads * hd * d)
            if self.qkv_bias:
                per_layer += (self.num_heads + 2 * self.num_kv_heads) * hd
        elif self.attention_type == "mla":
            qr = self.q_lora_rank or d
            per_layer += d * qr + qr * self.num_heads * (self.qk_nope_dim
                                                         + self.qk_rope_dim)
            per_layer += d * (self.kv_lora_rank + self.qk_rope_dim)
            per_layer += self.kv_lora_rank * self.num_heads * (
                self.qk_nope_dim + self.v_head_dim)
            per_layer += self.num_heads * self.v_head_dim * d
        if self.attention_type == "rwkv":
            # rwkv6 time-mix: r,k,v,g,o + decay params (approx)
            per_layer += 5 * d * d + 2 * d
        if self.attention_type == "hybrid" and self.ssm_state:
            # mamba head branch: in_proj (x,z), dt, B, C, out_proj (approx)
            per_layer += 2 * d * d + d * self.ssm_state * 2 + d * d
        moe_layers = L - self.first_dense_layers if self.moe else 0
        dense_layers = L - moe_layers
        dense_mlp = 3 * d * self.d_ff
        per_expert = 3 * d * self.moe_d_ff
        total = n_emb + L * per_layer + 2 * d  # final norm + norms approx
        total += dense_layers * dense_mlp
        if self.moe:
            total += moe_layers * (
                self.num_experts * per_expert
                + self.num_shared_experts * per_expert
                + d * self.num_experts  # router
                + (dense_mlp if self.dense_residual else 0)
            )
        return int(total)

    def active_param_count(self) -> int:
        """Activated params per token (MoE: only routed-in experts), the
        reference's formula."""
        if not self.moe:
            return self.param_count()
        per_expert = 3 * self.d_model * self.moe_d_ff
        moe_layers = self.num_layers - self.first_dense_layers
        inactive = moe_layers * per_expert * (
            self.num_experts - self.experts_per_token)
        return int(self.param_count() - inactive)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class FedConfig:
    """Federated-algorithm selection, FedGiA hyper-parameters (paper §V.B)
    and the baselines' (§V.D)."""

    algorithm: str = "fedgia"  # fedgia | fedavg | fedprox | fedpd | scaffold
    num_clients: int = 16
    k0: int = 5  # local steps between communications
    alpha: float = 0.5  # |C| / m, client-selection fraction
    sigma_t: float = 0.15  # sigma = t * r / m (paper Table III)
    lipschitz: float = 1.0  # r, replaced by the model's own when it has one
    auto_lipschitz: bool = False
    h_policy: str = "diag_ema"  # diag_ema | scalar | gram (linear models only)
    collapsed: bool = True  # closed-form k0-step round (the kernel's form)
    # the collapsed round's fused update: None runs the CUDA kernel on the
    # card and its plain version on the CPU; True the kernel (the CPU has
    # none, so there it raises); False the plain version on any device (an
    # A/B switch). kernel_interpret is the reference's Pallas interpret
    # mode, which has no CUDA meaning: True is rejected
    use_kernel: Optional[bool] = None
    kernel_interpret: bool = False
    # baseline hyper-parameters (paper §V.D)
    lr: float = 0.01
    prox_mu: float = 1e-4
    inner_steps: int = 5  # FedProx/FedPD inner GD steps
    fedpd_eta: float = 1.0
    state_dtype: str = "float32"
    # the mesh axes that enumerate clients (`launch/mesh.py`): the engine
    # splits the client rows over their product
    client_axes: Tuple[str, ...] = ("data",)
    # the placement knobs that only `sharding/specs.py` and the dry run
    # read: fsdp_axes additionally shards the client states' inner dims
    # over these mesh axes (FSDP); replicate_params keeps the parameters
    # replicated over `model` (pure data parallelism within a client)
    fsdp_axes: Tuple[str, ...] = ()
    replicate_params: bool = False

    def __post_init__(self):
        if self.algorithm not in ALGORITHMS:
            raise ValueError(
                f"unknown algorithm {self.algorithm!r}: {ALGORITHMS}")
        if self.h_policy not in H_POLICIES:
            raise ValueError(f"unknown h_policy {self.h_policy!r}: {H_POLICIES}")
        if self.k0 < 1:
            raise ValueError(f"k0 must be >= 1, got {self.k0}")
        if self.num_clients < 1:
            raise ValueError(f"num_clients must be >= 1, got {self.num_clients}")
        if self.kernel_interpret:
            raise ValueError(
                "kernel_interpret=True is the reference's Pallas interpret "
                "mode, which has no CUDA meaning: the port runs the kernel's "
                "plain version on the CPU (use_kernel=None) or, anywhere, "
                "with use_kernel=False")
        overlap = set(self.fsdp_axes) & set(self.client_axes)
        if overlap:
            raise ValueError(f"fsdp_axes {self.fsdp_axes} share "
                             f"{sorted(overlap)} with client_axes "
                             f"{self.client_axes}")
        if len(set(self.fsdp_axes)) != len(self.fsdp_axes):
            raise ValueError(f"fsdp_axes repeats an axis: {self.fsdp_axes}")
        if self.inner_steps < 1:
            raise ValueError(
                f"inner_steps must be >= 1, got {self.inner_steps}")
