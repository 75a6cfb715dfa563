"""Model configuration schema for the assigned architecture pool.

One frozen dataclass covers all five families (dense / moe / ssm / hybrid /
frontend-stubbed vlm+audio); family-specific fields are zero/empty when
unused. Exact dimensions for each assigned architecture live in
`repro_torch.configs.<arch_id>`. Counterpart of `repro.models.config`, field
for field: the port keeps its own copy.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid
    n_layers: int
    d_model: int
    vocab_size: int
    # attention (0 for attention-free families)
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0  # 0 -> d_model // n_heads
    d_ff: int = 0
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    first_k_dense: int = 0  # leading dense layers before MoE stack
    # SSM (mamba2 SSD)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    # hybrid (hymba): sliding-window attention everywhere except global layers
    swa_window: int = 0  # 0 = full attention
    n_global_layers: int = 0  # evenly spaced full-attention layers
    # frontends (stub): precomputed embeddings are model inputs
    frontend: str = ""  # "" | "vision" | "audio"
    n_patches: int = 0  # vision stub: patches per example
    n_codebooks: int = 0  # audio stub: EnCodec codebooks
    # misc
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    def __post_init__(self):
        if self.family not in ("dense", "moe", "ssm", "hybrid"):
            raise ValueError(f"unknown family {self.family!r}")
        if self.family != "ssm" and self.n_heads and self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    # ----- derived quantities -----
    @property
    def subquadratic(self) -> bool:
        """Can serve long_500k: attention-free or windowed attention."""
        return self.family == "ssm" or (self.family == "hybrid" and self.swa_window > 0)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def attn_window(self, layer: int) -> int:
        """Per-layer attention window (0 = full)."""
        if self.family != "hybrid" or self.swa_window == 0:
            return 0
        if self.n_global_layers <= 0:
            return self.swa_window
        stride = max(1, self.n_layers // self.n_global_layers)
        return 0 if layer % stride == 0 else self.swa_window

    def param_count(self) -> int:
        """Total parameters (embedding included)."""
        d, ff, L, V = self.d_model, self.d_ff, self.n_layers, self.vocab_size
        total = V * d  # embed
        if not self.tie_embeddings:
            total += d * V
        per_layer = 2 * d  # norms
        if self.family in ("dense", "moe", "hybrid"):
            hd = self.head_dim
            per_layer += d * self.n_heads * hd  # wq
            per_layer += 2 * d * self.n_kv_heads * hd  # wk, wv
            per_layer += self.n_heads * hd * d  # wo
        if self.family == "dense" or self.first_k_dense:
            pass
        if self.family in ("ssm", "hybrid"):
            di, st, nh = self.d_inner, self.ssm_state, self.ssm_heads
            proj_in = 2 * di + 2 * st + nh
            per_layer += d * proj_in + (di + 2 * st) * self.ssm_conv + 2 * nh + di * d
        # mlp
        if self.family == "moe":
            dense_mlp = 3 * d * ff
            moe_mlp = self.n_experts * 3 * d * ff + d * self.n_experts
            total += self.first_k_dense * dense_mlp + (L - self.first_k_dense) * moe_mlp
        elif ff:
            total += L * 3 * d * ff
        total += L * per_layer + d  # final norm
        return total

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: only routed experts)."""
        if self.family != "moe":
            return self.param_count()
        d, ff, L = self.d_model, self.d_ff, self.n_layers
        full = self.param_count()
        moe_layers = L - self.first_k_dense
        inactive = moe_layers * (self.n_experts - self.top_k) * 3 * d * ff
        return full - inactive
