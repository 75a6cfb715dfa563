"""Counterpart of `repro.configs.olmoe_1b_7b`, field for field.

olmoe-1b-7b [moe]: 16L d=2048 16H (kv=16) per-expert ff=1024 vocab=50304,
MoE 64 experts top-8 [arXiv:2409.02060; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab_size=50304,
    n_experts=64,
    top_k=8,
    capacity_factor=1.25,
)

REDUCED = ModelConfig(
    name="olmoe-1b-7b-reduced",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=32,
    vocab_size=256,
    n_experts=8,
    top_k=4,
    capacity_factor=2.0,
    dtype="float32",
)
