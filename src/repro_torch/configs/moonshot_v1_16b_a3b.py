"""Counterpart of `repro.configs.moonshot_v1_16b_a3b`, field for field.

moonshot-v1-16b-a3b [moe]: 48L d=2048 16H (kv=16) per-expert ff=1408,
vocab=163840, MoE 64 experts top-6 [hf:moonshotai/Moonlight-16B-A3B; hf].

Moonlight (DeepSeek-V3-style) keeps the first layer dense; modeled with
first_k_dense=1.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=163840,
    n_experts=64,
    top_k=6,
    capacity_factor=1.25,
    first_k_dense=1,
)

REDUCED = ModelConfig(
    name="moonshot-v1-16b-a3b-reduced",
    family="moe",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=32,
    vocab_size=256,
    n_experts=8,
    top_k=2,
    capacity_factor=2.0,
    first_k_dense=1,
    dtype="float32",
)
