"""Counterpart of `repro.configs.phi3_mini_3_8b`, field for field.

phi3-mini-3.8b [dense]: 32L d=3072 32H (kv=32) ff=8192 vocab=32064 —
RoPE SwiGLU GQA [arXiv:2404.14219; unverified].

Pure full attention -> long_500k is skipped (assignment rule; DESIGN.md
§Arch-applicability)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
)

REDUCED = ModelConfig(
    name="phi3-mini-3.8b-reduced",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    dtype="float32",
)
