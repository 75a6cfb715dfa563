"""Counterpart of `repro.configs.llava_next_34b`, field for field.

llava-next-34b [vlm]: 60L d=7168 56H (GQA kv=8) ff=20480 vocab=64000.

anyres tiling [hf:llava-hf/llava-v1.6 family; unverified]. The vision tower is
a STUB per assignment: `input_specs` supplies precomputed patch embeddings at
d_model (one 24x24 anyres base tile = 576 patches); only the 34B language
backbone is modeled.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="dense",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    frontend="vision",
    n_patches=576,
    rope_theta=5_000_000.0,
)

REDUCED = ModelConfig(
    name="llava-next-34b-reduced",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=8,  # keep the 56:8 q:kv GQA ratio
    n_kv_heads=2,
    head_dim=8,
    d_ff=128,
    vocab_size=256,
    frontend="vision",
    n_patches=8,
    dtype="float32",
)
