"""Counterpart of `repro.configs.mamba2_130m`, field for field.

mamba2-130m [ssm]: 24L d=768 (attention-free) vocab=50280, ssm_state=128 —
SSD (state-space duality) [arXiv:2405.21060; unverified].

Attention-free: runs long_500k (decode state is O(1) in context length);
d_inner = 2*768 = 1536, head_dim 64 -> 24 SSD heads."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    tie_embeddings=True,
)

REDUCED = ModelConfig(
    name="mamba2-130m-reduced",
    family="ssm",
    n_layers=2,
    d_model=64,
    d_ff=0,
    vocab_size=256,
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=16,
    ssm_chunk=16,
    tie_embeddings=True,
    dtype="float32",
)
