"""Counterpart of `repro.configs.llama3_2_1b`, field for field.

llama3.2-1b [dense]: 16L d=2048 32H (GQA kv=8) ff=8192 vocab=128256 —
small llama3 [hf:meta-llama/Llama-3.2-1B; unverified]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=128256,
    rope_theta=500000.0,
    tie_embeddings=True,
)

REDUCED = ModelConfig(
    name="llama3.2-1b-reduced",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=8,
    n_kv_heads=2,  # keep 4:1 GQA ratio
    d_ff=128,
    vocab_size=256,
    tie_embeddings=True,
    dtype="float32",
)
