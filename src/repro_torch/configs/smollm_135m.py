"""Counterpart of `repro.configs.smollm_135m`, field for field.

smollm-135m [dense]: 30L d=576 9H (GQA kv=3) ff=1536 vocab=49152 —
llama-arch small [hf:HuggingFaceTB/SmolLM-135M; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m",
    family="dense",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    d_ff=1536,
    vocab_size=49152,
    tie_embeddings=True,
)

REDUCED = ModelConfig(
    name="smollm-135m-reduced",
    family="dense",
    n_layers=3,
    d_model=48,
    n_heads=3,  # keep 3:1 GQA ratio
    n_kv_heads=1,
    d_ff=128,
    vocab_size=256,
    tie_embeddings=True,
    dtype="float32",
)
