"""Counterpart of `repro.configs.minicpm_2b`, field for field.

minicpm-2b [dense]: 40L d=2304 36H (kv=36) ff=5760 vocab=122753 —
WSD schedule (arch=llama-like) [arXiv:2404.06395; hf].

The WSD (Warmup-Stable-Decay) schedule is this arch's training signature;
`PREFERRED_SCHEDULE` is consumed by launch/train.py."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    d_ff=5760,
    vocab_size=122753,
    tie_embeddings=True,
)

PREFERRED_SCHEDULE = "wsd"

REDUCED = ModelConfig(
    name="minicpm-2b-reduced",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=160,
    vocab_size=255,  # deliberately odd-sized like the full vocab
    tie_embeddings=True,
    dtype="float32",
)
