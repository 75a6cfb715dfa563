"""Counterpart of `repro.configs.musicgen_large`, field for field.

musicgen-large [audio]: 48L d=2048 32H (kv=32) ff=8192 vocab=2048 —
decoder-only over EnCodec tokens [arXiv:2306.05284; hf].

Backbone only per assignment: the EnCodec frontend is a STUB — inputs are
4-codebook token ids (the delay-pattern interleaving is a data-prep concern,
noted in DESIGN.md); the model sums 4 codebook embeddings and predicts 4
parallel heads."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="dense",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    n_codebooks=4,
)

REDUCED = ModelConfig(
    name="musicgen-large-reduced",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=64,
    n_codebooks=4,
    dtype="float32",
)
