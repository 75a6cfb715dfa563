"""Counterpart of `repro.configs.hymba_1_5b`, field for field.

hymba-1.5b [hybrid]: 32L d=1600 25H (GQA kv=5) ff=5504, vocab=32001,
ssm_state=16 — parallel attn+mamba heads [arXiv:2411.13676; hf].

Hymba signature features modeled: parallel attention+SSM heads with
mean-fused normalized outputs; sliding-window attention (1024) on all but 3
evenly spaced global layers -> sub-quadratic, runs long_500k. Meta-tokens
(learned prefix) are a prompt-side feature and are omitted (DESIGN.md)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    swa_window=1024,
    n_global_layers=3,
)

REDUCED = ModelConfig(
    name="hymba-1.5b-reduced",
    family="hybrid",
    n_layers=3,
    d_model=64,
    n_heads=5,  # keep 5:1 GQA ratio
    n_kv_heads=1,
    head_dim=16,
    d_ff=128,
    vocab_size=255,
    ssm_state=16,
    ssm_head_dim=16,
    ssm_chunk=16,
    swa_window=8,
    n_global_layers=1,
    dtype="float32",
)
