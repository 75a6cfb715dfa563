"""Serving tier of the port: `PackedForest` (fused whole-forest prediction)."""
from repro_torch.serve.forest import PackedForest

__all__ = ["PackedForest"]
