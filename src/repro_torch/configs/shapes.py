"""Assigned input shapes and their stand-in tensors for the dry run.

Counterpart of `repro.configs.shapes`. LM shapes are seq_len x
global_batch; decode_* / long_* run `decode_step` (one new token against a
seq_len KV cache), NOT the train step. `long_500k` applies only to
sub-quadratic archs (ssm / hybrid-with-SWA). The input functions return
tensors on the ``meta`` device (shape and dtype, no storage), the port's
stand-in for ``jax.ShapeDtypeStruct``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def applicable(cfg: ModelConfig, shape: ShapeSpec) -> bool:
    """Assignment rules: long_500k only for sub-quadratic archs."""
    if shape.name == "long_500k":
        return cfg.subquadratic
    return True


def _i32(*shape):
    return torch.empty(shape, dtype=torch.int32, device="meta")


def train_input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """Meta stand-ins for one training batch (no allocation)."""
    B, S = shape.global_batch, shape.seq_len
    if cfg.n_codebooks:
        return {"codes": _i32(B, S, cfg.n_codebooks)}
    if cfg.frontend == "vision":
        P = cfg.n_patches
        return {
            "tokens": _i32(B, S - P),
            "patch_embeds": torch.empty((B, P, cfg.d_model), dtype=getattr(torch, cfg.dtype),
                                        device="meta"),
        }
    return {"tokens": _i32(B, S)}


def prefill_input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    B, S = shape.global_batch, shape.seq_len
    if cfg.n_codebooks:
        return {"tokens": _i32(B, S, cfg.n_codebooks)}
    return {"tokens": _i32(B, S)}


def decode_input_specs(cfg: ModelConfig, shape: ShapeSpec, paged: bool = True) -> dict:
    """Token + KV-cache stand-ins for a single decode step at context seq_len."""
    from repro_torch.models.serve import init_cache

    B, S = shape.global_batch, shape.seq_len
    cache = init_cache(cfg, B, S, paged=paged and cfg.family in ("dense", "moe"),
                       device=torch.device("meta"))
    tokens = _i32(B, cfg.n_codebooks) if cfg.n_codebooks else _i32(B)
    return {"tokens": tokens, "cache": cache}


def input_specs(cfg: ModelConfig, shape_name: str, paged_decode: bool = True) -> dict:
    shape = SHAPES[shape_name]
    if shape.kind == "train":
        return train_input_specs(cfg, shape)
    if shape.kind == "prefill":
        return prefill_input_specs(cfg, shape)
    return decode_input_specs(cfg, shape, paged=paged_decode)
