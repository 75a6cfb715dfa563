"""Gradient-based sampling configuration (paper §2.4).

Counterpart of `repro.core.sampling`. `SamplingConfig` keeps the reference's
fields and validation, so a checkpoint that names any method loads. Only
``method="none"`` trains in this slice: uniform (SGB), GOSS and MVS sampling
are queued with the sampled path (Alg. 7), and `sample` raises for them.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    method: str = "none"  # none | uniform (SGB) | goss | mvs
    f: float = 1.0  # overall sampling ratio (uniform & mvs)
    goss_a: float = 0.2  # GOSS top-gradient fraction
    goss_b: float = 0.1  # GOSS random fraction of the remainder
    mvs_lambda: float | None = None  # None -> estimate from (Σg/Σh)²

    def __post_init__(self):
        if self.method not in ("none", "uniform", "goss", "mvs"):
            raise ValueError(f"unknown sampling method {self.method!r}")
        if not (0.0 < self.f <= 1.0):
            raise ValueError("sampling ratio f must be in (0, 1]")


def sample(
    g: torch.Tensor, h: torch.Tensor, cfg: SamplingConfig
) -> tuple[torch.Tensor, torch.Tensor]:
    """The gradients a tree is built from: every row with weight 1 when
    nothing is sampled (the reference's ``g * 1.0``, the same bits)."""
    if cfg.method == "none" or (cfg.method == "uniform" and cfg.f >= 1.0):
        return g, h
    raise NotImplementedError(
        f"sampling method {cfg.method!r} is not ported yet: gradient-based "
        "sampling (SGB, GOSS, MVS) comes with the sampled path (Alg. 7)"
    )
