"""Quantized transport for gradient pairs and histograms.

Counterpart of `repro.compress.grad`. GBDT tolerates aggressive gradient and
histogram quantization (arxiv 2011.02022): a split depends on *sums* of
gradient pairs, so narrowing the stored pairs on the wire costs little
accuracy while halving (f16/bf16) or quartering (int8) spill and all-reduce
bytes.

The quantizer is a *transport*: payloads are dequantized back to f32
**before** any accumulation, so ``"raw"`` is bit for bit the f32 path and
the lossy modes change values, never the order of additions. Each mode is
the reference's arithmetic in f32: the int8 scale is ``max(amax|x|, 1e-12)
/ 127`` and the payload ``clamp(round(x / scale), -127, 127)``, where
`torch.round` rounds half to even as ``jnp.round`` does; f16 and bf16 are
plain round-to-nearest-even casts.

Two call sites use it: `repro_torch.core.histcache.HistogramStore` spill
and fetch (any mode; the int8 scale is taken on the device and stays there),
and a cross-shard histogram all-reduce (``"f16"``/``"bf16"`` only: int8
partial sums would overflow after a few shards, so :meth:`psum_cast`
rejects it).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch

__all__ = ["GradQuantizer", "GRAD_TRANSPORTS", "PSUM_TRANSPORTS"]

GRAD_TRANSPORTS = ("raw", "f16", "bf16", "int8")
PSUM_TRANSPORTS = ("raw", "f16", "bf16")

_WIRE_DTYPES = {"f16": torch.float16, "bf16": torch.bfloat16, "int8": torch.int8}


@dataclasses.dataclass(frozen=True)
class GradQuantizer:
    """f32 -> {f32, f16, bf16, int8-with-scale} wire transport."""

    mode: str = "raw"

    def __post_init__(self):
        if self.mode not in GRAD_TRANSPORTS:
            raise ValueError(
                f"unknown grad transport {self.mode!r}; "
                f"choose one of {', '.join(GRAD_TRANSPORTS)}"
            )

    @classmethod
    def resolve(cls, mode: Union[str, "GradQuantizer", None]) -> "GradQuantizer":
        if isinstance(mode, GradQuantizer):
            return mode
        return cls("raw" if mode is None else str(mode))

    @property
    def is_raw(self) -> bool:
        return self.mode == "raw"

    @property
    def wire_dtype(self) -> torch.dtype:
        return _WIRE_DTYPES.get(self.mode, torch.float32)

    def quantize(self, arr: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Narrow an f32 tensor to the wire dtype on its device.

        Returns ``(payload, scale)``; ``scale`` is a 0-d f32 tensor on the
        same device for ``"int8"`` (absmax / 127) and None otherwise."""
        if self.is_raw:
            return arr, None
        if self.mode == "int8":
            scale = torch.clamp(arr.abs().amax(), min=1e-12) / 127.0
            payload = torch.clamp(torch.round(arr / scale), -127, 127).to(torch.int8)
            return payload, scale
        return arr.to(self.wire_dtype), None

    def dequantize(self, payload: torch.Tensor, scale: Optional[torch.Tensor] = None):
        """Expand a wire payload back to f32 (before any accumulation)."""
        if self.is_raw:
            return payload
        if self.mode == "int8":
            return payload.to(torch.float32) * scale
        return payload.to(torch.float32)

    def psum_cast(self, hist: torch.Tensor) -> torch.Tensor:
        """Narrow a histogram for the cross-shard all-reduce."""
        if self.mode not in PSUM_TRANSPORTS:
            raise ValueError(
                f"grad transport {self.mode!r} cannot back a psum: int8 partial "
                "sums overflow across shards; use it for HistogramStore "
                "spill/fetch (ExecutionPolicy(grad_transport='int8')) and pick "
                "'f16' or 'bf16' for DistConfig(grad_transport=...)"
            )
        if self.is_raw:
            return hist
        return hist.to(self.wire_dtype)

    def psum_restore(self, hist: torch.Tensor) -> torch.Tensor:
        """Widen an all-reduce result back to f32."""
        if self.is_raw:
            return hist
        return hist.to(torch.float32)
