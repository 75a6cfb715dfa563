"""ELLPACK quantisation (paper Alg. 4 LookupBin): wrapper of ``csrc/ellpack_bin.cu``.

Counterpart of `repro.kernels.ellpack_bin.bin_values`. A block stages the
edges of up to four 32-feature tiles in shared memory (k-major, transposed
from the public (m, B) layout inside the kernel) for a long run of rows,
copies the values in with ``cp.async``, and binary-searches several values a
thread together, in the input's own type (float32 or float64); it writes
uint8 bins with 255 for NaN. Plain version: `repro_torch.kernels.ref.bin_values`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import launch_target, require, require_cuda

# widest edge table a block stages: 32 features x 1023 f32 rows, 128 KB of
# shared memory beside a 12 KB value ring, within the card's 227 KB a block
MAX_EDGES = 1024

launches = 0


def bin_values(
    x: torch.Tensor,  # (n_rows, m) f32 or f64 raw features
    padded_edges: torch.Tensor,  # (m, B) f32 right edges, +inf padded
    n_bins_per_feature: torch.Tensor,  # (m,) int32
) -> torch.Tensor:
    """(n_rows, m) uint8 bins; NaN -> 255."""
    global launches
    require_cuda(x, "bin_values")
    dev = x.device
    n_rows, m = x.shape
    max_bin = padded_edges.shape[1]
    require(x, "x", (torch.float32, torch.float64), (None, None), dev)
    require(padded_edges, "padded_edges", (torch.float32,), (m, None), dev)
    require(n_bins_per_feature, "n_bins_per_feature", (torch.int32,), (m,), dev)
    if not 1 <= max_bin <= MAX_EDGES:
        raise ValueError(f"padded_edges has {max_bin} columns; the kernel takes 1..{MAX_EDGES}")
    out = torch.empty((n_rows, m), dtype=torch.uint8, device=dev)
    if n_rows == 0 or m == 0:
        return out
    fn = _build.library("ellpack_bin")
    err = fn(
        x.data_ptr(), int(x.dtype == torch.float64), n_rows, m, padded_edges.data_ptr(),
        max_bin, n_bins_per_feature.data_ptr(), out.data_ptr(), *launch_target(dev),
    )
    _build.check(err, "bin_values", dev)
    launches += 1
    return out
