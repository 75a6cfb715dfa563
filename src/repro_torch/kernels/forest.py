"""Fused forest traversal: wrapper of ``csrc/forest.cu``.

Counterpart of `repro.kernels.forest.predict_forest`; one thread per row,
trees in ascending order, pure f32 adds of a leaf table that the caller
pre-scaled by the learning rate (`kernels.ops.predict_forest`). Plain
version: `repro_torch.kernels.ref.predict_forest_bins`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import require, require_cuda, stream_ptr

launches = 0


def predict_forest(
    bins: torch.Tensor,  # (n_rows, m) uint8 or int32
    feature: torch.Tensor,  # (T, n_nodes) int32
    split_bin: torch.Tensor,  # (T, n_nodes) int32
    default_left: torch.Tensor,  # (T, n_nodes) bool
    is_leaf: torch.Tensor,  # (T, n_nodes) bool
    leaf_value: torch.Tensor,  # (T, n_nodes) f32, pre-scaled
    max_depth: int,
    margin_in: torch.Tensor,  # (n_rows,) f32
) -> torch.Tensor:
    """(n_rows,) f32 margins: ``margin_in`` plus every tree's leaf value."""
    global launches
    require_cuda(bins, "predict_forest")
    dev = bins.device
    n_rows, m = bins.shape
    n_trees, n_nodes = feature.shape
    require(bins, "bins", (torch.uint8, torch.int32), (None, None), dev)
    for name, t, dt in (
        ("feature", feature, torch.int32), ("split_bin", split_bin, torch.int32),
        ("default_left", default_left, torch.bool), ("is_leaf", is_leaf, torch.bool),
        ("leaf_value", leaf_value, torch.float32),
    ):
        require(t, name, (dt,), (n_trees, n_nodes), dev)
    require(margin_in, "margin_in", (torch.float32,), (n_rows,), dev)
    if n_nodes == 0 or m == 0 or max_depth < 0:
        raise ValueError("predict_forest needs nodes, features and max_depth >= 0")
    out = torch.empty(n_rows, dtype=torch.float32, device=dev)
    if n_rows == 0:
        return out
    fn = _build.library("forest")
    err = fn(
        bins.data_ptr(), int(bins.dtype == torch.uint8), n_rows, m,
        feature.data_ptr(), split_bin.data_ptr(), default_left.data_ptr(),
        is_leaf.data_ptr(), leaf_value.data_ptr(), n_trees, n_nodes, max_depth,
        margin_in.data_ptr(), out.data_ptr(), stream_ptr(dev),
    )
    _build.check(err, "predict_forest")
    launches += 1
    return out
