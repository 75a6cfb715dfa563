"""Fused forest traversal: wrapper of ``csrc/forest.cu``.

Counterpart of `repro.kernels.forest.predict_forest`. The kernel packs each
node into one record, streams the forest through shared memory beside a
tile of rows, walks several trees of a row at once and adds the leaves in
ascending tree order as pure f32 adds of a leaf table that the caller
pre-scaled by the learning rate (`kernels.ops.predict_forest`). Plain
version: `repro_torch.kernels.ref.predict_forest_bins`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import launch_target, require, require_cuda

launches = 0

# What a packed node record can name (its fields' widths, csrc/forest.cu):
# for uint8 bins a 24-bit feature and a 23-bit child; int32 bins keep whole
# words, bounded by the C entry's int arguments.
MAX_FEATURES = {torch.uint8: 1 << 24, torch.int32: (1 << 31) - 1}
MAX_NODES = {torch.uint8: 1 << 23, torch.int32: 1 << 30}


def scratch_words(n_trees: int, n_nodes: int, bin_dtype: torch.dtype) -> int:
    """int32 words of the packed forest: each tree padded to a multiple of 4
    nodes, a record of 2 words (uint8 bins) or 4 (int32 bins) and a leaf
    value a node."""
    n_pad = (n_nodes + 3) // 4 * 4
    return n_trees * n_pad * (3 if bin_dtype == torch.uint8 else 5)


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
    if m > MAX_FEATURES[bins.dtype]:
        raise ValueError(
            f"predict_forest packs a node's feature into a field of at most "
            f"{MAX_FEATURES[bins.dtype]} features for {bins.dtype} bins; got m={m}"
        )
    if n_nodes > MAX_NODES[bins.dtype] or scratch_words(n_trees, n_nodes, bins.dtype) >= 1 << 31:
        raise ValueError(
            f"predict_forest packs at most {MAX_NODES[bins.dtype]} nodes a tree for "
            f"{bins.dtype} bins and 2**31 words a forest; got {n_trees} trees of {n_nodes} nodes"
        )
    out = torch.empty(n_rows, dtype=torch.float32, device=dev)
    if n_rows == 0:
        return out
    scratch = torch.empty(scratch_words(n_trees, n_nodes, bins.dtype), dtype=torch.int32,
                          device=dev)
    fn = _build.library("forest")
    err = fn(
        bins.data_ptr(), int(bins.dtype == torch.uint8), n_rows, m,
        feature.data_ptr(), split_bin.data_ptr(), default_left.data_ptr(),
        is_leaf.data_ptr(), leaf_value.data_ptr(), n_trees, n_nodes, max_depth,
        margin_in.data_ptr(), out.data_ptr(), scratch.data_ptr(), *launch_target(dev),
    )
    _build.check(err, "predict_forest", dev)
    launches += 1
    return out
