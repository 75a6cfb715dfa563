"""Dispatch by tensor device: CUDA kernel for CUDA tensors, plain version
for CPU tensors.

Counterpart of `repro.kernels.ops`. There is no ``impl`` switch and no
environment override: a CUDA tensor always launches the hand-written kernel
(which raises on anything it cannot take), and only a CPU tensor runs the
plain PyTorch version from `kernels.ref`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import forest as _forest
from repro_torch.kernels import histogram as _histogram
from repro_torch.kernels import partition as _partition
from repro_torch.kernels import ref as _ref

MISSING_BIN = _ref.MISSING_BIN


def build_histogram_nodes(bins, g, h, positions, build_nodes, n_bins: int):
    """Fused histogram over an explicit global build-node set: ``out[s]`` is
    the (m, n_bins, 2) histogram of node ``build_nodes[s]``."""
    if bins.is_cuda:
        return _histogram.build_histogram_nodes(bins, g, h, positions, build_nodes, n_bins)
    return _ref.build_histogram_nodes(bins, g, h, positions, build_nodes, n_bins)


def partition_rows(bins, positions, feature, split_bin, default_left, is_leaf):
    if bins.is_cuda:
        return _partition.partition_rows(
            bins, positions, feature, split_bin, default_left, is_leaf
        )
    return _ref.partition_rows(bins, positions, feature, split_bin, default_left, is_leaf)


def predict_bins(bins, feature, split_bin, default_left, is_leaf, leaf_value, max_depth: int):
    """One tree's leaf values. Not a kernel in the reference either: plain
    tensor code on every device."""
    return _ref.predict_bins(
        bins, feature, split_bin, default_left, is_leaf, leaf_value, max_depth
    )


def predict_forest(
    bins,
    feature,  # (T, n_total) stacked forest arrays, one launch for all T trees
    split_bin,
    default_left,
    is_leaf,
    leaf_value,
    max_depth: int,
    learning_rate: float,
    margin_in,
):
    """``margin_in + lr * leaf_t`` accumulated in tree order.

    The leaf table is scaled by the learning rate HERE, as one eager
    elementwise multiply, so the kernel and the plain version only add: no
    compiler can contract the multiply-add into an FMA, and the fused result
    equals the per-tree loop bit for bit.
    """
    if feature.shape[0] == 0:  # empty forest: margins pass through
        return margin_in.to(torch.float32)
    scaled_leaf = (
        torch.tensor(learning_rate, dtype=torch.float32, device=leaf_value.device)
        * leaf_value.to(torch.float32)
    )
    if bins.is_cuda:
        return _forest.predict_forest(
            bins, feature, split_bin, default_left, is_leaf, scaled_leaf,
            max_depth, margin_in,
        )
    return _ref.predict_forest_bins(
        bins, feature, split_bin, default_left, is_leaf, scaled_leaf, max_depth, margin_in
    )
