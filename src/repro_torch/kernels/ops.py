"""Dispatch by tensor device: CUDA kernel for CUDA tensors, plain version
for CPU tensors.

Counterpart of `repro.kernels.ops`. There is no ``impl`` switch and no
environment override: a CUDA tensor always launches the hand-written kernel
(which raises on anything it cannot take), and only a CPU tensor runs the
plain PyTorch version from `kernels.ref`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import bitpack as _bitpack
from repro_torch.kernels import ellpack_bin as _ellpack_bin
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


def build_histogram(bins, g, h, positions, n_nodes: int, n_bins: int, node_map=None):
    """Level-window histogram over level-local positions, after an optional
    ``node_map`` remap: ``out[k]`` is the (m, n_bins, 2) histogram of the
    rows whose slot is k (kernel 4)."""
    if bins.is_cuda:
        return _histogram.build_histogram(bins, g, h, positions, n_nodes, n_bins, node_map)
    return _ref.build_histogram(bins, g, h, positions, n_nodes, n_bins, node_map)


def build_histogram_paged(
    stream,
    g,
    h,
    positions,
    offset: int,
    count: int,
    n_bins: int,
    node_map=None,
    build_nodes=None,
):
    """Page-batched histogram: the sum of per-page histograms over one
    stream pass.

    ``stream`` yields `StreamedPage`s whose host view has ``row_offset`` /
    ``n_rows`` and whose device tensor is the staged uint8 page;
    ``positions[page.index]`` holds that page's global tree positions. One
    kernel launch per page; pages are summed in f32 in stream order. On the
    card each page's kernel adds its histogram into the running sum from
    the second page on (the page's own histogram is never allocated); on the
    CPU the page's histogram is summed with ``add_``, the same f32 additions.

    With ``build_nodes`` (the fused path) each page's raw positions go
    straight to `build_histogram_nodes`; ``offset`` is unused then and
    ``count`` must equal the build-set size. Without it, the node window is
    ``[offset, offset + window)``, ``window`` being the node_map's length
    (or ``count`` for a full build): positions are made level-local by an
    elementwise step, rows outside the window get -1, and `build_histogram`
    builds the ``count`` slots, rows at derived nodes contributing to none.
    """
    if build_nodes is not None and count != build_nodes.shape[0]:
        raise ValueError(f"count={count} != {build_nodes.shape[0]} build nodes")
    window = node_map.shape[0] if node_map is not None else count
    hist = None
    for page in stream:
        ro, nr = page.host.row_offset, page.host.n_rows
        pos = positions[page.index]
        args = (page.device, g[ro : ro + nr], h[ro : ro + nr])
        if build_nodes is not None:
            if page.device.is_cuda:
                hist = _histogram.build_histogram_nodes(
                    *args, pos, build_nodes, n_bins, add_into=hist
                )
                continue
            hp = _ref.build_histogram_nodes(*args, pos, build_nodes, n_bins)
        else:
            level_pos = torch.where((pos >= offset) & (pos < offset + window), pos - offset, -1)
            if page.device.is_cuda:
                hist = _histogram.build_histogram(
                    *args, level_pos, count, n_bins, node_map=node_map, add_into=hist
                )
                continue
            hp = _ref.build_histogram(*args, level_pos, count, n_bins, node_map)
        # summed in place into the first page's histogram: one level
        # histogram fewer, the page's own dropped before the next page
        hist = hp if hist is None else hist.add_(hp)
        del hp
    return hist


def bin_values(x, padded_edges, n_bins_per_feature):
    """uint8 ELLPACK bins of raw f32 or f64 features (NaN -> 255)."""
    if x.is_cuda:
        return _ellpack_bin.bin_values(x, padded_edges, n_bins_per_feature)
    return _ref.bin_values(x, padded_edges, n_bins_per_feature)


def bitpack_decode(payload, row_syms: int, bits: int, missing: int | None):
    """(rows, row_syms) uint8 bins of a row-wise bitpack payload (rows,
    ceil(row_syms * bits / 8)) uint8; the packed ``missing`` symbol -> 255."""
    if payload.is_cuda:
        return _bitpack.bitpack_decode(payload, row_syms, bits, missing)
    return _ref.bitpack_decode(payload, row_syms, bits, missing)


def partition_rows(
    bins, positions, feature, split_bin, default_left, is_leaf, count_level=None, counts=None
):
    """New positions after one level's splits. With ``count_level`` (the next
    level's ``(offset, count)``) the rows per node of that window are added
    into ``counts`` ((count,) int32) in the same pass, so one buffer zeroed
    once per level sums a stream pass's pages."""
    args = (bins, positions, feature, split_bin, default_left, is_leaf, count_level, counts)
    if bins.is_cuda:
        return _partition.partition_rows(*args)
    return _ref.partition_rows(*args)


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
