"""Row repartition: wrapper of ``csrc/partition.cu``.

Counterpart of `repro.kernels.partition.partition_rows`, with the next
level's row counts (`repro.core.histcache.level_row_counts`) folded into the
same pass: one thread per row, counts merged per warp and per block.
Integer-exact. Plain version:
`repro_torch.kernels.ref.partition_rows`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import (
    check_count_window,
    launch_target,
    require,
    require_cuda,
)

launches = 0


def partition_rows(
    bins: torch.Tensor,  # (n_rows, m) uint8 or int32
    positions: torch.Tensor,  # (n_rows,) int32
    feature: torch.Tensor,  # (n_nodes,) int32
    split_bin: torch.Tensor,  # (n_nodes,) int32
    default_left: torch.Tensor,  # (n_nodes,) bool
    is_leaf: torch.Tensor,  # (n_nodes,) bool
    count_level: tuple[int, int] | None = None,  # (offset, count) of the next level
    counts: torch.Tensor | None = None,  # (count,) int32, added into
) -> torch.Tensor:
    """New (n_rows,) int32 positions after one level's splits. With
    ``count_level``, the rows whose new position lies in ``[offset, offset +
    count)`` are also added into ``counts[pos - offset]`` in the same pass."""
    global launches
    require_cuda(bins, "partition_rows")
    dev = bins.device
    n_rows, m = bins.shape
    n_nodes = feature.shape[0]
    require(bins, "bins", (torch.uint8, torch.int32), (None, None), dev)
    require(positions, "positions", (torch.int32,), (n_rows,), dev)
    require(feature, "feature", (torch.int32,), (n_nodes,), dev)
    require(split_bin, "split_bin", (torch.int32,), (n_nodes,), dev)
    require(default_left, "default_left", (torch.bool,), (n_nodes,), dev)
    require(is_leaf, "is_leaf", (torch.bool,), (n_nodes,), dev)
    check_count_window(count_level, counts, dev)
    if n_nodes == 0 or m == 0:
        raise ValueError("partition_rows needs at least one node and one feature")
    out = torch.empty(n_rows, dtype=torch.int32, device=dev)
    if n_rows == 0:
        return out
    offset, count = count_level if count_level is not None else (0, 0)
    fn = _build.library("partition")
    err = fn(
        bins.data_ptr(), int(bins.dtype == torch.uint8), n_rows, m,
        positions.data_ptr(), feature.data_ptr(), split_bin.data_ptr(),
        default_left.data_ptr(), is_leaf.data_ptr(), n_nodes, out.data_ptr(),
        offset, count, None if counts is None else counts.data_ptr(), *launch_target(dev),
    )
    _build.check(err, "partition_rows", dev)
    launches += 1
    return out
