"""Out-of-core tree construction over streamed pages (paper Alg. 6).

Counterpart of `repro.core.outofcore.build_tree_paged`. The training engine
(`GradientBooster._fit_external`) picks this builder when the
`ExecutionPolicy` decides ``out_of_core``; the data side (sketch, paging,
spill) lives on the DMatrix sources in `repro_torch.data.dmatrix`.

The depthwise loop (`core.tree.grow_tree_generic`) runs two `PageStream`
passes per level: one for the histogram, one for the repartition, which
also sums the next level's row counts across pages for the histogram
store's plan. Row positions are kept per page on the device and freeze at
leaves, so after the last level they give every row's leaf.

Best-first (lossguide) growth, with its per-node page skipping, is queued
(ROADMAP queue 1 item 5a).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.histcache import HistogramStore, LevelPlan, new_level_counts
from repro_torch.core.tree import TreeArrays, TreeParams, grow_tree_generic
from repro_torch.kernels import ops

Tensor = torch.Tensor


def build_tree_paged(
    make_stream,
    page_extents: list[tuple[int, int]],
    g: Tensor,  # (n_rows,) f32, on the pages' device
    h: Tensor,
    n_bins: int,
    bin_valid: Tensor,
    tp: TreeParams,
    cut_values: np.ndarray | None = None,
    cut_ptrs: np.ndarray | None = None,
    hist_cache: HistogramStore | None = None,
) -> tuple[TreeArrays, dict[int, Tensor]]:
    """One depthwise tree over streamed pages (Alg. 6 core).

    ``make_stream()`` starts one pass; pages arrive in `page_extents` order,
    each a `StreamedPage` whose host view carries ``row_offset`` and
    ``n_rows``. With histogram subtraction (the default) each histogram
    pass scatters only the rows of the build nodes. Returns (tree, per-page
    final positions keyed by stream index).
    """
    positions: dict[int, Tensor] = {
        i: torch.zeros(nr, dtype=torch.int32, device=g.device)
        for i, (_, nr) in enumerate(page_extents)
    }

    def hist_fn(offset: int, count: int, plan: LevelPlan) -> Tensor:
        # one double-buffered pass per level: page k+1 stages while page k's
        # histogram kernel runs
        return ops.build_histogram_paged(
            make_stream(), g, h, positions, offset, plan.n_build, n_bins,
            build_nodes=plan.build_nodes,
        )

    def partition_fn(feature, split_bin, default_left, is_leaf, count_level):
        # one launch per page; every page adds its rows into the same counts
        counts = new_level_counts(count_level, g.device)
        for sp in make_stream():
            positions[sp.index] = ops.partition_rows(
                sp.device, positions[sp.index], feature, split_bin, default_left, is_leaf,
                count_level, counts,
            )
        return counts

    tree = grow_tree_generic(
        hist_fn, partition_fn, g.sum(), h.sum(), n_bins, bin_valid, tp,
        cut_values, cut_ptrs, hist_cache=hist_cache,
    )
    return tree, positions
