"""Out-of-core tree construction over streamed pages (paper Alg. 6).

Counterpart of `repro.core.outofcore.build_tree_paged`. The training engine
(`GradientBooster._fit_external`) picks this builder when the
`ExecutionPolicy` decides ``out_of_core``; the data side (sketch, paging,
spill) lives on the DMatrix sources in `repro_torch.data.dmatrix`.

Either growth policy runs on two `PageStream` passes per step: one for the
histogram and one for the repartition, which also sums the next window's
row counts across pages for the histogram store's plan. A step is a tree
level (depthwise) or a batch of popped frontier leaves (lossguide). Row
positions are kept per page on the device and freeze at leaves, so after the
last step they give every row's leaf.

Per-node page skipping (lossguide): a pop moves only the popped nodes' rows,
so a page none of whose rows sits at a non-leaf node is left out of the
repartition pass, and, since the moved rows are exactly the rows of the
children's windows, out of the histogram pass that follows: no fetch, no
staging, counted in `TransferStats.pages_skipped`. The per-page predicates
of a pop reach the host in one copy.
"""
from __future__ import annotations

import inspect

import numpy as np
import torch

from repro_torch.core.histcache import (
    HistogramStore,
    LevelPlan,
    count_span,
    new_level_counts,
    take_counts,
)
from repro_torch.core.tree import TreeArrays, TreeParams, tree_growth_driver
from repro_torch.kernels import ops

Tensor = torch.Tensor


def _accepts_indices(make_stream) -> bool:
    """Can ``make_stream`` start a subset pass (an ``indices=`` keyword)?
    Zero-argument closures still work, without page skipping."""
    try:
        sig = inspect.signature(make_stream)
    except (TypeError, ValueError):
        return False
    return any(
        prm.kind is inspect.Parameter.VAR_KEYWORD or prm.name == "indices"
        for prm in sig.parameters.values()
    )


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
    page_skipping: bool = True,
) -> tuple[TreeArrays, dict[int, Tensor]]:
    """One tree over streamed pages (Alg. 6 core), either growth policy.

    ``make_stream()`` starts one pass; pages arrive in `page_extents` order,
    each a `StreamedPage` whose host view carries ``row_offset`` and
    ``n_rows``. With histogram subtraction (the default) each histogram
    pass scatters only the rows of the build nodes. With ``page_skipping``
    and a ``make_stream`` that takes ``indices=``, lossguide passes skip the
    pages no popped node has rows on. Returns (tree, per-page final
    positions keyed by stream index).
    """
    positions: dict[int, Tensor] = {
        i: torch.zeros(nr, dtype=torch.int32, device=g.device)
        for i, (_, nr) in enumerate(page_extents)
    }
    skip_enabled = (
        page_skipping and tp.grow_policy == "lossguide" and _accepts_indices(make_stream)
    )

    def active_pages(pred) -> list[int]:
        """The pages with a row for which ``pred(positions)`` holds, read to
        the host in one copy."""
        live = [i for i, (_, nr) in enumerate(page_extents) if nr]
        if not live:
            return []
        flags = torch.stack([pred(positions[i]).any() for i in live]).cpu().tolist()
        return [i for i, hit in zip(live, flags) if hit]

    def subset_stream(active: list[int]):
        """A pass over ``active`` pages only, counting the skips; a full pass
        when nothing (or everything) is skippable."""
        if not active or len(active) == len(page_extents):
            return make_stream()
        stream = make_stream(indices=active)
        stats = getattr(stream, "stats", None)
        if stats is not None:
            stats.pages_skipped += len(page_extents) - len(active)
        return stream

    # the repartition pass's page set, handed to the histogram pass of the
    # same pop: the rows that moved are the rows of the children's windows
    active_box: list[list[int] | None] = [None]

    def start_stream(offset: int, window: int):
        if not skip_enabled or offset == 0:
            return make_stream()
        active = active_box[0]
        active_box[0] = None
        if active is None:
            active = active_pages(lambda pos: (pos >= offset) & (pos < offset + window))
        return subset_stream(active)

    def hist_fn(offset: int, count: int, plan: LevelPlan) -> Tensor:
        # one double-buffered pass per step: page k+1 stages while page k's
        # histogram kernel runs. ``count`` is the driver's window span, a
        # superset of the build set for batched pops
        return ops.build_histogram_paged(
            start_stream(offset, count), g, h, positions, offset, plan.n_build, n_bins,
            build_nodes=plan.build_nodes,
        )

    def partition_fn(feature, split_bin, default_left, is_leaf, count_level):
        if skip_enabled:
            # after a pop's split writes, only the popped nodes are non-leaf
            # and hold rows: a page with none of theirs cannot change
            active = active_pages(lambda pos: ~is_leaf[pos.to(torch.int64)])
            active_box[0] = active
            stream = subset_stream(active)
        else:
            stream = make_stream()
        # one launch per page; every page adds its rows into the same counts
        counts = new_level_counts(count_level, g.device)
        span = count_span(count_level)
        for sp in stream:
            positions[sp.index] = ops.partition_rows(
                sp.device, positions[sp.index], feature, split_bin, default_left, is_leaf,
                span, counts,
            )
        return take_counts(count_level, counts)

    tree = tree_growth_driver(tp)(
        hist_fn, partition_fn, g.sum(), h.sum(), n_bins, bin_valid, tp,
        cut_values, cut_ptrs, hist_cache=hist_cache,
    )
    return tree, positions
