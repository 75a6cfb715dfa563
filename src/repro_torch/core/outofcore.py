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

`ExternalGradientBooster` is the deprecated alias of the old front door
(``(params, cache_dir=...)`` and ``fit(source)``): it builds an
`IterDMatrix` from the source and trains through `GradientBooster` under a
forced out-of-core policy, warning `FutureWarning` once per construction.
`PageSet` lives in `repro_torch.data.dmatrix`; importing it from here still
works.
"""
from __future__ import annotations

import inspect
import warnings

import numpy as np
import torch

from repro_torch.core.booster import BoosterParams, GradientBooster
from repro_torch.core.ellpack import DEFAULT_PAGE_BYTES
from repro_torch.core.histcache import (
    HistogramStore,
    LevelPlan,
    count_span,
    new_level_counts,
    take_counts,
)
from repro_torch.core.policy import ExecutionPolicy
from repro_torch.core.tree import TreeArrays, TreeParams, predict_tree_bins, tree_growth_driver
from repro_torch.data.pages import GLOBAL_STATS, TransferStats
from repro_torch.kernels import ops

Tensor = torch.Tensor


def __getattr__(name: str):
    # compatibility re-export: PageSet's home is the DMatrix module
    if name == "PageSet":
        from repro_torch.data.dmatrix import PageSet

        return PageSet
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


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
    hist_all_reduce=None,
    sum_all_reduce=None,
) -> tuple[TreeArrays, dict[int, Tensor]]:
    """One tree over streamed pages (Alg. 6 core), either growth policy.

    ``make_stream()`` starts one pass; pages arrive in `page_extents` order,
    each a `StreamedPage` whose host view carries ``row_offset`` and
    ``n_rows``. With histogram subtraction (the default) each histogram
    pass scatters only the rows of the build nodes. With ``page_skipping``
    and a ``make_stream`` that takes ``indices=``, lossguide passes skip the
    pages no popped node has rows on. Returns (tree, per-page final
    positions keyed by stream index).

    The sharded build (`repro_torch.distributed.grow_tree_distributed_paged`)
    passes the collectives of its mesh: ``hist_all_reduce(hist)`` sums each
    histogram pass over the ranks once, after the pass's page sum, and
    ``sum_all_reduce(t)`` sums the gradient totals and each partition pass's
    row counts. A rank skips pages by its own rows, so nothing reduces per
    page.
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
        hist = ops.build_histogram_paged(
            start_stream(offset, count), g, h, positions, offset, plan.n_build, n_bins,
            build_nodes=plan.build_nodes,
        )
        return hist if hist_all_reduce is None else hist_all_reduce(hist)

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
        if counts is not None and sum_all_reduce is not None:
            sum_all_reduce(counts)
        return take_counts(count_level, counts)

    total_g, total_h = g.sum(), h.sum()
    if sum_all_reduce is not None:
        total_g, total_h = sum_all_reduce(torch.stack([total_g, total_h]))
    tree = tree_growth_driver(tp)(
        hist_fn, partition_fn, total_g, total_h, n_bins, bin_valid, tp,
        cut_values, cut_ptrs, hist_cache=hist_cache,
    )
    return tree, positions


class ExternalGradientBooster(GradientBooster):
    """Deprecated alias for external-memory training.

    The unified surface is::

        dm = IterDMatrix(source, max_bin=..., cache_dir=...)
        GradientBooster(params, policy=ExecutionPolicy(mode="out_of_core")).fit(dm)

    This class keeps the ``(params, cache_dir=...)`` constructor and the
    ``fit(source)`` signature: it builds the `IterDMatrix` on first use
    (`preprocess`) and trains under a forced out-of-core policy, which
    promotes to the sampled path when the booster's `SamplingConfig` asks
    for sampling. Warns `FutureWarning` once per construction. ``device``
    (and any `BoosterParams` field) passes through ``**kwargs``.
    """

    def __init__(
        self,
        params: BoosterParams | None = None,
        cache_dir: str | None = None,
        page_bytes: int = DEFAULT_PAGE_BYTES,
        prefetch_depth: int = 2,
        staging_depth: int = 2,
        compress_pages: bool = False,
        stats: TransferStats | None = None,
        checkpoint_every: int | None = None,
        checkpoint_dir: str | None = None,
        device_cache_pages: int | None = None,
        **kwargs,
    ):
        warnings.warn(
            "ExternalGradientBooster is deprecated: use GradientBooster with "
            "ExecutionPolicy (e.g. GradientBooster(params, policy=ExecutionPolicy("
            "mode='out_of_core')).fit(IterDMatrix(source, cache_dir=...)))",
            FutureWarning,
            stacklevel=2,
        )
        policy = ExecutionPolicy(
            mode="out_of_core",
            prefetch_depth=prefetch_depth,
            staging_depth=staging_depth,
            device_cache_pages=device_cache_pages,
            checkpoint_every=checkpoint_every,
            checkpoint_dir=checkpoint_dir,
        )
        super().__init__(params, policy=policy, **kwargs)
        self.cache_dir = cache_dir
        self.page_bytes = page_bytes
        self.compress_pages = compress_pages
        self.stats = stats or GLOBAL_STATS
        self.labels_: np.ndarray | None = None
        self._dmatrix = None

    def preprocess(self, source, cuts=None):
        """Alg. 3 (incremental sketch) + Alg. 5 (external ELLPACK pages).
        Explicit ``cuts`` pin the quantisation (checkpoint resume) and skip
        the sketch pass."""
        from repro_torch.data.dmatrix import IterDMatrix

        self._dmatrix = IterDMatrix(
            source,
            max_bin=self.params.max_bin,
            cuts=cuts,
            cache_dir=self.cache_dir,
            page_bytes=self.page_bytes,
            compress=self.compress_pages,
            stats=self.stats,
            device=self.device,
        )
        self.cuts = self._dmatrix.cuts
        self.labels_ = self._dmatrix.labels
        self.pages = self._dmatrix.page_set()
        return self.pages

    def fit(
        self,
        source,
        eval_set: tuple[np.ndarray, np.ndarray] | None = None,
        eval_metric: str = "auto",
        verbose: bool = False,
        start_iteration: int = 0,
    ) -> "ExternalGradientBooster":
        if self._dmatrix is None:
            self.preprocess(source)
        return super().fit(
            self._dmatrix,
            eval_set=eval_set,
            eval_metric=eval_metric,
            verbose=verbose,
            start_iteration=start_iteration,
        )

    @classmethod
    def resume(
        cls, checkpoint_path: str, source, cache_dir: str | None = None, **kw
    ) -> "ExternalGradientBooster":
        """Restart from a checkpoint: reload the forest and rebuild the
        margins by streaming the source's pages, quantised with the
        checkpoint's cuts (numpy f32, ``margins[page] += lr * pred`` tree by
        tree, as the reference)."""
        base = GradientBooster.load(checkpoint_path, device=kw.get("device", "cuda"))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", FutureWarning)  # resume implies the alias
            self = cls(base.params, cache_dir=cache_dir, **kw)
        self.trees = base.trees
        self.base_margin_ = base.base_margin_
        self.preprocess(source, cuts=base.cuts)
        margins = np.full(self.pages.n_rows, self.base_margin_, np.float32)
        lr, md = self.params.learning_rate, self.params.max_depth
        for tree in self.trees:
            for sp in self._stream():
                pred = predict_tree_bins(tree, sp.device, md).cpu().numpy()
                sl = slice(sp.host.row_offset, sp.host.row_offset + sp.host.n_rows)
                margins[sl] += lr * pred
        self.margins_ = torch.from_numpy(margins).to(self.device)
        return self
