"""Tree construction on the device: depth-wise (paper Alg. 1) and best-first.

Counterpart of `repro.core.tree`. Trees use the complete-binary-tree array
layout (node i -> children 2i+1, 2i+2; n_total = 2^(effective_max_depth+1)
- 1). Per level d:

  histogram over the build nodes   (kernels.ops.build_histogram_nodes)
  -> sibling derivation            (core.histcache: parent - built)
  -> EvaluateSplit                 (core.split.evaluate_splits)
  -> RepartitionInstances          (kernels.ops.partition_rows)

`grow_tree_generic` drives the levels through two callbacks, histogram
accumulation (`HistFn`) and row repartition (`PartitionFn`), so the
out-of-core, sampled and elastic builders reuse it with their own passes.
Rows carry a global node-id position that freezes at leaves, so after the
last level ``leaf_value[pos]`` is every training row's prediction.

`grow_tree_lossguide_generic` is the best-first (lossguide) sibling over the
same two callbacks: a frontier ordered by split gain (node id breaks ties)
pops up to ``pop_batch`` leaves, writes their splits, repartitions only their
rows in one pass and builds their children's histograms in one pass, through
the store's per-node plans. Each pop's candidate splits reach the host in one
copy. Every builder picks its driver with `tree_growth_driver`.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core.histcache import (
    HistogramStore,
    LevelPlan,
    count_span,
    new_level_counts,
    take_counts,
)
from repro_torch.core.split import LevelSplits, SplitParams, evaluate_splits, leaf_weight
from repro_torch.kernels import ops

Tensor = torch.Tensor


class TreeArrays(NamedTuple):
    """One regression tree, complete-tree layout. All tensors length n_total."""

    feature: Tensor  # int32 split feature (0 for leaves)
    split_bin: Tensor  # int32 split bin (go left iff bin <= split_bin)
    split_value: Tensor  # f32 raw threshold (go left iff x <= split_value)
    default_left: Tensor  # bool missing-value direction
    is_leaf: Tensor  # bool
    leaf_value: Tensor  # f32 (0 for internal nodes)

    @property
    def n_total(self) -> int:
        return self.feature.shape[0]

    @property
    def max_depth(self) -> int:
        return int(np.log2(self.n_total + 1)) - 1


GROW_POLICIES = ("depthwise", "lossguide")


@dataclasses.dataclass(frozen=True)
class TreeParams:
    max_depth: int = 6
    split: SplitParams = SplitParams()
    # build only the smaller child of each split pair per level and derive the
    # sibling histogram as parent - built (exact up to f32 accumulation order)
    hist_subtraction: bool = True
    grow_policy: str = "depthwise"
    # lossguide leaf budget; 0 = up to the 2^max_depth complete tree.
    # Ignored by depthwise.
    max_leaves: int = 0
    # lossguide: frontier leaves popped per iteration, whose child windows
    # share one histogram pass and one repartition pass. 1 is strictly
    # best-first; >1 pops the current top-k without re-ranking against the
    # children just made (the same tree at a full leaf budget). Ignored by
    # depthwise.
    pop_batch: int = 1

    def __post_init__(self) -> None:
        if self.grow_policy not in GROW_POLICIES:
            raise ValueError(
                f"grow_policy must be one of {GROW_POLICIES}, got {self.grow_policy!r}"
            )
        if self.max_leaves < 0:
            raise ValueError(f"max_leaves must be >= 0, got {self.max_leaves}")
        if self.pop_batch < 1:
            raise ValueError(f"pop_batch must be >= 1, got {self.pop_batch}")

    @property
    def effective_max_depth(self) -> int:
        """Deepest level a node can reach: a lossguide tree of L leaves makes
        L - 1 splits, so no node sits deeper than min(max_depth, L - 1), and
        the node arrays shrink accordingly."""
        if self.grow_policy == "lossguide" and self.max_leaves:
            return min(self.max_depth, max(self.max_leaves - 1, 0))
        return self.max_depth

    @property
    def n_total_nodes(self) -> int:
        """Heap-array capacity: complete tree over the effective depth."""
        return 2 ** (self.effective_max_depth + 1) - 1

    @property
    def leaf_budget(self) -> int:
        """Most leaves a built tree may have (both policies)."""
        full = 2**self.effective_max_depth
        if self.grow_policy == "lossguide" and self.max_leaves:
            return min(self.max_leaves, full)
        return full


class TreeBuildResult(NamedTuple):
    tree: TreeArrays
    positions: Tensor  # (n_rows,) final leaf node per training row


# HistFn(offset, count, plan) -> (plan.n_build, m, n_bins, 2): the histograms
# of the global node ids in ``plan.build_nodes``. ``[offset, offset + count)``
# is the node window: a whole level for the depthwise driver, the popped
# node's 2-child window, or for batched pops the span of their children (a
# superset of the build set). ``plan.node_map`` maps the window's nodes to
# build slots where the window is contiguous (the level-window kernel's
# form); None means a full build or a batch.
HistFn = Callable[[int, int, LevelPlan], Tensor]

# PartitionFn(feature, split_bin, default_left, is_leaf, count_level)
#   -> int32 row counts, or None.
# Repartitions every live row to its child (rows at leaves stay frozen, so
# after a pop only the popped nodes' rows move). ``count_level`` is None when
# no histogram follows or subtraction is off; else the next window's
# ``(offset, count)`` (counts per node of it), or for batched pops a sorted
# list of global node ids (counts per listed node, in order: count the span
# with `histcache.new_level_counts` and gather with `take_counts`).
PartitionFn = Callable[
    [Tensor, Tensor, Tensor, Tensor, "tuple[int, int] | list[int] | None"], "Tensor | None"
]


def grow_tree_generic(
    hist_fn: HistFn,
    partition_fn: PartitionFn,
    total_g: Tensor,
    total_h: Tensor,
    n_bins: int,
    bin_valid: Tensor,  # (m, n_bins) bool
    params: TreeParams,
    cut_values: np.ndarray | None = None,
    cut_ptrs: np.ndarray | None = None,
    hist_cache: HistogramStore | None = None,
) -> TreeArrays:
    dev = bin_valid.device
    n_total = params.n_total_nodes
    max_depth = params.max_depth
    cache = hist_cache if hist_cache is not None else HistogramStore(
        enabled=params.hist_subtraction
    )
    cache.reset()
    level_counts: Tensor | None = None
    reg_lambda = params.split.reg_lambda

    feature = torch.zeros(n_total, dtype=torch.int32, device=dev)
    split_bin = torch.zeros(n_total, dtype=torch.int32, device=dev)
    default_left = torch.zeros(n_total, dtype=torch.bool, device=dev)
    is_leaf = torch.ones(n_total, dtype=torch.bool, device=dev)
    leaf_value = torch.zeros(n_total, dtype=torch.float32, device=dev)
    node_g = torch.zeros(n_total, dtype=torch.float32, device=dev)
    node_h = torch.zeros(n_total, dtype=torch.float32, device=dev)
    node_g[0] = total_g
    node_h[0] = total_h
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    for depth in range(max_depth):
        offset, count = 2**depth - 1, 2**depth
        sl = slice(offset, offset + count)
        plan = cache.plan(count, level_counts, dev)
        hist = cache.expand(plan, hist_fn(offset, count, plan))
        lvl_g, lvl_h = node_g[sl], node_h[sl]
        splits: LevelSplits = evaluate_splits(hist, lvl_g, lvl_h, bin_valid, params.split)

        # only nodes that are still growable (parent split) may split
        growable = ~is_leaf[sl] if depth else torch.ones(count, dtype=torch.bool, device=dev)
        do_split = splits.should_split & growable

        feature[sl] = torch.where(do_split, splits.feature, torch.zeros_like(splits.feature))
        split_bin[sl] = torch.where(
            do_split, splits.split_bin, torch.zeros_like(splits.split_bin)
        )
        default_left[sl] = splits.default_left & do_split
        is_leaf[sl] = ~do_split
        # nodes finalised as leaves at this level get their weight (eq. 6)
        w = leaf_weight(lvl_g, lvl_h, reg_lambda)
        leaf_value[sl] = torch.where(do_split | ~growable, zero, w)

        # children of level d are the contiguous range [2*offset+1, 2*offset+1+2*count)
        kids = slice(2 * offset + 1, 2 * offset + 1 + 2 * count)
        node_g[kids] = torch.stack(
            [torch.where(do_split, splits.left_g, zero), torch.where(do_split, splits.right_g, zero)],
            dim=1,
        ).reshape(-1)
        node_h[kids] = torch.stack(
            [torch.where(do_split, splits.left_h, zero), torch.where(do_split, splits.right_h, zero)],
            dim=1,
        ).reshape(-1)
        # children start growable iff the parent split
        is_leaf[kids] = (~do_split).repeat_interleave(2)

        count_level = (
            (2 ** (depth + 1) - 1, 2 ** (depth + 1))
            if cache.enabled and depth + 1 < max_depth
            else None
        )
        level_counts = partition_fn(feature, split_bin, default_left, is_leaf, count_level)

    # final level: every still-growable node is a leaf with its eq.-(6) weight
    offset, count = 2**max_depth - 1, 2**max_depth
    sl = slice(offset, offset + count)
    growable = ~is_leaf[sl] if max_depth else torch.ones(1, dtype=torch.bool, device=dev)
    w = leaf_weight(node_g[sl], node_h[sl], reg_lambda)
    leaf_value[sl] = torch.where(growable, w, leaf_value[sl])
    is_leaf[sl] = True

    return TreeArrays(
        feature=feature,
        split_bin=split_bin,
        split_value=_finalize_split_values(feature, split_bin, is_leaf, cut_values, cut_ptrs),
        default_left=default_left,
        is_leaf=is_leaf,
        leaf_value=leaf_value,
    )


def _finalize_split_values(
    feature: Tensor,
    split_bin: Tensor,
    is_leaf: Tensor,
    cut_values: np.ndarray | None,
    cut_ptrs: np.ndarray | None,
) -> Tensor:
    """Raw thresholds for prediction on unquantised features (0 at leaves)."""
    if cut_values is None or cut_ptrs is None:
        return torch.zeros(feature.shape[0], dtype=torch.float32, device=feature.device)
    values = torch.as_tensor(cut_values, dtype=torch.float32, device=feature.device)
    ptrs = torch.as_tensor(cut_ptrs, dtype=torch.int64, device=feature.device)
    idx = (ptrs[feature.to(torch.int64)] + split_bin.to(torch.int64)).clamp_(0, values.shape[0] - 1)
    return torch.where(is_leaf, torch.zeros_like(values[idx]), values[idx])


class _SplitCandidate(NamedTuple):
    """Frontier entry: one growable leaf's best split as host scalars
    (best-first order is host control flow)."""

    feature: int
    split_bin: int
    default_left: bool
    left_g: float
    left_h: float
    right_g: float
    right_h: float


def _splits_to_host(splits: LevelSplits) -> tuple:
    """The nine fields of ``splits`` as host arrays, in one device-to-host
    copy: the f32 fields travel as their int32 bit patterns beside the int32
    ones, so every float arrives exact. Returns (gain, left_g, left_h,
    right_g, right_h) as f32 arrays and (feature, split_bin, default_left,
    should_split) as int32 arrays."""
    words = torch.stack([
        splits.gain.view(torch.int32), splits.left_g.view(torch.int32),
        splits.left_h.view(torch.int32), splits.right_g.view(torch.int32),
        splits.right_h.view(torch.int32), splits.feature, splits.split_bin,
        splits.default_left.to(torch.int32), splits.should_split.to(torch.int32),
    ]).cpu().numpy()
    floats = words[:5].view(np.float32)
    return tuple(floats) + tuple(words[5:])


def grow_tree_lossguide_generic(
    hist_fn: HistFn,
    partition_fn: PartitionFn,
    total_g: Tensor,
    total_h: Tensor,
    n_bins: int,
    bin_valid: Tensor,  # (m, n_bins) bool
    params: TreeParams,
    cut_values: np.ndarray | None = None,
    cut_ptrs: np.ndarray | None = None,
    hist_cache: HistogramStore | None = None,
) -> TreeArrays:
    """Best-first (loss-guided) growth over the `grow_tree_generic` callbacks.

    A frontier ordered by gain pops up to ``pop_batch`` leaves, writes their
    splits into the heap arrays, repartitions their rows in one
    `PartitionFn` pass (every other node is a leaf, so its rows stay put) and
    builds their children's histograms in one `HistFn` pass, the smaller
    child of each by the store's per-node plan. At ``max_leaves >=
    2**effective_max_depth`` with untied gains this is the depthwise tree;
    smaller budgets keep the highest-gain splits.
    """
    dev = bin_valid.device
    n_total = params.n_total_nodes
    eff_depth = params.effective_max_depth
    max_leaves = params.leaf_budget
    cache = hist_cache if hist_cache is not None else HistogramStore(
        enabled=params.hist_subtraction
    )
    cache.reset()

    feature = torch.zeros(n_total, dtype=torch.int32, device=dev)
    split_bin = torch.zeros(n_total, dtype=torch.int32, device=dev)
    default_left = torch.zeros(n_total, dtype=torch.bool, device=dev)
    is_leaf = torch.ones(n_total, dtype=torch.bool, device=dev)
    node_g = torch.zeros(n_total, dtype=torch.float32, device=dev)
    node_h = torch.zeros(n_total, dtype=torch.float32, device=dev)
    node_g[0] = total_g
    node_h[0] = total_h

    # heap entries (-gain, node, candidate): highest gain first, the node id
    # breaking exact ties (the depthwise left-to-right order)
    frontier: list[tuple[float, int, _SplitCandidate]] = []

    def push_candidates(nodes: list[int], hist: Tensor) -> None:
        if len(nodes) == 1 or nodes[-1] - nodes[0] == len(nodes) - 1:
            sl = slice(nodes[0], nodes[-1] + 1)
            ng, nh = node_g[sl], node_h[sl]
        else:
            idx = torch.tensor(nodes, dtype=torch.int64, device=dev)
            ng, nh = node_g[idx], node_h[idx]
        splits = evaluate_splits(hist, ng, nh, bin_valid, params.split)
        gain, lg, lh, rg, rh, feat, sbin, dleft, should = _splits_to_host(splits)
        for j, node in enumerate(nodes):
            if should[j]:
                cand = _SplitCandidate(
                    int(feat[j]), int(sbin[j]), bool(dleft[j]),
                    float(lg[j]), float(lh[j]), float(rg[j]), float(rh[j]),
                )
                heapq.heappush(frontier, (-float(gain[j]), node, cand))
                # the store spills coldest first: the frontier gain is the heat
                cache.note_gain(node, float(gain[j]))
            else:
                cache.discard_node(node)  # a permanent leaf

    n_leaves = 1
    if eff_depth >= 1 and max_leaves >= 2:
        root_hist = hist_fn(0, 1, LevelPlan(
            node_map=None, n_build=1, count=1,
            build_nodes=torch.zeros(1, dtype=torch.int32, device=dev),
        ))
        cache.put_node(0, root_hist[0])
        push_candidates([0], root_hist)

    pop_batch = max(1, params.pop_batch)
    while frontier and n_leaves < max_leaves:
        # the popped splits are written together, so one repartition pass
        # moves every popped node's rows and one histogram pass covers all
        # their child windows (one page pass each out of core)
        batch: list[tuple[int, bool]] = []
        while frontier and len(batch) < pop_batch and n_leaves < max_leaves:
            _, node, cand = heapq.heappop(frontier)
            left, right = 2 * node + 1, 2 * node + 2
            feature[node] = cand.feature
            split_bin[node] = cand.split_bin
            default_left[node] = cand.default_left
            is_leaf[node] = False
            node_g[left] = cand.left_g
            node_h[left] = cand.left_h
            node_g[right] = cand.right_g
            node_h[right] = cand.right_h
            n_leaves += 1
            # children sit at depth(node) + 1; they can split only if their
            # own children still fit under the effective depth
            expandable = (node + 1).bit_length() < eff_depth and n_leaves < max_leaves
            batch.append((node, expandable))

        # parents in ascending order: the batch's slots follow node order
        parents = sorted(node for node, expandable in batch if expandable)
        for node, expandable in batch:
            if not expandable:
                cache.discard_node(node)

        if parents and cache.enabled:
            count_window = (
                (2 * parents[0] + 1, 2)
                if len(parents) == 1
                else [2 * p + 1 + c for p in parents for c in (0, 1)]
            )
        else:
            count_window = None
        counts = partition_fn(feature, split_bin, default_left, is_leaf, count_window)

        if len(parents) == 1:
            node = parents[0]
            left = 2 * node + 1
            plan = cache.plan_node(node, counts, dev)
            child_hist = cache.expand_node(node, plan, hist_fn(left, 2, plan))
            push_candidates([left, left + 1], child_hist)
        elif parents:
            lo = 2 * parents[0] + 1
            span = 2 * parents[-1] + 2 - lo + 1
            plan = cache.plan_nodes(parents, counts, dev)
            child_hist = cache.expand_nodes(parents, plan, hist_fn(lo, span, plan))
            push_candidates([2 * p + 1 + c for p in parents for c in (0, 1)], child_hist)

    # budget spent: the nodes left on the frontier stay leaves
    for _, node, _ in frontier:
        cache.discard_node(node)

    # every reachable leaf gets its eq.-(6) weight; unreachable slots have
    # node_g == node_h == 0, so theirs is (negative) zero
    w = leaf_weight(node_g, node_h, params.split.reg_lambda)
    leaf_value = torch.where(is_leaf, w, torch.zeros_like(w))
    return TreeArrays(
        feature=feature,
        split_bin=split_bin,
        split_value=_finalize_split_values(feature, split_bin, is_leaf, cut_values, cut_ptrs),
        default_left=default_left,
        is_leaf=is_leaf,
        leaf_value=leaf_value,
    )


def tree_growth_driver(params: TreeParams):
    """The driver of ``params.grow_policy``: both share the HistFn and
    PartitionFn contracts, so every builder dispatches through here."""
    if params.grow_policy == "lossguide":
        return grow_tree_lossguide_generic
    return grow_tree_generic


def grow_tree(
    bins: Tensor,  # (n_rows, m) uint8 or int32 quantised features, on the device
    g: Tensor,  # (n_rows,) f32
    h: Tensor,  # (n_rows,) f32
    n_bins: int,
    bin_valid: Tensor,  # (m, n_bins) bool
    params: TreeParams,
    cut_values: np.ndarray | None = None,
    cut_ptrs: np.ndarray | None = None,
    hist_cache: HistogramStore | None = None,
) -> TreeBuildResult:
    """In-core builder (paper Alg. 1; best-first when ``params.grow_policy ==
    "lossguide"``): one device-resident ELLPACK matrix."""
    pos_box = [torch.zeros(bins.shape[0], dtype=torch.int32, device=bins.device)]

    def hist_fn(offset: int, count: int, plan: LevelPlan) -> Tensor:
        return ops.build_histogram_nodes(bins, g, h, pos_box[0], plan.build_nodes, n_bins)

    def partition_fn(feature, split_bin, default_left, is_leaf, count_level):
        counts = new_level_counts(count_level, bins.device)
        pos_box[0] = ops.partition_rows(
            bins, pos_box[0], feature, split_bin, default_left, is_leaf,
            count_span(count_level), counts,
        )
        return take_counts(count_level, counts)

    tree = tree_growth_driver(params)(
        hist_fn, partition_fn, g.sum(), h.sum(), n_bins, bin_valid, params,
        cut_values, cut_ptrs, hist_cache=hist_cache,
    )
    return TreeBuildResult(tree=tree, positions=pos_box[0])


def predict_tree_bins(tree: TreeArrays, bins: Tensor, max_depth: int) -> Tensor:
    """Predict one tree over quantised rows."""
    return ops.predict_bins(
        bins, tree.feature, tree.split_bin, tree.default_left, tree.is_leaf,
        tree.leaf_value, max_depth,
    )
