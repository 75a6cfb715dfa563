"""Depth-wise tree construction (paper Alg. 1) on the device.

Counterpart of `repro.core.tree`. Trees use the complete-binary-tree array
layout (node i -> children 2i+1, 2i+2; n_total = 2^(max_depth+1) - 1). Per
level d:

  histogram over the build nodes   (kernels.ops.build_histogram_nodes)
  -> sibling derivation            (core.histcache: parent - built)
  -> EvaluateSplit                 (core.split.evaluate_splits)
  -> RepartitionInstances          (kernels.ops.partition_rows)

`grow_tree_generic` drives the levels through two callbacks, histogram
accumulation (`HistFn`) and row repartition (`PartitionFn`), so the
out-of-core builder (`core.outofcore.build_tree_paged`) reuses it with page
loops. Rows carry a global node-id position that freezes at leaves, so after
the last level ``leaf_value[pos]`` is every training row's prediction.

Best-first growth (``grow_policy="lossguide"``) is queued: `TreeParams`
raises for it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core.histcache import HistogramStore, LevelPlan, new_level_counts
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

    def __post_init__(self) -> None:
        if self.grow_policy not in GROW_POLICIES:
            raise ValueError(
                f"grow_policy must be one of {GROW_POLICIES}, got {self.grow_policy!r}"
            )
        if self.grow_policy == "lossguide":
            raise NotImplementedError(
                "grow_policy='lossguide' (best-first growth) is not ported yet; "
                "it is queued after the in-core depthwise slice"
            )

    @property
    def n_total_nodes(self) -> int:
        """Heap-array capacity: complete tree over max_depth."""
        return 2 ** (self.max_depth + 1) - 1


class TreeBuildResult(NamedTuple):
    tree: TreeArrays
    positions: Tensor  # (n_rows,) final leaf node per training row


# HistFn(offset, count, plan) -> (plan.n_build, m, n_bins, 2): the histograms
# of the global node ids in ``plan.build_nodes`` (level [offset, offset+count)).
HistFn = Callable[[int, int, LevelPlan], Tensor]

# PartitionFn(feature, split_bin, default_left, is_leaf, count_level)
#   -> (count,) int32 row counts of the next level's nodes, or None.
# Repartitions every live row to its child (rows at leaves stay frozen).
# ``count_level`` is the next level's (offset, count), or None when no
# histogram follows or subtraction is off.
PartitionFn = Callable[
    [Tensor, Tensor, Tensor, Tensor, "tuple[int, int] | None"], "Tensor | None"
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
    """In-core builder (paper Alg. 1): one device-resident ELLPACK matrix."""
    pos_box = [torch.zeros(bins.shape[0], dtype=torch.int32, device=bins.device)]

    def hist_fn(offset: int, count: int, plan: LevelPlan) -> Tensor:
        return ops.build_histogram_nodes(bins, g, h, pos_box[0], plan.build_nodes, n_bins)

    def partition_fn(feature, split_bin, default_left, is_leaf, count_level):
        counts = new_level_counts(count_level, bins.device)
        pos_box[0] = ops.partition_rows(
            bins, pos_box[0], feature, split_bin, default_left, is_leaf, count_level, counts
        )
        return counts

    tree = grow_tree_generic(
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
