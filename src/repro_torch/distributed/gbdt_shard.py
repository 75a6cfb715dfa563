"""Distributed GBDT tree construction (paper §2.2: histogram all-reduce).

Counterpart of `repro.distributed.gbdt_shard`, over `torch.distributed`.
Parallelism axes (all optional, compose):

  * rows sharded over the data axes ("pod", "data"): each rank builds the
    histogram of its own rows, and an all-reduce sums them (the paper's
    AllReduce);
  * features sharded over the "model" axis: each model shard evaluates its
    own feature slice, the per-node candidates are all-gathered (a few
    hundred bytes a node) and arg-maxed, first shard on ties, which is the
    single device's first arg-max over the global feature order; the shard
    owning a split feature decides its rows' left/right, all-reduced over
    the model group.

Distributed-optimisation tricks, as in the reference:

  * histogram subtraction (on unless `DistConfig.hist_subtraction` or
    `TreeParams.hist_subtraction` is off): each level all-reduces only the
    smaller child of every split pair, and each sibling is derived after the
    reduce as ``parent - built``; the build/derive choice uses the
    all-reduced row counts, so every rank makes the same one;
  * a narrowed wire (`DistConfig.grad_transport` "f16"/"bf16", or the
    legacy ``hist_dtype="bfloat16"``): the all-reduce carries the narrowed
    dtype and sums in it, and the result is widened to f32 after;
  * one data-sized collective a level: split search and the partition
    exchange O(nodes) and O(rows / shard) bytes.

The mesh, SPMD: one process per shard, `torchrun`'s model and the
counterpart of JAX's one program over a `Mesh`. `make_mesh(shape,
axis_names)` needs an initialised default process group of ``prod(shape)``
ranks (a world of one needs none: every collective is then the identity).
Ranks are laid out row-major over the axes, as JAX orders devices, so data
shard ``i`` of ``N`` holds rows ``[i*n/N, (i+1)*n/N)``. The sub-group of
every axis tuple is made once, at construction, in the same order on every
rank. The backend is the caller's process group. On a machine with one card
the ranks share it and the group is gloo: NCCL refuses two ranks of one
communicator on one device. Gloo takes CUDA tensors in all-reduce and
all-gather (through host copies), in every dtype used here (f32, f16, bf16,
int32, int64). `Mesh.stats` books every collective's calls, bytes (what this
rank hands in) and seconds (host clock, after the device has finished the
input, so it times the collective and not the kernels before it).

The SPMD calling convention: every rank calls each function with the same
global inputs, as the reference's caller passes global arrays. Each rank
stages only its row slice (and feature slice) as uint8, returns the tree
replicated, and returns row positions as the global vector gathered in mesh
row order (the reference's ``out_specs=(rep, vec_spec)``). `fit_sharded`
keeps each rank's margins to its own rows and returns a whole
`GradientBooster` on every rank.

Growth policy: ``grow_policy="lossguide"`` (on `DistConfig` or
`TreeParams`) builds best-first through `core.tree
.grow_tree_lossguide_generic`, whose per-pop histogram all-reduces only the
built child; `make_gbdt_step_fn` stays depthwise, as in the reference.
Out of core (`grow_tree_distributed_paged`), each rank streams its row
slice of every page through `PageStream` and reduces once per histogram
pass, after its page sum: ranks skip pages by their own rows, so a per-page
reduce would pair different pages across ranks.

``kernel_impl`` is read and has no effect: the device of the tensors picks
the kernel or its plain version (`kernels.ops`).
"""
from __future__ import annotations

import dataclasses
import datetime
import itertools
import os
import time
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.histcache import (
    HistogramStore,
    count_span,
    expand_level,
    level_row_counts,
    new_level_counts,
    plan_level,
    take_counts,
)
from repro_torch.core.split import evaluate_splits, leaf_weight
from repro_torch.core.tree import (
    TreeArrays,
    TreeParams,
    _finalize_split_values,
    grow_tree_lossguide_generic,
)
from repro_torch.kernels import ops

Tensor = torch.Tensor


# ------------------------------------------------------------------ the mesh
@dataclasses.dataclass
class CollectiveStats:
    """This rank's collectives: calls, bytes handed in, and host seconds."""

    all_reduce_calls: int = 0
    all_reduce_bytes: int = 0
    all_reduce_seconds: float = 0.0
    all_gather_calls: int = 0
    all_gather_bytes: int = 0
    all_gather_seconds: float = 0.0

    def reset(self) -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, f.default)


def _default_group_timeout() -> datetime.timedelta | None:
    """The default process group's timeout, for its sub-groups (None if
    this torch does not expose it: then `new_group` takes its default)."""
    try:
        pg = dist.distributed_c10d._get_default_group()
        return pg._get_backend(torch.device("cpu")).options._timeout
    except (AttributeError, RuntimeError):
        return None


class Mesh:
    """Named axes over the ranks of the default process group, row-major.

    ``shape`` maps axis name to size, in axis order, as `jax.sharding.Mesh`
    does. ``coords`` are this rank's index on each axis. ``device`` is where
    this rank's shards live."""

    def __init__(
        self,
        shape: Sequence[int],
        axis_names: Sequence[str],
        device: str | torch.device = "cuda",
    ):
        shape = tuple(int(s) for s in shape)
        axis_names = tuple(axis_names)
        if len(shape) != len(axis_names) or len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh shape {shape} and axis names {axis_names} do not match")
        if any(s < 1 for s in shape):
            raise ValueError(f"mesh axes must have size >= 1, got {shape}")
        world = int(np.prod(shape))
        if dist.is_available() and dist.is_initialized():
            if dist.get_world_size() != world:
                raise ValueError(
                    f"make_mesh({shape}) needs {world} ranks; the default process "
                    f"group has {dist.get_world_size()}"
                )
            self.rank = dist.get_rank()
            self._distributed = world > 1
        elif world == 1:
            self.rank = 0
            self._distributed = False
        else:
            raise RuntimeError(
                f"make_mesh({shape}) spans {world} ranks but no default process group "
                "is initialised: call torch.distributed.init_process_group (with a "
                "timeout) in each of the ranks first; nothing runs one shard alone"
            )
        self.shape = dict(zip(axis_names, shape))
        self.axis_names = axis_names
        self.world_size = world
        self.coords = dict(zip(axis_names, (int(c) for c in np.unravel_index(self.rank, shape))))
        self.device = _mesh_device(device, self.rank)
        self.stats = CollectiveStats()
        # every axis tuple's sub-group, made once, in the same order on every
        # rank (new_group is collective over the default group), with the
        # default group's timeout
        self._groups: dict[tuple[str, ...], object] = {}
        if self._distributed:
            timeout = _default_group_timeout()
            ranks = np.arange(world).reshape(shape)
            for k in range(1, len(axis_names) + 1):
                for axes in itertools.combinations(axis_names, k):
                    self._groups[axes] = self._make_groups(ranks, axes, timeout)

    def _make_groups(self, ranks: np.ndarray, axes: tuple[str, ...], timeout):
        """This rank's group over ``axes`` (None: the default group, or a
        group of one, whose collectives are the identity)."""
        size = self.axis_size(axes)
        if size == 1 or size == self.world_size:
            return None
        moved = np.moveaxis(ranks, [self.axis_names.index(a) for a in axes],
                            list(range(-len(axes), 0)))
        mine = None
        for block in moved.reshape(-1, size):
            group = dist.new_group(ranks=[int(r) for r in block], timeout=timeout)
            if self.rank in block:
                mine = group
        return mine

    @staticmethod
    def _axes(axes: str | Sequence[str]) -> tuple[str, ...]:
        return (axes,) if isinstance(axes, str) else tuple(axes)

    def axis_size(self, axes: str | Sequence[str]) -> int:
        return int(np.prod([self.shape[a] for a in self._axes(axes)]))

    def axis_index(self, axes: str | Sequence[str]) -> int:
        """This rank's index over ``axes``, row-major (a data shard's index
        over ``("pod", "data")``)."""
        idx = 0
        for a in self._axes(axes):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def _group(self, axes: tuple[str, ...]):
        return self._groups.get(tuple(a for a in self.axis_names if a in axes))

    @staticmethod
    def _ready(t: Tensor) -> None:
        # the input's producers finish before the clock starts
        if t.is_cuda:
            torch.cuda.synchronize(t.device)

    def all_reduce(self, t: Tensor, axes: str | Sequence[str]) -> Tensor:
        """Sum ``t`` in place over the ranks that share every coordinate but
        ``axes``'; returns ``t``. Identity over a size-1 axis set."""
        axes = self._axes(axes)
        if not self._distributed or self.axis_size(axes) == 1:
            return t
        self._ready(t)
        t0 = time.perf_counter()
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self._group(axes))
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
        self.stats.all_reduce_seconds += time.perf_counter() - t0
        self.stats.all_reduce_calls += 1
        self.stats.all_reduce_bytes += t.numel() * t.element_size()
        return t

    def all_gather(self, t: Tensor, axes: str | Sequence[str]) -> Tensor:
        """``(axis_size(axes),) + t.shape``: every rank's ``t`` over ``axes``,
        in index order, on ``t``'s device."""
        axes = self._axes(axes)
        n = self.axis_size(axes)
        if not self._distributed or n == 1:
            return t.unsqueeze(0)
        self._ready(t)
        t0 = time.perf_counter()
        src = t.contiguous()
        parts = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(parts, src, group=self._group(axes))
        out = torch.stack(parts)
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
        self.stats.all_gather_seconds += time.perf_counter() - t0
        self.stats.all_gather_calls += 1
        self.stats.all_gather_bytes += src.numel() * src.element_size()
        return out


def _mesh_device(device, rank: int) -> torch.device:
    from repro_torch.core.booster import resolve_device

    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
        local = int(os.environ.get("LOCAL_RANK", rank))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    return resolve_device(dev)


def make_mesh(
    shape: Sequence[int], axis_names: Sequence[str], device: str | torch.device = "cuda"
) -> Mesh:
    """The port's `jax.make_mesh`: ``shape`` over ``axis_names``, on the
    ranks of the default process group (see `Mesh`). ``device`` defaults to
    ``cuda:{LOCAL_RANK % device_count()}``; pass ``"cpu"`` for the plain
    versions."""
    return Mesh(shape, axis_names, device=device)


# ----------------------------------------------------------------- config
@dataclasses.dataclass(frozen=True)
class DistConfig:
    data_axes: tuple[str, ...] = ("data",)  # row sharding (+"pod" multi-pod)
    feature_axis: str | None = None  # "model" for feature-parallel split search
    hist_dtype: str = "float32"  # "bfloat16" -> compressed histogram all-reduce
    kernel_impl: str = "auto"  # read for compatibility; no effect
    hist_subtraction: bool = True  # all-reduce only the built half
    # growth-policy overrides of TreeParams (None inherits)
    grow_policy: str | None = None
    max_leaves: int | None = None
    # the tiered HistogramStore of the host-driven builders (the paged build
    # and the best-first frontier): it sees only all-reduced histograms and
    # counts, so every rank makes the same spill decisions
    hist_budget_bytes: int | None = None
    hist_retained_levels: int = 1
    # the all-reduce's wire (compress.GradQuantizer): "raw" (f32), "f16" or
    # "bf16"; "int8" is rejected (partial sums overflow across shards)
    grad_transport: str = "raw"
    # page codec of the sharded staging: "bitpack" stages each rank's packed
    # rows and decodes them on the device (rows only: no feature_axis)
    page_codec: str = "raw"

    def __post_init__(self) -> None:
        from repro_torch.compress import GradQuantizer, get_codec, make_transport

        get_codec(self.page_codec)
        GradQuantizer.resolve(self.grad_transport).psum_cast  # mode check
        if self.grad_transport not in ("raw", "f16", "bf16"):
            raise ValueError(
                f"DistConfig(grad_transport={self.grad_transport!r}) cannot "
                "back the histogram psum: int8 partial sums overflow across "
                "shards. Use 'f16'/'bf16' here, and point 'int8' at the "
                "spill transport (ExecutionPolicy(grad_transport='int8'))"
            )
        if make_transport(self.page_codec) is not None and self.feature_axis is not None:
            raise ValueError(
                f"DistConfig(page_codec={self.page_codec!r}) stages packed "
                "bytes, which only shard by rows; feature_axis="
                f"{self.feature_axis!r} would split symbols mid-byte. Drop "
                "feature_axis or use page_codec='raw'"
            )

    @property
    def grad_quantizer(self):
        """The all-reduce's transport, folding in the legacy hist_dtype knob."""
        from repro_torch.compress import GradQuantizer

        if self.grad_transport == "raw" and self.hist_dtype == "bfloat16":
            return GradQuantizer("bf16")
        return GradQuantizer(self.grad_transport)

    @property
    def all_axes(self) -> tuple[str, ...]:
        return self.data_axes + ((self.feature_axis,) if self.feature_axis else ())

    def resolve_tree_params(self, tp: TreeParams) -> TreeParams:
        """TreeParams with this config's grow_policy/max_leaves overrides."""
        kw = {}
        if self.grow_policy is not None:
            kw["grow_policy"] = self.grow_policy
        if self.max_leaves is not None:
            kw["max_leaves"] = self.max_leaves
        return dataclasses.replace(tp, **kw) if kw else tp


def check_feature_parallel_lossguide(tp: TreeParams, cfg: DistConfig) -> None:
    """Feature-parallel + lossguide is an unimplemented combination; fail fast
    with an actionable message."""
    if tp.grow_policy == "lossguide" and cfg.feature_axis is not None:
        raise NotImplementedError(
            f"feature-parallel lossguide growth is not implemented: DistConfig("
            f"feature_axis={cfg.feature_axis!r}, grow_policy='lossguide') would "
            "need the host-driven best-first frontier to all-gather per-node "
            "split candidates across feature shards on every pop. Either drop "
            "feature_axis (row-parallel lossguide is supported) or use "
            "grow_policy='depthwise' (feature-parallel split search is "
            "depthwise-only). Tracked as a ROADMAP open item."
        )


# ---------------------------------------------------------------- sharding
def _shard_span(n: int, mesh: Mesh, axes, what: str) -> tuple[int, int]:
    """[lo, hi) of this rank's shard of ``n`` items over ``axes``."""
    k = mesh.axis_size(axes)
    if n % k:
        raise ValueError(
            f"{what}={n} must divide evenly over {tuple(Mesh._axes(axes))} "
            f"({k} shards); pad or trim the input"
        )
    i = mesh.axis_index(axes)
    return i * n // k, (i + 1) * n // k


class _Shards(NamedTuple):
    rows: slice
    features: slice


def _shards(mesh: Mesh, cfg: DistConfig, n_rows: int, n_features: int) -> _Shards:
    rows = slice(*_shard_span(n_rows, mesh, cfg.data_axes, "n_rows"))
    features = slice(0, n_features)
    if cfg.feature_axis is not None:
        features = slice(*_shard_span(n_features, mesh, cfg.feature_axis, "num_features"))
    return _Shards(rows, features)


def _stage_bins(bins, sh: _Shards, device: torch.device) -> Tensor:
    """This rank's block of a global bin matrix, as contiguous uint8 on the
    device (only the block is copied)."""
    block = bins[sh.rows, sh.features]
    if isinstance(block, Tensor):
        return block.to(device=device, dtype=torch.uint8).contiguous()
    return torch.from_numpy(np.ascontiguousarray(block, dtype=np.uint8)).to(device)


def _stage_vec(v, rows: slice, device: torch.device, dtype=torch.float32) -> Tensor:
    part = v[rows]
    if isinstance(part, Tensor):
        return part.to(device=device, dtype=dtype).contiguous()
    return torch.from_numpy(np.ascontiguousarray(part)).to(device=device, dtype=dtype)


def _stage_bin_valid(bin_valid, sh: _Shards, device: torch.device) -> Tensor:
    bv = bin_valid if isinstance(bin_valid, Tensor) else torch.from_numpy(np.asarray(bin_valid))
    return bv[sh.features].to(device=device, dtype=torch.bool)


def _gather_rows(mesh: Mesh, local: Tensor, cfg: DistConfig) -> Tensor:
    """The global vector of every data shard's ``local`` rows, in order."""
    return mesh.all_gather(local, cfg.data_axes).reshape(-1)


# ------------------------------------------------------------- collectives
def _psum_hist(mesh: Mesh, hist: Tensor, cfg: DistConfig) -> Tensor:
    """The paper's AllReduce over the data axes, on the narrowed wire."""
    q = cfg.grad_quantizer
    return q.psum_restore(mesh.all_reduce(q.psum_cast(hist), cfg.data_axes))


def _psum_totals(mesh: Mesh, g: Tensor, h: Tensor, cfg: DistConfig) -> tuple[Tensor, Tensor]:
    totals = mesh.all_reduce(torch.stack([g.sum(), h.sum()]), cfg.data_axes)
    return totals[0], totals[1]


def _global_best(mesh: Mesh, splits, local_m: int, cfg: DistConfig) -> Tensor:
    """All-gather every feature shard's best candidates and arg-max them
    (first shard on ties). Returns (8, n_nodes): gain, global feature, bin,
    default_left, left_g, left_h, right_g, right_h."""
    shard = mesh.axis_index(cfg.feature_axis)
    cand = torch.stack([
        splits.gain,
        (splits.feature + shard * local_m).to(torch.float32),
        splits.split_bin.to(torch.float32),
        splits.default_left.to(torch.float32),
        splits.left_g,
        splits.left_h,
        splits.right_g,
        splits.right_h,
    ])  # (8, n_nodes)
    allc = mesh.all_gather(cand, cfg.feature_axis)  # (n_shards, 8, n_nodes)
    best = torch.argmax(allc[:, 0, :], dim=0)  # first arg-max
    return allc.gather(0, best[None, None, :].expand(1, 8, best.shape[0]))[0]


# ----------------------------------------------------------- the builders
def _grow_tree_local(
    mesh: Mesh,
    bins: Tensor,  # (local_rows, local_m) uint8 block of this rank
    g: Tensor,  # (local_rows,)
    h: Tensor,
    n_bins: int,
    bin_valid: Tensor,  # (local_m, n_bins)
    tp: TreeParams,
    cfg: DistConfig,
    cut_values: np.ndarray | None,
    cut_ptrs: np.ndarray | None,
) -> tuple[TreeArrays, Tensor]:
    """The depthwise build of one rank. Returns (tree, local positions)."""
    dev = bins.device
    n_total = tp.n_total_nodes
    max_depth = tp.max_depth
    local_rows, local_m = bins.shape
    reg_lambda = tp.split.reg_lambda
    subtract = cfg.hist_subtraction and tp.hist_subtraction

    feature = torch.zeros(n_total, dtype=torch.int32, device=dev)
    split_bin = torch.zeros(n_total, dtype=torch.int32, device=dev)
    default_left = torch.zeros(n_total, dtype=torch.bool, device=dev)
    is_leaf = torch.ones(n_total, dtype=torch.bool, device=dev)
    leaf_value = torch.zeros(n_total, dtype=torch.float32, device=dev)
    node_g = torch.zeros(n_total, dtype=torch.float32, device=dev)
    node_h = torch.zeros(n_total, dtype=torch.float32, device=dev)
    node_g[0], node_h[0] = _psum_totals(mesh, g, h, cfg)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    positions = torch.zeros(local_rows, dtype=torch.int32, device=dev)
    prev_hist: Tensor | None = None  # the previous level's reduced histogram
    level_counts: Tensor | None = None  # the reduced row counts of this level

    for depth in range(max_depth):
        offset, count = 2**depth - 1, 2**depth
        sl = slice(offset, offset + count)
        level_pos = torch.where(positions >= offset, positions - offset, -1)
        if subtract and prev_hist is not None and level_counts is not None:
            # build and reduce only the smaller child of each pair; derive
            # the siblings from the previous level
            node_map, build_left = plan_level(count, level_counts)
            built = ops.build_histogram(
                bins, g, h, level_pos, count // 2, n_bins, node_map=node_map
            )
            hist = expand_level(prev_hist, _psum_hist(mesh, built, cfg), build_left)
        else:
            hist = _psum_hist(
                mesh, ops.build_histogram(bins, g, h, level_pos, count, n_bins), cfg
            )
        prev_hist = hist

        lvl_g, lvl_h = node_g[sl], node_h[sl]
        splits = evaluate_splits(hist, lvl_g, lvl_h, bin_valid, tp.split)
        if cfg.feature_axis is not None:
            picked = _global_best(mesh, splits, local_m, cfg)
            s_gain, s_feature = picked[0], picked[1].to(torch.int32)
            s_bin, s_dleft = picked[2].to(torch.int32), picked[3] > 0.5
            s_lg, s_lh, s_rg, s_rh = picked[4], picked[5], picked[6], picked[7]
            should = torch.isfinite(s_gain) & (s_gain > 0.0)
        else:
            s_feature, s_bin, s_dleft = splits.feature, splits.split_bin, splits.default_left
            s_lg, s_lh, s_rg, s_rh = splits.left_g, splits.left_h, splits.right_g, splits.right_h
            should = splits.should_split

        growable = ~is_leaf[sl] if depth else torch.ones(count, dtype=torch.bool, device=dev)
        do_split = should & growable
        feature[sl] = torch.where(do_split, s_feature, torch.zeros_like(s_feature))
        split_bin[sl] = torch.where(do_split, s_bin, torch.zeros_like(s_bin))
        default_left[sl] = s_dleft & do_split
        is_leaf[sl] = ~do_split
        w = leaf_weight(lvl_g, lvl_h, reg_lambda)
        leaf_value[sl] = torch.where(do_split | ~growable, zero, w)
        kids = slice(2 * offset + 1, 2 * offset + 1 + 2 * count)
        node_g[kids] = torch.stack(
            [torch.where(do_split, s_lg, zero), torch.where(do_split, s_rg, zero)], dim=1
        ).reshape(-1)
        node_h[kids] = torch.stack(
            [torch.where(do_split, s_lh, zero), torch.where(do_split, s_rh, zero)], dim=1
        ).reshape(-1)
        is_leaf[kids] = (~do_split).repeat_interleave(2)

        # the next level's row counts drive its build/derive plan, reduced so
        # that every rank (and the single-device builder) plans alike
        count_level = (
            (2 ** (depth + 1) - 1, 2 ** (depth + 1))
            if subtract and depth + 1 < max_depth
            else None
        )
        if cfg.feature_axis is None:
            counts = new_level_counts(count_level, dev)
            positions = ops.partition_rows(
                bins, positions, feature, split_bin, default_left, is_leaf,
                count_level, counts,
            )
        else:
            positions = _partition_feature_parallel(
                mesh, bins, positions, feature, split_bin, default_left, is_leaf, local_m, cfg
            )
            counts = None if count_level is None else level_row_counts(positions, *count_level)
        level_counts = None if counts is None else mesh.all_reduce(counts, cfg.data_axes)

    # final level: every still-growable node is a leaf with its eq.-(6) weight
    offset, count = 2**max_depth - 1, 2**max_depth
    sl = slice(offset, offset + count)
    growable = ~is_leaf[sl] if max_depth else torch.ones(1, dtype=torch.bool, device=dev)
    w = leaf_weight(node_g[sl], node_h[sl], reg_lambda)
    leaf_value[sl] = torch.where(growable, w, leaf_value[sl])
    is_leaf[sl] = True
    tree = TreeArrays(
        feature=feature,
        split_bin=split_bin,
        split_value=_finalize_split_values(feature, split_bin, is_leaf, cut_values, cut_ptrs),
        default_left=default_left,
        is_leaf=is_leaf,
        leaf_value=leaf_value,
    )
    return tree, positions


def _partition_feature_parallel(
    mesh, bins, positions, feature, split_bin, default_left, is_leaf, local_m, cfg
) -> Tensor:
    """Feature-parallel repartition: the shard owning a row's split feature
    decides left/right, and an all-reduce over the model group tells the
    others (the reference's jnp form, `gbdt_shard.py:309-328`)."""
    shard = mesh.axis_index(cfg.feature_axis)
    active = positions >= 0
    safe = torch.where(active, positions, 0).to(torch.int64)
    lf = feature[safe] - shard * local_m
    owner = (lf >= 0) & (lf < local_m)
    bval = bins.gather(1, lf.clamp(0, local_m - 1).to(torch.int64)[:, None])[:, 0]
    missing = bval == ops.MISSING_BIN
    go_left_local = torch.where(missing, default_left[safe], bval.to(torch.int32) <= split_bin[safe])
    flag = torch.where(owner, go_left_local.to(torch.int32), 0)
    go_left = mesh.all_reduce(flag, cfg.feature_axis) > 0
    child = 2 * positions + 1 + torch.where(go_left, 0, 1).to(torch.int32)
    moved = torch.where(is_leaf[safe], positions, child)
    return torch.where(active, moved, -1).to(torch.int32)


def _grow_tree_distributed_lossguide(
    mesh: Mesh,
    bins: Tensor,
    g: Tensor,
    h: Tensor,
    n_bins: int,
    bin_valid: Tensor,
    tp: TreeParams,
    cfg: DistConfig,
    cut_values=None,
    cut_ptrs=None,
    transfer_stats=None,
) -> tuple[TreeArrays, Tensor]:
    """Best-first build of one rank through the host-driven frontier: each
    pop builds the local histogram of the popped node's 2-child window and
    all-reduces only the built slots; the sibling is derived from the stored
    parent. The 2 row counts are all-reduced once a pop, so every rank's
    store plans alike. Returns (tree, local positions)."""
    check_feature_parallel_lossguide(tp, cfg)
    if tp.pop_batch != 1:
        # as the reference: contiguous 2-child windows only
        tp = dataclasses.replace(tp, pop_batch=1)
    dev = bins.device
    pos_box = [torch.zeros(bins.shape[0], dtype=torch.int32, device=dev)]

    def hist_fn(offset: int, count: int, plan) -> Tensor:
        window = plan.count
        node_map = (
            torch.arange(window, dtype=torch.int32, device=dev)  # full build
            if plan.node_map is None
            else plan.node_map
        )
        pos = pos_box[0]
        lp = torch.where((pos >= offset) & (pos < offset + window), pos - offset, -1)
        built = ops.build_histogram(bins, g, h, lp, plan.n_build, n_bins, node_map=node_map)
        return _psum_hist(mesh, built, cfg)  # AllReduce of the built slots only

    def partition_fn(feature, split_bin, default_left, is_leaf, count_level):
        counts = new_level_counts(count_level, dev)
        pos_box[0] = ops.partition_rows(
            bins, pos_box[0], feature, split_bin, default_left, is_leaf,
            count_span(count_level), counts,
        )
        if counts is not None:
            mesh.all_reduce(counts, cfg.data_axes)
        return take_counts(count_level, counts)

    cache = HistogramStore(
        enabled=cfg.hist_subtraction and tp.hist_subtraction,
        budget_bytes=cfg.hist_budget_bytes,
        retained_levels=cfg.hist_retained_levels,
        transfer_stats=transfer_stats,
        grad_transport=cfg.grad_transport,  # narrows spill/fetch wires too
    )
    total_g, total_h = _psum_totals(mesh, g, h, cfg)
    tree = grow_tree_lossguide_generic(
        hist_fn, partition_fn, total_g, total_h, n_bins, bin_valid, tp,
        cut_values, cut_ptrs, hist_cache=cache,
    )
    return tree, pos_box[0]


def _grow_tree_sharded(mesh, bins, g, h, n_bins, bin_valid, tp, cfg, cut_values,
                       cut_ptrs, transfer_stats=None) -> tuple[TreeArrays, Tensor]:
    """One tree from this rank's staged block; (tree, local positions)."""
    tp = cfg.resolve_tree_params(tp)
    check_feature_parallel_lossguide(tp, cfg)
    if tp.grow_policy == "lossguide":
        return _grow_tree_distributed_lossguide(
            mesh, bins, g, h, n_bins, bin_valid, tp, cfg, cut_values, cut_ptrs,
            transfer_stats=transfer_stats,
        )
    return _grow_tree_local(mesh, bins, g, h, n_bins, bin_valid, tp, cfg, cut_values, cut_ptrs)


def _as_numpy(x):
    if x is None or isinstance(x, np.ndarray):
        return x
    if isinstance(x, Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def grow_tree_distributed(
    mesh: Mesh,
    bins,  # (n_rows, m) global bins (numpy or tensor), the same on every rank
    g,  # (n_rows,) global
    h,
    n_bins: int,
    bin_valid,  # (m, n_bins) bool, global
    tp: TreeParams,
    cfg: DistConfig,
    cut_values=None,
    cut_ptrs=None,
    transfer_stats=None,
) -> tuple[TreeArrays, Tensor]:
    """Build one tree with rows (and features) sharded over the mesh.

    Every rank passes the same global inputs and stages only its block.
    Returns the tree (replicated) and every row's final position (the
    global vector, gathered). ``transfer_stats`` is the `TransferStats`
    sink of the lossguide build's histogram spills and fetches (see
    ``DistConfig.hist_budget_bytes``); the depthwise build never spills.
    """
    sh = _shards(mesh, cfg, int(bins.shape[0]), int(bins.shape[1]))
    dev = mesh.device
    tree, positions = _grow_tree_sharded(
        mesh, _stage_bins(bins, sh, dev), _stage_vec(g, sh.rows, dev),
        _stage_vec(h, sh.rows, dev), n_bins, _stage_bin_valid(bin_valid, sh, dev),
        tp, cfg, _as_numpy(cut_values), _as_numpy(cut_ptrs), transfer_stats=transfer_stats,
    )
    return tree, _gather_rows(mesh, positions, cfg)


def make_gbdt_step_fn(
    mesh: Mesh,
    tp: TreeParams,
    n_bins: int,
    cfg: DistConfig,
    learning_rate: float = 0.3,
    objective: str = "binary:logistic",
    sampling_f: float = 1.0,
):
    """One full boosting iteration of this rank, SPMD.

    Returns ``step(bins, margin, labels, bin_valid, cut_values, cut_ptrs,
    generator) -> (margin, tree)``: margin -> (g, h) -> per-shard MVS ->
    depthwise build -> margin update, on global inputs (pass device tensors
    to stage no more than a slice), returning the global margin and the
    replicated tree. ``generator`` is the round's seed (an int, or a
    `torch.Generator` whose initial seed is used); each data shard draws
    from a generator seeded from it and its shard index, as the reference
    folds the shard into its key (the draws differ from ``jax.random``'s).

    Depthwise only: best-first growth is host-driven; use
    `grow_tree_distributed` or `grow_tree_distributed_paged` with
    ``grow_policy="lossguide"`` instead.
    """
    from repro_torch.core.objectives import get_objective
    from repro_torch.core.sampling import SamplingConfig, sample

    tp = cfg.resolve_tree_params(tp)
    if tp.grow_policy == "lossguide":
        raise NotImplementedError(
            "make_gbdt_step_fn compiles the whole boosting step into one SPMD "
            "program; lossguide growth is host-driven — build trees with "
            "grow_tree_distributed or grow_tree_distributed_paged instead"
        )
    obj = get_objective(objective)
    samp = SamplingConfig(method="mvs", f=sampling_f) if sampling_f < 1.0 else SamplingConfig()
    dev = mesh.device

    def step(bins, margin, labels, bin_valid, cut_values, cut_ptrs, generator):
        sh = _shards(mesh, cfg, int(bins.shape[0]), int(bins.shape[1]))
        margin_l = _stage_vec(margin, sh.rows, dev)
        g, h = obj.grad_hess(margin_l, _stage_vec(labels, sh.rows, dev))
        if samp.method != "none":
            seed = generator.initial_seed() if isinstance(generator, torch.Generator) else generator
            mixed = np.random.SeedSequence([int(seed) % (1 << 64), mesh.axis_index(cfg.data_axes)])
            shard_gen = torch.Generator(device=dev).manual_seed(
                int(mixed.generate_state(1, np.uint64)[0])
            )
            mask, w = sample(shard_gen, g, h, samp)
            scale = torch.where(mask, w, 0.0)
            g, h = g * scale, h * scale
        tree, positions = _grow_tree_local(
            mesh, _stage_bins(bins, sh, dev), g, h, n_bins, _stage_bin_valid(bin_valid, sh, dev),
            tp, cfg, _as_numpy(cut_values), _as_numpy(cut_ptrs),
        )
        new_margin = margin_l + learning_rate * tree.leaf_value[positions.to(torch.int64)]
        return _gather_rows(mesh, new_margin, cfg), tree

    return step


def distributed_train_step(*args, **kwargs):
    """Alias kept for the public API (see make_gbdt_step_fn)."""
    return make_gbdt_step_fn(*args, **kwargs)


# ------------------------------------------------------------ out of core
def sharded_page_put(mesh: Mesh, cfg: DistConfig) -> Callable:
    """``to_array`` for `PageStream`: a host page (an `EllpackPage` or its
    bins) -> this rank's row slice of it, contiguous uint8, so only the
    slice is staged. Every page's rows must divide evenly over the data
    axes."""

    def put(page) -> np.ndarray:
        arr = np.asarray(getattr(page, "bins", page))
        rows = slice(*_shard_span(arr.shape[0], mesh, cfg.data_axes, "page rows"))
        return np.ascontiguousarray(arr[rows], dtype=np.uint8)

    return put


class _Extent(NamedTuple):
    row_offset: int
    n_rows: int


class _LocalStream:
    """A `PageStream` pass whose pages carry this rank's row extents."""

    def __init__(self, stream, local_extents: list[_Extent]):
        self._stream = stream
        self._extents = local_extents
        self.stats = getattr(stream, "stats", None)

    def __iter__(self):
        for sp in self._stream:
            ext = self._extents[sp.index]
            if sp.device.shape[0] != ext.n_rows:
                raise ValueError(
                    f"page {sp.index} staged {sp.device.shape[0]} rows on rank "
                    f"{ext}; build the stream with to_array=sharded_page_put(mesh, cfg)"
                )
            yield sp._replace(host=ext)


def grow_tree_distributed_paged(
    mesh: Mesh,
    make_stream: Callable[..., object],
    page_extents: Sequence[tuple[int, int]],
    g,  # (n_rows,) global
    h,
    n_bins: int,
    bin_valid,
    tp: TreeParams,
    cfg: DistConfig,
    cut_values=None,
    cut_ptrs=None,
    page_skipping: bool = True,
    transfer_stats=None,
) -> tuple[TreeArrays, Tensor]:
    """Out-of-core distributed build: one tree over pages that never all sit
    in device memory, each rank streaming its row slice of every page.

    ``make_stream()`` starts one `PageStream` pass; build it with
    ``to_array=sharded_page_put(mesh, cfg)`` so that each rank stages only
    its rows. ``page_extents`` is the global (row_offset, n_rows) per page
    in stream order (e.g. ``PageSet.page_extents``). The build is
    `core.outofcore.build_tree_paged` on the rank's rows, whose histogram
    pass and row counts are all-reduced once a pass, after the rank's page
    sum. With ``grow_policy="lossguide"`` and a ``make_stream`` that takes
    ``indices=``, each rank skips the pages where none of its rows sit in
    the popped node's window (``page_skipping``; counted in the stream's
    ``TransferStats.pages_skipped``). ``transfer_stats`` receives the
    store's spills and fetches. Returns the tree and every row's final
    position, global.
    """
    from repro_torch.core.outofcore import _accepts_indices, build_tree_paged

    if cfg.feature_axis is not None:
        raise NotImplementedError(
            "grow_tree_distributed_paged shards rows only: staged pages split "
            "by rows (use grow_tree_distributed for feature_axis)"
        )
    tp = cfg.resolve_tree_params(tp)
    check_feature_parallel_lossguide(tp, cfg)
    dev = mesh.device
    spans = [_shard_span(nr, mesh, cfg.data_axes, "page rows") for _, nr in page_extents]
    local: list[_Extent] = []
    start = 0
    for lo, hi in spans:
        local.append(_Extent(start, hi - lo))
        start += hi - lo
    rows = np.concatenate(
        [np.arange(ro + lo, ro + hi) for (ro, _), (lo, hi) in zip(page_extents, spans)]
    ) if page_extents else np.zeros(0, np.int64)
    idx = torch.from_numpy(rows).to(dev)
    g_l = _stage_vec(g, slice(None), dev)[idx]
    h_l = _stage_vec(h, slice(None), dev)[idx]

    if _accepts_indices(make_stream):
        def local_stream(indices=None):
            return _LocalStream(
                make_stream(indices=indices) if indices is not None else make_stream(), local
            )
    else:
        def local_stream():
            return _LocalStream(make_stream(), local)

    cache = HistogramStore(
        enabled=cfg.hist_subtraction and tp.hist_subtraction,
        budget_bytes=cfg.hist_budget_bytes,
        retained_levels=cfg.hist_retained_levels,
        transfer_stats=transfer_stats,
        grad_transport=cfg.grad_transport,  # narrows spill/fetch wires too
    )
    tree, positions = build_tree_paged(
        local_stream, [tuple(e) for e in local], g_l, h_l, n_bins,
        _stage_bin_valid(bin_valid, _Shards(slice(None), slice(None)), dev), tp, _as_numpy(cut_values), _as_numpy(cut_ptrs),
        hist_cache=cache, page_skipping=page_skipping,
        hist_all_reduce=lambda hist: _psum_hist(mesh, hist, cfg),
        sum_all_reduce=lambda t: mesh.all_reduce(t, cfg.data_axes),
    )
    # every rank's positions, page by page in its local order, then
    # reassembled in global row order
    mine = torch.cat([positions[i] for i in range(len(page_extents))])
    every = mesh.all_gather(mine, cfg.data_axes)  # (n_shards, local_rows)
    parts = [every[:, e.row_offset : e.row_offset + e.n_rows].reshape(-1) for e in local]
    return tree, torch.cat(parts) if parts else mine


# ------------------------------------------------------------- the forest
def fit_sharded(
    mesh: Mesh,
    data,
    y=None,
    *,
    params=None,
    cfg: DistConfig | None = None,
    eval_set=None,
    eval_metric: str = "auto",
    verbose: bool = False,
    **kwargs,
):
    """Train a whole forest with rows (and optionally features) sharded over
    ``mesh``: the distributed front door of the DMatrix surface.

    ``data`` is anything `GradientBooster.fit` accepts (a DMatrix, raw
    ``(X, y)`` arrays, a batch source), the same on every rank. ``params``
    is a `BoosterParams` (extra ``**kwargs`` build or amend one), with
    `DistConfig`'s growth overrides on top. Returns a fitted
    `GradientBooster` on every rank (predict, save and get_params work).

    Each rank stages its block of the quantised matrix once (uint8; under
    ``page_codec="bitpack"`` its rows' packed bytes, decoded on the device),
    keeps the margins of its rows, and bins the eval set on its device.
    Each round builds one tree (the histogram all-reduce is the paper's
    §2.2 AllReduce). A requested sample is drawn over all rows with the
    booster's round generator, as the single-process fit draws it, from the
    all-gathered gradients. ``booster.stats`` books what the ranks staged,
    summed over ranks, and the store's spills and fetches.
    """
    from repro_torch.compress import make_transport
    from repro_torch.core.booster import (
        BoosterParams,
        EvalRecord,
        GradientBooster,
        bin_valid_from_cuts,
    )
    from repro_torch.core.ellpack import Binner
    from repro_torch.core.policy import ExecutionPolicy, sampling_requested
    from repro_torch.core.sampling import sample
    from repro_torch.core.tree import predict_tree_bins
    from repro_torch.data.dmatrix import as_dmatrix
    from repro_torch.data.pages import TransferStats

    cfg = cfg or DistConfig()
    if params is None:
        params = BoosterParams(**kwargs)
    elif kwargs:
        params = dataclasses.replace(params, **kwargs)
    tp = cfg.resolve_tree_params(params.tree_params())
    check_feature_parallel_lossguide(tp, cfg)
    dev = mesh.device

    dm = as_dmatrix(data, y, max_bin=params.max_bin, device=dev)
    labels = dm.require_labels()
    n_shards = mesh.axis_size(cfg.data_axes)
    if dm.n_rows % n_shards:
        raise ValueError(
            f"n_rows={dm.n_rows} must divide evenly over the data axes "
            f"{cfg.data_axes} ({n_shards} shards); pad or trim the DMatrix"
        )
    if cfg.feature_axis is not None and dm.num_features % mesh.shape[cfg.feature_axis]:
        raise ValueError(
            f"num_features={dm.num_features} must divide evenly over "
            f"feature_axis {cfg.feature_axis!r} ({mesh.shape[cfg.feature_axis]} shards)"
        )

    booster = GradientBooster(params, policy=ExecutionPolicy(mode="in_core"), device=dev)
    booster.cuts = dm.cuts
    # one ledger for the whole fit: staging, and the lossguide store's spills
    booster.stats = TransferStats()
    n_bins = dm.n_bins
    sh = _shards(mesh, cfg, dm.n_rows, dm.num_features)
    bin_valid = bin_valid_from_cuts(dm.cuts, n_bins, dev)[sh.features]
    transport = make_transport(cfg.page_codec)
    block = np.ascontiguousarray(dm.single_page_bins()[sh.rows, sh.features])
    if transport is None:
        bins = torch.from_numpy(block).to(dev)
        wire_nbytes = block.nbytes
    else:
        # row-wise bitpacking keeps each row's packed bytes self-contained,
        # so a rank's rows pack and decode alone
        wire, wire_meta = transport.encode(block)
        bins = transport.decode(torch.from_numpy(wire).to(dev), wire_meta)
        wire_nbytes = wire.nbytes
    staged = torch.tensor([wire_nbytes, block.nbytes], dtype=torch.int64, device=dev)
    mesh.all_reduce(staged, cfg.all_axes)  # the ledger counts every rank's copy
    booster.stats.host_to_device_bytes += int(staged[0])
    booster.stats.wire_bytes += int(staged[0])
    booster.stats.logical_bytes += int(staged[1])
    labels_t = torch.from_numpy(labels[sh.rows]).to(dev)
    booster.base_margin_ = (
        params.base_score if params.base_score is not None else booster.objective.base_margin(labels)
    )
    margin = torch.full((labels_t.shape[0],), booster.base_margin_, dtype=torch.float32, device=dev)

    eval_bins = eval_labels = eval_margin = None
    if eval_set is not None:
        eval_bins = Binner(dm.cuts, dev).to_device(eval_set[0])
        eval_labels = np.asarray(eval_set[1], np.float32)
        eval_margin = torch.full(
            (eval_labels.shape[0],), booster.base_margin_, dtype=torch.float32, device=dev
        )
    metric_name = booster._metric_name(eval_metric)
    sampled = sampling_requested(params.sampling)

    t0 = time.perf_counter()
    for it in range(params.n_estimators):
        g, h = booster.objective.grad_hess(margin, labels_t)
        gen = booster._round_generator(it)
        if sampled:
            # the draw over all rows, as one process draws it
            keep, w = sample(gen, _gather_rows(mesh, g, cfg), _gather_rows(mesh, h, cfg),
                             params.sampling)
            keep, w = keep[sh.rows], w[sh.rows]
        else:
            keep, w = sample(gen, g, h, params.sampling)
        scale = torch.where(keep, w, 0.0)
        tree, positions = _grow_tree_sharded(
            mesh, bins, g * scale, h * scale, n_bins, bin_valid, params.tree_params(), cfg,
            dm.cuts.values, dm.cuts.ptrs, transfer_stats=booster.stats,
        )
        booster.trees.append(tree)
        # eager multiply then add, as the in-core engine (no fused FMA)
        margin = margin + params.learning_rate * tree.leaf_value[positions.to(torch.int64)]
        if eval_bins is not None:
            pred = predict_tree_bins(tree, eval_bins, tp.max_depth)
            eval_margin = eval_margin + params.learning_rate * pred
            val = booster._eval(metric_name, eval_labels, eval_margin)
            booster.eval_history.append(
                EvalRecord(it, metric_name, val, time.perf_counter() - t0)
            )
            if verbose:
                print(f"[{it}] {metric_name}={val:.6f}")
    return booster
