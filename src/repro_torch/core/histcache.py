"""Histogram store: the subtraction trick for depthwise levels.

Counterpart of `repro.core.histcache` with an unlimited device budget
(``budget_bytes=None``). Every split partitions a parent's rows into its two
children and histograms add over rows, so ``hist(parent) == hist(left) +
hist(right)``. Per level the builder therefore builds only the smaller child
of each split pair (by exact row counts from the repartition) and derives the
sibling as ``parent - built``, roughly halving the histogram work.

  plan(count, counts, dev)   build/derive split of one level: a `LevelPlan`
                             whose ``build_nodes`` lists the global ids of the
                             smaller children (ties build left), or every node
                             for a full build (root, store disabled)
  expand(plan, built)        full level histogram from the compact build half
                             and the retained parent level; retained in turn
                             as the next level's parent
  level_row_counts(pos, offset, count)
                             rows per node of a level window, the counts
                             ``plan`` takes (defined beside the partition's
                             plain version, which computes them in its pass)

The budgeted tiers of the reference (host spill and fetch, ancestor chains)
and the per-node API of best-first growth are queued; a non-None
``budget_bytes`` raises.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.kernels.ref import level_row_counts  # noqa: F401 (re-exported)

Tensor = torch.Tensor


class LevelPlan(NamedTuple):
    """Build/derive split of one level and how the parent resolved.

    ``node_map[j]`` maps level-local node j to its compacted build slot, or
    -1 when j's histogram is derived (None for a full build). ``source`` is
    "build" (full rebuild from rows) or "device" (parent retained on device).
    ``build_nodes`` are the global ids of the build slots, in slot order.
    """

    node_map: Tensor | None  # (count,) int32, or None = build everything
    n_build: int  # number of histogram slots built
    count: int  # nodes at this level
    source: str = "build"
    build_nodes: Tensor | None = None


@dataclasses.dataclass
class HistCacheStats:
    """Build-vs-derive ledger (levels >= 1; the root build is not counted).

    Row totals accumulate as device scalars, with no host sync in the level
    loop, and convert to floats only when read."""

    levels: int = 0
    built_nodes: int = 0
    derived_nodes: int = 0
    _built_rows_acc: Tensor | None = dataclasses.field(default=None, repr=False)
    _total_rows_acc: Tensor | None = dataclasses.field(default=None, repr=False)

    def _add_rows(self, built: Tensor, total: Tensor) -> None:
        # f32, as the reference: int32 would wrap over a long fit
        built = built.to(torch.float32)
        total = total.to(torch.float32)
        if self._built_rows_acc is None:
            self._built_rows_acc, self._total_rows_acc = built, total
        else:
            self._built_rows_acc = self._built_rows_acc + built
            self._total_rows_acc = self._total_rows_acc + total

    @property
    def built_rows(self) -> float:
        """Rows scanned into built node histograms (subtraction mode)."""
        return float(self._built_rows_acc) if self._built_rows_acc is not None else 0.0

    @property
    def total_rows(self) -> float:
        """Rows a full per-node build would have scanned."""
        return float(self._total_rows_acc) if self._total_rows_acc is not None else 0.0

    @property
    def node_rows_ratio(self) -> float:
        """How many times fewer node-rows the subtraction build scans."""
        built = self.built_rows
        return self.total_rows / built if built else 1.0


def new_level_counts(count_level: tuple[int, int] | None, device) -> Tensor | None:
    """Zeroed (count,) int32 counts of a level window ``(offset, count)``, for
    `ops.partition_rows` to add into over a level's pages; None without one."""
    if count_level is None:
        return None
    return torch.zeros(count_level[1], dtype=torch.int32, device=device)


def plan_level(count: int, level_counts: Tensor) -> tuple[Tensor, Tensor]:
    """(node_map, build_left) for one level: build the smaller child of each
    sibling pair (ties build left, so every builder agrees)."""
    pairs = count // 2
    build_left = level_counts[0::2] <= level_counts[1::2]
    slots = torch.arange(pairs, dtype=torch.int32, device=level_counts.device)
    minus = torch.full_like(slots, -1)
    node_map = torch.stack(
        [torch.where(build_left, slots, minus), torch.where(build_left, minus, slots)], dim=1
    ).reshape(count)
    return node_map, build_left


def expand_level(parent_hist: Tensor, built: Tensor, build_left: Tensor) -> Tensor:
    """Full level histogram from the compact build half: the built child keeps
    its histogram, the sibling is ``parent - built``."""
    mask = build_left.reshape((-1,) + (1,) * (built.dim() - 1))
    # both children written straight into the level histogram, the derived
    # one computed in place there: no temporary beside it
    full = torch.empty((built.shape[0], 2) + built.shape[1:], dtype=built.dtype, device=built.device)
    torch.sub(parent_hist, built, out=full[:, 1])
    torch.where(mask, built, full[:, 1], out=full[:, 0])
    torch.where(mask, full[:, 1], built, out=full[:, 1])
    return full.reshape((2 * built.shape[0],) + built.shape[1:])


class HistogramStore:
    """Retains the previous level's histograms and plans each level's
    build/derive split. One instance per booster; `reset` runs at the start
    of every tree and keeps the accumulated `stats`.

    Parameters
    ----------
    enabled : subtraction on/off (off = every plan is a full build).
    budget_bytes : must be None (unlimited device tier); the budgeted host
        tier, whose spill and fetch traffic is booked in `TransferStats`, is
        queued.
    """

    def __init__(self, enabled: bool = True, budget_bytes: int | None = None):
        if budget_bytes is not None:
            raise NotImplementedError(
                "a histogram byte budget (host spill, fetch and ancestor chains) is "
                "not ported yet; it is queued after the in-core slice"
            )
        self.enabled = enabled
        self.stats = HistCacheStats()
        self._parent: Tensor | None = None
        self._parent_depth = -1
        self._build_left: Tensor | None = None

    def reset(self) -> None:
        self._parent = None
        self._parent_depth = -1
        self._build_left = None

    def plan(self, count: int, level_counts: Tensor | None, device: torch.device) -> LevelPlan:
        depth = count.bit_length() - 1  # count == 2**depth in the heap layout
        subtract = (
            self.enabled
            and count > 1
            and level_counts is not None
            and self._parent_depth == depth - 1
        )
        if not subtract:
            self._build_left = None
            return LevelPlan(
                node_map=None, n_build=count, count=count, source="build",
                build_nodes=torch.arange(count, dtype=torch.int32, device=device) + (count - 1),
            )
        node_map, build_left = plan_level(count, level_counts)
        pairs = count // 2
        offset = count - 1
        build_nodes = (
            offset
            + 2 * torch.arange(pairs, dtype=torch.int32, device=device)
            + (~build_left).to(torch.int32)
        )
        self._build_left = build_left
        self.stats.levels += 1
        self.stats.built_nodes += pairs
        self.stats.derived_nodes += count - pairs
        self.stats._add_rows(
            torch.minimum(level_counts[0::2], level_counts[1::2]).sum(), level_counts.sum()
        )
        return LevelPlan(
            node_map=node_map, n_build=pairs, count=count, source="device",
            build_nodes=build_nodes,
        )

    def expand(self, plan: LevelPlan, built: Tensor) -> Tensor:
        """Compact build histogram -> full (count, m, n_bins, 2) level
        histogram; retained as the next level's parent."""
        depth = plan.count.bit_length() - 1
        if plan.node_map is None:
            full = built
        else:
            full = expand_level(self._parent, built, self._build_left)
        if self.enabled:
            # depthwise retains exactly one level: the fresh one is the next
            # plan's parent and nothing reads older levels
            self._parent, self._parent_depth = full, depth
        return full
