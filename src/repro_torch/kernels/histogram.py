"""Gradient histograms: wrappers of ``csrc/histogram.cu`` and
``csrc/hist_window.cu``.

  build_histogram_nodes  kernel 1, rows matched against global build-node
                         ids (`repro.kernels.histogram.build_histogram_nodes`)
  build_histogram        kernel 4, level-local rows remapped through an
                         optional ``node_map`` (`repro.kernels.histogram
                         .build_histogram`)

Both bucket the matched rows by slot and scatter each slot's rows, one
feature group per block, into a shared-memory tile with 64-bit fixed-point
integer atomics (``csrc/hist_common.cuh``), so a result is the same bits on
every run, and the two give the same bits for the same matched rows. Plain
versions: `repro_torch.kernels.ref.build_histogram_nodes` and
`ref.build_histogram` (f32 sums), and ``ref.build_histogram_nodes_fixed`` /
``ref.build_histogram_fixed``, which the kernels equal bit for bit. With
``add_into`` a wrapper adds its histogram into that tensor in place, with
the bits of ``add_into.add_(hist)``. Each wrapper counts its own launches
(``launches``, ``launches_window``).
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import launch_target, require, require_cuda

# the least chunk size: a scatter block takes at most C rows of one slot
# (one work item), C chosen on the card as the larger of this and the
# matched rows over the wanted work items. A slot with more rows is split
# into chunks whose tiles meet in a compact int64 accumulator, sized from
# the shapes for min(S, n_rows // MIN_CHUNK_ROWS) slots.
MIN_CHUNK_ROWS = 4096
# scatter blocks wanted per SM slot (SMs x SCATTER_BLOCKS_PER_SM): work
# items are made small enough for this many waves
TARGET_WAVES = 2
# threads of a scatter block at most; the block runs a multiple of its
# feature group, so each thread keeps one feature
SCATTER_THREADS = 512
# scatter blocks meant to share an SM: each may take the SM's 228 KB of
# shared memory over this count, less the 1 KB the card keeps per block,
# and at most 227 KB
SCATTER_BLOCKS_PER_SM = 3
SM_SHARED_BYTES = 228 * 1024
MAX_BLOCK_SHARED = 227 * 1024
# shared memory kept for the two staging buffers when the feature group is
# sized; the buffers then take what the tile leaves, up to MAX_BATCH_ROWS
# rows each
STAGE_BYTES = 32 * 1024
MAX_BATCH_ROWS = 256

# node_map entries staged in shared memory by kernel 4 (48 KB of int32);
# a longer map is read from global memory
MAX_STAGED_MAP = 48 * 1024 // 4

launches = 0  # kernel 1
launches_window = 0  # kernel 4


@dataclass(frozen=True)
class HistPlan:
    """One launch's shapes (`plan_launch`); the first nine fields go to the
    C entry point in this order (``hist::PlanField``)."""

    feat_group: int  # F, features per scatter block
    threads: int  # threads per scatter block, a multiple of F
    batch_rows: int  # rows per staged batch
    stage_words: int  # 4-byte words staged per row
    smem_bytes: int  # dynamic shared memory of a scatter block
    min_chunk: int  # least C, the most rows of one work item
    target_items: int  # work items wanted: TARGET_WAVES waves of scatter blocks
    items_bound: int  # work items at most: n_slots + n_rows // min_chunk
    big_bound: int  # slots over C rows at most: min(n_slots, n_rows // min_chunk)
    n_groups: int  # feature groups, ceil(m / F)
    ws_ints: int  # int32 workspace (``hist::Workspace``)
    acc_values: int  # int64 accumulator values, big_bound * m * n_bins * 2

    @property
    def acc_offset(self) -> int:
        """Byte offset of the accumulator in the launch's one scratch buffer,
        after the workspace."""
        return -(-4 * self.ws_ints // 256) * 256

    @functools.cached_property
    def c_args(self):
        return (ctypes.c_int * 9)(
            self.feat_group, self.threads, self.batch_rows, self.stage_words, self.smem_bytes,
            self.min_chunk, self.target_items, self.items_bound, self.big_bound,
        )

    def chunk_rows(self, matched_rows: int) -> int:
        """C as the card picks it for this many matched rows."""
        return max(self.min_chunk, -(-matched_rows // self.target_items))


@functools.lru_cache(maxsize=256)
def plan_launch(
    n_rows: int, m: int, n_slots: int, n_bins: int, bin_bytes: int, n_sm: int = 132
) -> HistPlan:
    """Shapes of one histogram launch, from the shapes alone (no device
    read, so no host sync): the largest feature group whose ``F x n_bins x
    2`` int64 tile leaves `STAGE_BYTES` of the block's shared memory, evened
    out over the features; the staging buffers in what remains. Cached: a
    fit asks for the same few shapes on every page and level."""
    block_smem = min(MAX_BLOCK_SHARED, SM_SHARED_BYTES // SCATTER_BLOCKS_PER_SM - 1024)
    fit = (block_smem - STAGE_BYTES) // (n_bins * 16)
    if fit < 1:
        raise ValueError(f"n_bins={n_bins} does not fit one histogram in shared memory")
    n_groups = -(-m // max(1, min(m, fit, SCATTER_THREADS)))
    feat_group = -(-m // n_groups)
    stage_words = (3 + feat_group * bin_bytes + 3) // 4
    tile = feat_group * n_bins * 16
    row_bytes = 40 + 8 * stage_words  # both buffers: (g, h) int64, offset, words
    batch_rows = min(MAX_BATCH_ROWS, (block_smem - tile) // row_bytes)
    if batch_rows < 1:
        raise ValueError(f"no room to stage rows beside a {tile}-byte tile")
    items_bound = n_slots + n_rows // MIN_CHUNK_ROWS
    big_bound = min(n_slots, n_rows // MIN_CHUNK_ROWS)
    if items_bound * n_groups > 2**31 - 1:
        raise ValueError(f"{items_bound * n_groups} scatter blocks exceed the grid")
    return HistPlan(
        feat_group=feat_group, threads=feat_group * (SCATTER_THREADS // feat_group),
        batch_rows=batch_rows, stage_words=stage_words,
        smem_bytes=tile + batch_rows * row_bytes, min_chunk=MIN_CHUNK_ROWS,
        target_items=-(-TARGET_WAVES * n_sm * SCATTER_BLOCKS_PER_SM // n_groups),
        items_bound=items_bound, big_bound=big_bound, n_groups=n_groups,
        ws_ints=5 + 4 * n_slots + 2 * items_bound + 3 * n_rows,
        acc_values=big_bound * m * n_bins * 2,
    )


def _check_common(bins, g, h, positions, n_bins: int, what: str) -> None:
    require_cuda(bins, what)
    dev = bins.device
    n_rows = bins.shape[0] if bins.dim() == 2 else -1
    require(bins, "bins", (torch.uint8, torch.int32), (None, None), dev)
    require(g, "g", (torch.float32,), (n_rows,), dev)
    require(h, "h", (torch.float32,), (n_rows,), dev)
    require(positions, "positions", (torch.int32,), (n_rows,), dev)
    if not 1 <= n_bins <= 256:
        raise ValueError(f"n_bins must be in [1, 256], got {n_bins}")


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _prepare(bins, n_slots: int, n_bins: int, add_into):
    """(out, workspace pointer, accumulator pointer or None, plan, scratch)
    of one launch over ``n_slots``; workspace and accumulator share the one
    scratch tensor, which the caller keeps alive over the launch."""
    dev = bins.device
    n_rows, m = bins.shape
    if add_into is not None:
        require(add_into, "add_into", (torch.float32,), (n_slots, m, n_bins, 2), dev)
    plan = plan_launch(n_rows, m, n_slots, n_bins, bins.element_size(), _sm_count(dev.index))
    out = add_into if add_into is not None else torch.empty(
        (n_slots, m, n_bins, 2), dtype=torch.float32, device=dev
    )
    scratch = torch.empty(plan.acc_offset + 8 * plan.acc_values, dtype=torch.uint8, device=dev)
    ws = scratch.data_ptr()
    return out, ws, ws + plan.acc_offset if plan.acc_values else None, plan, scratch


def _empty(shape, device, add_into):
    return add_into if add_into is not None else torch.zeros(
        shape, dtype=torch.float32, device=device
    )


def build_histogram_nodes(
    bins: torch.Tensor,  # (n_rows, m) uint8 or int32
    g: torch.Tensor,  # (n_rows,) f32
    h: torch.Tensor,  # (n_rows,) f32
    positions: torch.Tensor,  # (n_rows,) int32 global node ids; < 0 = inactive
    build_nodes: torch.Tensor,  # (S,) int32 global build-node ids
    n_bins: int,
    add_into: torch.Tensor | None = None,  # (S, m, n_bins, 2) f32, added into in place
) -> torch.Tensor:
    """``(S, m, n_bins, 2)`` f32 histogram of the rows at each build node
    (or ``add_into`` with it added)."""
    global launches
    _check_common(bins, g, h, positions, n_bins, "build_histogram_nodes")
    require(build_nodes, "build_nodes", (torch.int32,), (None,), bins.device)
    n_rows, m = bins.shape
    n_slots = build_nodes.shape[0]
    if n_slots * 4 > 48 * 1024:
        raise ValueError(f"{n_slots} build nodes exceed the kernel's node table")
    if n_rows == 0 or n_slots == 0 or m == 0:
        return _empty((n_slots, m, n_bins, 2), bins.device, add_into)
    out, ws, acc, plan, _scratch = _prepare(bins, n_slots, n_bins, add_into)
    fn = _build.library("histogram")
    err = fn(
        bins.data_ptr(), int(bins.dtype == torch.uint8), n_rows, m, n_bins,
        g.data_ptr(), h.data_ptr(), positions.data_ptr(), build_nodes.data_ptr(),
        n_slots, ws, acc, out.data_ptr(), int(add_into is not None), plan.c_args,
        max(0, (n_rows - 1).bit_length()), *launch_target(bins.device),
    )
    _build.check(err, "build_histogram_nodes", bins.device)
    launches += 1
    return out


def build_histogram(
    bins: torch.Tensor,  # (n_rows, m) uint8 or int32
    g: torch.Tensor,  # (n_rows,) f32
    h: torch.Tensor,  # (n_rows,) f32
    positions: torch.Tensor,  # (n_rows,) int32 level-local node index; < 0 = inactive
    n_nodes: int,
    n_bins: int,
    node_map: torch.Tensor | None = None,  # (level_nodes,) int32 -> build slot or -1
    add_into: torch.Tensor | None = None,  # (n_nodes, m, n_bins, 2) f32, added into in place
) -> torch.Tensor:
    """``(n_nodes, m, n_bins, 2)`` f32 histogram of the rows at each slot:
    ``node_map[pos]`` for ``0 <= pos < len(node_map)``, or ``pos`` itself
    without a node_map; every other row, and a slot outside ``[0, n_nodes)``,
    matches nothing. With ``add_into``, that tensor with it added."""
    global launches_window
    _check_common(bins, g, h, positions, n_bins, "build_histogram")
    if node_map is not None:
        require(node_map, "node_map", (torch.int32,), (None,), bins.device)
    n_rows, m = bins.shape
    map_len = 0 if node_map is None else node_map.shape[0]
    if n_rows == 0 or n_nodes == 0 or m == 0 or (node_map is not None and map_len == 0):
        return _empty((n_nodes, m, n_bins, 2), bins.device, add_into)
    out, ws, acc, plan, _scratch = _prepare(bins, n_nodes, n_bins, add_into)
    fn = _build.library("hist_window")
    err = fn(
        bins.data_ptr(), int(bins.dtype == torch.uint8), n_rows, m, n_bins,
        g.data_ptr(), h.data_ptr(), positions.data_ptr(),
        None if node_map is None else node_map.data_ptr(), map_len,
        int(0 < map_len <= MAX_STAGED_MAP), n_nodes, ws, acc, out.data_ptr(),
        int(add_into is not None), plan.c_args, max(0, (n_rows - 1).bit_length()),
        *launch_target(bins.device),
    )
    _build.check(err, "build_histogram", bins.device)
    launches_window += 1
    return out
