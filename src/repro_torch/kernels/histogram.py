"""Gradient histograms: wrappers of ``csrc/histogram.cu`` and
``csrc/hist_window.cu``.

  build_histogram_nodes  kernel 1, rows matched against global build-node
                         ids (`repro.kernels.histogram.build_histogram_nodes`)
  build_histogram        kernel 4, level-local rows remapped through an
                         optional ``node_map`` (`repro.kernels.histogram
                         .build_histogram`)

Both scatter into shared-memory histogram tiles with 64-bit fixed-point
integer atomics (``csrc/hist_common.cuh``), so a result is the same bits on
every run, and the two give the same bits for the same matched rows. Plain
versions: `repro_torch.kernels.ref.build_histogram_nodes` and
`ref.build_histogram`. Each wrapper counts its own launches (``launches``,
``launches_window``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import require, require_cuda, stream_ptr

# shared memory one block may take for its int64 (slot, feature, bin, g|h)
# tile; the card allows 227 KB per block
SMEM_BUDGET = 200 * 1024
# blocks wanted per SM before rows are split into chunks
BLOCKS_PER_SM = 4
MIN_ROWS_PER_CHUNK = 256

# node_map entries staged in shared memory by kernel 4 (48 KB of int32);
# a longer map is read from global memory
MAX_STAGED_MAP = 48 * 1024 // 4

launches = 0  # kernel 1
launches_window = 0  # kernel 4


def plan_tiles(n_rows: int, m: int, n_slots: int, n_bins: int, n_sm: int):
    """(slot_tile, feat_tile, rows_per_chunk, smem_bytes) for one launch.

    A block's tile holds slot_tile x feat_tile histograms of n_bins (g, h)
    int64 pairs within `SMEM_BUDGET`; slots are split into the fewest equal
    tiles that fit, and the remaining room goes to features. Rows are then
    chunked until the grid has about `BLOCKS_PER_SM` blocks per SM."""
    units = SMEM_BUDGET // (n_bins * 16)
    if units < 1:
        raise ValueError(f"n_bins={n_bins} does not fit one histogram in shared memory")
    n_stiles = -(-n_slots // units)
    slot_tile = -(-n_slots // n_stiles)
    feat_tile = max(1, min(m, units // slot_tile))
    blocks = -(-m // feat_tile) * n_stiles
    n_chunks = max(1, min(-(-BLOCKS_PER_SM * n_sm // blocks), -(-n_rows // MIN_ROWS_PER_CHUNK)))
    rows_per_chunk = -(-n_rows // n_chunks)
    return slot_tile, feat_tile, rows_per_chunk, slot_tile * feat_tile * n_bins * 16


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


def _scratch(bins: torch.Tensor, n_slots: int, n_bins: int):
    """(out, slot, absmax, acc, tile plan) of one launch over ``n_slots``."""
    dev = bins.device
    n_rows, m = bins.shape
    out = torch.empty((n_slots, m, n_bins, 2), dtype=torch.float32, device=dev)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = plan_tiles(n_rows, m, n_slots, n_bins, n_sm)[:3]
    slot = torch.empty(n_rows, dtype=torch.int32, device=dev)
    absmax = torch.empty(2, dtype=torch.int32, device=dev)
    acc = torch.empty(out.numel(), dtype=torch.int64, device=dev)
    return out, slot, absmax, acc, plan


def build_histogram_nodes(
    bins: torch.Tensor,  # (n_rows, m) uint8 or int32
    g: torch.Tensor,  # (n_rows,) f32
    h: torch.Tensor,  # (n_rows,) f32
    positions: torch.Tensor,  # (n_rows,) int32 global node ids; < 0 = inactive
    build_nodes: torch.Tensor,  # (S,) int32 global build-node ids
    n_bins: int,
) -> torch.Tensor:
    """``(S, m, n_bins, 2)`` f32 histogram of the rows at each build node."""
    global launches
    _check_common(bins, g, h, positions, n_bins, "build_histogram_nodes")
    require(build_nodes, "build_nodes", (torch.int32,), (None,), bins.device)
    n_rows, m = bins.shape
    n_slots = build_nodes.shape[0]
    if n_slots * 4 > 48 * 1024:
        raise ValueError(f"{n_slots} build nodes exceed the kernel's node table")
    if n_rows == 0 or n_slots == 0 or m == 0:
        return torch.zeros((n_slots, m, n_bins, 2), dtype=torch.float32, device=bins.device)
    out, slot, absmax, acc, (slot_tile, feat_tile, rows_per_chunk) = _scratch(
        bins, n_slots, n_bins
    )
    fn = _build.library("histogram")
    err = fn(
        bins.data_ptr(), int(bins.dtype == torch.uint8), n_rows, m, n_bins,
        g.data_ptr(), h.data_ptr(), positions.data_ptr(), build_nodes.data_ptr(),
        n_slots, slot.data_ptr(), absmax.data_ptr(), acc.data_ptr(), out.data_ptr(),
        slot_tile, feat_tile, rows_per_chunk, max(0, (n_rows - 1).bit_length()),
        stream_ptr(bins.device),
    )
    _build.check(err, "build_histogram_nodes")
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
) -> torch.Tensor:
    """``(n_nodes, m, n_bins, 2)`` f32 histogram of the rows at each slot:
    ``node_map[pos]`` for ``0 <= pos < len(node_map)``, or ``pos`` itself
    without a node_map; every other row, and a slot outside ``[0, n_nodes)``,
    matches nothing."""
    global launches_window
    _check_common(bins, g, h, positions, n_bins, "build_histogram")
    if node_map is not None:
        require(node_map, "node_map", (torch.int32,), (None,), bins.device)
    n_rows, m = bins.shape
    map_len = 0 if node_map is None else node_map.shape[0]
    if n_rows == 0 or n_nodes == 0 or m == 0 or (node_map is not None and map_len == 0):
        return torch.zeros((n_nodes, m, n_bins, 2), dtype=torch.float32, device=bins.device)
    out, slot, absmax, acc, (slot_tile, feat_tile, rows_per_chunk) = _scratch(
        bins, n_nodes, n_bins
    )
    fn = _build.library("hist_window")
    err = fn(
        bins.data_ptr(), int(bins.dtype == torch.uint8), n_rows, m, n_bins,
        g.data_ptr(), h.data_ptr(), positions.data_ptr(),
        None if node_map is None else node_map.data_ptr(), map_len,
        int(0 < map_len <= MAX_STAGED_MAP), n_nodes,
        slot.data_ptr(), absmax.data_ptr(), acc.data_ptr(), out.data_ptr(),
        slot_tile, feat_tile, rows_per_chunk, max(0, (n_rows - 1).bit_length()),
        stream_ptr(bins.device),
    )
    _build.check(err, "build_histogram")
    launches_window += 1
    return out
