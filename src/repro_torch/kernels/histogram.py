"""Fused node-set gradient histogram: wrapper of ``csrc/histogram.cu``.

Counterpart of `repro.kernels.histogram.build_histogram_nodes`. The kernel
scatters into shared-memory histogram tiles with 64-bit fixed-point integer
atomics, so its result is the same bits on every run (see the note in the
source). Plain version: `repro_torch.kernels.ref.build_histogram_nodes`.
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

launches = 0


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
    require_cuda(bins, "build_histogram_nodes")
    dev = bins.device
    n_rows, m = bins.shape
    n_slots = build_nodes.shape[0]
    require(bins, "bins", (torch.uint8, torch.int32), (None, None), dev)
    require(g, "g", (torch.float32,), (n_rows,), dev)
    require(h, "h", (torch.float32,), (n_rows,), dev)
    require(positions, "positions", (torch.int32,), (n_rows,), dev)
    require(build_nodes, "build_nodes", (torch.int32,), (None,), dev)
    if not 1 <= n_bins <= 256:
        raise ValueError(f"n_bins must be in [1, 256], got {n_bins}")
    if n_slots * 4 > 48 * 1024:
        raise ValueError(f"{n_slots} build nodes exceed the kernel's node table")
    out = torch.empty((n_slots, m, n_bins, 2), dtype=torch.float32, device=dev)
    if n_rows == 0 or n_slots == 0 or m == 0:
        return out.zero_()
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    slot_tile, feat_tile, rows_per_chunk, _ = plan_tiles(n_rows, m, n_slots, n_bins, n_sm)
    slot = torch.empty(n_rows, dtype=torch.int32, device=dev)
    absmax = torch.empty(2, dtype=torch.int32, device=dev)
    acc = torch.empty(out.numel(), dtype=torch.int64, device=dev)
    fn = _build.library("histogram")
    err = fn(
        bins.data_ptr(), int(bins.dtype == torch.uint8), n_rows, m, n_bins,
        g.data_ptr(), h.data_ptr(), positions.data_ptr(), build_nodes.data_ptr(),
        n_slots, slot.data_ptr(), absmax.data_ptr(), acc.data_ptr(), out.data_ptr(),
        slot_tile, feat_tile, rows_per_chunk, max(0, (n_rows - 1).bit_length()),
        stream_ptr(dev),
    )
    _build.check(err, "build_histogram_nodes")
    launches += 1
    return out
