"""Plain PyTorch versions of the six CUDA kernels (and single-tree predict).

These are the semantics ground truth of `repro_torch.kernels`: each CUDA
kernel must agree with the function here on the same inputs (partition and
forest, binning and the bitpack decode bit for bit; the histogram kernels bit for bit with the
``*_fixed`` versions, which sum in the kernels' 64-bit fixed point, and to
f32 summation order with the f32 ones). The f32 versions are the path a CPU
tensor takes through `kernels.ops`; all are the yardsticks `chip_smoke.py`
holds the kernels against on the card. Counterparts of `repro.kernels.ref`.

Conventions shared with the kernels:
  * bins are ``(n_rows, m)`` uint8 or int32; ``MISSING_BIN`` (255) is missing
    and falls in no histogram bin;
  * a negative position matches no node (inactive / padding rows);
  * node-attribute lookups clamp the node id into ``[0, n_nodes)``, as the
    reference's gathers do.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._checks import check_count_window

MISSING_BIN = 255

# rows per chunk of the scatter in `build_histogram_nodes`: bounds the
# (rows, m) int64 index temporaries at full width (1M x 500 would be 4 GB)
_HIST_ROW_CHUNK = 1 << 16
# compare cells per chunk of `bin_values`: bounds its (rows, m, B) boolean
# temporary (100k x 500 x 255 whole would be 12.75 GB)
_BIN_CHUNK_CELLS = 1 << 24
# symbols per chunk of `bitpack_decode`: bounds its (rows, row_syms) int32
# and int64 temporaries (a 67,108 x 500 page whole would be ~0.8 GB)
_BITPACK_CHUNK_SYMS = 1 << 22


def row_slots(positions: torch.Tensor, build_nodes: torch.Tensor) -> torch.Tensor:
    """Build slot of every row: the first ``s`` with ``build_nodes[s] ==
    positions[r]``, or -1 when the row's node is not in the build set."""
    hit = positions.to(torch.int32)[:, None] == build_nodes.to(torch.int32)[None, :]
    if hit.shape[1] == 0:
        return torch.full_like(positions, -1, dtype=torch.int32)
    slot = torch.argmax(hit.to(torch.int8), dim=1).to(torch.int32)
    return torch.where(hit.any(dim=1), slot, torch.full_like(slot, -1))


def apply_node_map(positions: torch.Tensor, node_map: torch.Tensor) -> torch.Tensor:
    """Remap level-local node ids through ``node_map`` (histogram subtraction).

    ``node_map[j]`` is the build slot of level node ``j``, or -1 when j's
    histogram is derived as ``parent - sibling``. Rows at derived nodes,
    inactive rows and rows whose position falls outside the window come out
    -1 and contribute to no bin."""
    pos = positions.to(torch.int32)
    if node_map.shape[0] == 0:
        return torch.full_like(pos, -1)
    in_window = (pos >= 0) & (pos < node_map.shape[0])
    safe = pos.clamp(0, node_map.shape[0] - 1).to(torch.int64)
    return torch.where(in_window, node_map.to(torch.int32)[safe], -1)


def _hist_cells(bins, slot, n_bins: int):
    """Per chunk of `_HIST_ROW_CHUNK` rows: (g cell, row) of every (row,
    feature) whose slot is >= 0 and whose bin is a real one, the cell being
    ``((slot * m + f) * n_bins + bin) * 2`` in the flat (S, m, n_bins, 2)
    histogram (h is the next cell)."""
    n_rows, m = bins.shape
    slot = slot.to(torch.int64)
    feat = torch.arange(m, device=bins.device, dtype=torch.int64)[None, :] * n_bins
    for lo in range(0, n_rows, _HIST_ROW_CHUNK):
        hi = min(lo + _HIST_ROW_CHUNK, n_rows)
        b = bins[lo:hi].to(torch.int64)
        s = slot[lo:hi, None]
        valid = (b != MISSING_BIN) & (b >= 0) & (b < n_bins) & (s >= 0)
        yield (s * (m * n_bins) + feat + b)[valid] * 2, torch.nonzero(valid)[:, 0] + lo


def _index_add_(out: torch.Tensor, index: torch.Tensor, values: torch.Tensor) -> None:
    """``out.index_add_(0, index, values)`` with one order of the f32 adds on
    every call. On a CUDA tensor that is PyTorch's deterministic version (a
    stable sort of the indices, then each cell's adds in index order, the
    CPU's order): its default float atomics add in an order set by timing,
    and gave other sums from call to call on the H100."""
    if not out.is_cuda:
        out.index_add_(0, index, values)
        return
    mode = torch.are_deterministic_algorithms_enabled()
    warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        out.index_add_(0, index, values)
    finally:
        torch.use_deterministic_algorithms(mode, warn_only=warn_only)


def _scatter_histogram(bins, g, h, slot, n_slots: int, n_bins: int) -> torch.Tensor:
    """``out[s, f, b] = (sum g, sum h)`` over rows with ``slot == s`` whose
    bin of feature f is ``b != MISSING_BIN``; slot -1 matches nothing. Each
    cell adds its rows in row order."""
    m = bins.shape[1]
    out = torch.zeros(n_slots * m * n_bins * 2, dtype=torch.float32, device=bins.device)
    for cell, rows in _hist_cells(bins, slot, n_bins):
        _index_add_(out, cell, g[rows].to(torch.float32))
        _index_add_(out, cell + 1, h[rows].to(torch.float32))
    return out.reshape(n_slots, m, n_bins, 2)


def _fixed_scale(v: torch.Tensor, matched: torch.Tensor, lg_rows: int) -> float:
    """Power-of-two fixed-point scale of ``v`` over the matched rows:
    ``2 ** (62 - lg_rows - e)`` with ``max|v| < 2 ** e`` (``e = 0`` when the
    maximum is 0), so no sum of up to ``2 ** lg_rows`` rounded terms leaves
    int64."""
    mx = v[matched].abs().max() if bool(matched.any()) else v.new_zeros(())
    e = int(torch.frexp(mx.to(torch.float32)).exponent)
    return 2.0 ** (62 - lg_rows - e)


def _scatter_histogram_fixed(bins, g, h, slot, n_slots: int, n_bins: int) -> torch.Tensor:
    """`_scatter_histogram` in the CUDA kernels' arithmetic, bit for bit:
    g and h are scaled by `_fixed_scale` (``lg_rows`` from all ``n_rows``),
    rounded half to even to int64 (``__double2ll_rn``), summed exactly in
    int64, and each sum converted once, ``float(double(acc) / scale)``.
    Integer sums do not depend on the order of rows."""
    n_rows, m = bins.shape
    lg_rows = max(0, (n_rows - 1).bit_length())
    matched = slot >= 0
    scales = [_fixed_scale(v, matched, lg_rows) for v in (g, h)]
    qg, qh = [(v.to(torch.float64) * s).round().to(torch.int64) for v, s in zip((g, h), scales)]
    acc = torch.zeros(n_slots * m * n_bins * 2, dtype=torch.int64, device=bins.device)
    for cell, rows in _hist_cells(bins, slot, n_bins):
        acc.index_add_(0, cell, qg[rows])
        acc.index_add_(0, cell + 1, qh[rows])
    scale = torch.tensor(scales, dtype=torch.float64, device=bins.device)
    return (acc.reshape(-1, 2).to(torch.float64) / scale).to(torch.float32).reshape(
        n_slots, m, n_bins, 2
    )


def build_histogram_nodes(
    bins: torch.Tensor,  # (n_rows, m) uint8 or int32 local bins
    g: torch.Tensor,  # (n_rows,) f32
    h: torch.Tensor,  # (n_rows,) f32
    positions: torch.Tensor,  # (n_rows,) int32 global node ids; < 0 = inactive
    build_nodes: torch.Tensor,  # (S,) int32 global build-node ids, all >= 0
    n_bins: int,
) -> torch.Tensor:
    """``out[s, f, b] = (sum g, sum h)`` over rows at node ``build_nodes[s]``
    whose bin of feature f is ``b != MISSING_BIN``; shape (S, m, n_bins, 2)."""
    slot = row_slots(positions, build_nodes)
    return _scatter_histogram(bins, g, h, slot, build_nodes.shape[0], n_bins)


def build_histogram_nodes_fixed(bins, g, h, positions, build_nodes, n_bins: int) -> torch.Tensor:
    """`build_histogram_nodes` with kernel 1's fixed-point sums: the same
    bits as the CUDA kernel on the same inputs."""
    slot = row_slots(positions, build_nodes)
    return _scatter_histogram_fixed(bins, g, h, slot, build_nodes.shape[0], n_bins)


def build_histogram(
    bins: torch.Tensor,  # (n_rows, m) uint8 or int32 local bins
    g: torch.Tensor,  # (n_rows,) f32
    h: torch.Tensor,  # (n_rows,) f32
    positions: torch.Tensor,  # (n_rows,) int32 level-local node index; < 0 = inactive
    n_nodes: int,
    n_bins: int,
    node_map: torch.Tensor | None = None,  # (level_nodes,) int32 -> build slot or -1
) -> torch.Tensor:
    """Level-window histogram: ``out[k]`` sums the rows whose slot is ``k``,
    the slot being ``node_map[pos]`` (or ``pos`` without a node_map); rows
    with a slot outside ``[0, n_nodes)`` contribute to no bin. Shape
    (n_nodes, m, n_bins, 2)."""
    return _scatter_histogram(bins, g, h, _window_slots(positions, n_nodes, node_map), n_nodes,
                              n_bins)


def build_histogram_fixed(bins, g, h, positions, n_nodes: int, n_bins: int, node_map=None):
    """`build_histogram` with kernel 4's fixed-point sums: the same bits as
    the CUDA kernel on the same inputs."""
    return _scatter_histogram_fixed(bins, g, h, _window_slots(positions, n_nodes, node_map),
                                    n_nodes, n_bins)


def _window_slots(positions, n_nodes: int, node_map) -> torch.Tensor:
    """A row's slot in a level window: ``node_map[pos]`` (or ``pos``), -1
    outside ``[0, n_nodes)``."""
    pos = positions.to(torch.int32)
    if node_map is not None:
        pos = apply_node_map(pos, node_map)
    return torch.where((pos >= 0) & (pos < n_nodes), pos, -1)


def bin_values(
    x: torch.Tensor,  # (n_rows, m) f32 or f64 raw features
    padded_edges: torch.Tensor,  # (m, B) f32 right edges, +inf padded
    n_bins_per_feature: torch.Tensor,  # (m,) int32
) -> torch.Tensor:
    """Quantise raw features to uint8 local bins (Alg. 4 inner loop):
    ``clip(#{k : x > edges[f, k]}, 0, n_bins_f - 1)``, NaN -> MISSING_BIN.

    Compares in x's own type (the f32 edges widen exactly to f64), in row
    chunks so no (n_rows, m, B) temporary is ever whole."""
    n_rows, m = x.shape
    edges = padded_edges.to(x.dtype)
    last = (n_bins_per_feature.to(torch.int64) - 1).clamp(min=0)
    out = torch.empty((n_rows, m), dtype=torch.uint8, device=x.device)
    step = max(1, _BIN_CHUNK_CELLS // max(m * padded_edges.shape[1], 1))
    for lo in range(0, n_rows, step):
        xc = x[lo : lo + step]
        cnt = (xc[:, :, None] > edges[None, :, :]).sum(dim=-1)
        b = torch.minimum(cnt, last[None, :])
        out[lo : lo + step] = torch.where(torch.isnan(xc), MISSING_BIN, b).to(torch.uint8)
    return out


def level_row_counts(positions: torch.Tensor, offset: int, count: int) -> torch.Tensor:
    """(count,) int32 rows per window-local node of ``[offset, offset +
    count)``; rows outside the window count nowhere. Counterpart of
    `repro.core.histcache.level_row_counts`."""
    lp = positions.to(torch.int64) - offset
    valid = (lp >= 0) & (lp < count)
    safe = torch.where(valid, lp, torch.full_like(lp, count))  # overflow slot
    counts = torch.zeros(count + 1, dtype=torch.int32, device=positions.device)
    counts.scatter_add_(0, safe, torch.ones_like(safe, dtype=torch.int32))
    return counts[:count]


def partition_rows(
    bins: torch.Tensor,  # (n_rows, m) uint8 or int32
    positions: torch.Tensor,  # (n_rows,) int32; < 0 = retired
    feature: torch.Tensor,  # (n_nodes,) int32 split feature per node
    split_bin: torch.Tensor,  # (n_nodes,) int32 (go left iff bin <= split_bin)
    default_left: torch.Tensor,  # (n_nodes,) bool missing direction
    is_leaf: torch.Tensor,  # (n_nodes,) bool
    count_level: tuple[int, int] | None = None,  # (offset, count) of the next level
    counts: torch.Tensor | None = None,  # (count,) int32, added into
) -> torch.Tensor:
    """Rows move to child ``2p+1`` (left) or ``2p+2`` (right); rows at a leaf
    keep their position; inactive rows stay -1. With ``count_level``, the
    new positions' `level_row_counts` are added into ``counts`` in place."""
    check_count_window(count_level, counts, bins.device)
    pos = positions.to(torch.int32)
    active = pos >= 0
    safe = torch.where(active, pos, torch.zeros_like(pos)).clamp_(max=feature.shape[0] - 1)
    safe = safe.to(torch.int64)
    f_idx = feature[safe].to(torch.int64).clamp_(0, bins.shape[1] - 1)
    bval = torch.gather(bins, 1, f_idx[:, None])[:, 0].to(torch.int32)
    go_left = torch.where(bval == MISSING_BIN, default_left[safe], bval <= split_bin[safe])
    child = 2 * pos + 1 + (~go_left).to(torch.int32)
    moved = torch.where(is_leaf[safe], pos, child)
    out = torch.where(active, moved, torch.full_like(pos, -1))
    if count_level is not None:
        counts.add_(level_row_counts(out, *count_level))
    return out


def _leaf_positions(bins, feature, split_bin, default_left, is_leaf, max_depth):
    """Walk one complete-layout tree ``max_depth`` steps; returns node ids."""
    pos = torch.zeros(bins.shape[0], dtype=torch.int64, device=bins.device)
    for _ in range(max_depth):
        f_idx = feature[pos].to(torch.int64).clamp_(0, bins.shape[1] - 1)
        bval = torch.gather(bins, 1, f_idx[:, None])[:, 0].to(torch.int32)
        go_left = torch.where(bval == MISSING_BIN, default_left[pos], bval <= split_bin[pos])
        child = 2 * pos + 1 + (~go_left).to(torch.int64)
        pos = torch.where(is_leaf[pos], pos, child)
    return pos


def predict_bins(
    bins: torch.Tensor,  # (n_rows, m)
    feature: torch.Tensor,  # (n_nodes,) int32
    split_bin: torch.Tensor,  # (n_nodes,) int32
    default_left: torch.Tensor,  # (n_nodes,) bool
    is_leaf: torch.Tensor,  # (n_nodes,) bool
    leaf_value: torch.Tensor,  # (n_nodes,) f32
    max_depth: int,
) -> torch.Tensor:
    """Leaf value of every row under one tree."""
    pos = _leaf_positions(bins, feature, split_bin, default_left, is_leaf, max_depth)
    return leaf_value[pos]


def predict_forest_bins(
    bins: torch.Tensor,  # (n_rows, m)
    feature: torch.Tensor,  # (T, n_nodes) int32
    split_bin: torch.Tensor,  # (T, n_nodes) int32
    default_left: torch.Tensor,  # (T, n_nodes) bool
    is_leaf: torch.Tensor,  # (T, n_nodes) bool
    leaf_value: torch.Tensor,  # (T, n_nodes) f32, PRE-SCALED by the learning rate
    max_depth: int,
    margin_in: torch.Tensor,  # (n_rows,) f32
) -> torch.Tensor:
    """``margin_in + sum_t leaf_t(row)``, added tree by tree in forest order
    as pure f32 adds (the leaf table arrives pre-scaled, see `ops`)."""
    margin = margin_in.to(torch.float32)
    for t in range(feature.shape[0]):
        margin = margin + predict_bins(
            bins, feature[t], split_bin[t], default_left[t], is_leaf[t],
            leaf_value[t], max_depth,
        )
    return margin


def bitpack_decode(
    payload: torch.Tensor,  # (rows, ceil(row_syms * bits / 8)) uint8
    row_syms: int,
    bits: int,
    missing: int | None,
) -> torch.Tensor:
    """(rows, row_syms) uint8 symbols of a row-wise packed payload: symbol s
    of a row is the row's bits ``[s * bits, s * bits + bits)``, read
    little-endian from the low bit of its first byte (two bytes at most for
    ``bits <= 8``); the packed ``missing`` symbol becomes ``MISSING_BIN``.
    Rows are decoded in chunks so that the temporaries stay bounded."""
    rows, row_bytes = payload.shape
    out = torch.empty((rows, row_syms), dtype=torch.uint8, device=payload.device)
    if rows * row_syms == 0:
        return out
    bit = torch.arange(row_syms, dtype=torch.int64, device=payload.device) * bits
    byte = bit >> 3
    shift = (bit & 7).to(torch.int32)
    has_next = byte + 1 < row_bytes
    nxt = torch.where(has_next, byte + 1, byte)
    mask = (1 << bits) - 1
    step = max(1, _BITPACK_CHUNK_SYMS // row_syms)
    for lo in range(0, rows, step):
        blk = payload[lo : lo + step].to(torch.int32)
        word = blk[:, byte] | torch.where(has_next, blk[:, nxt], 0) << 8
        sym = (word >> shift) & mask
        if missing is not None:
            sym = torch.where(sym == missing, MISSING_BIN, sym)
        out[lo : lo + step] = sym.to(torch.uint8)
    return out
