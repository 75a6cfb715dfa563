"""ELLPACK quantised matrix and external pages (paper Alg. 4 / Alg. 5).

Counterpart of `repro.core.ellpack`. Features are quantised to per-feature
local bin indices with the `HistogramCuts` and stored dense (fixed row width
= num_features) as uint8; bin 255 is the missing sentinel, so each feature
has at most 255 real bins.

Quantisation runs on the caller's device through `kernels.ops.bin_values`
(the CUDA binning kernel for a CUDA device): raw rows cross to the device in
chunks of at most one page's rows, so binning never needs the whole raw
matrix on the device. The bins equal the reference's numpy `bin_batch` bit
for bit, for float32 and float64 input. In external-memory mode the matrix
is a sequence of fixed-budget pages (default 32 MiB, the paper's page
size), with the reference's page-row arithmetic; `compact` gathers sampled
rows from many pages into one page (the Compact step of Alg. 7).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Iterator, Sequence

import numpy as np
import torch

from repro_torch.core.quantile import HistogramCuts, QuantileSketch
from repro_torch.kernels import ops

MISSING_BIN = 255
DEFAULT_PAGE_BYTES = 32 * 1024 * 1024  # paper: 32 MiB pages


def bin_batch(X: np.ndarray, cuts: HistogramCuts) -> np.ndarray:
    """Quantise a dense batch on the host (numpy copy of the reference's
    Alg. 4 oracle). No path of the port calls it; tests hold the device
    binning against it.

    bin(x) = clip(searchsorted(edges_f, x, side='left'), 0, n_bins_f - 1);
    NaN -> MISSING_BIN.
    """
    X = np.asarray(X)
    n, m = X.shape
    out = np.empty((n, m), dtype=np.uint8)
    for f in range(m):
        edges = cuts.feature_edges(f)
        col = X[:, f]
        b = np.searchsorted(edges, col, side="left")
        b = np.clip(b, 0, max(len(edges) - 1, 0)).astype(np.uint8)
        b[np.isnan(col)] = MISSING_BIN
        out[:, f] = b
    return out


def rows_per_page(num_features: int, page_bytes: int = DEFAULT_PAGE_BYTES) -> int:
    return max(1, page_bytes // max(num_features, 1))


class Binner:
    """`HistogramCuts` as device tables, quantising raw rows on one device.

    The padded edge matrix is ``max_n_bins`` wide (+inf padded) and lives on
    the device with the per-feature bin counts. Raw rows are compared in
    their numpy promotion type against float32 edges: float32 where numpy's
    ``searchsorted`` would compare in float32 (float32, float16, small ints),
    float64 otherwise, so the bins equal `bin_batch`'s.
    """

    def __init__(self, cuts: HistogramCuts, device, page_bytes: int = DEFAULT_PAGE_BYTES):
        self.device = torch.device(device)
        self.num_features = cuts.num_features
        self.chunk_rows = rows_per_page(cuts.num_features, page_bytes)
        width = max(cuts.max_n_bins, 1)
        self.edges = torch.from_numpy(cuts.padded_edges(width)).to(self.device)
        self.n_bins = torch.from_numpy(cuts.n_bins_per_feature.astype(np.int32)).to(self.device)

    def _chunks(self, X: np.ndarray) -> Iterator[tuple[int, torch.Tensor]]:
        """(first row, device uint8 bins) per chunk of at most one page's rows."""
        X = np.asarray(X)
        if X.ndim != 2 or X.shape[1] != self.num_features:
            raise ValueError(
                f"X has shape {X.shape}; expected (n_rows, {self.num_features})"
            )
        dtype = np.float32 if np.result_type(X.dtype, np.float32) == np.float32 else np.float64
        for lo in range(0, X.shape[0], self.chunk_rows):
            raw = np.ascontiguousarray(X[lo : lo + self.chunk_rows], dtype=dtype)
            yield lo, ops.bin_values(
                torch.from_numpy(raw).to(self.device), self.edges, self.n_bins
            )

    def to_device(self, X: np.ndarray) -> torch.Tensor:
        """(n_rows, m) uint8 bins, resident on the device."""
        X = np.asarray(X)
        out = torch.empty((len(X), self.num_features), dtype=torch.uint8, device=self.device)
        for lo, bins in self._chunks(X):
            out[lo : lo + bins.shape[0]] = bins
        return out

    def to_host(self, X: np.ndarray) -> np.ndarray:
        """(n_rows, m) uint8 bins, binned on the device and copied back."""
        X = np.asarray(X)
        out = np.empty((len(X), self.num_features), dtype=np.uint8)
        for lo, bins in self._chunks(X):
            out[lo : lo + bins.shape[0]] = bins.cpu().numpy()
        return out


@dataclasses.dataclass
class EllpackPage:
    """One fixed-row-width page of quantised features (host uint8)."""

    bins: np.ndarray  # (n_rows, num_features) uint8
    row_offset: int = 0  # global index of first row

    @property
    def n_rows(self) -> int:
        return self.bins.shape[0]

    @property
    def num_features(self) -> int:
        return self.bins.shape[1]

    @property
    def nbytes(self) -> int:
        return self.bins.nbytes

    @property
    def row_ids(self) -> np.ndarray:
        return np.arange(self.row_offset, self.row_offset + self.n_rows)


@dataclasses.dataclass
class EllpackMatrix:
    """A quantised training matrix: one page in-core, many pages out-of-core."""

    cuts: HistogramCuts
    pages: list[EllpackPage]

    @property
    def n_rows(self) -> int:
        return sum(p.n_rows for p in self.pages)

    @property
    def num_features(self) -> int:
        return self.cuts.num_features

    def single_page(self) -> EllpackPage:
        if len(self.pages) == 1:
            return self.pages[0]
        return EllpackPage(
            bins=np.concatenate([p.bins for p in self.pages], axis=0), row_offset=0
        )

    def iter_pages(self) -> Iterator[EllpackPage]:
        return iter(self.pages)


def create_ellpack_inmemory(
    X: np.ndarray,
    max_bin: int = 256,
    cuts: HistogramCuts | None = None,
    *,
    device="cuda",
    page_bytes: int = DEFAULT_PAGE_BYTES,
) -> EllpackMatrix:
    """In-core path: sketch on the host (unless ``cuts`` is given), then
    quantise the whole matrix on ``device`` into one host page (Alg. 2+4)."""
    X = np.asarray(X)
    if cuts is None:
        sketch = QuantileSketch(X.shape[1], max_bin=max_bin)
        sketch.update(X)
        cuts = sketch.finalize()
    bins = Binner(cuts, device, page_bytes).to_host(X)
    return EllpackMatrix(cuts=cuts, pages=[EllpackPage(bins, 0)])


def create_ellpack_pages(
    batches: Iterable[np.ndarray],
    cuts: HistogramCuts,
    page_bytes: int = DEFAULT_PAGE_BYTES,
    *,
    device="cuda",
) -> Iterator[EllpackPage]:
    """Out-of-core path (Alg. 5): bin each batch on ``device``, accumulate
    the uint8 rows on the host, emit ~page_bytes pages.

    Input batches are the CSR pages of the paper (variable row count); output
    pages have a fixed byte budget so device staging is bounded. The page
    extents are the reference's exactly.
    """
    binner = Binner(cuts, device, page_bytes)
    buf: list[np.ndarray] = []
    buf_bytes = 0
    row_offset = 0
    emitted_rows = 0
    for batch in batches:
        binned = binner.to_host(batch)
        buf.append(binned)
        buf_bytes += binned.nbytes
        while buf_bytes >= page_bytes:
            rows_needed = rows_per_page(binned.shape[1], page_bytes)
            stacked = np.concatenate(buf, axis=0) if len(buf) > 1 else buf[0]
            page_bins, rest = stacked[:rows_needed], stacked[rows_needed:]
            yield EllpackPage(np.ascontiguousarray(page_bins), row_offset)
            row_offset += page_bins.shape[0]
            emitted_rows += page_bins.shape[0]
            buf = [rest] if rest.shape[0] else []
            buf_bytes = rest.nbytes if rest.shape[0] else 0
    if buf_bytes or (emitted_rows == 0 and buf):
        stacked = np.concatenate(buf, axis=0) if len(buf) > 1 else buf[0]
        if stacked.shape[0]:
            yield EllpackPage(np.ascontiguousarray(stacked), row_offset)


def compact(
    pages: Sequence[EllpackPage], selected_rows: np.ndarray
) -> tuple[EllpackPage, np.ndarray]:
    """Gather selected global rows from many pages into one page (Alg. 7 Compact).

    Returns (compacted page, the global row ids in page order) so gradients can
    be aligned with the compacted rows.
    """
    selected_rows = np.asarray(selected_rows)
    sel_sorted = np.sort(selected_rows)
    chunks: list[np.ndarray] = []
    ids: list[np.ndarray] = []
    for page in pages:
        lo = np.searchsorted(sel_sorted, page.row_offset, side="left")
        hi = np.searchsorted(sel_sorted, page.row_offset + page.n_rows, side="left")
        if hi > lo:
            local = sel_sorted[lo:hi] - page.row_offset
            chunks.append(page.bins[local])
            ids.append(sel_sorted[lo:hi])
    if not chunks:
        m = pages[0].num_features if pages else 0
        return EllpackPage(np.zeros((0, m), dtype=np.uint8), 0), np.zeros(0, np.int64)
    return (
        EllpackPage(np.concatenate(chunks, axis=0), 0),
        np.concatenate(ids).astype(np.int64),
    )


def estimate_ellpack_bytes(n_rows: int, num_features: int) -> int:
    """CalculateEllpackPageSize of Alg. 5 for dense uint8 ELLPACK."""
    return n_rows * num_features


def num_pages(n_rows: int, num_features: int, page_bytes: int = DEFAULT_PAGE_BYTES) -> int:
    return max(1, math.ceil(estimate_ellpack_bytes(n_rows, num_features) / page_bytes))
