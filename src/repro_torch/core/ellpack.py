"""ELLPACK quantisation (paper Alg. 4): raw features -> per-feature bins.

Counterpart of the in-core part of `repro.core.ellpack`, a numpy copy.
Features are quantised to per-feature local bin indices with the
`HistogramCuts` and stored dense (fixed row width = num_features) as uint8;
bin 255 is the missing sentinel, so each feature has at most 255 real bins.
The paged matrix (Alg. 5) and `compact` (Alg. 7) arrive with the
out-of-core slice.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.quantile import HistogramCuts, QuantileSketch

MISSING_BIN = 255
DEFAULT_PAGE_BYTES = 32 * 1024 * 1024  # paper: 32 MiB pages


def bin_batch(X: np.ndarray, cuts: HistogramCuts) -> np.ndarray:
    """Quantize a dense batch to local bin indices (host version of Alg. 4).

    bin(x) = clip(searchsorted(edges_f, x, side='left'), 0, n_bins_f - 1);
    NaN -> MISSING_BIN.
    """
    X = np.asarray(X)
    n, m = X.shape
    # work column by column on a transposed copy: contiguous columns in and
    # out, one transpose back at the end (same bins as a strided walk)
    columns = np.ascontiguousarray(X.T)
    out_t = np.empty((m, n), dtype=np.uint8)
    for f in range(m):
        edges = cuts.feature_edges(f)
        col = columns[f]
        b = np.searchsorted(edges, col, side="left")
        b = np.clip(b, 0, max(len(edges) - 1, 0)).astype(np.uint8)
        b[np.isnan(col)] = MISSING_BIN
        out_t[f] = b
    return np.ascontiguousarray(out_t.T)


def create_ellpack_inmemory(
    X: np.ndarray, max_bin: int = 256, cuts: HistogramCuts | None = None
) -> tuple[HistogramCuts, np.ndarray]:
    """In-core path: sketch (unless ``cuts`` is given) and quantize the whole
    matrix as one page (Alg. 2+4). Returns (cuts, (n_rows, m) uint8 bins)."""
    X = np.asarray(X)
    if cuts is None:
        sketch = QuantileSketch(X.shape[1], max_bin=max_bin)
        sketch.update(X)
        cuts = sketch.finalize()
    return cuts, bin_batch(X, cuts)
