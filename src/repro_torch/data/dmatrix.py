"""DMatrix: the data surface `GradientBooster.fit` accepts.

Counterpart of the in-core part of `repro.data.dmatrix`. A DMatrix owns its
`HistogramCuts`, row and feature counts, labels and the quantised ELLPACK
matrix, and reports `estimated_device_bytes()` for the `ExecutionPolicy`
decision. `ArrayDMatrix` quantises in-memory ndarrays whole (Alg. 2+4).
The paged sources (`IterDMatrix`, `PagedDMatrix`) and the page-set view
arrive with the out-of-core slice; `as_dmatrix` raises for a batch source.
"""
from __future__ import annotations

from typing import Any

import numpy as np

from repro_torch.core.ellpack import DEFAULT_PAGE_BYTES, create_ellpack_inmemory
from repro_torch.core.quantile import HistogramCuts


class DMatrix:
    """Quantised training data (host side) with the fields every mode reads."""

    cuts: HistogramCuts
    labels: np.ndarray | None
    page_bytes: int
    n_bins: int

    @property
    def n_rows(self) -> int:
        raise NotImplementedError

    @property
    def num_features(self) -> int:
        return self.cuts.num_features

    def estimated_device_bytes(self) -> int:
        """Bytes of the quantised matrix staged whole (dense uint8 ELLPACK)."""
        return self.n_rows * self.num_features

    def single_page_bins(self) -> np.ndarray:
        """The whole quantised matrix as one (n_rows, m) uint8 array."""
        raise NotImplementedError

    def require_labels(self) -> np.ndarray:
        if self.labels is None:
            raise ValueError(
                f"{type(self).__name__} has no labels; construct it with y "
                "before calling fit"
            )
        return self.labels


class ArrayDMatrix(DMatrix):
    """In-memory ndarrays quantised whole (Alg. 2+4)."""

    def __init__(
        self,
        X: np.ndarray,
        y: np.ndarray | None = None,
        *,
        max_bin: int = 256,
        cuts: HistogramCuts | None = None,
        page_bytes: int = DEFAULT_PAGE_BYTES,
    ):
        X = np.asarray(X)
        if X.ndim != 2:
            raise ValueError(f"X must be 2-D (n_rows, num_features); got shape {X.shape}")
        self.n_bins = min(max_bin, 255)
        self.cuts, self._bins = create_ellpack_inmemory(X, max_bin=self.n_bins, cuts=cuts)
        self.labels = None if y is None else np.asarray(y, np.float32)
        if self.labels is not None and self.labels.shape[0] != X.shape[0]:
            raise ValueError(f"len(y)={self.labels.shape[0]} != n_rows={X.shape[0]}")
        self.page_bytes = page_bytes

    @property
    def n_rows(self) -> int:
        return self._bins.shape[0]

    def single_page_bins(self) -> np.ndarray:
        return self._bins


def as_dmatrix(
    data: Any,
    y: np.ndarray | None = None,
    *,
    max_bin: int = 256,
    cuts: HistogramCuts | None = None,
) -> DMatrix:
    """Coerce what the user handed `fit` into a DMatrix: a DMatrix is itself,
    an ndarray (+ y) or an ``(X, y)`` pair becomes an `ArrayDMatrix`."""
    if isinstance(data, DMatrix):
        if y is not None:
            raise ValueError("pass labels when constructing the DMatrix, not to fit()")
        return data
    if isinstance(data, tuple) and len(data) == 2 and y is None:
        data, y = data
    if isinstance(data, np.ndarray) or (
        hasattr(data, "__array__") and not hasattr(data, "iter_batches") and not callable(data)
    ):
        return ArrayDMatrix(data, y, max_bin=max_bin, cuts=cuts)
    raise NotImplementedError(
        f"{type(data).__name__} is not an array: batch sources (IterDMatrix) are "
        "not ported yet; they come with the out-of-core slice"
    )
