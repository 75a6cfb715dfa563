"""Incremental quantile sketch (paper Alg. 2 / Alg. 3).

Counterpart of `repro.core.quantile`: a numpy copy, so the port imports
nothing of the JAX package. Identical inputs give identical cuts.

Produces per-feature histogram cut points from data seen one batch (CSR/dense
page) at a time, so the raw feature matrix never needs to be resident — the
"Incremental Quantile Generation" step of out-of-core preprocessing.

The sketch is a weighted merge-prune summary per feature: each summary entry is
a (value, weight) pair where weight is the total sample weight represented by
that entry. Updating with a batch sorts the batch column, compresses it to at
most `sketch_size` entries at evenly spaced cumulative-weight ranks (always
keeping min and max), and merges with the running summary, re-pruning to
`sketch_size`. Approximation error of any quantile is O(1/sketch_size) in rank,
and the sketch is exact when a feature has <= sketch_size distinct values.

Missing values (NaN) are excluded from the sketch, matching XGBoost.
"""
from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np


@dataclasses.dataclass
class HistogramCuts:
    """Per-feature bin right-edges, ragged, XGBoost HistogramCuts layout.

    Feature f owns ``values[ptrs[f]:ptrs[f+1]]`` (sorted ascending). The bin of
    x is ``clip(searchsorted(edges, x, side='left'), 0, n_bins_f - 1)``; the
    last edge is max(x)+eps so every in-range value lands in a real bin.
    """

    values: np.ndarray  # (total_cuts,) float32, concatenated right edges
    ptrs: np.ndarray  # (num_features + 1,) int32
    min_vals: np.ndarray  # (num_features,) float32, per-feature data minimum

    @property
    def num_features(self) -> int:
        return len(self.ptrs) - 1

    def n_bins(self, f: int) -> int:
        return int(self.ptrs[f + 1] - self.ptrs[f])

    @property
    def n_bins_per_feature(self) -> np.ndarray:
        return (self.ptrs[1:] - self.ptrs[:-1]).astype(np.int32)

    @property
    def max_n_bins(self) -> int:
        return int(self.n_bins_per_feature.max()) if self.num_features else 0

    def feature_edges(self, f: int) -> np.ndarray:
        return self.values[self.ptrs[f] : self.ptrs[f + 1]]

    def padded_edges(self, max_bin: int) -> np.ndarray:
        """Dense (num_features, max_bin) edge matrix padded with +inf.

        This is the layout the device-side binning kernel consumes: the bin of
        x for feature f is ``sum_k(x > padded[f, k])`` clipped to n_bins_f - 1,
        which is equivalent to the ragged searchsorted above.
        """
        out = np.full((self.num_features, max_bin), np.inf, dtype=np.float32)
        for f in range(self.num_features):
            e = self.feature_edges(f)
            out[f, : len(e)] = e
        return out

    def bin_raw_value(self, f: int, b: int) -> float:
        """Right edge (split threshold) of bin b of feature f."""
        return float(self.values[self.ptrs[f] + b])


def _prune(values: np.ndarray, weights: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Compress a sorted (value, weight) summary to at most k entries.

    Selects entries nearest to evenly spaced cumulative-weight ranks, always
    keeping the first and last entries; weights of dropped entries fold into
    the next kept entry so the total weight is preserved exactly.
    """
    n = len(values)
    if n <= k:
        return values, weights
    cumw = np.cumsum(weights)
    total = cumw[-1]
    # ranks at entry midpoints; pick the entry covering each target rank
    targets = total * (np.arange(1, k - 1) / (k - 1))
    idx = np.searchsorted(cumw, targets, side="left")
    keep = np.unique(np.concatenate([[0], idx, [n - 1]]))
    out_values = values[keep]
    # fold weights: each kept entry absorbs all weight since the previous kept
    kept_cumw = cumw[keep]
    out_weights = np.diff(np.concatenate([[0.0], kept_cumw]))
    return out_values, out_weights


def _merge_summaries(
    a_vals: np.ndarray, a_w: np.ndarray, b_vals: np.ndarray, b_w: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    vals = np.concatenate([a_vals, b_vals])
    w = np.concatenate([a_w, b_w])
    order = np.argsort(vals, kind="mergesort")
    vals, w = vals[order], w[order]
    # combine exact duplicates
    if len(vals) > 1:
        same = np.concatenate([[False], vals[1:] == vals[:-1]])
        if same.any():
            group = np.cumsum(~same) - 1
            out_vals = vals[~same]
            out_w = np.bincount(group, weights=w)
            return out_vals, out_w.astype(np.float64)
    return vals, w.astype(np.float64)


class QuantileSketch:
    """Mergeable per-feature quantile sketch (paper Alg. 2/3).

    ``update`` is the in-core per-batch step (Alg. 2 body); calling it once per
    external page is exactly Alg. 3. ``merge`` combines sketches built on
    different hosts/devices (distributed preprocessing).
    """

    def __init__(self, num_features: int, max_bin: int = 256, sketch_size: int | None = None):
        if max_bin < 2:
            raise ValueError("max_bin must be >= 2")
        self.num_features = num_features
        self.max_bin = max_bin
        # XGBoost uses a sketch ~8x the bin count for accuracy headroom.
        self.sketch_size = sketch_size or max(8 * max_bin, 64)
        self._values: list[np.ndarray] = [
            np.empty(0, dtype=np.float64) for _ in range(num_features)
        ]
        self._weights: list[np.ndarray] = [
            np.empty(0, dtype=np.float64) for _ in range(num_features)
        ]
        self._min = np.full(num_features, np.inf, dtype=np.float64)
        self._max = np.full(num_features, -np.inf, dtype=np.float64)
        self._count = 0

    def update(self, batch: np.ndarray, sample_weight: np.ndarray | None = None) -> None:
        batch = np.asarray(batch)
        if batch.ndim != 2 or batch.shape[1] != self.num_features:
            raise ValueError(
                f"batch shape {batch.shape} incompatible with num_features={self.num_features}"
            )
        if sample_weight is None:
            sample_weight = np.ones(batch.shape[0], dtype=np.float64)
        self._count += batch.shape[0]
        # one transposed copy makes every column contiguous (a strided column
        # walk of a row-major matrix costs a cache miss per value); widening
        # each column to f64 afterwards gives the reference's values exactly
        columns = np.ascontiguousarray(batch.T)

        def summarize(f: int):
            col = columns[f].astype(np.float64)
            valid = ~np.isnan(col)
            col = col[valid]
            if col.size == 0:
                return None
            w = sample_weight[valid]
            order = np.argsort(col, kind="mergesort")
            vals, ws = _merge_summaries(col[order], w[order], np.empty(0), np.empty(0))
            vals, ws = _prune(vals, ws, self.sketch_size)
            mv, mw = _merge_summaries(self._values[f], self._weights[f], vals, ws)
            return vals[0], vals[-1], _prune(mv, mw, self.sketch_size)

        # features are independent and numpy's sorts release the GIL, so a
        # thread per core summarises them in parallel; every result is
        # written back here, in feature order
        workers = max(1, min(self.num_features, os.cpu_count() or 1))
        with ThreadPoolExecutor(max_workers=workers) as pool:
            for f, res in enumerate(pool.map(summarize, range(self.num_features))):
                if res is None:
                    continue
                lo, hi, (self._values[f], self._weights[f]) = res
                self._min[f] = min(self._min[f], lo)
                self._max[f] = max(self._max[f], hi)

    def merge(self, other: "QuantileSketch") -> "QuantileSketch":
        if other.num_features != self.num_features:
            raise ValueError("feature count mismatch")
        out = QuantileSketch(self.num_features, self.max_bin, self.sketch_size)
        out._count = self._count + other._count
        for f in range(self.num_features):
            mv, mw = _merge_summaries(
                self._values[f], self._weights[f], other._values[f], other._weights[f]
            )
            out._values[f], out._weights[f] = _prune(mv, mw, self.sketch_size)
            out._min[f] = min(self._min[f], other._min[f])
            out._max[f] = max(self._max[f], other._max[f])
        return out

    def finalize(self) -> HistogramCuts:
        """Produce per-feature cut points (right edges) from the sketch."""
        all_values: list[np.ndarray] = []
        ptrs = np.zeros(self.num_features + 1, dtype=np.int32)
        for f in range(self.num_features):
            vals, w = self._values[f], self._weights[f]
            if len(vals) == 0:
                cuts = np.array([np.inf], dtype=np.float32)  # all-missing feature
            else:
                cumw = np.cumsum(w)
                total = cumw[-1]
                n_distinct = len(vals)
                n_bins = min(self.max_bin, n_distinct)
                if n_distinct <= self.max_bin:
                    cuts = vals.astype(np.float64).copy()
                else:
                    targets = total * (np.arange(1, n_bins) / n_bins)
                    idx = np.searchsorted(cumw, targets, side="left")
                    cuts = np.unique(vals[idx])
                    cuts = np.append(cuts, vals[-1])
                # widen the last edge so max maps into the final bin
                last = cuts[-1]
                eps = max(abs(last) * 1e-6, 1e-6)
                cuts[-1] = last + eps
                # float32 storage can collapse nearby cuts (e.g. subnormals
                # underflow to 0) — dedupe after the cast to keep edges
                # strictly increasing; ensure the last edge still covers max.
                cuts = np.unique(cuts.astype(np.float32))
                if cuts[-1] <= last:
                    cuts[-1] = np.nextafter(
                        np.float32(last), np.float32(np.inf), dtype=np.float32
                    )
            all_values.append(cuts)
            ptrs[f + 1] = ptrs[f] + len(cuts)
        return HistogramCuts(
            values=np.concatenate(all_values).astype(np.float32),
            ptrs=ptrs,
            min_vals=np.where(np.isfinite(self._min), self._min, 0.0).astype(np.float32),
        )


def sketch_dense(
    X: np.ndarray,
    max_bin: int = 256,
    batch_rows: int | None = None,
    sample_weight: np.ndarray | None = None,
) -> HistogramCuts:
    """Convenience: run the incremental sketch over a dense matrix in batches."""
    X = np.asarray(X)
    sketch = QuantileSketch(X.shape[1], max_bin=max_bin)
    step = batch_rows or X.shape[0]
    for start in range(0, X.shape[0], step):
        sw = None if sample_weight is None else sample_weight[start : start + step]
        sketch.update(X[start : start + step], sw)
    return sketch.finalize()
