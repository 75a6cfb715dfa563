"""Synthetic dataset generator (paper §4.1 uses sklearn make_classification).

Counterpart of `make_classification` in `repro.data.synthetic`, a numpy copy:
informative features drawn from class-dependent Gaussian clusters, redundant
features as random linear combinations, plus pure-noise features. Batches
are deterministic in (seed, batch), and the same arguments give the same
arrays as the reference.
"""
from __future__ import annotations

import numpy as np


def _rng(seed: int, batch: int = 0) -> np.random.Generator:
    # batch -1 is reserved for batch-independent model parameters
    return np.random.Generator(
        np.random.PCG64(np.random.SeedSequence([seed, batch + 1]))
    )


def make_classification(
    n_rows: int,
    num_features: int,
    n_informative: int | None = None,
    class_sep: float = 1.0,
    flip_y: float = 0.01,
    missing_rate: float = 0.0,
    seed: int = 0,
    batch: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Binary classification batch; deterministic in (seed, batch)."""
    rng = _rng(seed, batch)
    ni = n_informative or max(2, num_features // 10)
    ni = min(ni, num_features)
    # class-dependent means for informative block (same for all batches: derive
    # from seed only)
    mrng = _rng(seed, -1)
    means = mrng.normal(0.0, class_sep, size=(2, ni))
    y = rng.integers(0, 2, size=n_rows)
    X = rng.normal(size=(n_rows, num_features)).astype(np.float32)
    X[:, :ni] += means[y]
    # redundant features: linear combos of informative
    n_red = min(max(num_features // 10, 0), num_features - ni)
    if n_red > 0:
        W = mrng.normal(size=(ni, n_red))
        X[:, ni : ni + n_red] = (X[:, :ni] @ W).astype(np.float32)
    if flip_y > 0:
        flip = rng.random(n_rows) < flip_y
        y = np.where(flip, 1 - y, y)
    if missing_rate > 0:
        mask = rng.random(X.shape) < missing_rate
        X[mask] = np.nan
    return X, y.astype(np.float32)
