"""Synthetic dataset generators (paper §4.1 uses sklearn make_classification).

Counterpart of `repro.data.synthetic`, a numpy copy: informative features
drawn from class-dependent Gaussian clusters, redundant features as random
linear combinations, plus pure-noise features; HIGGS-shaped and regression
batches; and the streaming sources built on them. Batches are deterministic
in (seed, batch), so a streaming source can be re-iterated bit-identically
(out-of-core training reads the data several times), and the same arguments
give the same arrays as the reference.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterator

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


def make_higgs_like(
    n_rows: int, seed: int = 0, batch: int = 0, missing_rate: float = 0.0
) -> tuple[np.ndarray, np.ndarray]:
    """HIGGS-shaped data: 28 features, nonlinear decision boundary (§4.3 analogue)."""
    rng = _rng(seed, batch)
    m = 28
    X = rng.normal(size=(n_rows, m)).astype(np.float32)
    # low-level kinematic features interact nonlinearly, like the physics set
    mrng = _rng(seed, -1)
    w1 = mrng.normal(size=(m,))
    w2 = mrng.normal(size=(m,))
    logits = (
        X @ w1 * 0.5
        + np.sin(X @ w2)
        + 0.8 * X[:, 0] * X[:, 1]
        - 0.6 * X[:, 2] * X[:, 3] * np.tanh(X[:, 4])
    )
    logits = logits / np.std(logits)
    p = 1.0 / (1.0 + np.exp(-2.0 * logits))
    y = (rng.random(n_rows) < p).astype(np.float32)
    if missing_rate > 0:
        mask = rng.random(X.shape) < missing_rate
        X[mask] = np.nan
    return X, y


def make_regression(
    n_rows: int, num_features: int, noise: float = 0.1, seed: int = 0, batch: int = 0
) -> tuple[np.ndarray, np.ndarray]:
    rng = _rng(seed, batch)
    mrng = _rng(seed, -1)
    w = mrng.normal(size=(num_features,))
    X = rng.normal(size=(n_rows, num_features)).astype(np.float32)
    y = X @ w + np.sin(2.0 * X[:, 0]) + noise * rng.normal(size=n_rows)
    return X, y.astype(np.float32)


@dataclasses.dataclass
class SyntheticSource:
    """Streaming data source: batches generated on demand, re-iterable."""

    n_rows: int
    num_features: int
    batch_rows: int = 65536
    task: str = "classification"  # classification | higgs | regression
    seed: int = 0
    missing_rate: float = 0.0
    batch_offset: int = 0  # start batch index (use a large offset for eval splits)

    def __post_init__(self):
        if self.task == "higgs":
            self.num_features = 28  # HIGGS has 28 features

    @property
    def n_batches(self) -> int:
        return math.ceil(self.n_rows / self.batch_rows)

    def iter_batches(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        for b0 in range(self.n_batches):
            b = b0 + self.batch_offset
            rows = min(self.batch_rows, self.n_rows - b0 * self.batch_rows)
            if self.task == "classification":
                yield make_classification(
                    rows, self.num_features, seed=self.seed, batch=b,
                    missing_rate=self.missing_rate,
                )
            elif self.task == "higgs":
                yield make_higgs_like(
                    rows, seed=self.seed, batch=b, missing_rate=self.missing_rate
                )
            elif self.task == "regression":
                yield make_regression(rows, self.num_features, seed=self.seed, batch=b)
            else:
                raise ValueError(self.task)

    def materialize(self) -> tuple[np.ndarray, np.ndarray]:
        xs, ys = zip(*self.iter_batches())
        return np.concatenate(xs), np.concatenate(ys)


@dataclasses.dataclass
class ArraySource:
    """In-memory arrays exposed through the streaming-source protocol."""

    X: np.ndarray
    y: np.ndarray
    batch_rows: int = 65536

    @property
    def n_rows(self) -> int:
        return self.X.shape[0]

    @property
    def num_features(self) -> int:
        return self.X.shape[1]

    def iter_batches(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        for start in range(0, self.n_rows, self.batch_rows):
            sl = slice(start, start + self.batch_rows)
            yield self.X[sl], self.y[sl]
