"""Objectives (loss -> gradient pairs) and evaluation metrics.

Counterpart of `repro.core.objectives`. Each objective produces first and
second order gradients (g, h) of the loss with respect to the current margin
(paper eq. 5) as torch tensors on the margin's device, plus the base score
and the inverse link. Metrics are numpy, evaluated on the host.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Objective:
    """A twice-differentiable loss in the XGBoost sense."""

    name: str
    # (margin, label) -> (g, h), elementwise.
    grad_hess: Callable[[Tensor, Tensor], tuple[Tensor, Tensor]]
    # margin -> prediction (inverse link).
    transform: Callable[[Tensor], Tensor]
    # labels -> scalar initial margin (base score).
    base_margin: Callable[[np.ndarray], float]


def _squared_grad_hess(margin: Tensor, label: Tensor) -> tuple[Tensor, Tensor]:
    return margin - label, torch.ones_like(margin)


def _logistic_grad_hess(margin: Tensor, label: Tensor) -> tuple[Tensor, Tensor]:
    p = torch.sigmoid(margin)
    return p - label, p * (1.0 - p)


def _logit_base(labels: np.ndarray) -> float:
    p = float(np.clip(np.mean(labels), 1e-6, 1.0 - 1e-6))
    return float(np.log(p / (1.0 - p)))


SQUARED_ERROR = Objective(
    name="reg:squarederror",
    grad_hess=_squared_grad_hess,
    transform=lambda m: m,
    base_margin=lambda y: float(np.mean(y)),
)

LOGISTIC = Objective(
    name="binary:logistic",
    grad_hess=_logistic_grad_hess,
    transform=torch.sigmoid,
    base_margin=_logit_base,
)

OBJECTIVES: dict[str, Objective] = {
    SQUARED_ERROR.name: SQUARED_ERROR,
    LOGISTIC.name: LOGISTIC,
}


def get_objective(name: str) -> Objective:
    try:
        return OBJECTIVES[name]
    except KeyError as e:
        raise ValueError(
            f"unknown objective {name!r}; known: {sorted(OBJECTIVES)}"
        ) from e


# ---------------------------------------------------------------------------
# Metrics (numpy; evaluation happens host-side on streamed predictions).
# ---------------------------------------------------------------------------


def auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """ROC AUC via the rank statistic (ties handled by average rank)."""
    labels = np.asarray(labels).ravel()
    scores = np.asarray(scores).ravel()
    n_pos = int(np.sum(labels == 1))
    n_neg = labels.size - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(scores, kind="mergesort")
    sorted_scores = scores[order]
    ranks = np.empty(labels.size, dtype=np.float64)
    # average ranks for tied groups
    i = 0
    while i < labels.size:
        j = i
        while j + 1 < labels.size and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        ranks[order[i : j + 1]] = 0.5 * (i + j) + 1.0
        i = j + 1
    sum_pos_ranks = float(np.sum(ranks[labels == 1]))
    return (sum_pos_ranks - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg)


def rmse(labels: np.ndarray, preds: np.ndarray) -> float:
    labels = np.asarray(labels).ravel()
    preds = np.asarray(preds).ravel()
    return float(np.sqrt(np.mean((labels - preds) ** 2)))


def logloss(labels: np.ndarray, probs: np.ndarray) -> float:
    labels = np.asarray(labels).ravel()
    probs = np.clip(np.asarray(probs).ravel(), 1e-7, 1.0 - 1e-7)
    return float(-np.mean(labels * np.log(probs) + (1 - labels) * np.log(1 - probs)))


def accuracy(labels: np.ndarray, probs: np.ndarray) -> float:
    labels = np.asarray(labels).ravel()
    return float(np.mean((np.asarray(probs).ravel() > 0.5) == (labels > 0.5)))


METRICS = {"auc": auc, "rmse": rmse, "logloss": logloss, "accuracy": accuracy}
