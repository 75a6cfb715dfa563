"""Split evaluation: paper eq. (6)/(7)/(8) with missing-value default directions.

Counterpart of `repro.core.split`. Given per-node gradient histograms,
enumerate every (feature, bin) split with both missing-value routings and
return the arg-max split per node: EvaluateSplit of Alg. 1, vectorised over
all nodes of a tree level, as tensor code on the histogram's device.

A level is evaluated in node chunks of at most `CHUNK_BYTES` per
(nodes, m, n_bins) f32 temporary: nodes are independent and a node's
arithmetic is the same in any chunk, so the result is the same bits, and
the temporaries stay bounded at any level width.

Two rules are part of the contract: a split at a feature's LAST real bin is
allowed only with default-right (default-left would leave the right child
empty), and ties go to the first arg-max in (feature, bin) order, with
default-right preferred over default-left at equal gain.
"""
from __future__ import annotations

import dataclasses

import torch

Tensor = torch.Tensor

# bytes of one (nodes, m, n_bins) f32 temporary of split evaluation: at the
# paper's width (500 x 255) a chunk is 16 nodes, and the ~11 temporaries live
# at once take ~90 MB instead of 0.72 GB at a 128-node level
CHUNK_BYTES = 8 << 20


@dataclasses.dataclass(frozen=True)
class SplitParams:
    reg_lambda: float = 1.0  # λ of eq. (3)
    gamma: float = 0.0  # γ of eq. (3); subtracted in eq. (8)
    min_child_weight: float = 1.0  # XGBoost default: min hessian per child


@dataclasses.dataclass
class LevelSplits:
    """Best split per node of one tree level (all tensors shaped (n_nodes,))."""

    gain: Tensor
    feature: Tensor  # int32
    split_bin: Tensor  # int32
    default_left: Tensor  # bool
    left_g: Tensor
    left_h: Tensor
    right_g: Tensor
    right_h: Tensor
    should_split: Tensor  # bool


def _leaf_objective(g: Tensor, h: Tensor, reg_lambda: float) -> Tensor:
    """(Σg)² / (Σh + λ): twice the per-leaf term of eq. (7), sign flipped."""
    return (g * g) / (h + reg_lambda)


def evaluate_splits(
    hist: Tensor,  # (n_nodes, m, n_bins, 2) gradient histogram (g, h)
    node_g: Tensor,  # (n_nodes,) total gradient per node (incl. missing rows)
    node_h: Tensor,  # (n_nodes,)
    bin_valid: Tensor,  # (m, n_bins) bool: real (non-padding) bins per feature
    params: SplitParams,
) -> LevelSplits:
    n_nodes, m, n_bins, _ = hist.shape
    step = max(1, CHUNK_BYTES // max(1, m * n_bins * 4))
    if step >= n_nodes:
        return _evaluate_chunk(hist, node_g, node_h, bin_valid, params)
    parts = [
        _evaluate_chunk(
            hist[lo : lo + step], node_g[lo : lo + step], node_h[lo : lo + step],
            bin_valid, params,
        )
        for lo in range(0, n_nodes, step)
    ]
    return LevelSplits(
        *[torch.cat([getattr(p, f.name) for p in parts]) for f in dataclasses.fields(LevelSplits)]
    )


def _evaluate_chunk(
    hist: Tensor, node_g: Tensor, node_h: Tensor, bin_valid: Tensor, params: SplitParams
) -> LevelSplits:
    n_nodes, m, n_bins, _ = hist.shape
    lam, gamma, mcw = params.reg_lambda, params.gamma, params.min_child_weight
    neg_inf = torch.tensor(float("-inf"), dtype=torch.float32, device=hist.device)

    cum = torch.cumsum(hist, dim=2)  # stats for bins <= b (left side, non-missing)
    cum_g, cum_h = cum[..., 0], cum[..., 1]
    miss_g = node_g[:, None] - cum_g[:, :, -1]  # (n_nodes, m) missing mass
    miss_h = node_h[:, None] - cum_h[:, :, -1]
    parent_obj = _leaf_objective(node_g, node_h, lam)[:, None, None]
    ng, nh = node_g[:, None, None], node_h[:, None, None]

    def gain_of(left_g: Tensor, left_h: Tensor) -> Tensor:
        right_g = ng - left_g
        right_h = nh - left_h
        raw = 0.5 * (
            _leaf_objective(left_g, left_h, lam)
            + _leaf_objective(right_g, right_h, lam)
            - parent_obj
        ) - gamma
        ok = (left_h >= mcw) & (right_h >= mcw)
        return torch.where(ok, raw, neg_inf)

    dl_g = cum_g + miss_g[:, :, None]
    dl_h = cum_h + miss_h[:, :, None]
    gain_dr = gain_of(cum_g, cum_h)  # missing rows go right
    gain_dl = gain_of(dl_g, dl_h)  # missing rows go left

    valid = bin_valid[None, :, :]
    n_valid = bin_valid.sum(dim=1, keepdim=True)
    last_bin = torch.cumsum(bin_valid.to(torch.int32), dim=1) == n_valid
    gain_dr = torch.where(valid, gain_dr, neg_inf)
    gain_dl = torch.where(valid & ~last_bin[None], gain_dl, neg_inf)

    use_dl = gain_dl > gain_dr
    gain = torch.maximum(gain_dl, gain_dr).reshape(n_nodes, m * n_bins)
    best_idx = torch.argmax(gain, dim=1)  # first arg-max
    best_gain = gain.gather(1, best_idx[:, None])[:, 0]

    def pick(x: Tensor) -> Tensor:
        return x.reshape(n_nodes, m * n_bins).gather(1, best_idx[:, None])[:, 0]

    best_dl = pick(use_dl)
    left_g = pick(torch.where(use_dl, dl_g, cum_g))
    left_h = pick(torch.where(use_dl, dl_h, cum_h))
    return LevelSplits(
        gain=best_gain,
        feature=torch.div(best_idx, n_bins, rounding_mode="floor").to(torch.int32),
        split_bin=(best_idx % n_bins).to(torch.int32),
        default_left=best_dl,
        left_g=left_g,
        left_h=left_h,
        right_g=node_g - left_g,
        right_h=node_h - left_h,
        should_split=torch.isfinite(best_gain) & (best_gain > 0.0),
    )


def leaf_weight(g: Tensor, h: Tensor, reg_lambda: float) -> Tensor:
    """Optimal leaf weight, eq. (6): w* = -Σg / (Σh + λ)."""
    return -g / (h + reg_lambda)
