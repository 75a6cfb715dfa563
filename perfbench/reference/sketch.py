"""Quantile cuts by the weighted merge-prune sketch of the paper's Alg. 2/3,
in plain PyTorch (float64), one feature at a time.

The same deterministic algorithm the system states: each batch's column is
sorted, exact duplicates are merged with their weights summed, the summary
is pruned to ``sketch_size`` entries at evenly spaced cumulative-weight
ranks (first and last kept, dropped weight folded into the next kept
entry), merged with the running summary and pruned again. The cuts are the
summary's values at ``max_bin`` evenly spaced ranks, deduplicated, with the
last edge widened past the maximum, stored as float32. Every weight is a
whole number, so the float64 sums are exact in any order.
"""
from __future__ import annotations

import numpy as np
import torch

F64 = torch.float64


def sketch_size(max_bin: int) -> int:
    return max(8 * max_bin, 64)


def _prune(vals: torch.Tensor, w: torch.Tensor, k: int):
    n = vals.shape[0]
    if n <= k:
        return vals, w
    cumw = torch.cumsum(w, 0)
    total = cumw[-1]
    targets = total * (torch.arange(1, k - 1, dtype=F64, device=vals.device) / (k - 1))
    idx = torch.searchsorted(cumw, targets)
    ends = torch.tensor([0, n - 1], device=vals.device)
    keep = torch.unique(torch.cat([ends[:1], idx, ends[1:]]))
    kept = cumw[keep]
    return vals[keep], torch.diff(kept, prepend=kept.new_zeros(1))


def _merge(a_v, a_w, b_v, b_w):
    vals = torch.cat([a_v, b_v])
    w = torch.cat([a_w, b_w])
    vals, order = torch.sort(vals, stable=True)
    w = w[order]
    uniq, inverse = torch.unique_consecutive(vals, return_inverse=True)
    if uniq.shape[0] == vals.shape[0]:
        return vals, w
    return uniq, torch.zeros(uniq.shape[0], dtype=F64, device=w.device).index_add_(0, inverse, w)


class Sketch:
    """Per-feature summaries of the batches seen so far."""

    def __init__(self, num_features: int, max_bin: int, device):
        self.max_bin = max_bin
        self.k = sketch_size(max_bin)
        self.device = torch.device(device)
        empty = torch.empty(0, dtype=F64, device=self.device)
        self.values = [empty] * num_features
        self.weights = [empty] * num_features

    def update(self, batch: torch.Tensor) -> None:
        """``batch``: (rows, m) float32 on the sketch's device."""
        cols = batch.to(self.device).t().to(F64)
        for f in range(cols.shape[0]):
            col = cols[f]
            col = col[~torch.isnan(col)]
            if col.numel() == 0:
                continue
            col = torch.sort(col).values
            v, w = _merge(col, torch.ones_like(col), col[:0], col[:0])
            v, w = _prune(v, w, self.k)
            mv, mw = _merge(self.values[f], self.weights[f], v, w)
            self.values[f], self.weights[f] = _prune(mv, mw, self.k)

    def cuts(self) -> tuple[np.ndarray, np.ndarray]:
        """(values f32, ptrs int32): feature f owns values[ptrs[f]:ptrs[f+1]]."""
        out, ptrs = [], [0]
        for vals, w in zip(self.values, self.weights):
            if vals.numel() == 0:
                c = np.array([np.inf], np.float32)
            else:
                n_distinct = vals.shape[0]
                n_bins = min(self.max_bin, n_distinct)
                if n_distinct <= self.max_bin:
                    cuts = vals.clone()
                else:
                    cumw = torch.cumsum(w, 0)
                    targets = cumw[-1] * (
                        torch.arange(1, n_bins, dtype=F64, device=vals.device) / n_bins
                    )
                    cuts = torch.unique(vals[torch.searchsorted(cumw, targets)])
                    cuts = torch.cat([cuts, vals[-1:]])
                last = float(cuts[-1])
                cuts[-1] = last + max(abs(last) * 1e-6, 1e-6)
                c = np.unique(cuts.cpu().numpy().astype(np.float32))
                if float(c[-1]) <= last:
                    c[-1] = np.nextafter(np.float32(last), np.float32(np.inf), dtype=np.float32)
            out.append(c)
            ptrs.append(ptrs[-1] + len(c))
        return np.concatenate(out).astype(np.float32), np.asarray(ptrs, np.int32)


def cuts_of(batches, num_features: int, max_bin: int, device):
    """The cuts of a sequence of (rows, m) float32 batches, sketched in order."""
    sk = Sketch(num_features, max_bin, device)
    for b in batches:
        sk.update(b)
    return sk.cuts()
