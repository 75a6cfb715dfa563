"""Bins by the cuts, in plain PyTorch: the bin of x for feature f is
``clip(searchsorted(edges_f, x, side='left'), 0, n_bins_f - 1)`` compared in
float32, and a NaN is the missing bin 255."""
from __future__ import annotations

import numpy as np
import torch

MISSING_BIN = 255


class Edges:
    def __init__(self, values: np.ndarray, ptrs: np.ndarray, device):
        m = len(ptrs) - 1
        nbf = np.diff(ptrs).astype(np.int64)
        width = int(nbf.max())
        pad = np.full((m, width), np.inf, np.float32)
        for f in range(m):
            pad[f, : nbf[f]] = values[ptrs[f] : ptrs[f + 1]]
        self.padded = torch.from_numpy(pad).to(device)
        self.n_bins = torch.from_numpy(nbf).to(device)
        self.values = torch.from_numpy(values).to(device)
        self.ptrs = torch.from_numpy(ptrs.astype(np.int64)).to(device)

    def bin(self, X: torch.Tensor) -> torch.Tensor:
        """(rows, m) float32 on the edges' device -> (rows, m) uint8."""
        xt = X.t().contiguous()
        b = torch.searchsorted(self.padded, xt)
        b = torch.minimum(b, (self.n_bins - 1)[:, None])
        b = torch.where(torch.isnan(xt), MISSING_BIN, b)
        return b.t().to(torch.uint8)
