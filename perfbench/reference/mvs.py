"""Minimal-variance sampling (Ibragimov and Gusev 2019; the paper's eq. 9)
in plain PyTorch, float64: each row's keep probability
p_i = min(g_hat_i / mu, 1), g_hat_i = sqrt(g_i^2 + lambda h_i^2), with
lambda = (sum g / sum h)^2 and mu the exact threshold at which the p_i sum to
f n. A kept row is weighted 1 / p_i."""
from __future__ import annotations

import torch

F64 = torch.float64


def probabilities(g: torch.Tensor, h: torch.Tensor, f: float) -> torch.Tensor:
    g, h = g.to(F64), h.to(F64)
    n = g.shape[0]
    lam = (g.sum() / h.sum().clamp_min(1e-12)) ** 2
    g_hat = torch.sqrt(g * g + lam * h * h)
    s = f * n
    desc = torch.sort(g_hat, descending=True).values
    suffix = torch.flip(torch.cumsum(torch.flip(desc, (0,)), 0), (0,))
    ks = torch.arange(n, dtype=F64, device=g.device)
    mu_k = suffix / (s - ks).clamp_min(1e-12)
    prev = torch.cat([desc.new_full((1,), float("inf")), desc[:-1]])
    valid = (prev >= mu_k) & (desc <= mu_k) & (ks < s)
    mu = mu_k[torch.argmax(valid.to(torch.uint8))] if bool(valid.any()) else g_hat.max()
    return (g_hat / mu.clamp_min(1e-30)).clamp(0.0, 1.0)


def compacted_capacity(n_rows: int, f: float) -> int:
    """Rows of the compacted page: the expected kept rows with a quarter
    more for the spread of the draw, plus 256, rounded up to 1024; the kept
    rows past it (the extreme tail) are not used."""
    cap = int(n_rows * min(1.0, f * 1.25)) + 256
    return min(n_rows, -(-cap // 1024) * 1024)
