"""HIGGS-shaped data in torch, drawn on the card from the seed.

A copy of the shapes of the port's ``data/synthetic.py`` ``make_higgs_like``:
28 Gaussian features whose label follows a nonlinear boundary (a linear
term, a sine of a projection, and products of the first five features, as
the physics set's low-level kinematic features interact), drawn with a
`torch.Generator` so that the yardstick cannot move with the program.
"""
from __future__ import annotations

import torch


def generate(n_rows: int, params: dict, seed: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(X f32 (n_rows, 28), y f32 (n_rows,)) on ``device``."""
    m = int(params["num_features"])
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    w1 = torch.randn(m, generator=gen, device=device, dtype=torch.float64)
    w2 = torch.randn(m, generator=gen, device=device, dtype=torch.float64)
    X = torch.randn((n_rows, m), generator=gen, device=device, dtype=torch.float32)
    Xd = X.double()
    logits = (
        (Xd @ w1) * 0.5
        + torch.sin(Xd @ w2)
        + 0.8 * Xd[:, 0] * Xd[:, 1]
        - 0.6 * Xd[:, 2] * Xd[:, 3] * torch.tanh(Xd[:, 4])
    )
    del Xd
    logits = logits / logits.std(correction=0)
    p = torch.sigmoid(2.0 * logits)
    y = (torch.rand(n_rows, generator=gen, device=device, dtype=torch.float64) < p).float()
    return X, y
