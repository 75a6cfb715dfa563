"""sklearn-style ``make_classification`` in torch, drawn on the card from the
seed: the data of the paper's §4.1 workload.

A copy of the shapes of the port's ``data/synthetic.py`` generator, drawn
with a `torch.Generator` so that the yardstick cannot move with the program:
an informative block of class-dependent Gaussian clusters (a tenth of the
features), a redundant block of random linear combinations of it (another
tenth), pure-noise features after them, and 1% of the labels flipped. The
same seed gives the same arrays on any card of one kind.
"""
from __future__ import annotations

import torch


def generate(n_rows: int, params: dict, seed: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(X f32 (n_rows, m), y f32 (n_rows,)) on ``device``."""
    m = int(params["num_features"])
    ni = min(int(params.get("n_informative") or max(2, m // 10)), m)
    n_red = min(max(m // 10, 0), m - ni)
    class_sep = float(params.get("class_sep", 1.0))
    flip_y = float(params.get("flip_y", 0.01))
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    means = torch.randn((2, ni), generator=gen, device=device, dtype=torch.float64) * class_sep
    W = torch.randn((ni, n_red), generator=gen, device=device, dtype=torch.float64)
    y = torch.randint(0, 2, (n_rows,), generator=gen, device=device)
    X = torch.randn((n_rows, m), generator=gen, device=device, dtype=torch.float32)
    X[:, :ni] = (X[:, :ni].double() + means[y]).float()
    if n_red:
        X[:, ni : ni + n_red] = (X[:, :ni].double() @ W).float()
    if flip_y > 0:
        flip = torch.rand(n_rows, generator=gen, device=device) < flip_y
        y = torch.where(flip, 1 - y, y)
    return X, y.float()
