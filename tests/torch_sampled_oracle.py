"""Helpers for the tests of the port's sampled path, on the CPU and on the
card (no JAX here): one fixed set of sampling masks handed to any package's
``sample``, and the rows a default-direction tie may route apart.
"""
from __future__ import annotations

import numpy as np


def patch_sample(monkeypatch, module, n_rows: int, keep_frac: float, as_array, seed: int = 0):
    """Replace ``module.sample`` with one that hands out round i's numpy
    (keep, weight), the same for every module patched with the same
    arguments; ``as_array(x, g)`` puts x where the gradients ``g`` are.
    Returns the keep masks in round order."""
    masks = []

    def fixed_sample(key, g, h, cfg):
        assert g.shape == (n_rows,)
        rng = np.random.default_rng(seed + len(masks))
        keep = rng.random(n_rows) < keep_frac
        masks.append(keep)
        return as_array(keep, g), as_array(rng.uniform(0.5, 4.0, n_rows).astype(np.float32), g)

    monkeypatch.setattr(module, "sample", fixed_sample)
    return masks


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def paths(tree, bins: np.ndarray) -> np.ndarray:
    """(n_rows, depth + 1): the node each row of ``bins`` is at, level by level."""
    feat, sb, dl, leaf = (_host(getattr(tree, f))
                          for f in ("feature", "split_bin", "default_left", "is_leaf"))
    depth = int(np.log2(len(leaf) + 1)) - 1
    rows, pos = np.arange(len(bins)), np.zeros(len(bins), np.int64)
    out = [pos]
    for _ in range(depth):
        b = bins[rows, feat[pos]]
        left = np.where(b == 255, dl[pos], b <= sb[pos])
        pos = np.where(leaf[pos], pos, 2 * pos + 1 + (~left).astype(np.int64))
        out.append(pos)
    return np.stack(out, axis=1)


def tie_routed_rows(trees, want_trees, masks, capacity: int, train_bins, *row_bins):
    """Per array of ``row_bins``, the rows two forests may route apart:
    through a node where they send missing values opposite ways, with that
    node's feature missing. Each such node is required to be a tie: no row
    its round kept (the first ``capacity`` of its mask) reaches it with the
    feature missing, so both directions have one gain up to the f32 residue
    of (node total - histogram sum), which two builders may add in another
    order."""
    out = [np.zeros(len(b), bool) for b in row_bins]
    for tree, want, keep in zip(trees, want_trees, masks, strict=True):
        leaf, feat = _host(tree.is_leaf), _host(tree.feature)
        flip = np.nonzero((_host(tree.default_left) != _host(want.default_left)) & ~leaf)[0]
        kept = train_bins[np.nonzero(keep)[0][:capacity]]
        for k in flip:
            f = int(feat[k])
            assert not ((paths(tree, kept) == k).any(1) & (kept[:, f] == 255)).any(), (
                f"node {k} sends missing values opposite ways and has kept rows missing it")
            for bins, hit in zip(row_bins, out):
                hit |= (paths(tree, bins) == k).any(1) & (bins[:, f] == 255)
    return out
