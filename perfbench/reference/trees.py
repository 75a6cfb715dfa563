"""Depthwise tree growth (paper Alg. 1) in plain PyTorch, as a judge and as
a builder.

Trees use the complete-binary-tree layout: node i has children 2i+1 and
2i+2, a row goes left iff its bin <= the split bin (a missing bin by the
default direction), and a leaf's value is -G/(H + lambda) over its rows.
A split's gain is 0.5 (GL^2/(HL+lambda) + GR^2/(HR+lambda) - G^2/(H+lambda))
- gamma, over every real bin of every feature with the missing rows sent
either way (not left at a feature's last real bin), each child holding a
hessian of at least ``min_child_weight``; a node splits iff its best gain is
above 0.

`judge_tree` follows a given tree level by level over the rows it is given,
works out every reached node's statistics and histograms again in float64,
and measures how far the tree's choices fall from the best: for each
node, the share of its best gain that the tree's choice there loses (a
leaf gains 0), the best gain counted at least at ``floor`` units of the
float32 rounding of a gain at the root's sums; for each leaf, the gap between the tree's value
and the reference's, in units of float32 rounding at the root's sums (the
size of the rounding a node's totals carry when each is its parent's less
its sibling's). `build_tree` grows its own tree the same way, in the dtype of
the gradients it is given (the control).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

F64 = torch.float64
MISSING_BIN = 255
HIST_BINS = 256  # real bins 0..254 and the missing bin
HUGE = 1e30  # a gap with no finite reading (a split the reference forbids)
F32_UNIT = 2.0**-24  # float32's unit roundoff


@dataclasses.dataclass(frozen=True)
class TreeSettings:
    max_depth: int
    reg_lambda: float
    gamma: float
    min_child_weight: float


@dataclasses.dataclass
class Tree:
    """One tree as host arrays, complete-tree layout."""

    feature: np.ndarray  # int
    split_bin: np.ndarray  # int
    default_left: np.ndarray  # bool
    is_leaf: np.ndarray  # bool
    leaf_value: np.ndarray  # float


@dataclasses.dataclass
class LevelCount:
    """The rows one level of one tree touched (for byte and operation counts)."""

    rows: int  # rows in this level's growable nodes
    nodes: int  # growable nodes holding rows
    build_rows: int  # rows of the nodes whose histogram is built (smaller child)
    build_nodes: int
    split_rows: int  # rows in nodes that split here
    split_nodes: int


def histograms(bins, node, g, h, n_nodes: int, block: int = 64):
    """(n_nodes, m, 256) sums of g and h over the rows, by node and bin; the
    dtype of g. ``bins`` (r, m) uint8 and ``node`` (r,) int64 row by row."""
    r, m = bins.shape
    hg = torch.zeros(n_nodes * m * HIST_BINS, dtype=g.dtype, device=g.device)
    hh = torch.zeros_like(hg)
    for f0 in range(0, m, block):
        f1 = min(m, f0 + block)
        feats = torch.arange(f0, f1, device=g.device)
        idx = ((node[:, None] * m + feats[None, :]) * HIST_BINS + bins[:, f0:f1].long()).view(-1)
        hg.index_add_(0, idx, g[:, None].expand(r, f1 - f0).reshape(-1))
        hh.index_add_(0, idx, h[:, None].expand(r, f1 - f0).reshape(-1))
    return hg.view(n_nodes, m, HIST_BINS), hh.view(n_nodes, m, HIST_BINS)


def _raw_gain(lg, lh, G, H, s: TreeSettings):
    lam = s.reg_lambda
    rg, rh = G - lg, H - lh
    return 0.5 * (lg * lg / (lh + lam) + rg * rg / (rh + lam) - G * G / (H + lam)) - s.gamma


def child_sums(hg, hh, G, H):
    """Left-child (g, h) sums of every real bin, missing rows sent right
    (dr) and left (dl), each (k, m, 255)."""
    cg = torch.cumsum(hg[:, :, :MISSING_BIN], 2)
    ch = torch.cumsum(hh[:, :, :MISSING_BIN], 2)
    mg = (G[:, None] - cg[:, :, -1])[:, :, None]
    mh = (H[:, None] - ch[:, :, -1])[:, :, None]
    return (cg, ch), (cg + mg, ch + mh)


def gain_tables(hg, hh, G, H, n_real, s: TreeSettings):
    """(gain with missing right, gain with missing left), each (k, m, 255),
    -inf where a split is not allowed."""
    neg_inf = torch.tensor(float("-inf"), dtype=hg.dtype, device=hg.device)
    Gn, Hn = G[:, None, None], H[:, None, None]

    def gain(lg, lh):
        ok = (lh >= s.min_child_weight) & (Hn - lh >= s.min_child_weight)
        return torch.where(ok, _raw_gain(lg, lh, Gn, Hn, s), neg_inf)

    (dr_g, dr_h), (dl_g, dl_h) = child_sums(hg, hh, G, H)
    valid, last = _bin_masks(n_real, hg.device)
    g_dr = torch.where(valid, gain(dr_g, dr_h), neg_inf)
    g_dl = torch.where(valid & ~last, gain(dl_g, dl_h), neg_inf)
    return g_dr, g_dl


def _bin_masks(n_real, device):
    b = torch.arange(MISSING_BIN, device=device)[None, :]
    return (b < n_real[:, None])[None], (b == (n_real - 1)[:, None])[None]


def _level_rows(pos, off: int, cnt: int):
    at = (pos >= off) & (pos < off + cnt)
    rows = torch.nonzero(at).squeeze(1)
    return rows, pos[rows] - off


def _route(bins, rows, pos, feature, split_bin, default_left):
    """Children of ``rows`` (all in split nodes) by their node's split."""
    node = pos[rows]
    x = bins[rows, feature[node]].long()
    left = torch.where(x == MISSING_BIN, default_left[node], x <= split_bin[node])
    return 2 * node + 1 + (~left).long()


def _counts(node_rows, split_mask, nodes_in_level: int) -> LevelCount:
    c = torch.bincount(node_rows, minlength=nodes_in_level)
    present = c > 0
    if nodes_in_level == 1:
        build = c
    else:
        pair = c.view(-1, 2)
        # the smaller child of each pair is built, the other derived
        build = torch.where(pair[:, :1] <= pair[:, 1:], pair[:, :1], pair[:, 1:]).view(-1)
        build = build[present.view(-1, 2).any(1)]
    return LevelCount(
        rows=int(c.sum()), nodes=int(present.sum()),
        build_rows=int(build.sum()), build_nodes=int((build >= 0).sum()),
        split_rows=int(c[split_mask].sum()), split_nodes=int((split_mask & present).sum()),
    )


def traverse(bins, tree: Tree, device):
    """Each row's leaf under ``tree`` (heap node ids, int64)."""
    t = _device_tree(tree, device)
    pos = torch.zeros(bins.shape[0], dtype=torch.int64, device=device)
    for d in range(int(np.log2(len(tree.feature) + 1)) - 1):
        off, cnt = 2**d - 1, 2**d
        rows, node = _level_rows(pos, off, cnt)
        moving = rows[~t["is_leaf"][pos[rows]]]
        pos[moving] = _route(bins, moving, pos, t["feature"], t["split_bin"], t["default_left"])
    return pos


def _device_tree(tree: Tree, device):
    def as_t(a, dt):
        return torch.as_tensor(np.asarray(a), device=device).to(dt)

    return {
        "feature": as_t(tree.feature, torch.int64),
        "split_bin": as_t(tree.split_bin, torch.int64),
        "default_left": as_t(tree.default_left, torch.bool),
        "is_leaf": as_t(tree.is_leaf, torch.bool),
    }


@dataclasses.dataclass
class TreeJudgement:
    split_gap: float  # the largest share of a node's best gain lost (0 when not judged)
    ref_leaf: torch.Tensor  # (n_total,) f64 reference leaf values on the tree's structure
    leaf_gap: float
    levels: list  # LevelCount per level
    pos: torch.Tensor  # each given row's leaf


def judge_tree(bins, g, h, tree: Tree, n_real, s: TreeSettings, splits: bool,
               floor: float = 1.0) -> TreeJudgement:
    """Follow ``tree`` over the rows of ``bins`` with float64 gradients
    ``g``, ``h``; with ``splits`` also build every level's histograms and
    measure each node's gain gap, against a best gain of at least ``floor``
    units of a gain's float32 rounding at the root's sums."""
    dev = g.device
    t = _device_tree(tree, dev)
    n_total = len(tree.feature)
    depth = int(np.log2(n_total + 1)) - 1
    pos = torch.zeros(bins.shape[0], dtype=torch.int64, device=dev)
    # a gain's float32 rounding at the root's sums, u (sum |g|)^2 / (H + lambda):
    # below ``floor`` of them a node's best gain is no scale to measure a
    # loss against
    a = float(g.abs().sum())
    tau = floor * F32_UNIT * a * a / (float(h.sum()) + s.reg_lambda)
    worst = 0.0
    levels = []
    for d in range(depth):
        off, cnt = 2**d - 1, 2**d
        rows, node = _level_rows(pos, off, cnt)
        split_mask = ~t["is_leaf"][off : off + cnt]
        levels.append(_counts(node, split_mask, cnt))
        if splits and rows.numel():
            worst = max(worst, _split_loss(bins[rows], node, g[rows], h[rows], cnt, off, t,
                                           n_real, s, tau))
        moving = rows[split_mask[node]]
        pos[moving] = _route(bins, moving, pos, t["feature"], t["split_bin"], t["default_left"])
    G = torch.zeros(n_total, dtype=F64, device=dev).index_add_(0, pos, g)
    H = torch.zeros(n_total, dtype=F64, device=dev).index_add_(0, pos, h)
    has_rows = torch.bincount(pos, minlength=n_total) > 0
    ref_leaf = torch.where(has_rows, -G / (H + s.reg_lambda), torch.zeros_like(G))
    port_leaf = torch.as_tensor(np.asarray(tree.leaf_value, np.float64), device=dev)
    # a leaf's statistics carry float32 rounding at the scale of the root's
    # sums (a child's totals are its parent's less its sibling's): the gap in
    # units of that rounding, u (sum |g| + |leaf| sum h) / (H + lambda)
    unit = F32_UNIT * (g.abs().sum() + ref_leaf.abs() * h.sum()) / (H + s.reg_lambda)
    gap = (port_leaf - ref_leaf).abs() / unit.clamp_min(1e-300)
    leaf_gap = float(gap[has_rows].max())
    return TreeJudgement(worst, ref_leaf, leaf_gap, levels, pos)


def _split_loss(bins, node, g, h, cnt, off, t, n_real, s: TreeSettings, tau: float) -> float:
    """The largest share of its best gain that a level's node with rows
    loses: the best allowed gain (0 if none is above 0) less the exact gain
    of the tree's choice (0 for a leaf), floored at 0, over the best gain or
    ``tau``, whichever is larger. A chosen bin the feature does not have
    loses `HUGE`."""
    dev = g.device
    G = torch.zeros(cnt, dtype=F64, device=dev).index_add_(0, node, g)
    H = torch.zeros(cnt, dtype=F64, device=dev).index_add_(0, node, h)
    present = torch.bincount(node, minlength=cnt) > 0
    hg, hh = histograms(bins, node, g, h, cnt)
    g_dr, g_dl = gain_tables(hg, hh, G, H, n_real, s)
    best = torch.maximum(g_dr, g_dl).view(cnt, -1).max(1).values.clamp_min(0.0)
    ids = torch.arange(off, off + cnt, device=dev)
    split = ~t["is_leaf"][ids]
    f = t["feature"][ids]
    b = t["split_bin"][ids].clamp(0, MISSING_BIN - 1)
    dl = t["default_left"][ids]
    k = torch.arange(cnt, device=dev)
    (dr_g, dr_h), (dl_g, dl_h) = child_sums(hg, hh, G, H)
    lg = torch.where(dl, dl_g[k, f, b], dr_g[k, f, b])
    lh = torch.where(dl, dl_h[k, f, b], dr_h[k, f, b])
    chosen = torch.where(split, _raw_gain(lg, lh, G, H, s), torch.zeros_like(G))
    valid, last = _bin_masks(n_real, dev)
    allowed = valid[0, f, b] & ~(dl & last[0, f, b])
    share = (best - chosen).clamp_min(0.0) / best.clamp_min(max(tau, 1e-300))
    share = torch.where(split & ~allowed, torch.full_like(share, HUGE), share)
    return float(torch.where(present, share, torch.zeros_like(share)).max())


def build_tree(bins, g, h, n_real, s: TreeSettings) -> Tree:
    """Grow a tree greedily over every row, in the dtype of ``g`` and ``h``:
    the first best (feature, bin) by gain, missing right on a tie."""
    dev, dt = g.device, g.dtype
    n_total = 2 ** (s.max_depth + 1) - 1
    feature = np.zeros(n_total, np.int64)
    split_bin = np.zeros(n_total, np.int64)
    default_left = np.zeros(n_total, bool)
    is_leaf = np.ones(n_total, bool)
    pos = torch.zeros(bins.shape[0], dtype=torch.int64, device=dev)
    for d in range(s.max_depth):
        off, cnt = 2**d - 1, 2**d
        rows, node = _level_rows(pos, off, cnt)
        growable = np.zeros(cnt, bool)
        growable[0] = d == 0
        if d:
            parents = (np.arange(off, off + cnt) - 1) // 2
            growable = ~is_leaf[parents]
        if not rows.numel():
            break
        G = torch.zeros(cnt, dtype=dt, device=dev).index_add_(0, node, g[rows])
        H = torch.zeros(cnt, dtype=dt, device=dev).index_add_(0, node, h[rows])
        hg, hh = histograms(bins[rows], node, g[rows], h[rows], cnt)
        g_dr, g_dl = gain_tables(hg, hh, G, H, n_real, s)
        flat = torch.maximum(g_dr, g_dl).view(cnt, -1)
        best_idx = torch.argmax(flat, 1)
        best = flat.gather(1, best_idx[:, None])[:, 0]
        use_dl = (g_dl > g_dr).view(cnt, -1).gather(1, best_idx[:, None])[:, 0]
        do = (torch.isfinite(best) & (best > 0)).cpu().numpy() & growable
        ids = np.arange(off, off + cnt)
        fb = best_idx.cpu().numpy()
        feature[ids[do]] = fb[do] // MISSING_BIN
        split_bin[ids[do]] = fb[do] % MISSING_BIN
        default_left[ids[do]] = use_dl.cpu().numpy()[do]
        is_leaf[ids[do]] = False
        t = _device_tree(Tree(feature, split_bin, default_left, is_leaf, None), dev)
        moving = rows[~t["is_leaf"][pos[rows]]]
        pos[moving] = _route(bins, moving, pos, t["feature"], t["split_bin"], t["default_left"])
    G = torch.zeros(n_total, dtype=dt, device=dev).index_add_(0, pos, g)
    H = torch.zeros(n_total, dtype=dt, device=dev).index_add_(0, pos, h)
    leaf = (-G / (H + s.reg_lambda)).cpu().numpy()
    reached = torch.bincount(pos, minlength=n_total).cpu().numpy() > 0
    leaf = np.where(is_leaf & reached, leaf, 0.0)
    return Tree(feature, split_bin, default_left, is_leaf, leaf.astype(np.float32))
