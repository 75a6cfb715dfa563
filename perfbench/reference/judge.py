"""The comparison that decides ``correct``: the reference works the cuts,
the bins and each tree's statistics out again from the arrays the benchmark
handed the program, and judges what the program produced.

Numbers compared (each beside its limit in the cell's file):

  cuts_mismatch   cut values (and per-feature counts) that differ from the
                  reference sketch's; an exact comparison
  bins_mismatch   bins that differ from the reference's binning of the same
                  rows; exact (in the sampled cell, the bins read back from
                  the pages on disk)
  split_gap       the largest share of a node's best gain that the tree's
                  split choice there loses (`trees.judge_tree`), over the
                  nodes of the judged trees (`split_trees`: every tree of a
                  sampled fit; else the first three, the middle and the last)
  leaf_gap        the widest gap of a leaf value, in units of float32
                  rounding at the scale of the root's sums, over every tree
  margin_gap      the root mean square gap of the training rows' margins
                  after the fit, over the root mean square of what the
                  reference's forest moved them
  weight_gap      (sampled, printed, not compared) widest relative gap of
                  a kept row's weight from the reference's 1 / p_i: the
                  leaf values, built with the reference's weights, carry it
  kept_z          (sampled) how many standard deviations the kept row
                  count lies from sum p_i, the widest over the trees
  draw_z          (sampled) how many standard deviations the kept rows'
                  sums of g_i / p_i and h_i / p_i lie from the sums of g and
                  h over every row, the widest over both and the trees: a
                  draw with the right count but the wrong rows
  ranks_differ    (sharded) ranks whose forest differs bit for bit from
                  rank 0's

The reference follows the program's own trees: each tree's gradients come
from the reference's margins, which add the reference's leaf values on the
program's tree structure, so a split or leaf is judged against what the
reference holds best for that node (as a served token is judged by the
reference's logits over the served prefix).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from . import binning, mvs, sketch, trees

F64 = torch.float64


@dataclasses.dataclass
class ProgramOutput:
    """What the program produced, as host arrays."""

    cut_values: np.ndarray
    cut_ptrs: np.ndarray
    bins: object  # (n, m) uint8 host array, or a callable giving (lo, array) blocks
    trees: list  # trees.Tree per round, in order
    base_margin: float
    margins: np.ndarray | None = None  # training margins after the fit (f32), if kept
    samples: list | None = None  # per round (keep bool, weight f32) host arrays


def _base_margin(objective: str, y: np.ndarray) -> float:
    mean = float(np.mean(np.asarray(y, np.float64)))
    if objective == "binary:logistic":
        p = min(max(mean, 1e-6), 1 - 1e-6)
        return math.log(p / (1 - p))
    if objective == "reg:squarederror":
        return mean
    raise ValueError(f"the reference has no objective {objective!r}")


def _gradients(objective: str, margin: torch.Tensor, labels: torch.Tensor):
    """(g, h) of the loss at ``margin``: logistic, or squared error."""
    if objective == "binary:logistic":
        p = torch.sigmoid(margin)
        return p - labels, p * (1.0 - p)
    return margin - labels, torch.ones_like(margin)


def _blocks(bins, n_rows: int, step: int):
    if callable(bins):
        yield from bins()
        return
    for lo in range(0, n_rows, step):
        yield lo, bins[lo : lo + step]


def split_trees(n_trees: int) -> list[int]:
    """The trees of an in-core fit whose every split is judged: the first
    three, the middle and the last."""
    return sorted({t for t in (0, 1, 2, n_trees // 2, n_trees - 1) if 0 <= t < n_trees})


def _draw_z(keep: torch.Tensor, prob: torch.Tensor, g: torch.Tensor, h: torch.Tensor) -> float:
    """The widest of the kept rows' sums of g / p and h / p from the full
    sums, in standard deviations of a draw that keeps row i with p_i."""
    inv = torch.where(keep, 1.0 / prob.clamp_min(1e-300), torch.zeros_like(prob))
    odds = (1.0 - prob) / prob.clamp_min(1e-300)
    z = 0.0
    for v in (g, h):
        sd = math.sqrt(max(float((v * v * odds).sum()), 1e-300))
        z = max(z, abs(float((v * inv).sum() - v.sum())) / sd)
    return z


def judge(X: np.ndarray, y: np.ndarray, out: ProgramOutput, cfg: dict, *, device,
          sketch_batches: list, split_trees: list, sampling_f: float | None = None,
          split_floor: float = 1.0, block_rows: int = 1 << 18) -> tuple[dict, list]:
    """(numbers by name, per-tree level counts). ``sketch_batches`` are the
    (lo, hi) row ranges the program's sketch saw, in order; ``split_trees``
    the trees whose every split is judged; ``split_floor`` the cell's floor
    of a node's best gain (`trees.judge_tree`)."""
    dev = torch.device(device)
    n, m = X.shape
    max_bin = min(int(cfg["max_bin"]), 255)
    nums: dict[str, float] = {}

    sk = sketch.Sketch(m, max_bin, dev)
    for lo, hi in sketch_batches:
        sk.update(torch.from_numpy(X[lo:hi]).to(dev))
    values, ptrs = sk.cuts()
    if ptrs.shape == out.cut_ptrs.shape and np.array_equal(ptrs, out.cut_ptrs):
        nums["cuts_mismatch"] = float(np.count_nonzero(values != out.cut_values))
    else:
        nums["cuts_mismatch"] = float(max(len(values), len(out.cut_values)))
    edges = binning.Edges(values, ptrs, dev)

    bins = torch.empty((n, m), dtype=torch.uint8, device=dev)
    for lo in range(0, n, block_rows):
        bins[lo : lo + block_rows] = edges.bin(torch.from_numpy(X[lo : lo + block_rows]).to(dev))
    wrong = 0
    for lo, block in _blocks(out.bins, n, block_rows):
        theirs = torch.from_numpy(np.ascontiguousarray(block)).to(dev)
        wrong += int((theirs != bins[lo : lo + theirs.shape[0]]).sum())
    nums["bins_mismatch"] = float(wrong)

    s = trees.TreeSettings(int(cfg["max_depth"]), float(cfg["reg_lambda"]),
                           float(cfg["gamma"]), float(cfg["min_child_weight"]))
    lr = float(cfg["learning_rate"])
    n_real = edges.n_bins
    labels = torch.from_numpy(np.asarray(y, np.float64)).to(dev)
    m_ref = torch.full((n,), _base_margin(cfg["objective"], y), dtype=F64, device=dev)
    m_ref0 = m_ref.clone()
    m_view = torch.full((n,), float(np.float32(out.base_margin)), dtype=F64, device=dev)
    split_gap = leaf_gap = weight_gap = kept_z = draw_z = 0.0
    judged = set(split_trees)
    counts = []
    for t, tree in enumerate(out.trees):
        g, h = _gradients(cfg["objective"], m_ref, labels)
        if out.samples is None:
            j = trees.judge_tree(bins, g, h, tree, n_real, s, splits=t in judged,
                                 floor=split_floor)
            pos = j.pos
        else:
            keep, w = (torch.from_numpy(np.asarray(a)).to(dev) for a in out.samples[t])
            prob = mvs.probabilities(g, h, sampling_f)
            kept = keep.nonzero().squeeze(1)
            rel = (w[kept].to(F64) * prob[kept] - 1.0).abs()
            weight_gap = max(weight_gap, float(rel.max()) if kept.numel() else 0.0)
            var = float((prob * (1 - prob)).sum())
            kept_z = max(kept_z, abs(kept.numel() - float(prob.sum())) / math.sqrt(max(var, 1.0)))
            draw_z = max(draw_z, _draw_z(keep.bool(), prob, g, h))
            sel = kept[: mvs.compacted_capacity(n, sampling_f)]
            wr = 1.0 / prob[sel]
            j = trees.judge_tree(bins[sel], g[sel] * wr, h[sel] * wr, tree, n_real, s,
                                 splits=t in judged, floor=split_floor)
            pos = trees.traverse(bins, tree, dev)
        split_gap = max(split_gap, j.split_gap)
        leaf_gap = max(leaf_gap, j.leaf_gap)
        counts.append(j.levels)
        m_ref = m_ref + lr * j.ref_leaf[pos]
        leaf = torch.as_tensor(np.asarray(tree.leaf_value, np.float64), device=dev)
        m_view = m_view + lr * leaf[pos]
    nums["split_gap"] = split_gap
    nums["leaf_gap"] = leaf_gap
    mine = m_view if out.margins is None else torch.from_numpy(
        np.asarray(out.margins, np.float64)).to(dev)
    moved = (m_ref - m_ref0).pow(2).mean().sqrt()
    nums["margin_gap"] = float((mine - m_ref).pow(2).mean().sqrt() / moved.clamp_min(1e-300))
    if out.samples is not None:
        nums["weight_gap"] = weight_gap
        nums["kept_z"] = kept_z
        nums["draw_z"] = draw_z
    return nums, counts
