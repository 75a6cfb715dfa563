"""The plain reference: hand-built two-level trees, the sketch and binning
against the port's own on the same rows, and the MVS probabilities."""
import numpy as np
import pytest
import torch

from perfbench.reference import binning, mvs, sketch, trees

S = trees.TreeSettings(max_depth=2, reg_lambda=1.0, gamma=0.0, min_child_weight=1.0)
BINS = torch.tensor([[0, 0], [0, 1], [1, 0], [1, 1], [2, 0], [2, 1], [3, 0], [3, 1]],
                    dtype=torch.uint8)
N_REAL = torch.tensor([4, 2])
G = torch.tensor([-3.0, -1, -3, -1, 1, 3, 1, 3], dtype=torch.float64)
H = torch.ones(8, dtype=torch.float64)
# worked by hand: the root splits feature 0 at bin 1 (gain 12.8), each child
# feature 1 at bin 0 (gain 0.2667 each); leaves -G/(H+1) over rows {0,2},
# {1,3}, {4,6}, {5,7}
HAND = trees.Tree(
    feature=np.array([0, 1, 1, 0, 0, 0, 0]), split_bin=np.array([1, 0, 0, 0, 0, 0, 0]),
    default_left=np.zeros(7, bool), is_leaf=np.array([0, 0, 0, 1, 1, 1, 1], bool),
    leaf_value=np.array([0, 0, 0, 2.0, 2 / 3, -2 / 3, -2.0]),
)


def test_builder_grows_the_hand_tree():
    got = trees.build_tree(BINS, G, H, N_REAL, S)
    for field in ("feature", "split_bin", "default_left", "is_leaf"):
        assert np.array_equal(getattr(got, field), getattr(HAND, field)), field
    np.testing.assert_allclose(got.leaf_value, HAND.leaf_value, rtol=1e-6)


def test_judge_reads_nothing_on_the_hand_tree():
    j = trees.judge_tree(BINS, G, H, HAND, N_REAL, S, splits=True)
    assert j.split_gap < 1e-12 and j.leaf_gap < 1e-12
    assert j.pos.tolist() == [3, 4, 3, 4, 5, 6, 5, 6]
    assert [(lv.rows, lv.build_rows, lv.split_rows) for lv in j.levels] == [(8, 8, 8), (8, 4, 8)]


def test_judge_measures_a_worse_split():
    # one level: the root on feature 1 at bin 0 loses 12.8 - 3.2 of 12.8
    s1 = trees.TreeSettings(1, 1.0, 0.0, 1.0)
    wrong = trees.Tree(np.array([1, 0, 0]), np.zeros(3, int), np.zeros(3, bool),
                       np.array([0, 1, 1], bool), np.array([0, 0.8, -0.8]))
    j = trees.judge_tree(BINS, G, H, wrong, N_REAL, s1, splits=True)
    assert j.split_gap == pytest.approx((12.8 - 3.2) / 12.8)
    assert j.leaf_gap < 1e-6
    # two levels: the same root, its children left as leaves, which lose all
    # the gain their level had
    deep = trees.Tree(np.array([1, 0, 0, 0, 0, 0, 0]), np.zeros(7, int), np.zeros(7, bool),
                      np.array([0, 1, 1, 1, 1, 1, 1], bool), np.array([0, 0.8, -0.8, 0, 0, 0, 0]))
    assert trees.judge_tree(BINS, G, H, deep, N_REAL, S, splits=True).split_gap == 1.0


def test_split_gap_is_per_node_and_floored():
    # node 2 split on feature 0 at bin 2 ({1, 3} | {1, 3}) gains
    # 0.5 (16/3 + 16/3 - 64/5) = -1.0667 where its best gains 0.2667: it
    # loses five times its own best gain
    wrong = trees.Tree(HAND.feature.copy(), HAND.split_bin.copy(), HAND.default_left,
                       HAND.is_leaf, HAND.leaf_value)
    wrong.feature[2], wrong.split_bin[2] = 0, 2
    assert trees.judge_tree(BINS, G, H, wrong, N_REAL, S, splits=True).split_gap == \
        pytest.approx(5.0)
    # a best gain under the floor counts as the floor: u (sum |g| = 16)^2 / (8 + 1)
    s1 = trees.TreeSettings(1, 1.0, 0.0, 1.0)
    root_wrong = trees.Tree(np.array([1, 0, 0]), np.zeros(3, int), np.zeros(3, bool),
                            np.array([0, 1, 1], bool), np.array([0, 0.8, -0.8]))
    floor = 25.6 / (2.0**-24 * 16 * 16 / 9)
    j = trees.judge_tree(BINS, G, H, root_wrong, N_REAL, s1, splits=True, floor=floor)
    assert j.split_gap == pytest.approx((12.8 - 3.2) / 25.6)


def test_judge_measures_a_wrong_leaf_and_a_forbidden_split():
    leaf = HAND.leaf_value.copy()
    leaf[3] = 2.2
    bad_leaf = trees.Tree(HAND.feature, HAND.split_bin, HAND.default_left, HAND.is_leaf, leaf)
    j = trees.judge_tree(BINS, G, H, bad_leaf, N_REAL, S, splits=True)
    # in units of float32 rounding at the root's scale: 2^-24 (sum |g| = 16
    # + |leaf| 2 x sum h = 8) / (H + 1 = 3)
    assert j.leaf_gap == pytest.approx(0.2 / (2.0**-24 * (16 + 2 * 8) / 3))
    forbidden = trees.Tree(HAND.feature, HAND.split_bin.copy(), HAND.default_left.copy(),
                           HAND.is_leaf, HAND.leaf_value)
    forbidden.split_bin[1] = 1  # feature 1's last real bin, with missing rows sent left
    forbidden.default_left[1] = True
    j = trees.judge_tree(BINS, G, H, forbidden, N_REAL, S, splits=True)
    assert j.split_gap >= trees.HUGE


def test_sketch_and_bins_equal_the_ports():
    from repro_torch.core.ellpack import bin_batch
    from repro_torch.core.quantile import QuantileSketch

    rng = np.random.default_rng(3)
    X = rng.normal(size=(6000, 4)).astype(np.float32)
    X[:, 1] = np.round(X[:, 1] * 3)  # few distinct values, exact duplicates
    X[rng.random(X.shape) < 0.02] = np.nan
    ours = sketch.Sketch(4, 16, "cpu")
    theirs = QuantileSketch(4, max_bin=16)
    for lo in range(0, 6000, 1500):
        ours.update(torch.from_numpy(X[lo:lo + 1500]))
        theirs.update(X[lo:lo + 1500])
    values, ptrs = ours.cuts()
    cuts = theirs.finalize()
    assert np.array_equal(ptrs, cuts.ptrs) and np.array_equal(values, cuts.values)
    edges = binning.Edges(values, ptrs, "cpu")
    assert np.array_equal(edges.bin(torch.from_numpy(X)).numpy(), bin_batch(X, cuts))


def test_mvs_probabilities():
    g = torch.randn(10000, dtype=torch.float64)
    h = torch.rand(10000, dtype=torch.float64) * 0.25
    p = mvs.probabilities(g, h, 0.1)
    assert float(p.sum()) == pytest.approx(1000.0, rel=1e-9)
    assert float(p.max()) <= 1.0 and float(p.min()) >= 0.0
    lam = (g.sum() / h.sum()) ** 2
    g_hat = torch.sqrt(g * g + lam * h * h)
    order = torch.argsort(g_hat)
    assert bool((torch.diff(p[order]) >= 0).all())
    assert mvs.compacted_capacity(1_000_000, 0.1) == 125952
