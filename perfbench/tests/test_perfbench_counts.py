"""The byte and operation counts of the per-layer metrics, on hand-worked
shapes."""
import pytest
import torch

from perfbench.reference.trees import LevelCount, _counts
from perfbench.yardstick import spec
from perfbench.yardstick.peaks import floor_seconds

LV = LevelCount(rows=100, nodes=4, build_rows=30, build_nodes=2, split_rows=60, split_nodes=3)


def test_level_counts_take_the_smaller_child():
    node = torch.tensor([0, 0, 1, 1, 1, 2, 3])
    split = torch.tensor([True, False, True, True])
    c = _counts(node, split, 4)
    # pairs (2 rows, 3 rows) and (1, 1): the smaller of each is built
    assert (c.rows, c.nodes, c.build_rows, c.build_nodes) == (7, 4, 3, 2)
    assert (c.split_rows, c.split_nodes) == (2 + 1 + 1, 3)


def test_histogram_bytes_and_ops():
    hist = spec.load_metric("hist_roofline")
    # node ids of the level's rows, the built rows' 10 bins and g, h, and two
    # built nodes of 10 x 255 (g, h) f32 pairs
    assert hist.level_bytes(LV, 10, 255) == 100 * 4 + 30 * (10 + 8) + 2 * 10 * 255 * 8
    assert hist.level_ops(LV, 10) == 2 * 30 * 10


def test_partition_bytes_and_ops():
    part = spec.load_metric("partition_roofline")
    assert part.level_bytes(LV) == 100 * 8 + 60
    assert part.level_ops(LV) == 60


def test_roofline_share_from_a_trace():
    hist = spec.load_metric("hist_roofline")
    kernel_s = {"void (anonymous namespace)::scatter_kernel<unsigned char>(int)": 0.002,
                "row_slot_kernel(int const*)": 0.001, "partition_kernel<unsigned char>": 5.0,
                "void at::native::scatter_gather_elementwise_kernel<>": 9.0}
    ctx = {"ranks": [{"trace": {"kernel_s": kernel_s, "busy_s": 1.0}}], "levels": [[LV]],
           "fits": 2, "num_features": 10, "n_bins": 255}
    b = 2 * hist.level_bytes(LV, 10, 255)
    assert hist.read(ctx) == pytest.approx(100 * floor_seconds(b, 2 * 600) / 0.003)


def test_tree_mfu_counts_a_round():
    mfu = spec.load_metric("tree_mfu")
    ctx = {"levels": [[LV]], "fits": 3, "num_features": 10, "n_bins": 255, "n_rows": 100,
           "world": 1, "window_s": 2.0}
    b, o = mfu.round_counts(ctx, [LV], 100)
    hist = spec.load_metric("hist_roofline")
    part = spec.load_metric("partition_roofline")
    assert b == 28 * 100 + hist.level_bytes(LV, 10, 255) + part.level_bytes(LV) + 4 * 10 * 255 * 8
    assert mfu.read(ctx) == pytest.approx(100 * 3 * floor_seconds(b, o) / 2.0)


def test_idle_and_counters():
    ranks = [{"trace": {"busy_s": 1.0}, "window_s": 4.0, "counters": {"allreduce_s": 0.5}},
             {"trace": {"busy_s": 3.0}, "window_s": 4.0, "counters": {"allreduce_s": 1.5}}]
    ctx = {"ranks": ranks, "trees": 10}
    assert spec.load_metric("device_idle").read(ctx) == pytest.approx(50.0)
    assert spec.load_metric("allreduce_s_per_tree").read(ctx) == pytest.approx(0.15)
    assert spec.load_metric("h2d_MB_per_tree").read(ctx) is None
