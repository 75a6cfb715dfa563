"""A whole boosting round's share of the cards' peak, in percent: the least
time the window's rounds could take over the window's wall time, against
the peak of every card the cell uses. Counted from the algorithm's shapes,
so it reads the same work whatever implements it.

A round (in core, or one rank's share of a sharded round): the gradients
(read the margin and label, write g and h: 16 bytes a row, 4 operations),
each level's histograms (`hist_roofline`), split scan (read every growable
node's m x n_bins (g, h) histogram once; about 20 operations a bin) and
repartition (`partition_roofline`), and the margin update (read each row's
leaf, read and write its margin: 12 bytes, 2 operations).
"""
from perfbench.yardstick.peaks import floor_seconds
from perfbench.yardstick.spec import load_metric

SCAN_OPS_PER_BIN = 20.0


def round_counts(ctx: dict, levels_of_tree, n_rows: int, scan_rows=None) -> tuple[float, float]:
    hist = load_metric("hist_roofline")
    part = load_metric("partition_roofline")
    m, nb = ctx["num_features"], ctx["n_bins"]
    b = 16.0 * n_rows + 12.0 * n_rows
    o = 6.0 * n_rows
    for lv in levels_of_tree:
        b += hist.level_bytes(lv, m, nb) + part.level_bytes(lv) + lv.nodes * m * nb * 8
        o += hist.level_ops(lv, m) + part.level_ops(lv) + SCAN_OPS_PER_BIN * lv.nodes * m * nb
    return b, o


def share(ctx: dict, extra_bytes_per_round: float = 0.0) -> float:
    n = ctx["n_rows"]
    total = 0.0
    for levels in ctx["levels"]:
        b, o = round_counts(ctx, levels, n)
        total += floor_seconds(b + extra_bytes_per_round, o)
    total *= ctx["fits"]
    return 100.0 * total / ctx["world"] / ctx["window_s"]


def read(ctx: dict):
    return share(ctx)
