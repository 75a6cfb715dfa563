"""A sampled round's share of the card's peak, in percent (`tree_mfu`'s
count on the compacted rows, Alg. 7): the gradients and margin update over
every row, the MVS draw (read g and h, write the keep mask and weight: 13
bytes a row), the compacted page written (m bytes a kept row), the tree's
levels over the kept rows, and the margin pass reading every row's m bins
once."""
from perfbench.yardstick.spec import load_metric


def read(ctx: dict):
    n, m = ctx["n_rows"], ctx["num_features"]
    kept = sum(tree[0].rows for tree in ctx["levels"]) / max(len(ctx["levels"]), 1)
    return load_metric("tree_mfu").share(ctx, 13.0 * n + kept * m + n * m)
