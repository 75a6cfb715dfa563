"""The histogram kernels' share of their roofline, in percent: the least
time one card could take for the histograms the window built, over the
device time of kernels 1 and 4 (``csrc/histogram.cu``, ``hist_window.cu``,
``hist_common.cuh``) in the trace, summed over ranks.

Bytes are what these inputs need, each read or written once: per level,
every row's node id of the level (to find the rows), and for the rows of
the nodes whose histogram is built (the smaller child of each pair; the
root at level 0) their m bin bytes and their g and h (8 bytes); written,
each built node's m x n_bins (g, h) float32 pairs. Operations: two adds a
built row and feature.
"""
from perfbench.yardstick.peaks import floor_seconds
from perfbench.yardstick.trace import kernel_seconds

KERNELS = ("row_slot_kernel|window_slot_kernel|plan_items_kernel|bucket_kernel|"
           "scatter_kernel|finalize_big_kernel")


def level_bytes(lv, m: int, n_bins: int) -> float:
    return lv.rows * 4 + lv.build_rows * (m + 8) + lv.build_nodes * m * n_bins * 8


def level_ops(lv, m: int) -> float:
    return 2.0 * lv.build_rows * m


def window_counts(ctx: dict) -> tuple[float, float]:
    """(bytes, operations) of every histogram the window built: the judged
    fit's trees, once for each fit (every fit grows the same forest)."""
    m, nb = ctx["num_features"], ctx["n_bins"]
    b = sum(level_bytes(lv, m, nb) for tree in ctx["levels"] for lv in tree)
    o = sum(level_ops(lv, m) for tree in ctx["levels"] for lv in tree)
    return b * ctx["fits"], o * ctx["fits"]


def read(ctx: dict):
    if any(r["trace"] is None for r in ctx["ranks"]):
        return None
    device_s = sum(kernel_seconds(r["trace"]["kernel_s"], KERNELS) for r in ctx["ranks"])
    if device_s <= 0:
        return None
    return 100.0 * floor_seconds(*window_counts(ctx)) / device_s
