"""The partition kernel's share of its roofline, in percent (kernel 2,
``csrc/partition.cu``): the least time for the window's repartitions over
the kernel's device time in the trace, summed over ranks.

Bytes per level: each row of the level's growable nodes reads and writes
its node id (4 + 4 bytes), and each row of a node that splits reads its bin
of the split feature (1 byte). Operations: one compare a moving row.
"""
from perfbench.yardstick.peaks import floor_seconds
from perfbench.yardstick.trace import kernel_seconds

KERNELS = "partition_kernel"


def level_bytes(lv) -> float:
    return lv.rows * 8 + lv.split_rows


def level_ops(lv) -> float:
    return float(lv.split_rows)


def window_counts(ctx: dict) -> tuple[float, float]:
    b = sum(level_bytes(lv) for tree in ctx["levels"] for lv in tree)
    o = sum(level_ops(lv) for tree in ctx["levels"] for lv in tree)
    return b * ctx["fits"], o * ctx["fits"]


def read(ctx: dict):
    if any(r["trace"] is None for r in ctx["ranks"]):
        return None
    device_s = sum(kernel_seconds(r["trace"]["kernel_s"], KERNELS) for r in ctx["ranks"])
    if device_s <= 0:
        return None
    return 100.0 * floor_seconds(*window_counts(ctx)) / device_s
