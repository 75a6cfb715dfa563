"""`device_idle` in the sampled (out-of-core) cell: the share of the traced
window, in percent, in which no operation ran on the device."""

from perfbench.yardstick.spec import load_metric


def read(ctx: dict):
    return load_metric("device_idle").read(ctx)
