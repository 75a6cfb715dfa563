"""Seconds a tree: the window's wall time, from the first fit's start to the
last fit's `torch.cuda.synchronize()`, over every tree the window grew."""


def read(ctx: dict) -> float:
    return ctx["window_s"] / ctx["trees"]
