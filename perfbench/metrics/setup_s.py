"""Seconds from the process's start to the window's: loading, the data
handed over, the DMatrix (sketch, binning, pages), the kernels' build or
load, and a warm fit; on several ranks, until the last is ready."""


def read(ctx: dict) -> float:
    return ctx["setup_s"]
