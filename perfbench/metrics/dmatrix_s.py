"""Seconds of the program's DMatrix build in set-up (the host quantile
sketch, binning on the card, and pages written where the cell pages), by
the host clock around the call; the slowest rank's."""


def read(ctx: dict) -> float:
    return max(r["dmatrix_s"] for r in ctx["ranks"])
