"""The share of the traced window, in percent, in which no operation ran on
the device (the union of the trace's device intervals), the mean over the
ranks."""


def read(ctx: dict):
    if any(r["trace"] is None or r["trace"]["busy_s"] <= 0 for r in ctx["ranks"]):
        return None
    idle = [1.0 - r["trace"]["busy_s"] / r["window_s"] for r in ctx["ranks"]]
    return 100.0 * sum(idle) / len(idle)
