"""Seconds a tree in the histogram all-reduce (`Mesh.stats.all_reduce_seconds`:
host time after each input is ready, so it holds ranks waiting on each
other), the slowest rank's."""


def read(ctx: dict):
    if "allreduce_s" not in ctx["ranks"][0]["counters"]:
        return None
    return max(r["counters"]["allreduce_s"] for r in ctx["ranks"]) / ctx["trees"]
