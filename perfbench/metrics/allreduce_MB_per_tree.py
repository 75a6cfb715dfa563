"""Megabytes a rank hands to the all-reduce a tree (`Mesh.stats.all_reduce_bytes`)."""


def read(ctx: dict):
    c = ctx["ranks"][0]["counters"]
    return c["allreduce_bytes"] / 1e6 / ctx["trees"] if "allreduce_bytes" in c else None
