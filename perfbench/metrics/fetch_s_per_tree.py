"""Seconds a tree the page prefetcher spent fetching pages from disk or host
(`TransferStats.stream_fetch_seconds`, read before and after the window)."""


def read(ctx: dict):
    c = ctx["ranks"][0]["counters"]
    return c["fetch_s"] / ctx["trees"] if "fetch_s" in c else None
