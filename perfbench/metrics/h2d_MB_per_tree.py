"""Megabytes copied host to device a tree in the window (the page layer's
`TransferStats.host_to_device_bytes`, read before and after the window)."""


def read(ctx: dict):
    c = ctx["ranks"][0]["counters"]
    return c["h2d_bytes"] / 1e6 / ctx["trees"] if "h2d_bytes" in c else None
