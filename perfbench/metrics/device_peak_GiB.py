"""The most device memory the program held during the window, in GiB:
`torch.cuda.max_memory_allocated` after a reset at the window's start, the
largest over the ranks."""


def read(ctx: dict) -> float:
    return max(r["peak"] for r in ctx["ranks"]) / float(1 << 30)
