"""Serving tier of the port, counterpart of `repro.serve`:

  `PackedForest`   a fitted booster flattened into (T, n_total) tensors and
                   predicted by ONE fused forest launch (the CUDA forest
                   kernel on the card) instead of a per-tree loop;
  `ForestServer` / out-of-core prediction: rows stream as ELLPACK pages and
  `predict_*`      forests larger than the device budget page tree-chunks
                   through the same `PageStream` engine, with partial
                   margins chained chunk to chunk so the result is bit for
                   bit the in-core forest's; a pinned prefix of chunks stays
                   on the device across requests (`plan_residency`);
  `BatchServer`    request micro-batcher: single-row requests coalesce into
                   padded fixed-shape batches under a deadline;
  `ServeStats`     the serving ledger (p50/p99 latency, batch occupancy,
                   rows/s, chunk hits and misses, h2d bytes).

`GradientBooster.predict` is the front door for raw rows and any DMatrix.
"""
from repro_torch.serve.batcher import BatchServer, ServeStats
from repro_torch.serve.engine import (
    ForestServer,
    ResidencyPlan,
    plan_residency,
    predict_margin_dmatrix,
    resolve_trees_per_chunk,
)
from repro_torch.serve.forest import PackedForest

__all__ = [
    "BatchServer",
    "ForestServer",
    "PackedForest",
    "ResidencyPlan",
    "ServeStats",
    "plan_residency",
    "predict_margin_dmatrix",
    "resolve_trees_per_chunk",
]
