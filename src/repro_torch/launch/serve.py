"""Forest serving command: a checkpointed forest behind the micro-batcher.

Counterpart of the forest mode of `repro.launch.serve`. Loads a
`GradientBooster.save` checkpoint (written by either package) onto
``--device`` ("cuda" unless asked otherwise), serves ``--requests`` single
rows through a `BatchServer` over a `ForestServer`, checks the answers equal
a direct ``predict_margin`` of the same rows bit for bit, and prints the
`ServeStats` and residency ledgers:

    PYTHONPATH=src python -m repro_torch.launch.serve --forest ckpt/ --requests 2048

The LM mode of the reference (``--arch``) is not ported (ROADMAP queue 1
item 11).
"""
from __future__ import annotations

import argparse

import numpy as np


def serve_forest(args) -> None:
    """Micro-batched single-row serving over a checkpointed forest."""
    from repro_torch.core.booster import GradientBooster
    from repro_torch.serve import BatchServer, ForestServer, ServeStats

    booster = GradientBooster.load(args.forest, device=args.device)
    stats = ServeStats()
    pin_chunks = {"auto": None, "on": True, "off": False}[args.pin_chunks]
    budget = (
        int(args.serve_budget_mib * 2**20)
        if args.serve_budget_mib is not None else None
    )
    server = ForestServer(
        booster, trees_per_chunk=args.trees_per_chunk,
        pin_chunks=pin_chunks, serve_budget_bytes=budget, serve_stats=stats,
    )
    forest = server.forest
    print(f"loaded forest: {forest.n_trees} trees, depth {forest.max_depth}, "
          f"{forest.nbytes / 2**20:.2f} MiB packed "
          f"({forest.cuts.num_features} features) on {forest.device}")

    rng = np.random.default_rng(args.seed)
    rows = rng.normal(size=(args.requests, forest.cuts.num_features)).astype(np.float32)

    # warm the kernels (and their first-use build) so the latency quantiles
    # measure traffic
    server.predict_margin(rows[: args.max_batch])

    # one ServeStats for batcher and engine: measured launch shapes feed
    # DeviceMemoryModel.serve_batch_rows chunk sizing, residency lands here
    with BatchServer(
        server.predict_margin, max_batch=args.max_batch,
        max_delay_ms=args.max_delay_ms, stats=stats,
    ) as srv:
        futures = [srv.submit(r) for r in rows]
        preds = np.asarray([f.result(timeout=120.0) for f in futures], np.float32)
    if not np.array_equal(preds, server.predict_margin(rows).astype(np.float32)):
        raise SystemExit("batched serving diverged from direct predict")

    print(f"served {stats.requests} requests in {stats.batches} batches "
          f"(max_batch={args.max_batch}, deadline={args.max_delay_ms} ms)")
    print(f"  occupancy {stats.occupancy:.2f}  padded rows {stats.padded_rows}")
    print(f"  p50 {stats.p50_ms:.2f} ms  p99 {stats.p99_ms:.2f} ms  "
          f"{stats.rows_per_s:,.0f} rows/s")
    if server.stats.host_to_device_bytes:
        print(f"  forest paging: {server.stats.host_to_device_bytes / 2**20:.2f} MiB "
              "tree-chunk traffic")
    ledger = server.residency()
    if ledger:
        print(f"  residency: {ledger['pinned_chunks']} pinned chunks "
              f"({ledger['pinned_mib']:.2f} MiB)  "
              f"chunk hit rate {ledger['chunk_hit_rate']:.2f}  "
              f"h2d {ledger['h2d_mib']:.2f} MiB "
              f"({stats.h2d_bytes_per_request:,.0f} B/request)")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--forest", help="GradientBooster checkpoint dir to serve")
    ap.add_argument("--device", default="cuda",
                    help="device to serve on: cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--requests", type=int, default=1024)
    ap.add_argument("--max-batch", type=int, default=256)
    ap.add_argument("--max-delay-ms", type=float, default=2.0)
    ap.add_argument("--trees-per-chunk", type=int, default=None,
                    help="page the forest in chunks of this many trees")
    ap.add_argument("--pin-chunks", choices=["auto", "on", "off"], default="auto",
                    help="pin forest tree-chunks on the device under the shared "
                         "serving budget (auto: pin when a budget is known; off: "
                         "legacy re-streaming)")
    ap.add_argument("--serve-budget-mib", type=float, default=None,
                    help="byte budget (MiB) of the shared row-page/tree-chunk "
                         "residency cache")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--arch", help="LM architecture to serve: not ported (ROADMAP item 11)")
    args = ap.parse_args(argv)

    if args.arch:
        ap.error("LM serving (--arch) is not ported: ROADMAP queue 1 item 11")
    if not args.forest:
        ap.error("pass --forest <checkpoint dir>")
    serve_forest(args)


if __name__ == "__main__":
    main()
