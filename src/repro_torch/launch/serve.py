"""Serving command: forest serving (BatchServer) or LM prefill + decode.

Counterpart of `repro.launch.serve`. Both modes run on ``--device`` ("cuda"
unless asked otherwise; without a CUDA device that raises).

Forest mode loads a `GradientBooster.save` checkpoint (written by either
package), serves ``--requests`` single rows through a `BatchServer` over a
`ForestServer`, checks the answers equal a direct ``predict_margin`` of the
same rows bit for bit, and prints the `ServeStats` and residency ledgers:

    PYTHONPATH=src python -m repro_torch.launch.serve --forest ckpt/ --requests 2048

LM mode runs batched prefill + greedy decode for any assigned arch, at its
reduced config unless ``--full``, with random weights from a seeded
generator, and prints the prefill time, the decode rate and the greedy
continuation:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b --tokens 16 --paged
"""
from __future__ import annotations

import argparse
import dataclasses
import time

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


@dataclasses.dataclass
class LMServeRun:
    """What `serve_lm` served: the config and weights, the prompts, the
    greedy tokens (prefill's, then one a decode step), the logits of prefill
    and of every decode step, and the host seconds of prefill and decode
    (each ending in a device synchronise)."""

    cfg: object
    params: dict
    prompts: object
    tokens: list
    logits: list
    prefill_s: float
    decode_s: float
    first_step_s: float


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve_lm(args) -> LMServeRun:
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.core.booster import resolve_device
    from repro_torch.models.serve import decode_step, prefill
    from repro_torch.models.transformer import init_params

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=not args.full)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_params(cfg, gen, dev)
    rng = np.random.default_rng(0)
    shape = (args.batch, args.prompt_len)
    if cfg.n_codebooks:
        shape += (cfg.n_codebooks,)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, shape)).to(dev)

    max_len = args.prompt_len + args.tokens
    paged = args.paged and cfg.family in ("dense", "moe")
    with torch.inference_mode():
        _sync(dev)
        t0 = time.perf_counter()
        logits, cache = prefill(params, cfg, prompts, max_len=max_len, paged=paged)
        _sync(dev)
        prefill_s = time.perf_counter() - t0
        print(f"prefill: {args.batch}x{args.prompt_len} in {prefill_s:.4f}s")

        tok = torch.argmax(logits, dim=-1)
        out, seen = [tok], [logits]
        t0 = time.perf_counter()
        first_s = 0.0
        for i in range(args.tokens):
            lg, cache = decode_step(params, cfg, tok, cache)
            tok = torch.argmax(lg, dim=-1)
            out.append(tok)
            seen.append(lg)
            if i == 0:
                _sync(dev)
                first_s = time.perf_counter() - t0
        _sync(dev)
        dt = time.perf_counter() - t0
    steady = (
        f"; {(dt - first_s) / (args.tokens - 1) * 1e3:.3f} ms a step after the first"
        if args.tokens > 1 else ""
    )
    print(f"decode: {args.tokens} steps x batch {args.batch} in {dt:.4f}s "
          f"({args.tokens * args.batch / dt:.1f} tok/s{steady})")
    first = [int(t.reshape(args.batch, -1)[0, 0]) for t in out]
    print("greedy continuation (seq 0):", first)
    return LMServeRun(cfg, params, prompts, out, seen, prefill_s, dt, first_s)


def main(argv=None):
    from repro_torch.configs.registry import LM_ARCHS

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--forest", help="GradientBooster checkpoint dir to serve")
    ap.add_argument("--device", default="cuda",
                    help="device to serve on: cuda (the kernels), or cpu (their plain "
                         "versions, and the LM on the host)")
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
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the forest's request rows, or of the LM's weights")
    # LM mode
    ap.add_argument("--arch", choices=LM_ARCHS,
                    help="LM arch to serve (ignored with --forest)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--paged", action="store_true")
    ap.add_argument("--full", action="store_true")
    args = ap.parse_args(argv)

    if args.forest:
        return serve_forest(args)
    if args.arch:
        return serve_lm(args)
    ap.error("pass --forest <checkpoint dir> or --arch <lm arch>")


if __name__ == "__main__":
    main()
