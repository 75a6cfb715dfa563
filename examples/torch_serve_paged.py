"""Out-of-core forest serving on the PyTorch + CUDA port (the paper's paging
idea at predict time), the workflow of ``examples/serve_paged.py``.

Trains a booster from a batch iterator whose ELLPACK pages spill to disk
(`IterDMatrix(cache_dir=...)`), reopens the page cache as a `PagedDMatrix`,
and serves predictions three ways that must agree bit-for-bit:

  1. the fused whole-forest kernel (its plain version with ``--device
     cpu``) vs the per-tree reference loop,
  2. `predict(PagedDMatrix)` streaming row pages through PageStream
     vs the in-core fused launch,
  3. a paged forest (tree-chunks streamed through the same engine,
     margins chained chunk-to-chunk) vs the resident forest.

Then a `BatchServer` coalesces single-row requests into padded batches and
prints its `ServeStats` ledger (latency quantiles, occupancy, rows/s).

    PYTHONPATH=src python examples/torch_serve_paged.py [--quick] [--device cpu]

Exits non-zero if any equivalence fails — CI runs this as a tier-1 smoke.
"""
import argparse
import tempfile

import numpy as np
import torch

from repro_torch.core.booster import GradientBooster
from repro_torch.data.dmatrix import IterDMatrix, PagedDMatrix
from repro_torch.serve import BatchServer, ForestServer, ServeStats


def synthetic(n_rows: int, m: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n_rows, m)).astype(np.float32)
    y = (X[:, 0] * 1.5 - X[:, 1] + 0.3 * X[:, 2] ** 2 > 0).astype(np.float32)
    X[rng.random(X.shape) < 0.02] = np.nan  # exercise default directions
    return X, y


def batches(X, y, batch_rows):
    def gen():
        for lo in range(0, X.shape[0], batch_rows):
            yield X[lo : lo + batch_rows], y[lo : lo + batch_rows]

    return gen


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--quick", action="store_true", help="small config for CI smoke")
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu")
    args = ap.parse_args()

    n_rows, m, n_trees, depth = (2000, 16, 20, 4) if args.quick else (8000, 30, 60, 6)
    X, y = synthetic(n_rows, m)

    with tempfile.TemporaryDirectory() as cache_dir:
        dm = IterDMatrix(
            batches(X, y, 512), max_bin=64, cache_dir=cache_dir, page_bytes=16 * 1024,
            device=args.device,
        )
        booster = GradientBooster(
            n_estimators=n_trees, max_depth=depth, max_bin=64,
            objective="binary:logistic", device=args.device,
        )
        booster.fit(dm)
        paged = PagedDMatrix(cache_dir)
        print(f"trained {n_trees} depth-{depth} trees; page cache: "
              f"{len(paged.page_set().row_offsets)} pages, {paged.n_rows} rows")

        # 1. fused whole-forest kernel == per-tree reference, bit-for-bit
        forest = booster.packed_forest()
        bins = torch.from_numpy(paged.single_page_bins()).to(forest.device)
        per_tree = forest.predict_margin_per_tree(bins).cpu().numpy()
        fused = forest.predict_margin_bins(bins).cpu().numpy()
        assert np.array_equal(fused, per_tree), "fused kernel != per-tree reference"
        print("fused forest kernel == per-tree reference: bit-for-bit")

        # 2. streamed predict(PagedDMatrix) == in-core fused launch
        streamed = booster.predict_margin(paged)
        assert np.array_equal(streamed, fused), "streamed predict != in-core"
        st = paged.stats
        print(f"predict(PagedDMatrix) == in-core: bit-for-bit "
              f"({st.host_to_device_bytes / 2**20:.2f} MiB staged, "
              f"overlap ratio {st.overlap_ratio:.2f})")

        # 3. paged forest: tree-chunks streamed, margins chained across chunks
        server = ForestServer(booster, trees_per_chunk=max(n_trees // 4, 1))
        chunked = server.predict_margin(paged)
        assert np.array_equal(chunked, fused), "paged forest != resident forest"
        print(f"paged forest ({server.trees_per_chunk} trees/chunk) == resident: "
              f"bit-for-bit ({server.stats.host_to_device_bytes / 2**20:.2f} MiB "
              "forest+row pages staged)")

        # 3b. shared-budget residency: pin tree-chunks under a byte budget,
        # repeat the request — steady state pays only the non-resident
        # remainder, and the margins stay bit-for-bit with the resident forest
        chunk = max(n_trees // 4, 1)
        n_total = 2 ** (depth + 1) - 1
        worst = max(nr for _, nr in paged.page_set().page_extents)
        budget = worst * m + (n_trees // chunk // 2 + 1) * 24 * chunk * n_total
        sstats = ServeStats()
        tuned = ForestServer(
            booster, trees_per_chunk=chunk, serve_budget_bytes=budget,
            serve_stats=sstats,
        )
        for _ in range(2):  # second request serves pins from device residency
            out = tuned.predict_margin(paged)
            assert np.array_equal(out, fused), "tuned residency != resident forest"
        ledger = tuned.residency()
        print(f"shared-budget residency == resident: bit-for-bit "
              f"({ledger['pinned_chunks']} pinned chunks, "
              f"chunk hit rate {ledger['chunk_hit_rate']:.2f}, "
              f"{sstats.h2d_bytes_per_request:,.0f} h2d B/request)")
        assert ledger["chunk_hit_rate"] > 0.0, "pinned chunks never hit"

    # 4. request micro-batching over the packed forest
    stats = ServeStats()
    n_req = 256 if args.quick else 1024
    with BatchServer(forest.predict_margin, max_batch=64, max_delay_ms=5.0,
                     stats=stats) as srv:
        futures = [srv.submit(X[i % n_rows]) for i in range(n_req)]
        got = np.asarray([f.result(timeout=60.0) for f in futures], np.float32)
    direct = forest.predict_margin(np.stack([X[i % n_rows] for i in range(n_req)]))
    assert np.array_equal(got, direct), "batched serving != direct predict"
    print(f"BatchServer: {stats.requests} requests in {stats.batches} batches "
          f"(occupancy {stats.occupancy:.2f})")
    print(f"  p50 {stats.p50_ms:.2f} ms  p99 {stats.p99_ms:.2f} ms  "
          f"{stats.rows_per_s:,.0f} rows/s")
    print("all serving paths agree bit-for-bit")


if __name__ == "__main__":
    main()
