#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (`src/repro_torch`).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py            # full size: 1M x 500 training rows
    python3 chip_smoke.py --rows N   # fewer training rows, same widths

Phases, each of which fails the run on error:
  1. builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc,
     sm_90a) and prints the build time and the ptxas resource report;
  2. drives the main path: ``GradientBooster(device="cuda")`` at the width
     of ``configs/xgb_paper.py`` (500 features, max_bin 256, depth 8,
     lr 0.1, binary:logistic, no sampling) fits 10 trees with a 100k-row
     eval set, then predicts the eval rows; every kernel's launch count is
     zeroed before and read after, and each must be > 0;
  3. holds each kernel against its plain PyTorch version on the card at the
     shapes the main path gives it (histogram: all training rows, 500
     features, 256 bins, 64 build nodes; partition: a trained tree over all
     training rows; forest: the trained forest over the eval rows), and
     times kernel, plain version and, where one exists, one PyTorch library
     call computing the same function;
  4. fits twice on a 200k-row subset and requires identical trees;
  5. requires ``predict_margin`` to equal the per-tree loop bit for bit.

It prints a JSON line of per-kernel numbers, the card's name and power limit
(nvidia-smi), and last ``{"ok": true, "device": {...}}``. It imports nothing
of JAX and exits non-zero without a CUDA device or outside a checkout.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores


def _time_ms(fn, iters: int, warmup: int = 1) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1_000_000, help="training rows")
    ap.add_argument("--trees", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {ROOT} is not a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.core.booster import GradientBooster
    from repro_torch.core.ellpack import bin_batch
    from repro_torch.core.objectives import auc
    from repro_torch.data.dmatrix import ArrayDMatrix
    from repro_torch.data.synthetic import make_classification
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import forest as k_forest
    from repro_torch.kernels import histogram as k_hist
    from repro_torch.kernels import partition as k_part

    dev = torch.device("cuda", 0)
    kernels = {"histogram": k_hist, "partition": k_part, "forest": k_forest}

    # 1. build ---------------------------------------------------------------
    _build.build_all()
    print(f"build: {_build.build_seconds:.3f} s for {len(_build.SOURCES)} sources")
    for name, log in _build.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "Compiling entry" in line:
                print(f"  ptxas {name}: {line.strip()}")

    # 2. main path -----------------------------------------------------------
    t0 = time.perf_counter()
    X, y = make_classification(args.rows, 500, seed=args.seed)
    Xe, ye = make_classification(100_000, 500, seed=args.seed, batch=1)
    print(f"data: {args.rows} x 500 train, 100000 x 500 eval, {time.perf_counter() - t0:.1f} s")
    params = dict(
        n_estimators=args.trees, max_depth=8, learning_rate=0.1, max_bin=256,
        objective="binary:logistic",
    )
    t0 = time.perf_counter()
    dm = ArrayDMatrix(X, y, max_bin=256)
    quantise_s = time.perf_counter() - t0
    for mod in kernels.values():
        mod.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    booster = GradientBooster(device="cuda", **params).fit(dm, eval_set=(Xe, ye))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    margin = booster.predict_margin(Xe)
    predict_ms = (time.perf_counter() - t0) * 1e3
    launches = {name: mod.launches for name, mod in kernels.items()}
    eval_auc = auc(ye, margin)
    n_trees = len(booster.trees)
    # the boosting loop alone: eval_history's clock starts after the eval
    # set is binned on the host
    loop_s = booster.eval_history[-1].elapsed_s
    print(
        f"main path: decision={booster.decision_.mode} trees={n_trees} "
        f"quantise={quantise_s:.3f} s (host sketch + binning) fit={fit_s:.3f} s "
        f"boosting_loop={loop_s:.3f} s per_tree={loop_s / n_trees:.4f} s "
        f"predict={predict_ms:.3f} ms (100000 rows, incl. host binning) eval_auc={eval_auc:.6f}"
    )
    print(f"main path launches: {json.dumps(launches)}")
    if booster.decision_.mode != "in_core":
        raise SystemExit("main path did not train in core")
    if not all(v > 0 for v in launches.values()):
        raise SystemExit(f"a kernel of the main path was never launched: {launches}")
    if not (np.all(np.isfinite(margin)) and margin.shape == (100_000,) and eval_auc > 0.7):
        raise SystemExit(f"main path output wrong: shape {margin.shape}, auc {eval_auc}")

    # 3. kernels against their plain versions, at main-path shapes ------------
    bins = torch.from_numpy(dm.single_page_bins()).to(dev)
    eval_bins = torch.from_numpy(bin_batch(Xe, booster.cuts)).to(dev)
    n, m = bins.shape
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    g = torch.randn(n, generator=gen, device=dev)
    h = torch.rand(n, generator=gen, device=dev)
    # deepest built level of a depth-8 tree: rows spread over level 7's 128
    # nodes (ids 127..254), 10% inactive; the smaller child of each pair built
    pos = torch.randint(127, 255, (n,), generator=gen, device=dev, dtype=torch.int32)
    pos[torch.rand(n, generator=gen, device=dev) < 0.1] = -1
    pick = torch.randint(0, 2, (64,), generator=gen, device=dev, dtype=torch.int32)
    nodes = 127 + 2 * torch.arange(64, device=dev, dtype=torch.int32) + pick
    n_bins = 255
    results = []

    def hist_k():
        return k_hist.build_histogram_nodes(bins, g, h, pos, nodes, n_bins)

    def hist_p():
        return ref.build_histogram_nodes(bins, g, h, pos, nodes, n_bins)

    saved = k_hist.launches
    got, want = hist_k(), hist_p()
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    if not torch.allclose(got, want, rtol=1e-5, atol=1e-5):
        raise SystemExit(f"histogram kernel disagrees with its plain version: max err {err}")
    if not torch.equal(got, hist_k()):
        raise SystemExit("histogram kernel is not deterministic run to run")
    slot = ref.row_slots(pos, nodes).to(torch.int64)
    valid = (bins != 255) & (slot[:, None] >= 0)
    cell = (slot[:, None] * (m * n_bins) + torch.arange(m, device=dev) * n_bins + bins)[valid]
    rows = torch.nonzero(valid)[:, 0]
    gh = torch.stack([g[rows], h[rows]], dim=1)
    del valid, rows
    lib_out = torch.zeros(64 * m * n_bins, 2, device=dev)
    lib_ms = _time_ms(lambda: lib_out.index_put_((cell,), gh, accumulate=True), 3)
    n_matched = int((slot >= 0).sum())
    del cell, gh, lib_out
    # only matched rows need their bins (contiguous m-byte rows) and g, h;
    # every row's position is read once to match it
    hb, hb_by = _bound(
        n_matched * (m * bins.element_size() + 8) + 4 * n + 64 * 4 + 64 * m * n_bins * 8,
        2.0 * n_matched * m,
    )
    results.append(dict(
        name="build_histogram_nodes", route="cuda",
        source="src/repro_torch/kernels/csrc/histogram.cu",
        replaces="src/repro/kernels/histogram.py:214",
        launches=launches["histogram"], max_abs_err=err,
        ms=_time_ms(hist_k, 5), plain_ms=_time_ms(hist_p, 2),
        bound_ms=hb, bound_by=hb_by, library_ms=lib_ms,
    ))
    k_hist.launches = saved

    t0_tree = booster.trees[0]
    level_pos = torch.zeros(n, dtype=torch.int32, device=dev)
    part_args = (t0_tree.feature, t0_tree.split_bin, t0_tree.default_left, t0_tree.is_leaf)
    for _ in range(6):  # rows at level 6 of the first tree: the 7th partition's input
        level_pos = ref.partition_rows(bins, level_pos, *part_args)
    level_pos[torch.rand(n, generator=gen, device=dev) < 0.05] = -1
    saved = k_part.launches
    got = k_part.partition_rows(bins, level_pos, *part_args)
    want = ref.partition_rows(bins, level_pos, *part_args)
    if not torch.equal(got, want):
        raise SystemExit("partition kernel disagrees with its plain version")
    moved = int(((level_pos >= 0) & ~t0_tree.is_leaf[level_pos.clamp(min=0).long()]).sum())
    pb, pb_by = _bound(n * 8 + moved + t0_tree.n_total * 10, n)
    results.append(dict(
        name="partition_rows", route="cuda",
        source="src/repro_torch/kernels/csrc/partition.cu",
        replaces="src/repro/kernels/partition.py:82",
        launches=launches["partition"], max_abs_err=0.0,
        ms=_time_ms(lambda: k_part.partition_rows(bins, level_pos, *part_args), 20),
        plain_ms=_time_ms(lambda: ref.partition_rows(bins, level_pos, *part_args), 5),
        bound_ms=pb, bound_by=pb_by, library_ms=None,
    ))
    k_part.launches = saved

    forest = booster.packed_forest()
    scaled = torch.tensor(forest.learning_rate, dtype=torch.float32, device=dev) * forest.leaf_value
    f_args = (forest.feature, forest.split_bin, forest.default_left, forest.is_leaf, scaled,
              forest.max_depth)
    m_in = torch.full((eval_bins.shape[0],), forest.base_margin, device=dev)
    saved = k_forest.launches
    got = k_forest.predict_forest(eval_bins, *f_args, m_in)
    want = ref.predict_forest_bins(eval_bins, *f_args, m_in)
    if not torch.equal(got, want):
        err = (got - want).abs().max().item()
        raise SystemExit(f"forest kernel disagrees with its plain version: max err {err}")
    steps = 0  # internal nodes each row visits: the bins this run's data needs
    for t in range(forest.n_trees):
        p = torch.zeros(eval_bins.shape[0], dtype=torch.int64, device=dev)
        for _ in range(forest.max_depth):
            inner = ~forest.is_leaf[t][p]
            steps += int(inner.sum())
            f_idx = forest.feature[t][p].long()
            b = eval_bins.gather(1, f_idx[:, None])[:, 0].int()
            left = torch.where(b == 255, forest.default_left[t][p], b <= forest.split_bin[t][p])
            p = torch.where(inner, 2 * p + 1 + (~left).long(), p)
    nt = eval_bins.shape[0]
    fb, fb_by = _bound(steps + nt * 8 + forest.n_trees * forest.n_total * 14,
                       nt * forest.n_trees)
    results.append(dict(
        name="predict_forest", route="cuda",
        source="src/repro_torch/kernels/csrc/forest.cu",
        replaces="src/repro/kernels/forest.py:129",
        launches=launches["forest"], max_abs_err=0.0,
        ms=_time_ms(lambda: k_forest.predict_forest(eval_bins, *f_args, m_in), 20),
        plain_ms=_time_ms(lambda: ref.predict_forest_bins(eval_bins, *f_args, m_in), 3),
        bound_ms=fb, bound_by=fb_by, library_ms=None,
    ))
    k_forest.launches = saved
    for r in results:
        print(
            f"kernel {r['name']}: max_abs_err={r['max_abs_err']:.3g} ms={r['ms']:.4f} "
            f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
            f"library_ms={r['library_ms']} launches={r['launches']}"
        )

    # 4. determinism: two fits on a 200k-row subset grow identical trees ------
    sub = min(200_000, args.rows)
    fits = [
        GradientBooster(device="cuda", **params).fit(X[:sub], y[:sub], cuts=booster.cuts)
        for _ in range(2)
    ]
    for a, b in zip(fits[0].trees, fits[1].trees):
        if not all(torch.equal(u, v) for u, v in zip(a, b)):
            raise SystemExit("two fits on the same data grew different trees")
    print(f"determinism: two fits on {sub} rows grew {len(fits[0].trees)} identical trees")

    # 5. fused predict equals the per-tree loop bit for bit -------------------
    fused = forest.predict_margin_bins(eval_bins)
    per_tree = forest.predict_margin_per_tree(eval_bins)
    if not (torch.equal(fused, per_tree) and np.array_equal(margin, fused.cpu().numpy())):
        raise SystemExit("fused forest predict differs from the per-tree loop")
    print("predict: fused forest == per-tree loop (bitwise)")

    print(json.dumps({"kernels": results}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
