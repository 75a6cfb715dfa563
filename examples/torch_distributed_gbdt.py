"""Distributed GBDT on the PyTorch + CUDA port: rows sharded over `data`,
features over `model`, histogram all-reduce — the paper's §2.2 AllReduce,
the workflow of ``examples/distributed_gbdt.py``.

The reference simulates 8 XLA devices in one process; the port's mesh is
one process a shard over ``torch.distributed``. This script spawns the 8
ranks of the same 4 x 2 mesh (gloo, joined through a ``file://`` store in a
temporary directory, 60 s a collective) and runs the reference's steps on
each: 10 boosting iterations of `make_gbdt_step_fn` with MVS sampling and a
bf16 all-reduce, then `fit_sharded` on an `ArrayDMatrix`. Rank 0 prints.
With ``--device cuda`` all 8 ranks share the card (each through gloo, which
all-reduces CUDA tensors through host copies; NCCL refuses two ranks on one
device); with several cards rank r takes card ``r % count``.

    PYTHONPATH=src python examples/torch_distributed_gbdt.py [--device cpu]
"""
import argparse
import datetime
import os
import sys
import tempfile
import time

import numpy as np

MESH = (4, 2)
TIMEOUT_S = 60  # every collective ends within this, or raises
DEADLINE_S = 900  # the parent kills ranks still running after this


def rank_main(rank: int, world: int, store: str, device: str) -> None:
    import torch
    import torch.distributed as dist

    if device == "cpu":
        torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=TIMEOUT_S),
    )
    from repro_torch.core import BoosterParams
    from repro_torch.core.booster import bin_valid_from_cuts
    from repro_torch.core.ellpack import create_ellpack_inmemory
    from repro_torch.core.objectives import auc
    from repro_torch.core.tree import TreeParams
    from repro_torch.data.dmatrix import ArrayDMatrix
    from repro_torch.data.synthetic import make_classification
    from repro_torch.distributed import DistConfig, fit_sharded, make_gbdt_step_fn, make_mesh

    say = print if rank == 0 else (lambda *a, **k: None)
    mesh = make_mesh(MESH, ("data", "model"), device=device)
    devices = [None] * world
    dist.all_gather_object(devices, str(mesh.device))
    say("devices:", devices)
    X, y = make_classification(16384, 32, class_sep=1.2, seed=3)
    ell = create_ellpack_inmemory(X, max_bin=32, device=mesh.device)
    bins = ell.single_page().bins
    bv = bin_valid_from_cuts(ell.cuts, 32, mesh.device)
    cv, cp = ell.cuts.values, ell.cuts.ptrs

    cfg = DistConfig(data_axes=("data",), feature_axis="model", hist_dtype="bfloat16")
    step = make_gbdt_step_fn(
        mesh, TreeParams(max_depth=5), 32, cfg,
        learning_rate=0.3, objective="binary:logistic", sampling_f=0.3,
    )

    labels = torch.from_numpy(y)
    margin = torch.zeros(X.shape[0], dtype=torch.float32)
    for it in range(10):
        margin, tree = step(bins, margin, y, bv, cv, cp, it)
        p = torch.sigmoid(margin.cpu())
        ll = float(-torch.mean(labels * torch.log(p + 1e-7)
                               + (1 - labels) * torch.log(1 - p + 1e-7)))
        acc = float(torch.mean(((p > 0.5) == (labels > 0.5)).float()))
        say(f"iter {it}: logloss={ll:.4f} acc={acc:.3f}")

    # ---- the estimator surface, sharded: the same DMatrix objects the
    # single-device GradientBooster takes go straight into fit_sharded ----
    dm = ArrayDMatrix(X, y, max_bin=32, device=mesh.device)
    booster = fit_sharded(
        mesh, dm,
        params=BoosterParams(n_estimators=10, max_depth=5, max_bin=32,
                             learning_rate=0.3, objective="binary:logistic"),
        cfg=cfg,
    )
    say(f"fit_sharded: {len(booster.trees)} trees, "
        f"train AUC {auc(y, booster.predict(X)):.4f}")
    dist.barrier()
    dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu")
    args = ap.parse_args()
    import torch
    import torch.multiprocessing as mp

    from repro_torch.core.booster import resolve_device

    resolve_device(args.device)  # no CUDA device: raise here, before spawning
    world = int(np.prod(MESH))
    with tempfile.TemporaryDirectory(prefix="torch_distributed_gbdt_") as td:
        ctx = mp.start_processes(rank_main, args=(world, os.path.join(td, "store"), args.device),
                                 nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + DEADLINE_S
        try:
            for proc in ctx.processes:
                proc.join(timeout=max(0.0, deadline - time.monotonic()))
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
                    proc.join()
    codes = [p.exitcode for p in ctx.processes]
    if any(codes):
        print(f"rank exit codes {codes}", file=sys.stderr)
        return 1
    del torch
    return 0


if __name__ == "__main__":
    sys.exit(main())
