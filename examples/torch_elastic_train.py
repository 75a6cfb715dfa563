"""Elastic fault-tolerant training on the PyTorch + CUDA port: kill a worker
mid-fit, recover; the workflow of ``examples/elastic_train.py``.

Spawns a 2-worker `ElasticTrainer` (each worker is a real subprocess that
streams its own on-disk ELLPACK shard), arms a deterministic `FaultPlan`
that hard-kills worker w1 (``os._exit``) at iteration 3, and lets the
coordinator do its job: detect the death (heartbeat + exit-code watch),
re-assign the orphaned shard to the survivor, reload the forest from the
last durable checkpoint, and reset every worker's margins from it.

The run then repeats WITHOUT the fault plan, and the two forests are
compared field by field: because the coordinator accumulates per-shard
gradients/histograms in sorted shard order, the recovered forest must be
**bit-for-bit identical** to the uninterrupted one.

    PYTHONPATH=src python examples/torch_elastic_train.py [--quick] [--device cpu]

With ``--device cuda`` every worker process opens the card (the card's
compute mode must let several processes share it).

Exits non-zero if recovery fails or the forests differ — CI runs this as a
nightly chaos smoke.
"""
import argparse
import os
import sys
import tempfile

import torch

from repro_torch.core import BoosterParams
from repro_torch.data.synthetic import make_classification
from repro_torch.distributed import ElasticConfig, ElasticTrainer, prepare_shards
from repro_torch.fault import FaultPlan, FaultSpec


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--quick", action="store_true", help="small config for CI smoke")
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu")
    args = ap.parse_args()

    n_rows, n_trees = (600, 4) if args.quick else (4000, 10)
    kill_at = 3
    X, y = make_classification(n_rows, 8, class_sep=1.5, flip_y=0.02, seed=11)
    params = BoosterParams(
        n_estimators=n_trees, max_depth=3, max_bin=32, objective="binary:logistic", seed=0
    )
    cfg = ElasticConfig(n_workers=2, rpc_timeout_s=180.0)

    with tempfile.TemporaryDirectory() as td:
        shards = prepare_shards(
            X, y, cfg.n_workers, os.path.join(td, "shards"), max_bin=32, page_bytes=4096,
            device=args.device,
        )
        print(f"prepared {len(shards)} shards for {cfg.n_workers} workers")

        print("\n--- uninterrupted run ---")
        smooth = ElasticTrainer(
            shards, params, checkpoint_dir=os.path.join(td, "ckpt_a"), config=cfg,
            device=args.device,
        ).fit()

        print(f"\n--- chaos run: kill w1 at iteration {kill_at} ---")
        plan = FaultPlan.of(
            FaultSpec(
                site="elastic.worker.iteration",
                at=kill_at,
                action="kill",
                match={"worker": "w1"},
            )
        )
        trainer = ElasticTrainer(
            shards,
            params,
            checkpoint_dir=os.path.join(td, "ckpt_b"),
            config=cfg,
            fault_plan=plan,
            verbose=True,
            device=args.device,
        )
        chaotic = trainer.fit()

        print(f"\nrecoveries: {trainer.recoveries}")
        assert trainer.recoveries == 1, "expected exactly one recovery"
        assert len(chaotic.trees) == n_trees, "forest incomplete after recovery"
        for i, (a, b) in enumerate(zip(smooth.trees, chaotic.trees)):
            for f in a._fields:
                if not torch.equal(getattr(a, f), getattr(b, f)):
                    print(f"FAIL: tree {i} field {f} differs")
                    return 1
        print(f"OK: recovered forest of {n_trees} trees is bit-for-bit identical "
              "to the uninterrupted run")
        print(f"transfer ledger: io_retries={trainer.stats.io_retries} "
              f"io_giveups={trainer.stats.io_giveups}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
