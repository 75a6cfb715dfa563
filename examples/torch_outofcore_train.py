"""END-TO-END DRIVER on the PyTorch + CUDA port: out-of-core GBDT training
as the paper runs it, the workflow of ``examples/outofcore_train.py``.

Streams a dataset that (by construction) never sits in memory at once,
through the unified DMatrix surface:
  1. incremental quantile sketch over batches          (Alg. 3, IterDMatrix)
  2. ELLPACK pages written to disk                     (Alg. 5, PageStore)
  3. per-iteration MVS sampling + page compaction      (Alg. 7, the policy's
                                                        sampled fast path)
  4. margin cache updates by streaming pages
  5. periodic checkpoints + a simulated crash/resume from the on-disk page
     cache alone (PagedDMatrix — the raw data is never re-read)

    PYTHONPATH=src python examples/torch_outofcore_train.py [--rows 200000] [--trees 200]
        [--device cpu]
"""
import argparse
import os
import tempfile
import time

from repro_torch.core import BoosterParams, ExecutionPolicy, GradientBooster, SamplingConfig
from repro_torch.core.objectives import auc
from repro_torch.data.dmatrix import IterDMatrix, PagedDMatrix
from repro_torch.data.pages import TransferStats
from repro_torch.data.synthetic import SyntheticSource


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=50_000)
    ap.add_argument("--trees", type=int, default=60)
    ap.add_argument("--sample-ratio", type=float, default=0.2)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu")
    args = ap.parse_args()

    workdir = args.workdir or tempfile.mkdtemp(prefix="ooc_gbdt_")
    train = SyntheticSource(n_rows=args.rows, num_features=28, batch_rows=8192,
                            task="higgs", seed=7)
    evals = SyntheticSource(n_rows=5000, num_features=28, task="higgs", seed=7,
                            batch_offset=100_000)
    Xe, ye = evals.materialize()

    stats = TransferStats()
    params = BoosterParams(
        n_estimators=args.trees, max_depth=6, max_bin=128, learning_rate=0.1,
        objective="binary:logistic",
        sampling=SamplingConfig(method="mvs", f=args.sample_ratio), seed=0,
    )
    ckpt = os.path.join(workdir, "ckpt")
    cache = os.path.join(workdir, "pages")
    policy = ExecutionPolicy(mode="out_of_core", checkpoint_every=20, checkpoint_dir=ckpt)

    print(f"workdir: {workdir}")
    t0 = time.perf_counter()
    dm = IterDMatrix(train, max_bin=128, cache_dir=cache,
                     page_bytes=256 * 1024, stats=stats, device=args.device)
    half = args.trees // 2
    booster = GradientBooster(
        BoosterParams(**{**params.__dict__, "n_estimators": half}), policy=policy,
        device=args.device,
    )
    booster.fit(dm, eval_set=(Xe, ye), verbose=True)
    booster.save(ckpt)
    print(f"\n-- simulated crash after {half} trees; resuming from {ckpt} "
          "using only the on-disk page cache --\n")

    # resume from the spilled pages alone: PagedDMatrix reopens the cache
    # directory (cuts + labels from its sidecar), no raw-data pass needed
    resumed_dm = PagedDMatrix(cache, stats=stats)
    resumed = GradientBooster.resume(ckpt, resumed_dm, policy=policy, device=args.device)
    resumed.params = params
    resumed.fit(resumed_dm, eval_set=(Xe, ye), verbose=True, start_iteration=half)

    dt = time.perf_counter() - t0
    print(f"\ntrained {len(resumed.trees)} trees in {dt:.1f}s "
          f"(mode: {resumed.decision_.mode}, f={resumed.decision_.sampling_f})")
    print(f"pages on disk:      {resumed_dm.n_pages}")
    print(f"disk written:       {stats.disk_write_bytes/2**20:.1f} MiB")
    print(f"host->device moved: {stats.host_to_device_bytes/2**20:.1f} MiB")
    print(f"stream overlap:     {stats.overlap_ratio:.2f} "
          f"({stats.overlap_saved_seconds:.1f}s of transfer+compute hidden)")
    print(f"eval AUC:           {auc(ye, resumed.predict(Xe)):.4f}")


if __name__ == "__main__":
    main()
