"""One DMatrix, every training mode, on the PyTorch + CUDA port: the
workflow of ``examples/dmatrix_modes.py``.

Builds a single `IterDMatrix` (batch-callback quantization, ELLPACK pages
spilled to disk) and trains the same `GradientBooster` hyperparameters four
ways: mode="auto" under a deliberately small memory budget (the policy picks
out-of-core), and each mode forced explicitly. Because the DMatrix owns its
quantization, the exact modes (in-core / out-of-core, and auto which resolves
to one of them) grow identical forests; sampling trades a little AUC for a
compacted working set.

    PYTHONPATH=src python examples/torch_dmatrix_modes.py [--quick] [--device cpu]
"""
import argparse
import tempfile
import time

import numpy as np

from repro_torch.core import BoosterParams, ExecutionPolicy, GradientBooster
from repro_torch.core.objectives import auc
from repro_torch.data.dmatrix import IterDMatrix
from repro_torch.data.pages import TransferStats
from repro_torch.data.synthetic import SyntheticSource


def main(quick: bool = False, device: str = "cuda") -> None:
    with tempfile.TemporaryDirectory(prefix="dmatrix_modes_") as workdir:
        run_modes(workdir, quick, device)


def run_modes(workdir: str, quick: bool, device: str) -> None:
    rows = 4_000 if quick else 20_000
    trees = 8 if quick else 30
    train = SyntheticSource(n_rows=rows, num_features=28, batch_rows=2048,
                            task="higgs", seed=7)
    evals = SyntheticSource(n_rows=rows // 4, num_features=28, task="higgs",
                            seed=7, batch_offset=100_000)
    Xe, ye = evals.materialize()

    stats = TransferStats()
    dm = IterDMatrix(train, max_bin=64, cache_dir=f"{workdir}/pages",
                     page_bytes=32 * 1024, stats=stats, device=device)
    print(f"IterDMatrix: {dm.n_rows} rows x {dm.num_features} features, "
          f"{dm.n_pages} pages on disk at {workdir}/pages")

    params = BoosterParams(
        n_estimators=trees, max_depth=5, max_bin=64, learning_rate=0.2,
        objective="binary:logistic", seed=0,
    )
    # budget sized so the decision procedure must go out-of-core: halfway
    # between the streaming floor (fixed + 2 pages + per-row state) and the
    # in-core threshold (fixed + matrix + per-row state + labels/margins)
    probe = ExecutionPolicy().memory_model(dm, params)
    in_core_need = probe.in_core_bytes(dm.n_rows)
    ooc_need = probe.out_of_core_bytes(dm.n_rows)
    budget = (in_core_need + ooc_need) // 2
    assert ooc_need <= budget < in_core_need

    policies = {
        "auto": ExecutionPolicy(mode="auto", memory_budget_bytes=budget),
        "in_core": ExecutionPolicy(mode="in_core"),
        "out_of_core": ExecutionPolicy(mode="out_of_core"),
        "sampled": ExecutionPolicy(mode="sampled", memory_budget_bytes=budget),
    }
    results = {}
    for name, policy in policies.items():
        b = GradientBooster(params, policy=policy, device=device)
        t0 = time.perf_counter()
        b.fit(dm)
        dt = time.perf_counter() - t0
        a = auc(ye, b.predict(Xe))
        d = b.decision_
        results[name] = (b, a)
        extra = f" f={d.sampling_f}" if d.sampling_f else ""
        print(f"{name:>12}: resolved mode={d.mode}{extra}  auc={a:.4f}  "
              f"{dt:5.1f}s  ({d.reason})")

    auto_margin = results["auto"][0].predict_margin(Xe)
    forced_margin = results["out_of_core"][0].predict_margin(Xe)
    np.testing.assert_allclose(auto_margin, forced_margin, rtol=1e-4, atol=1e-5)
    delta = abs(results["auto"][1] - results["out_of_core"][1])
    print(f"\nauto resolved to out-of-core: auc_delta vs forced = {delta:.6f}")
    in_out_delta = abs(results["in_core"][1] - results["out_of_core"][1])
    print(f"in-core vs out-of-core (same cuts, exact modes): "
          f"auc_delta = {in_out_delta:.6f}")
    print(f"stream overlap hidden: {stats.overlap_ratio:.2f} of serial cost; "
          f"h2d moved {stats.host_to_device_bytes / 2**20:.1f} MiB")
    assert delta == 0.0, "auto-selected forest must equal the forced one"
    assert in_out_delta <= 1e-3, "exact modes must agree to f32 tolerance"


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--quick", action="store_true", help="small sizes for CI smoke")
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu")
    args = ap.parse_args()
    main(quick=args.quick, device=args.device)
