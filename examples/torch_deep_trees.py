"""Deep trees under a histogram budget on the PyTorch + CUDA port: the
tiered HistogramStore, the workflow of ``examples/deep_trees.py``.

At depth 12 the retained per-node histograms (`2^d * m * n_bins * 2 * 4`
bytes depthwise, one per frontier leaf for lossguide) dominate the device
working set; the Table-1 byte model now sees them, so a deliberately small
``memory_budget_bytes`` makes ``ExecutionPolicy`` refuse the config outright:
the fixed working set "OOMs" before a single row is staged. Setting
``hist_budget_bytes`` caps the device share of the store — cold frontier
histograms spill to host buffers and are staged back through the same
`PageStream` path the ELLPACK pages use — and the identical budget now
resolves in-core and trains, growing bit-for-bit the forest an unlimited
store grows.

    PYTHONPATH=src python examples/torch_deep_trees.py [--quick] [--device cpu]
"""
import argparse
import time

import numpy as np

from repro_torch.core import (
    BoosterParams,
    DeviceMemoryModel,
    ExecutionPolicy,
    GradientBooster,
)
from repro_torch.core.objectives import auc
from repro_torch.data.synthetic import SyntheticSource

MAX_DEPTH = 12
MAX_LEAVES = 256
BUDGET = 2_500_000  # deliberately small device budget for the byte model


def main(quick: bool = False, device: str = "cuda") -> None:
    rows = 4_000 if quick else 16_000
    trees = 4 if quick else 12
    train = SyntheticSource(n_rows=rows, num_features=28, batch_rows=2048,
                           task="higgs", seed=11)
    evals = SyntheticSource(n_rows=rows // 4, num_features=28, task="higgs",
                           seed=11, batch_offset=100_000)
    X, y = train.materialize()
    Xe, ye = evals.materialize()

    params = BoosterParams(
        n_estimators=trees, max_depth=MAX_DEPTH, max_bin=64, learning_rate=0.2,
        objective="binary:logistic", seed=0,
        grow_policy="lossguide", max_leaves=MAX_LEAVES,
    )

    # 1) without a histogram budget the byte model rejects the config: the
    # frontier histograms alone (~3.7 MB) bust the 2.5 MB device budget
    try:
        GradientBooster(
            params, policy=ExecutionPolicy(mode="auto", memory_budget_bytes=BUDGET),
            device=device,
        ).fit(X, y)
        raise SystemExit("expected the byte model to reject this config")
    except ValueError as e:
        assert "histogram" in str(e)
        print(f"without hist budget: {e}\n")

    # 2) the same device budget with a 64-histogram store budget: cold
    # frontier histograms spill to host, the decision resolves in-core
    node_hist_bytes = DeviceMemoryModel(
        num_features=X.shape[1], max_bin=params.max_bin
    ).hist_node_bytes
    policy = ExecutionPolicy(
        mode="auto", memory_budget_bytes=BUDGET,
        hist_budget_bytes=64 * node_hist_bytes,
    )
    b = GradientBooster(params, policy=policy, device=device)
    t0 = time.perf_counter()
    b.fit(X, y)
    dt = time.perf_counter() - t0
    d = b.decision_
    a = auc(ye, b.predict(Xe))
    assert d.mode == "in_core", d.reason
    assert b.stats.hist_spills > 0, "a tight store budget must actually spill"
    print(f"with hist_budget_bytes={policy.hist_budget_bytes}: resolved "
          f"mode={d.mode}  auc={a:.4f}  {dt:5.1f}s  ({d.reason})")
    print(f"histogram tier traffic: {b.stats.hist_spills} spills "
          f"({b.stats.hist_spill_bytes / 2**20:.1f} MiB out), "
          f"{b.stats.hist_fetches} fetches "
          f"({b.stats.hist_fetch_bytes / 2**20:.1f} MiB back)")

    # 3) spilling changes where histograms live, never what they contain:
    # the unlimited-store forest is identical
    b_ref = GradientBooster(params, policy=ExecutionPolicy(mode="in_core"), device=device)
    b_ref.fit(X, y)
    np.testing.assert_allclose(
        b.predict_margin(Xe), b_ref.predict_margin(Xe), rtol=1e-5, atol=1e-6
    )
    delta = abs(a - auc(ye, b_ref.predict(Xe)))
    print(f"auc_delta vs unlimited store = {delta:.6f}")
    assert delta == 0.0, "spilled and unlimited forests must match"


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--quick", action="store_true", help="small sizes for CI smoke")
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu")
    args = ap.parse_args()
    main(quick=args.quick, device=args.device)
