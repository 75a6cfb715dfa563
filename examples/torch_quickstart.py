"""Quickstart on the PyTorch + CUDA port: in-core gradient boosting on
synthetic data, the workflow of ``examples/quickstart.py``.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

from repro_torch.core import BoosterParams, GradientBooster, SamplingConfig
from repro_torch.core.objectives import auc
from repro_torch.data.synthetic import make_classification


def main(device: str = "cuda") -> None:
    X, y = make_classification(8000, 32, n_informative=8, class_sep=1.5, seed=0)
    Xe, ye = make_classification(2000, 32, n_informative=8, class_sep=1.5, seed=0, batch=999)

    booster = GradientBooster(
        BoosterParams(
            n_estimators=30,
            max_depth=5,
            learning_rate=0.3,
            objective="binary:logistic",
            sampling=SamplingConfig(method="mvs", f=0.5),  # paper §3.4
        ),
        device=device,
    )
    booster.fit(X, y, eval_set=(Xe, ye), verbose=True)
    preds = booster.predict(Xe)
    print(f"\nfinal eval AUC: {auc(ye, preds):.4f}")
    print(f"trees built:    {len(booster.trees)}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu")
    main(ap.parse_args().device)
