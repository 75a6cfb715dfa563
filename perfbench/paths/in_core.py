"""The in-core path: `GradientBooster.fit` on an `ArrayDMatrix`, the whole
quantised matrix staged to the card once a fit (the paper's Alg. 1)."""
from __future__ import annotations

import time

import torch

from perfbench import harness
from perfbench.reference import judge
from perfbench.reference import trees as ref_trees
from perfbench.reference.judge import ProgramOutput


def host_tree(t) -> ref_trees.Tree:
    return ref_trees.Tree(*(x.cpu().numpy() for x in (
        t.feature, t.split_bin, t.default_left, t.is_leaf, t.leaf_value)))


class Program:
    """The program under test, as the harness drives it."""

    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.trees_per_fit = int(cell.traffic["trees_per_fit"])
        self.power_limit_w = None

    def setup(self) -> None:
        from repro_torch.core.booster import BoosterParams
        from repro_torch.core.policy import ExecutionPolicy
        from repro_torch.data.dmatrix import ArrayDMatrix

        cfg = self.cell.config
        t0 = time.perf_counter()
        self.X, self.y = harness.make_data(cfg, self.seed, self.device)
        self.data_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.dm = ArrayDMatrix(self.X, self.y, max_bin=int(cfg["max_bin"]), device=self.device)
        self.dmatrix_s = time.perf_counter() - t0
        self.params = BoosterParams(n_estimators=self.trees_per_fit,
                                    **harness.booster_kwargs(cfg, self.seed))
        self.policy = ExecutionPolicy(mode="in_core")
        self._fit(int(self.cell.traffic["warm_trees"]))

    def _fit(self, n_trees: int):
        import dataclasses

        from repro_torch.core.booster import GradientBooster

        params = dataclasses.replace(self.params, n_estimators=n_trees)
        booster = GradientBooster(params, policy=self.policy, device=self.device)
        booster.fit(self.dm)
        if booster.decision_.mode != "in_core":
            raise SystemExit(f"the in-core cell ran {booster.decision_.mode!r}")
        return booster

    def fit(self) -> dict:
        booster = self._fit(self.trees_per_fit)
        return {"trees": booster.trees, "base_margin": booster.base_margin_}

    def host_trees(self, record) -> list:
        return [host_tree(t) for t in record["trees"]]

    def counters(self) -> dict:
        return {}

    def output(self, record, forest) -> ProgramOutput:
        return ProgramOutput(self.dm.cuts.values, self.dm.cuts.ptrs,
                             self.dm.single_page_bins(), forest, record["base_margin"])

    def close(self) -> None:
        self.dm = None

    def judge_args(self) -> dict:
        return {"sketch_batches": [(0, self.X.shape[0])],
                "split_trees": judge.split_trees(self.trees_per_fit), **self.cell.judge}
