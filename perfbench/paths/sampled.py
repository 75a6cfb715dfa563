"""The sampled out-of-core path (the paper's Alg. 7): the rows handed to an
`IterDMatrix` in batches, quantised into 32 MiB pages written under
``TMPDIR``, and `GradientBooster.fit` under an ``auto`` policy whose budget
lies halfway between the byte model's streaming and in-core needs, with
MVS sampling configured, so that the policy decides ``sampled``."""
from __future__ import annotations

import os
import tempfile
import time

from perfbench import harness
from perfbench.paths import in_core
from perfbench.reference.judge import ProgramOutput


class Program(in_core.Program):
    def setup(self) -> None:
        from repro_torch.core.booster import BoosterParams
        from repro_torch.core.policy import ExecutionPolicy
        from repro_torch.core.sampling import SamplingConfig
        from repro_torch.data.dmatrix import IterDMatrix

        cfg, tr = self.cell.config, self.cell.traffic
        t0 = time.perf_counter()
        self.X, self.y = harness.make_data(cfg, self.seed, self.device)
        self.data_s = time.perf_counter() - t0
        step = int(tr["batch_rows"])
        self.batches = [(lo, min(lo + step, len(self.X))) for lo in range(0, len(self.X), step)]
        self._dir = tempfile.TemporaryDirectory(prefix="perfbench_pages_",
                                                dir=os.environ.get("TMPDIR"))
        t0 = time.perf_counter()
        self.dm = IterDMatrix([(self.X[lo:hi], self.y[lo:hi]) for lo, hi in self.batches],
                              max_bin=int(cfg["max_bin"]), cache_dir=self._dir.name,
                              page_bytes=int(tr["page_bytes"]), device=self.device)
        self.dmatrix_s = time.perf_counter() - t0
        self.params = BoosterParams(
            n_estimators=self.trees_per_fit,
            sampling=SamplingConfig(method=tr["sampling"], f=float(tr["sampling_f"])),
            **harness.booster_kwargs(cfg, self.seed),
        )
        model = ExecutionPolicy().memory_model(self.dm, self.params)
        need_stream = model.out_of_core_bytes(self.dm.n_rows)
        need_core = model.in_core_bytes(self.dm.n_rows)
        self.policy = ExecutionPolicy(mode="auto",
                                      memory_budget_bytes=(need_stream + need_core) // 2)
        self._samples = None
        self._record_samples()
        self._fit(int(tr["warm_trees"]))

    def _record_samples(self) -> None:
        """Keep each round's sampled rows and weights, which the reference
        judges: the booster's ``sample`` call, wrapped. They are copied to
        the host as they are drawn, so that the card holds no more than the
        program does (the host compaction reads the draw there anyway)."""
        import repro_torch.core.booster as booster_mod

        inner = booster_mod.sample

        def recording(*args, **kwargs):
            keep, w = inner(*args, **kwargs)
            if self._samples is not None:
                self._samples.append((keep.cpu().numpy(), w.cpu().numpy()))
            return keep, w

        booster_mod.sample = recording

    def _fit(self, n_trees: int):
        import dataclasses

        from repro_torch.core.booster import GradientBooster

        params = dataclasses.replace(self.params, n_estimators=n_trees)
        booster = GradientBooster(params, policy=self.policy, device=self.device)
        booster.fit(self.dm)
        if booster.decision_.mode != "sampled":
            raise SystemExit(f"the sampled cell's policy decided {booster.decision_.mode!r}")
        return booster

    def fit(self) -> dict:
        self._samples = []
        booster = self._fit(self.trees_per_fit)
        samples, self._samples = self._samples, None
        return {"trees": booster.trees, "base_margin": booster.base_margin_,
                "margins": booster.margins_.cpu().numpy(), "samples": samples}

    def counters(self) -> dict:
        st = self.dm.page_set().stats
        return {"h2d_bytes": st.host_to_device_bytes, "fetch_s": st.stream_fetch_seconds}

    def output(self, record, forest) -> ProgramOutput:
        pages = self.dm.page_set()

        def blocks():
            for _, page in pages.iter_pages():
                yield page.row_offset, page.bins

        return ProgramOutput(self.dm.cuts.values, self.dm.cuts.ptrs, blocks, forest,
                             record["base_margin"], margins=record["margins"],
                             samples=record["samples"])

    def close(self) -> None:
        self.dm = None
        self._dir.cleanup()

    def judge_args(self) -> dict:
        return {"sketch_batches": self.batches, "split_trees": list(range(self.trees_per_fit)),
                "sampling_f": float(self.cell.traffic["sampling_f"]), **self.cell.judge}
