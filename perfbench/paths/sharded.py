"""The sharded path (the paper's §2.2): `fit_sharded` over a data mesh of
one NCCL rank a card, rows split evenly, the histograms all-reduced. Every
rank draws the same global arrays from the seed, builds the same DMatrix,
and stages only its own rows."""
from __future__ import annotations

import dataclasses
import time

import torch

from perfbench import harness
from perfbench.paths import in_core


class Ranks:
    """The coordination of the ranks over the default process group: rank 0
    decides whether another fit starts (and whether the trace goes on) and
    tells the others with one tiny broadcast, so the ranks stay in step."""

    def __init__(self, device):
        import torch.distributed as dist

        self.dist, self.device = dist, device
        self.rank, self.world = dist.get_rank(), dist.get_world_size()

    def decide(self, go: bool, tracing: bool) -> tuple[bool, bool]:
        flags = torch.tensor([int(go), int(tracing)], dtype=torch.int32, device=self.device)
        self.dist.broadcast(flags, src=0)
        return bool(flags[0]), bool(flags[1])

    def gather(self, obj) -> list:
        out = [None] * self.world
        self.dist.all_gather_object(out, obj)
        return out

    def barrier(self) -> None:
        if self.device.type == "cuda":
            self.dist.barrier(device_ids=[self.device.index])
        else:
            self.dist.barrier()


class Program(in_core.Program):
    grad_transport = "raw"

    def setup(self) -> None:
        from repro_torch.core.booster import BoosterParams
        from repro_torch.data.dmatrix import ArrayDMatrix
        from repro_torch.distributed.gbdt_shard import DistConfig, make_mesh

        cfg = self.cell.config
        world = int(self.cell.traffic["world"])
        t0 = time.perf_counter()
        self.X, self.y = harness.make_data(cfg, self.seed, self.device)
        self.data_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.dm = ArrayDMatrix(self.X, self.y, max_bin=int(cfg["max_bin"]), device=self.device)
        self.dmatrix_s = time.perf_counter() - t0
        self.params = BoosterParams(n_estimators=self.trees_per_fit,
                                    **harness.booster_kwargs(cfg, self.seed))
        self.mesh = make_mesh((world, 1), ("data", "model"), device=self.device)
        self.dist_cfg = DistConfig(data_axes=("data",), grad_transport=self.grad_transport)
        self._fit(int(self.cell.traffic["warm_trees"]))

    def _fit(self, n_trees: int):
        from repro_torch.distributed.gbdt_shard import fit_sharded

        params = dataclasses.replace(self.params, n_estimators=n_trees)
        return fit_sharded(self.mesh, self.dm, params=params, cfg=self.dist_cfg)

    def counters(self) -> dict:
        st = self.mesh.stats
        return {"allreduce_s": st.all_reduce_seconds, "allreduce_bytes": st.all_reduce_bytes}
