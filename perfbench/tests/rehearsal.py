"""A cell's whole run on the CPU at a small size: the harness, the program's
plain versions and the reference, with the look for a card skipped. The
tests drive sound runs, the control and planted faults through it."""
from __future__ import annotations

import multiprocessing
import os
import tempfile
import time

SMALL = {"rows": 4000, "num_features": 12, "n_informative": 3}
# the sampled draw's count is judged in standard deviations, which grow with
# the rows: a fault that drops half the draw must read past the limit
SAMPLED_ROWS = 48000
SMALL_TRAFFIC = {"trees_per_fit": 3, "batch_rows": 1000, "page_bytes": 12 * 700,
                 "warm_trees": 1}
# the four-card path has no cell in `BENCHMARK.json` yet: its rehearsal runs
# the sharded traffic mix over the in-core cell's configuration and limits,
# with every rank's forest held equal to rank 0's
SHARDED = "xgb-paper.allreduce4"


def load(name: str):
    from perfbench.yardstick import spec as spec_lib

    if name != SHARDED:
        return spec_lib.load_cell(name)
    cell = spec_lib.load_cell("xgb-paper.in_core")
    cell.name, cell.chips = name, 4
    cell.traffic = spec_lib.load_json(spec_lib.BENCH_DIR / "traffic" / "allreduce4.json")
    cell.limits = {**cell.limits, "ranks_differ": 0}
    return cell


def small_cell(name: str):
    cell = load(name)
    cell.config.update(SMALL)
    if cell.config["generator"] == "make_higgs_like":
        cell.config["num_features"] = 28
    cell.traffic.update(SMALL_TRAFFIC)
    if cell.traffic["path"] == "sampled":
        cell.config["rows"] = SAMPLED_ROWS
        cell.traffic["batch_rows"] = SAMPLED_ROWS // 4
    return cell


def run_small(name: str, seed: int, fault=None, seconds: float = 0.0) -> dict:
    """Rank 0's result of a small run of ``name`` on the CPU; ``fault``
    (a callable) breaks the program first, in every rank."""
    cell = small_cell(name)
    world = int(cell.traffic.get("world", 1))
    if world == 1:
        return _run(cell, seed, fault, seconds, None)
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    with tempfile.TemporaryDirectory() as d:
        store = os.path.join(d, "store")
        procs = [ctx.Process(target=_rank_main, args=(name, seed, fault, seconds, r, 2, store, queue))
                 for r in range(2)]
        for p in procs:
            p.start()
        result = queue.get(timeout=300)
        for p in procs:
            p.join(timeout=120)
            assert not p.is_alive()
    if isinstance(result, BaseException):
        raise result
    return result


def _run(cell, seed, fault, seconds, comm):
    import torch

    from perfbench import harness
    from perfbench.yardstick import spec as spec_lib

    if fault is not None:
        fault()
    path = spec_lib.load_path(cell.traffic["path"])
    program = path.Program(cell, seed, torch.device("cpu"))
    try:
        return harness.drive(program, cell, seed, seconds, False, comm or harness.Solo(),
                             time.perf_counter(), cuda=False)
    finally:
        program.close()


def _rank_main(name, seed, fault, seconds, rank, world, store, queue):
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[2]
    sys.path[:0] = [str(root), str(root / "src")]
    import datetime

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        from perfbench.paths import sharded

        cell = small_cell(name)
        cell.traffic["world"] = world
        result = _run(cell, seed, fault, seconds, sharded.Ranks(torch.device("cpu")))
        if rank == 0:
            queue.put(result)
    except BaseException as e:  # the parent reads it and re-raises
        if rank == 0:
            queue.put(e)
        raise
    finally:
        dist.destroy_process_group()
