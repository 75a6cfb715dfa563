#!/usr/bin/env python3
"""Run one cell of the benchmark and print its result as the last line of
standard output.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration, traffic mix and metrics come from
`BENCHMARK.json` and the files it names under ``perfbench/``. The run needs
as many CUDA cards as the cell asks for, and exits without a result on
fewer. The kernels' build and compile caches stay in ``build/`` of the
checkout, so only a checkout's first run builds them.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import datetime  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BUILD = ROOT / "build"
for var, sub in (("TRITON_CACHE_DIR", "triton_cache"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(BUILD / sub)
os.environ["USE_FLAX"] = "0"
os.environ.setdefault("OMP_NUM_THREADS", "4")
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

RANK_TIMEOUT_S = 300


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # the rank processes of a cell on several cards: the run starts itself
    # once for each further rank
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--rendezvous", default=None, help=argparse.SUPPRESS)
    # the sharded program's narrowed all-reduce, the control of a sharded
    # cell (perfbench/control.py); never set by a measured run
    ap.add_argument("--grad-transport", default=None, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def spawn_ranks(args, world: int, rendezvous: str) -> list:
    procs = []
    for rank in range(1, world):
        cmd = [sys.executable, str(Path(__file__).resolve()), "--workload", args.workload,
               "--seed", str(args.seed), "--seconds", str(args.seconds), "--trace",
               str(args.trace), "--rank", str(rank), "--rendezvous", rendezvous]
        if args.grad_transport:
            cmd += ["--grad-transport", args.grad_transport]
        procs.append(subprocess.Popen(cmd, stdout=sys.stderr, stderr=sys.stderr))
    return procs


def main(argv=None) -> int:
    args = parse(argv)
    from perfbench.yardstick import device as device_lib
    from perfbench.yardstick import spec as spec_lib
    from perfbench.yardstick.imports import refuse_forbidden

    cell = spec_lib.load_cell(args.workload)
    world = int(cell.traffic.get("world", 1))
    if world != cell.chips:
        sys.exit(f"{cell.name}: the traffic's world {world} differs from the cell's chips")
    device_lib.require_cards(cell.chips)

    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from perfbench import harness

    path = spec_lib.load_path(cell.traffic["path"])
    procs, scratch, comm = [], None, harness.Solo()
    dev = torch.device("cuda", args.rank)
    torch.cuda.set_device(dev)
    try:
        if world > 1:
            import torch.distributed as dist

            rendezvous = args.rendezvous
            if args.rank == 0:
                scratch = tempfile.TemporaryDirectory(prefix="perfbench_rdzv_",
                                                      dir=os.environ.get("TMPDIR"))
                rendezvous = os.path.join(scratch.name, "store")
                procs = spawn_ranks(args, world, rendezvous)
            dist.init_process_group("nccl", init_method=f"file://{rendezvous}", rank=args.rank,
                                    world_size=world, device_id=dev,
                                    timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
            comm = path.Ranks(dev)
        program = path.Program(cell, args.seed, dev)
        if args.grad_transport:
            program.grad_transport = args.grad_transport
        program.power_limit_w = device_lib.power_limit_w(args.rank) if args.rank == 0 else None
        if args.trace:
            harness.install_spans(cell.traffic.get("spans", []))
        try:
            result = harness.drive(program, cell, args.seed, args.seconds, bool(args.trace),
                                   comm, T_START)
        finally:
            program.close()
        if world > 1:
            dist.destroy_process_group()
        for p in procs:
            if p.wait(timeout=RANK_TIMEOUT_S) != 0:
                sys.exit(f"rank process {p.args} exited with {p.returncode}")
        procs = []
    finally:
        for p in procs:
            p.kill()
            p.wait()
        if scratch is not None:
            scratch.cleanup()
    # every rank, at its very end: nothing of JAX or the JAX package loaded
    refuse_forbidden()
    if result is None:
        return 0
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
