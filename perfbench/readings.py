#!/usr/bin/env python3
"""The readings that a cell's correctness limits are set from: sound fits
of the program over many seeds, and the faults of
``perfbench/tests/faults.py`` planted under the same fit, at the cell's own
size.

    python3 perfbench/readings.py --workload <cell> --seeds <n>[,<n>...] [--faults <f>[,<f>...]]

For each seed one process sets the cell up as a run does (data from the
seed, the program's DMatrix, the warm fit), then judges one fit of the
timed path, the program's ``fit``, against the reference; on the first
seed it then plants each named fault, judges one more fit and takes the
fault out again. Each fit prints one JSON line: the seed, ``sound`` or the
fault's name, every number the judge read, and whether the cell's limits
hold. The control is `perfbench/control.py`'s. The benchmark's own runs
never run this.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(ROOT / "perfbench" / "tests")]

# what the faults patch, restored after each
PATCHED = (("repro_torch.core.booster", "grow_tree"), ("repro_torch.core.booster", "sample"),
           ("repro_torch.core.sampling", "sample"))


def judged(program, record) -> dict:
    from perfbench.reference import judge

    out = program.output(record, program.host_trees(record))
    nums, _ = judge.judge(program.X, program.y, out, program.cell.config,
                          device=program.device, **program.judge_args())
    held = [nums[k] <= lim for k, lim in program.cell.limits.items() if k in nums]
    return {"nums": nums, "within_limits": all(held)}


def read(cell, seeds, fault_names, device):
    """One line a judged fit: every seed's sound fit, and on the first seed
    each named fault's."""
    import importlib

    import torch

    import faults
    from perfbench.yardstick import spec as spec_lib

    path = spec_lib.load_path(cell.traffic["path"])
    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        program = path.Program(cell, seed, device)
        program.setup()
        line = {"seed": seed, "kind": "sound", **judged(program, program.fit())}
        line["seconds"] = time.perf_counter() - t0
        yield line
        for name in fault_names if i == 0 else []:
            saved = [(importlib.import_module(m), a) for m, a in PATCHED]
            saved = [(mod, a, getattr(mod, a)) for mod, a in saved]
            try:
                getattr(faults, name)()
                if hasattr(program, "_record_samples"):
                    program._record_samples()
                yield {"seed": seed, "kind": name, **judged(program, program.fit())}
            finally:
                for mod, a, inner in saved:
                    setattr(mod, a, inner)
        program.close()
        del program
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--faults", default="")
    args = ap.parse_args(argv)
    from perfbench.yardstick import device as device_lib
    from perfbench.yardstick import spec as spec_lib

    cell = spec_lib.load_cell(args.workload)
    device_lib.require_cards(cell.chips)
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    seeds = [int(s) for s in args.seeds.split(",")]
    for line in read(cell, seeds, [f for f in args.faults.split(",") if f], "cuda"):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
