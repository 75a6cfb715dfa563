#!/usr/bin/env python3
"""The control of ``correct``: what the comparison must refuse.

    python3 perfbench/control.py --workload <cell> --seeds <n>[,<n>...]

For a one-card cell the reference itself is put in the program's place,
computed in the precision below the configuration's float32: every
gradient and hessian rounded to bfloat16 (sums still in float32), the step a
later change might take to halve the histograms' input. It draws the cell's
data from each seed, builds the forest of one fit of the cell (in the
sampled cell, with its own MVS draw from the seed), and hands cuts, bins,
trees, margins and draws to the same judge as a run. For a sharded cell the
program's own narrowed path serves: `perfbench/run.py` with the histogram
all-reduce carried in bfloat16 (``DistConfig(grad_transport="bf16")``), one
fit. Each seed prints one JSON line of the numbers compared, their limits
and whether the control came out correct (it must not). The benchmark's own
runs never run this.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def control_output(cell, X, y, seed: int, device):
    """One fit of the cell by the reference in bfloat16 gradients, as a
    `ProgramOutput`."""
    import numpy as np
    import torch

    from perfbench.reference import binning, mvs, sketch, trees
    from perfbench.reference.judge import ProgramOutput

    cfg, tr = cell.config, cell.traffic
    dev = torch.device(device)
    n, m = X.shape
    sampled = tr["path"] == "sampled"
    step = int(tr.get("batch_rows", n)) if sampled else n
    sk = sketch.Sketch(m, min(int(cfg["max_bin"]), 255), dev)
    for lo in range(0, n, step):
        sk.update(torch.from_numpy(X[lo : lo + step]).to(dev))
    values, ptrs = sk.cuts()
    edges = binning.Edges(values, ptrs, dev)
    bins = torch.cat([edges.bin(torch.from_numpy(X[lo : lo + (1 << 18)]).to(dev))
                      for lo in range(0, n, 1 << 18)])
    s = trees.TreeSettings(int(cfg["max_depth"]), float(cfg["reg_lambda"]),
                           float(cfg["gamma"]), float(cfg["min_child_weight"]))
    lr = float(cfg["learning_rate"])
    labels = torch.from_numpy(np.asarray(y, np.float32)).to(dev)
    pm = float(np.clip(np.mean(y), 1e-6, 1 - 1e-6))
    base = float(np.log(pm / (1 - pm)))
    margin = torch.full((n,), base, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed % (1 << 63))
    forest, samples = [], []
    for _ in range(int(tr["trees_per_fit"])):
        p = torch.sigmoid(margin)
        g = (p - labels).bfloat16().float()
        h = (p * (1 - p)).bfloat16().float()
        if sampled:
            f = float(tr["sampling_f"])
            prob = mvs.probabilities(g, h, f).float()
            keep = torch.rand(n, generator=gen, device=dev) < prob
            w = 1.0 / prob.clamp_min(1e-12)
            sel = keep.nonzero().squeeze(1)[: mvs.compacted_capacity(n, f)]
            tree = trees.build_tree(bins[sel], (g[sel] * w[sel]).bfloat16().float(),
                                    (h[sel] * w[sel]).bfloat16().float(), edges.n_bins, s)
            samples.append((keep.cpu().numpy(), w.cpu().numpy()))
        else:
            tree = trees.build_tree(bins, g, h, edges.n_bins, s)
        pos = trees.traverse(bins, tree, dev)
        margin = margin + lr * torch.from_numpy(tree.leaf_value).to(dev)[pos]
        forest.append(tree)
    return ProgramOutput(values, ptrs, bins.cpu().numpy(), forest, base,
                         margins=margin.cpu().numpy() if sampled else None,
                         samples=samples if sampled else None)


def judge_control(cell, seed: int, device) -> dict:
    import numpy as np

    from perfbench import harness
    from perfbench.reference import judge

    X, y = harness.make_data(cell.config, seed, device)
    out = control_output(cell, X, y, seed, device)
    tr = cell.traffic
    n = X.shape[0]
    if tr["path"] == "sampled":
        step = int(tr["batch_rows"])
        kw = {"sketch_batches": [(lo, min(lo + step, n)) for lo in range(0, n, step)],
              "split_trees": list(range(int(tr["trees_per_fit"]))),
              "sampling_f": float(tr["sampling_f"])}
    else:
        kw = {"sketch_batches": [(0, n)],
              "split_trees": judge.split_trees(int(tr["trees_per_fit"]))}
    nums, _ = judge.judge(X, y, out, cell.config, device=device, **kw, **cell.judge)
    checks = {k: {"value": nums[k], "limit": lim} for k, lim in cell.limits.items() if k in nums}
    correct = all(np.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return {"seed": seed, "correct": correct, "checks": checks, "nums": nums}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    from perfbench.yardstick import device as device_lib
    from perfbench.yardstick import spec as spec_lib

    cell = spec_lib.load_cell(args.workload)
    device_lib.require_cards(cell.chips)
    for seed in (int(s) for s in args.seeds.split(",")):
        if cell.chips > 1:
            cmd = [sys.executable, str(ROOT / "perfbench" / "run.py"), "--workload", cell.name,
                   "--seed", str(seed), "--seconds", "0", "--trace", "0",
                   "--grad-transport", "bf16"]
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode:
                print(res.stderr[-4000:], file=sys.stderr)
                print(json.dumps({"seed": seed, "correct": None, "failed": res.returncode}))
                continue
            line = json.loads(res.stdout.strip().splitlines()[-1])
            print(json.dumps({"seed": seed, "correct": line["correct"],
                              "checks": line["checks"]}), flush=True)
        else:
            import torch

            torch.backends.cuda.matmul.allow_tf32 = False
            print(json.dumps(judge_control(cell, seed, "cuda")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
