"""One run of one cell: set-up, the measured window, the comparison with
the reference, the per-layer metrics and the result line.

A path file (``paths/<path>.py``, named by the traffic mix) supplies the
program under test as a ``Program`` with ``setup()``, ``fit()``,
``host_trees(record)``, ``counters()``, ``output(record, forest)``,
``judge_args()`` and ``close()``; everything else here is the same for
every cell. The window starts fits of
``trees_per_fit`` trees back to back, each on a fresh booster over the
DMatrix that set-up built, until ``seconds`` have passed; the fit in flight
finishes and counts. A time per tree is the wall time from the first fit's
start to the last fit's `torch.cuda.synchronize()` over all the trees grown.
"""
from __future__ import annotations

import dataclasses
import hashlib
import sys
import time

import numpy as np

from perfbench.yardstick import spec as spec_lib
from perfbench.yardstick import trace as trace_lib
from perfbench.yardstick.imports import refuse_forbidden


# a traced run traces the window's first fits, up to this many seconds: a
# trace of every host operation of a whole window takes minutes to read
TRACE_SECONDS = 10.0


class Solo:
    """The coordination of a one-card run: nothing to coordinate."""

    rank, world = 0, 1

    def decide(self, go: bool, tracing: bool) -> tuple[bool, bool]:
        return go, tracing

    def gather(self, obj) -> list:
        return [obj]

    def barrier(self) -> None:
        pass


@dataclasses.dataclass
class Span:
    """What a stretch of the window did: its seconds, fits, trees, and the
    program's counters at its end."""

    seconds: float
    fits: int
    trees: int
    counters: dict


@dataclasses.dataclass
class Window:
    whole: Span
    traced: Span | None  # the traced first fits, in a traced run
    records: list
    fit_seconds: list  # each fit's own wall seconds, for the log


def run_window(program, seconds: float, comm, sync, session=None) -> Window:
    """Fits back to back until ``seconds`` have passed; with a trace
    ``session``, it is stopped once a fit ends past `TRACE_SECONDS`. Rank 0
    decides both for every rank."""
    records, trees, marks, traced = [], 0, [], None
    t0 = time.perf_counter()
    while True:
        rec = program.fit()
        sync()
        records.append(rec)
        trees += len(rec["trees"])
        marks.append(time.perf_counter())
        elapsed = marks[-1] - t0
        go, tracing = comm.decide(elapsed < seconds,
                                  session is not None and elapsed < TRACE_SECONDS)
        if session is not None and (not tracing or not go):
            trace_lib.stop(session)
            traced = Span(elapsed, len(records), trees, program.counters())
            session = None
        if not go:
            break
    fit_s = [b - a for a, b in zip([t0] + marks[:-1], marks)]
    whole = Span(marks[-1] - t0, len(records), trees, program.counters())
    return Window(whole, traced, records, fit_s)


def forest_digest(forest) -> str:
    h = hashlib.sha256()
    for tree in forest:
        for a in (tree.feature, tree.split_bin, tree.default_left, tree.is_leaf, tree.leaf_value):
            h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def drive(program, cell: spec_lib.CellSpec, seed: int, seconds: float, trace: bool,
          comm, t_start: float, cuda: bool = True) -> dict | None:
    """Run one cell on this rank; rank 0 returns the result line's object,
    the others None."""
    import torch

    dev = program.device
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    program.setup()
    sync()
    comm.barrier()
    setup_s = time.perf_counter() - t_start
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    before = program.counters()
    session = trace_lib.start() if trace else None
    win = run_window(program, seconds, comm, sync, session)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    # a traced run's metrics all read its traced stretch, an untraced run's
    # the whole window
    span = win.traced if trace else win.whole
    summary = trace_lib.reduce(session) if trace else None
    del session
    forests = [program.host_trees(r) for r in win.records]
    mine = {
        "peak": peak,
        "dmatrix_s": program.dmatrix_s,
        "counters": {k: span.counters[k] - before.get(k, 0) for k in span.counters},
        "trace": summary,
        "digests": [forest_digest(f) for f in forests],
        "window_s": span.seconds,
        "fits": span.fits,
        "trees": span.trees,
    }
    ranks = comm.gather(mine)
    if comm.rank != 0:
        refuse_forbidden()
        return None

    pick = seed % len(win.records)
    out = program.output(win.records[pick], forests[pick])
    del win.records[:]
    if cuda:
        torch.cuda.empty_cache()
    from perfbench.reference import judge

    kw = program.judge_args()
    t_judge = time.perf_counter()
    nums, levels = judge.judge(program.X, program.y, out, cell.config, device=dev, **kw)
    print(f"set-up {setup_s:.3f} s (data {program.data_s:.3f} s, DMatrix "
          f"{program.dmatrix_s:.3f} s), window "
          f"{win.whole.seconds:.3f} s ({win.whole.fits} fits, {win.whole.trees} trees), reference "
          f"{time.perf_counter() - t_judge:.3f} s; fits "
          f"{' '.join(f'{x:.3f}' for x in win.fit_seconds)} s", file=sys.stderr)
    if comm.world > 1:
        nums["ranks_differ"] = float(sum(r["digests"] != ranks[0]["digests"] for r in ranks[1:]))
    limits = cell.limits
    for k in sorted(set(nums) - set(limits)):
        print(f"reading {k}: {nums[k]!r} (not compared)", file=sys.stderr)
    checks = [[k, nums[k], limits[k]] for k in limits]
    correct = all(np.isfinite(v) and v <= lim for _, v, lim in checks)

    ctx = {
        "ranks": ranks, "levels": levels, "window_s": span.seconds,
        "fits": span.fits, "trees": span.trees,
        "n_rows": program.X.shape[0], "num_features": program.X.shape[1],
        "n_bins": min(int(cell.config["max_bin"]), 255), "world": comm.world,
        "setup_s": setup_s,
    }
    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = spec_lib.load_metric(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "count": comm.world,
        "memory_peak_bytes": max(r["peak"] for r in ranks),
        "power_limit_w": program.power_limit_w,
    }
    # after the window, the judge and the metrics' readers: whatever they
    # loaded is held to the same rule as the window
    refuse_forbidden()
    result = {"correct": bool(correct), "attempted": win.whole.fits, "failed": 0,
              "metrics": metrics, "device": device}
    if trace:
        busy = [r["trace"]["busy_s"] for r in ranks]
        device["busy_s"] = float(np.mean(busy))
        device["window_s"] = span.seconds
        result["breakdown"] = {"device_ops": ranks[0]["trace"]["device_ops"],
                               "idle_gaps": ranks[0]["trace"]["idle_gaps"]}
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in checks}
    return result


def install_spans(entries) -> None:
    """Wrap each named call into the program in a profiler range, so a
    traced run sees the benchmark's spans around the calls into each layer:
    ``[module, attribute (dotted within it), span name]``."""
    import functools
    import importlib

    import torch

    for module, attr, label in entries:
        owner = importlib.import_module(module)
        *path, last = attr.split(".")
        for part in path:
            owner = getattr(owner, part)
        inner = getattr(owner, last)

        @functools.wraps(inner)
        def wrapped(*args, _inner=inner, _label=label, **kwargs):
            with torch.profiler.record_function(_label):
                return _inner(*args, **kwargs)

        setattr(owner, last, wrapped)


def make_data(config: dict, seed: int, device) -> tuple[np.ndarray, np.ndarray]:
    """The configuration's arrays, drawn on ``device`` from the seed by its
    generator (``traffic/<generator>.py``) and copied once to the host."""
    gen = spec_lib.load_generator(config["generator"])
    X, y = gen.generate(int(config["rows"]), config, seed, device)
    return X.cpu().numpy(), y.cpu().numpy()


def booster_kwargs(config: dict, seed: int) -> dict:
    """`BoosterParams` fields from the configuration's tree settings."""
    return dict(
        learning_rate=float(config["learning_rate"]), max_depth=int(config["max_depth"]),
        objective=config["objective"], max_bin=int(config["max_bin"]),
        reg_lambda=float(config["reg_lambda"]), gamma=float(config["gamma"]),
        min_child_weight=float(config["min_child_weight"]), seed=seed % (1 << 63),
    )
