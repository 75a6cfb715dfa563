"""Dry run: every (arch x shape x mesh) cell as a sharded program, on the host.

Counterpart of `repro.launch.dryrun`, which lowers and compiles each cell
for 256 / 512 host devices. The port runs each cell's step once, as rank 0
of a fake world of 256 or 512 ranks (``torch.distributed``'s "fake"
backend: every collective returns at once), on the ``meta`` device: weights,
optimizer state, batch and caches are DTensors laid out per the sharding
rules whose local shards have shapes and no storage. For each cell this
proves, without hardware:
  * the sharding config is coherent (every op of the step finds a layout,
    every redistribution a path),
  * the per-device memory (the peak of live local bytes) and whether it
    fits one 80 GB card,
  * and the per-device FLOPs / bytes / collective bytes for the roofline
    (`repro_torch.roofline.analysis.CostMode`, on H100 constants).

The layer loop is Python, so every layer is counted (the reference
extrapolates from two depths because XLA counts a scan body once). The GBDT
cell runs the port's `make_gbdt_step_fn` on its own mesh of the fake world,
on seeded host arrays through the plain versions; its values are those of
one rank's shard whose collectives returned nothing, so only its costs
mean anything.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k --single-pod
Results land in experiments/dryrun_torch/<mesh>/<arch>__<shape>.json
(resumable: a cell whose file exists is read, not run). Importing this
module touches no process group and no device.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback

import numpy as np
import torch

from repro_torch.configs.registry import LM_ARCHS, get_config
from repro_torch.configs.shapes import (
    SHAPES,
    ShapeSpec,
    applicable,
    decode_input_specs,
    prefill_input_specs,
    train_input_specs,
)
from repro_torch.launch.mesh import make_production_mesh, mesh_axes
from repro_torch.roofline.analysis import CostMode, RooflineReport, analyze_traced
from repro_torch.sharding.rules import (
    P,
    MeshAxes,
    NamedSharding,
    mesh_sizes,
    param_specs,
    placements,
    serve_cache_specs,
    set_mesh_context,
    state_shardings,
)

OUT_ROOT = os.path.join(os.path.dirname(__file__), "..", "..", "..", "experiments",
                        "dryrun_torch")
CARD_BYTES = 80e9  # one H100 80GB
MESH_DEVICE = "cuda"  # the device type the meshes name (the card's collectives)
# ``reduced`` cells: each arch's REDUCED config at these shapes on a 2 x 2
# (or 2 x 2 x 2) host-typed mesh, the same program at test size
REDUCED_SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 32, 4),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32, 4),
    "decode_32k": ShapeSpec("decode_32k", "decode", 64, 4),
    "long_500k": ShapeSpec("long_500k", "decode", 128, 1),
}


@contextlib.contextmanager
def fake_world(world_size: int):
    """This process as rank 0 of a ``world_size``-rank world whose
    collectives do nothing; torn down on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _nd(mesh, names) -> int:
    sizes = mesh_sizes(mesh)
    n = 1
    for name in names if isinstance(names, tuple) else (names,):
        n *= sizes[name]
    return n


def _batch_spec(leaf: torch.Tensor, mesh, axes: MeshAxes) -> P:
    """The reference's `_batch_shardings` rule for one leaf."""
    dp = axes.data
    if leaf.shape[0] % _nd(mesh, dp) != 0:
        return P(*([None] * leaf.ndim))
    return P(dp, *([None] * (leaf.ndim - 1)))


def _sharded_like(tree, specs, mesh):
    """Every meta tensor leaf of ``tree`` as a DTensor of its spec (or
    `NamedSharding`) whose local shard is a fresh meta tensor (nothing of
    the global one kept)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    def one(leaf, spec):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        pl = spec.placements if isinstance(spec, NamedSharding) else placements(spec, mesh)
        shape, _ = compute_local_shape_and_global_offset(leaf.shape, mesh, pl)
        local = torch.empty(shape, dtype=leaf.dtype, device="meta")
        return DTensor.from_local(local, mesh, pl, run_check=False, shape=leaf.shape,
                                  stride=leaf.stride())

    def walk(t, s):
        if isinstance(t, dict):
            return {k: walk(v, s[k]) for k, v in t.items()}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(walk(v, sv) for v, sv in zip(t, s)))
        if isinstance(t, tuple):
            return tuple(walk(v, sv) for v, sv in zip(t, s))
        return one(t, s)

    return walk(tree, specs)


def trace_lm(cfg, shape: ShapeSpec, mesh, axes: MeshAxes) -> CostMode:
    """One step of ``cfg`` at ``shape`` on ``mesh`` (meta shards), under a
    `CostMode` whose counters and peak start at the step (the weights,
    state, batch and caches counted as its arguments)."""
    from repro_torch.models.serve import decode_step, prefill
    from repro_torch.models.transformer import init_params
    from repro_torch.train.optimizer import OptConfig, adamw_init
    from repro_torch.train.train_step import TrainConfig, TrainState, make_train_step

    specs = {"train": train_input_specs, "prefill": prefill_input_specs,
             "decode": decode_input_specs}[shape.kind](cfg, shape)
    meta = init_params(cfg, None, "meta")
    params = _sharded_like(meta, param_specs(meta, mesh, axes), mesh)
    batch = {k: _sharded_like(v, _batch_spec(v, mesh, axes), mesh)
             for k, v in specs.items() if k != "cache"}
    cost = CostMode()
    with set_mesh_context(mesh, axes):
        if shape.kind == "train":
            oc = OptConfig(schedule="wsd" if cfg.name == "minicpm-2b" else "cosine")
            state = TrainState(meta, adamw_init(meta, oc))
            state = _sharded_like(state, state_shardings(state, mesh, axes), mesh)
            step = make_train_step(cfg, oc, TrainConfig(remat=True))
            with cost:
                cost.track(state, batch)
                cost.start()
                step(state, batch)
        elif shape.kind == "prefill":
            with torch.no_grad(), cost:
                cost.track(params, batch)
                cost.start()
                prefill(params, cfg, batch["tokens"], max_len=shape.seq_len)
        else:
            cache = specs["cache"]
            cache = _sharded_like(cache, serve_cache_specs(cache, mesh, axes,
                                                           shape.global_batch), mesh)
            with torch.no_grad(), cost:
                cost.track(params, batch, cache)
                cost.start()
                decode_step(params, cfg, batch["tokens"], cache)
    return cost


def _mesh_shape(multi_pod: bool, reduced: bool = False) -> tuple[int, ...]:
    side = 2 if reduced else 16
    return (2, side, side) if multi_pod else (side, side)


def _mesh_name(multi_pod: bool, reduced: bool = False) -> str:
    return "x".join(map(str, _mesh_shape(multi_pod, reduced)))


def _cell_mesh(multi_pod: bool, reduced: bool):
    """The cell's mesh. The two pods' data axes are laid out as one mesh
    dim of 32, ``"pod+data"`` (pod-major: the same ranks in the same order
    as `make_production_mesh`'s 2 x 16 x 16), carrying the axis sizes the
    rules read: a dim the rules split over ``("pod", "data")`` is split over
    that one dim, and its collectives run once over 32 ranks instead of
    twice. DTensor plans a 3-D mesh's redistributions ~20x slower."""
    from repro_torch.launch.mesh import _world_mesh

    if not reduced:
        if not multi_pod:
            return make_production_mesh(device_type=MESH_DEVICE)
        mesh = _world_mesh((32, 16), ("pod+data", "model"), MESH_DEVICE)
        mesh.axis_sizes = {"pod": 2, "data": 16, "model": 16}
        return mesh
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    # host-typed: DTensor's shape propagation of some ops on f32 REDUCED
    # configs (a log-softmax of a strided slice) needs CUDA for a cuda mesh
    return _world_mesh(_mesh_shape(multi_pod, True), names, "cpu")


def lower_lm_cell(arch: str, shape_name: str, multi_pod: bool,
                  reduced: bool = False) -> RooflineReport:
    cfg = get_config(arch, reduced=reduced)
    shape = (REDUCED_SHAPES if reduced else SHAPES)[shape_name]
    mesh = _cell_mesh(multi_pod, reduced)
    axes = mesh_axes(multi_pod)
    cost = trace_lm(cfg, shape, mesh, axes)
    tokens = (
        shape.global_batch * shape.seq_len
        if shape.kind in ("train", "prefill")
        else shape.global_batch
    )
    return analyze_traced(
        cost, arch=arch, shape=shape_name, mesh_name=_mesh_name(multi_pod, reduced),
        chips=mesh.size(), n_active_params=cfg.active_param_count(), tokens=tokens,
        kind="train" if shape.kind == "train" else "serve",
    )


def gbdt_inputs(g, rows: int, m: int, seed: int = 0) -> tuple:
    """Seeded host arrays at the reference's structs: a compacted ELLPACK
    page of ``rows`` x ``m`` bins (``g.num_features`` real features, the
    rest masked by ``bin_valid``), margins, labels, cut values and pointers."""
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, g.n_bins, (rows, m), dtype=np.uint8)
    margin = np.zeros(rows, np.float32)
    labels = (rng.random(rows) < 0.5).astype(np.float32)
    bin_valid = np.zeros((m, g.n_bins), bool)
    bin_valid[: g.num_features] = True
    cut_values = np.tile(np.arange(g.n_bins, dtype=np.float32), m)
    cut_ptrs = (np.arange(m + 1) * g.n_bins).astype(np.int32)
    return bins, margin, labels, bin_valid, cut_values, cut_ptrs


def trace_gbdt(g, mesh_shape: tuple[int, ...], axis_names: tuple[str, ...],
               data_axes: tuple[str, ...], seed: int = 0) -> tuple[CostMode, int]:
    """One boosting iteration of ``g`` (an `xgb_paper` config) as rank 0 of
    the current world, on the host: (the `CostMode`, the global rows). The
    features are padded to a multiple of the model axis (500 -> 512 on 16),
    the padding masked by ``bin_valid``."""
    from repro_torch.core.split import SplitParams
    from repro_torch.core.tree import TreeParams
    from repro_torch.distributed import DistConfig, make_gbdt_step_fn, make_mesh

    mesh = make_mesh(mesh_shape, axis_names, device="cpu")
    rows = g.rows_per_device * mesh.axis_size(data_axes)
    msize = mesh.axis_size("model")
    m = -(-g.num_features // msize) * msize
    tp = TreeParams(max_depth=g.max_depth, split=SplitParams(reg_lambda=1.0))
    dcfg = DistConfig(data_axes=data_axes, feature_axis="model", kernel_impl="ref")
    step = make_gbdt_step_fn(mesh, tp, g.n_bins, dcfg, learning_rate=g.learning_rate,
                             objective=g.objective, sampling_f=g.sampling_f)
    inputs = gbdt_inputs(g, rows, m, seed)
    cost = CostMode()
    with cost:
        cost.start()
        step(*inputs, seed)
    return cost, rows


def lower_gbdt_cell(shape_name: str, multi_pod: bool, reduced: bool = False) -> RooflineReport:
    """The paper's own workload: one boosting iteration on the production mesh."""
    from repro_torch.configs import xgb_paper

    g = xgb_paper.REDUCED if reduced else xgb_paper.CONFIG
    axes = mesh_axes(multi_pod)
    shape = _mesh_shape(multi_pod, reduced)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    cost, rows = trace_gbdt(g, shape, names, axes.data)
    # model flops for one boosting iteration ~ histogram builds: rows x depth x (g,h)
    useful = rows * g.max_depth * 2 * 2  # one MAC per (row, level, grad pair)
    return analyze_traced(
        cost, arch="xgb-paper", shape=shape_name, mesh_name=_mesh_name(multi_pod, reduced),
        chips=int(np.prod(shape)), n_active_params=1, tokens=1, kind="train",
        useful_flops=float(useful),
    )


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
             reduced: bool = False) -> dict:
    """One cell, in a fake world of its mesh's size set up and torn down
    here; ``reduced`` runs the arch's REDUCED config at `REDUCED_SHAPES` on
    a 2 x 2 (x 2) mesh."""
    mesh_name = _mesh_name(multi_pod, reduced)
    os.makedirs(os.path.join(out_dir, mesh_name), exist_ok=True)
    path = os.path.join(out_dir, mesh_name, f"{arch}__{shape_name}.json")
    if os.path.exists(path):
        with open(path) as fh:
            return json.load(fh)
    t0 = time.perf_counter()
    try:
        with fake_world(int(np.prod(_mesh_shape(multi_pod, reduced)))):
            if arch == "xgb-paper":
                report = lower_gbdt_cell(shape_name, multi_pod, reduced)
            else:
                report = lower_lm_cell(arch, shape_name, multi_pod, reduced)
        result = report.to_dict()
        result["fits_one_card"] = result["memory_stats"]["peak_estimate_bytes"] <= CARD_BYTES
        result["status"] = "ok"
    except Exception as e:  # noqa: BLE001 — record failures, keep sweeping
        result = {
            "arch": arch, "shape": shape_name, "mesh": mesh_name,
            "status": "error", "error": f"{type(e).__name__}: {e}",
            "traceback": traceback.format_exc()[-2000:],
        }
    result["compile_seconds"] = round(time.perf_counter() - t0, 1)
    with open(path, "w") as fh:
        json.dump(result, fh, indent=1)
    status = result["status"]
    extra = (
        f"dominant={result.get('dominant')} compile={result['compile_seconds']}s"
        if status == "ok" else result.get("error", "")[:120]
    )
    print(f"[{mesh_name}] {arch} x {shape_name}: {status} {extra}", flush=True)
    return result


def iter_cells(include_gbdt: bool = True):
    for arch in LM_ARCHS:
        cfg = get_config(arch)
        for shape_name, shape in SHAPES.items():
            if applicable(cfg, shape):
                yield arch, shape_name
    if include_gbdt:
        yield "xgb-paper", "boost_1m"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--single-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=os.path.abspath(OUT_ROOT))
    args = ap.parse_args(argv)

    pods = []
    if args.multi_pod or args.all or not args.single_pod:
        pods.append(True)
    if args.single_pod or args.all or not args.multi_pod:
        pods.append(False)
    pods = sorted(set(pods))  # False (single) first

    cells = list(iter_cells())
    if args.arch:
        cells = [(a, s) for a, s in cells if a == args.arch]
        if args.arch == "xgb-paper" and not cells:
            cells = [("xgb-paper", "boost_1m")]
    if args.shape:
        cells = [(a, s) for a, s in cells if s == args.shape]

    n_fail = 0
    for multi_pod in pods:
        for arch, shape in cells:
            res = run_cell(arch, shape, multi_pod, args.out)
            n_fail += res["status"] != "ok"
    print(f"done; failures: {n_fail}")
    return n_fail


if __name__ == "__main__":
    raise SystemExit(main())
