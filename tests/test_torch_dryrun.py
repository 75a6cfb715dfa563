"""The port's dry run (`repro_torch.launch.dryrun`) on the CPU.

`run_cell` reaches ``ok`` for one REDUCED arch of each family x {train,
prefill, decode} and for ``xgb_paper.REDUCED``, each on a fake 2 x 2 world
that it sets up and tears down. On a 1 x 1 world the dry run's per-device
FLOPs equal `torch.utils.flop_counter.FlopCounterMode` around the same step
run for real on the CPU with no mesh; the FLOPs (and collective bytes) are
affine in ``n_layers``, the assumption the reference's two-depth
extrapolation makes; importing the module initialises no process group.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ShapeSpec, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh, mesh_axes

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
FAMILIES = ["llama3.2-1b", "olmoe-1b-7b", "mamba2-130m", "hymba-1.5b"]
KINDS = ["train_4k", "prefill_32k", "decode_32k"]


@pytest.mark.parametrize("shape", KINDS)
@pytest.mark.parametrize("arch", FAMILIES)
def test_run_cell_reduced_reaches_ok(tmp_path, arch, shape):
    res = dryrun.run_cell(arch, shape, False, str(tmp_path), reduced=True)
    assert res["status"] == "ok", res.get("traceback")
    assert not dist.is_initialized()
    assert res["mesh"] == "2x2" and res["chips"] == 4
    assert res["flops_per_device"] > 0 and res["bytes_per_device"] > 0
    assert res["collective_bytes_per_device"] > 0
    assert res["memory_stats"]["peak_estimate_bytes"] >= res["memory_stats"][
        "argument_size_in_bytes"] > 0
    assert res["fits_one_card"] is True
    assert res["dominant"] in ("compute", "memory", "collective")
    # resumable: the cell's JSON is read back, not run again
    path = tmp_path / "2x2" / f"{arch}__{shape}.json"
    assert json.loads(path.read_text()) == res
    assert dryrun.run_cell(arch, shape, False, str(tmp_path), reduced=True) == res


def test_run_cell_gbdt_reduced(tmp_path):
    from repro_torch.configs.xgb_paper import REDUCED as G

    res = dryrun.run_cell("xgb-paper", "boost_1m", False, str(tmp_path), reduced=True)
    assert res["status"] == "ok", res.get("traceback")
    assert not dist.is_initialized()
    assert res["flops_per_device"] == 0 and res["useful_ratio"] is None
    assert res["model_flops"] == G.rows_per_device * 2 * G.max_depth * 2 * 2
    assert res["collective_breakdown"].get("all-reduce", 0) > 0  # the histogram psum
    assert res["bytes_per_device"] > 0


def test_failed_cell_is_recorded(tmp_path, monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("no layout")

    monkeypatch.setattr(dryrun, "lower_lm_cell", boom)
    res = dryrun.run_cell("llama3.2-1b", "train_4k", False, str(tmp_path), reduced=True)
    assert res["status"] == "error" and res["error"] == "RuntimeError: no layout"
    assert "Traceback" in res["traceback"]
    assert not dist.is_initialized()


CASES = {
    "train": ShapeSpec("t", "train", 32, 4),
    "prefill": ShapeSpec("p", "prefill", 32, 4),
    "decode": ShapeSpec("d", "decode", 64, 4),
}


def _real_step(cfg, shape: ShapeSpec):
    """The step the dry run traces, on real CPU tensors, no mesh."""
    from repro_torch.models.serve import decode_step, init_cache, prefill
    from repro_torch.models.transformer import init_params
    from repro_torch.train.optimizer import OptConfig, adamw_init
    from repro_torch.train.train_step import TrainConfig, TrainState, make_train_step

    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        oc = OptConfig()
        state = TrainState(params, adamw_init(params, oc))
        batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))
                 .to(torch.int32)}
        step = make_train_step(cfg, oc, TrainConfig(remat=True))
        return lambda: step(state, batch)
    if shape.kind == "prefill":
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))).to(torch.int32)
        return lambda: prefill(params, cfg, tokens, max_len=S)
    cache = init_cache(cfg, B, S, paged=cfg.family in ("dense", "moe"), device="cpu")
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B,))).to(torch.int32)
    return lambda: decode_step(params, cfg, tokens, cache)


def _trace(cfg, shape, mesh_shape=(1, 1)):
    with dryrun.fake_world(int(np.prod(mesh_shape))):
        mesh = make_host_mesh(*mesh_shape, device_type="cpu")
        return dryrun.trace_lm(cfg, shape, mesh, mesh_axes(False))


@pytest.mark.parametrize("arch", ["llama3.2-1b", "olmoe-1b-7b"])
@pytest.mark.parametrize("kind", sorted(CASES))
def test_one_rank_flops_equal_flop_counter(arch, kind):
    cfg = get_config(arch, reduced=True)
    cost = _trace(cfg, CASES[kind])
    step = _real_step(cfg, CASES[kind])
    counter = FlopCounterMode(display=False)
    with torch.no_grad() if kind != "train" else torch.enable_grad(), counter:
        step()
    assert cost.flops == counter.get_total_flops() > 0
    assert cost.collectives == {}


def test_flops_affine_in_depth():
    base = get_config("llama3.2-1b", reduced=True)
    costs = [_trace(dataclasses.replace(base, n_layers=n), CASES["train"], (2, 2))
             for n in (2, 3, 4)]
    flops = [c.flops for c in costs]
    assert flops[1] - flops[0] == flops[2] - flops[1] > 0
    coll = [sum(c.collectives.values()) for c in costs]
    assert coll[1] - coll[0] == coll[2] - coll[1] > 0


def test_import_touches_no_process_group():
    code = ("import torch.distributed as d, repro_torch.launch.dryrun, "
            "repro_torch.launch.mesh; print(d.is_initialized())")
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"
