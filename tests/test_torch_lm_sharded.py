"""The port's LM models under a mesh, on gloo ranks on the CPU, against
the same step with no mesh.

Two ranks (a 1 x 2 ``(data, model)`` mesh) and four (2 x 2) run
`torch_lm_shard_ranks.run`, spawned once per module with
`torch.multiprocessing` (a ``file://`` store under tmp, a 60 s collective
timeout, a join deadline): REDUCED llama3.2-1b, olmoe-1b-7b and hymba-1.5b
in f32, their weights laid out per `param_specs`, the batch over the data
axis, prefill and one `make_train_step` under `set_mesh_context`. Every
rank's gathered results are held against this process's one-rank run:

  loss, prefill logits     within 1e-5 (logits: or within the one-rank f32
                           logits' own distance from an f64 run, where that
                           is larger: hymba's f32 prefill sits ~1.3e-5 from
                           its f64 one)
  grad norm                within 1e-5 of its value, relative
  updated parameters       within 1e-5 wherever the one-rank gradient is at
                           least 1e-4 (AdamW's first step is g / (|g| + eps):
                           a gradient below its own rounding may flip sign),
                           and within 2 * lr everywhere
"""
import dataclasses
import os
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_lm_shard_ranks as ranks

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
DEADLINE_S = 240
TOL = 1e-5
SIZEABLE_GRAD = 1e-4


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    out = tmp_path_factory.mktemp("lm_shard")
    os.environ["PYTHONPATH"] = os.pathsep.join(
        p for p in (SRC, os.environ.get("PYTHONPATH", "")) if p)
    ctxs = [mp.start_processes(ranks.run, args=(w, str(out / f"store{w}"), str(out)),
                               nprocs=w, join=False, start_method="spawn")
            for w in ranks.MESHES]
    deadline = time.monotonic() + DEADLINE_S
    procs = [p for c in ctxs for p in c.processes]
    try:
        for proc in procs:
            proc.join(timeout=max(0.0, deadline - time.monotonic()))
    finally:
        hung = [p.pid for p in procs if p.is_alive()]
        for proc in procs:
            if proc.is_alive():
                proc.kill()
    assert not hung, f"ranks {hung} still running after {DEADLINE_S} s"
    assert [p.exitcode for p in procs] == [0] * len(procs)
    return out


@pytest.fixture(scope="module")
def one_rank():
    return {a: ranks.compute(a) for a in ranks.ARCHS}


def _f32_floor(arch: str) -> float:
    """How far the one-rank f32 prefill logits lie from an f64 run."""
    from repro_torch.models.serve import prefill

    cfg, params, tokens = ranks._inputs(arch)
    with torch.no_grad():
        got, _ = prefill(params, cfg, tokens, max_len=ranks.S)
        p64 = {k: ({kk: vv.double() for kk, vv in v.items()} if isinstance(v, dict)
                   else v.double()) for k, v in params.items()}
        want, _ = prefill(p64, dataclasses.replace(cfg, dtype="float64"), tokens,
                          max_len=ranks.S)
    return float((got.double() - want).abs().max())


@pytest.mark.parametrize("world", sorted(ranks.MESHES))
@pytest.mark.parametrize("arch", ranks.ARCHS)
def test_sharded_step_matches_one_rank(spawned, one_rank, arch, world):
    want = one_rank[arch]
    lr = ranks.OPT["peak_lr"]
    logit_tol = max(TOL, _f32_floor(arch))
    for rank in range(world):
        got = np.load(spawned / f"{arch}_w{world}_r{rank}.npz")
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=0, atol=TOL)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=TOL, atol=0)
        d = float(np.max(np.abs(got["logits"] - want["logits"])))
        assert d <= logit_tol, (arch, world, rank, d, logit_tol)
        params = [k for k in want if k.startswith("param/")]
        assert params and set(params) == {k for k in got.files if k.startswith("param/")}
        for k in params:
            diff = np.abs(got[k] - want[k])
            g = np.abs(want["grad/" + k[len("param/"):]])
            assert diff.max() <= 2 * lr * (1 + 1e-3), (k, float(diff.max()))
            sized = g >= SIZEABLE_GRAD
            assert sized.any(), k
            assert diff[sized].max() <= TOL, (k, float(diff[sized].max()))
