"""The rank program of `test_torch_lm_sharded.py`: the port's LM models on a
mesh of gloo ranks on the CPU.

Imports neither JAX nor the reference. Every rank builds the same seeded
weights and batch, lays them out per the sharding rules on a ``(data,
model)`` mesh, runs `prefill` and one `make_train_step` step under the
mesh context, and writes the full (gathered) results to
``<out>/<arch>_w<world>_r<rank>.npz``. `one_rank` computes the same with no
mesh and no process group, the results the sharded ones are held against.
"""
from __future__ import annotations

import datetime
import os

import numpy as np

ARCHS = ("llama3.2-1b", "olmoe-1b-7b", "hymba-1.5b")
MESHES = {2: (1, 2), 4: (2, 2)}  # world -> (data, model)
B, S = 4, 32
SEED = 3
TIMEOUT_S = 60
OPT = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)


def _inputs(arch: str):
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params

    cfg = get_config(arch, reduced=True)
    params = init_params(cfg, torch.Generator().manual_seed(SEED), "cpu")
    rng = np.random.default_rng(SEED)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int64))
    return cfg, params, tokens


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]


def _full(t):
    return (t.full_tensor() if hasattr(t, "full_tensor") else t).detach().numpy()


def compute(arch: str, mesh=None, axes=None) -> dict:
    """Prefill's last logits, and one train step's loss, grad norm and
    updated parameters, as numpy arrays (gathered from the shards)."""
    import contextlib

    import torch

    from repro_torch.models.serve import prefill
    from repro_torch.sharding.rules import (
        distribute_tree,
        param_shardings,
        set_mesh_context,
    )
    from repro_torch.train.optimizer import OptConfig, adamw_init
    from repro_torch.train.train_step import TrainConfig, TrainState, make_train_step

    cfg, params, tokens = _inputs(arch)
    ctx = contextlib.nullcontext()
    if mesh is not None:
        params = param_shardings(params, mesh, axes)
        tokens = distribute_tree(tokens, (axes.data, None), mesh)
        ctx = set_mesh_context(mesh, axes)
    oc = OptConfig(**OPT)
    with ctx:
        with torch.no_grad():  # DTensors do not run under inference_mode
            logits, _ = prefill(params, cfg, tokens, max_len=S)
        step = make_train_step(cfg, oc, TrainConfig(remat=True))
        state, metrics = step(TrainState(params, adamw_init(params, oc)), {"tokens": tokens})
    out = {"logits": _full(logits), "loss": _full(metrics["loss"]),
           "grad_norm": _full(metrics["grad_norm"])}
    if mesh is None:  # the one-rank gradients, which the comparison of updates reads
        from repro_torch.models.transformer import lm_loss
        from repro_torch.train.train_step import value_and_grad

        _, _, grads = value_and_grad(lambda p: lm_loss(p, cfg, {"tokens": tokens}), params)
        out.update({f"grad/{k}": _full(v) for k, v in _leaves(grads)})
    out.update({f"param/{k}": _full(v) for k, v in _leaves(state.params)})
    return out


def run(rank: int, world: int, store: str, out: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=TIMEOUT_S),
    )
    try:
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.sharding.rules import MeshAxes

        mesh = make_host_mesh(*MESHES[world], device_type="cpu")
        for arch in ARCHS:
            res = compute(arch, mesh, MeshAxes())
            np.savez(os.path.join(out, f"{arch}_w{world}_r{rank}.npz"), **res)
    finally:
        dist.destroy_process_group()
