"""The rank programs of the port's sharded LM runs, and what they are held to.

Imports neither JAX nor the reference. Every rank builds the same seeded
weights and batch (`_batch`: tokens, an audio model's codes, a vision
model's patch embeddings) and lays them out per the sharding rules on a
``(data, model)`` mesh.

- `run`: gloo ranks on the CPU (`test_torch_lm_sharded.py`, worlds of 2 and
  4). Each rank runs `compute` (prefill, 3 greedy decode steps on the
  sharded contiguous cache, one `make_train_step` step) for every arch,
  then the checkpoint flows: the state after one step saved sharded (rank 0
  also saves it gathered: a one-rank save of the same state); the world of
  4 runs the uninterrupted second step, the world of 2 restores the 2 x 2
  checkpoint onto 1 x 2 and 2 x 1 (`state_shardings`) and steps on 1 x 2,
  and restores the reference-written checkpoint onto 1 x 2 and saves it
  again, sharded; last, `disagreement`.
- `run_cards`: one card a rank over NCCL (`test_torch_cuda.py`'s four-card
  runs): `compute` on 2 x 2 (twice: whether NCCL gives the same bits run to
  run), then FULL_ARCHS at full width (`full_width`; llava-next-34b and
  moonshot-v1-16b-a3b at their FULL_LAYERS depth, reckoned by
  `full_depth_reckoned` and `hold_depth_reckoned`).
- `card_of_one`: a world of one over NCCL on one card (`chip_smoke.py`
  phase 16): `compute` on a 1 x 1 card mesh against no mesh, and a
  checkpoint saved and restored with ``shardings`` bit for bit.

`compute` with no mesh and no process group gives the results the sharded
ones are held against (`check_against_one_rank`).
"""
from __future__ import annotations

import dataclasses
import datetime
import json
import os
import time

import numpy as np

ARCHS = ("llama3.2-1b", "olmoe-1b-7b", "hymba-1.5b", "mamba2-130m", "smollm-135m",
         "phi3-mini-3.8b", "minicpm-2b", "musicgen-large", "moonshot-v1-16b-a3b",
         "llava-next-34b")
MESHES = {2: (1, 2), 4: (2, 2)}  # world -> (data, model)
B, S = 4, 32
DECODE_STEPS = 3
SEED = 3
TIMEOUT_S = 60
OPT = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)
# the checkpoint flows: the world whose 2 x 2 checkpoints the world of 2
# restores, onto these meshes (stepping on the first)
CKPT_WORLD = 4
RESTORE_MESHES = ((1, 2), (2, 1))
READY_WAIT_S = 180  # the world of 2 waits this long for the world of 4's checkpoints
# the held tolerances (`test_torch_lm_sharded.py`'s docstring)
TOL = 1e-5
DECODE_TOL = 1e-4
SIZEABLE_GRAD = 1e-4

# ---- full width on four cards (`full_width`)
FULL_ARCHS = ("phi3-mini-3.8b", "olmoe-1b-7b", "llava-next-34b", "moonshot-v1-16b-a3b")
FULL_BATCH, FULL_SEQ = 4, 512  # and a vision model's n_patches patch positions
# Depth cuts; widths, heads, experts, top-k, vocab and n_patches stay as in
# configs/*.py. At ~23 B a parameter on 2 x 2, llava-next-34b (60 layers,
# 34.4 B parameters) and moonshot-v1-16b-a3b (48 layers, 28.1 B) need more
# than four 80 GB cards, so they run at the largest depth whose dry run of a
# bf16 step on 2 x 2 peaks at most FULL_PEAK_LIMIT a card
# (`full_depth_reckoned`, dry runs on the host); phi3 and olmoe run
# whole. The f32 hold runs at the largest depth whose one-card f32
# `value_and_grad` peaks at most HOLD_PEAK_LIMIT (`hold_depth_reckoned`): the
# rest of the card's 85.0 GB is the CUDA context's, the NCCL communicators'
# of every mesh the run has made (their buffers lie outside the allocator)
# and the allocator's; at 71 GB a hold left NCCL no room (llava, 12 layers).
# Reckoned on an NVIDIA H100 80GB HBM3 machine (torch 2.11.0+cu128): dry-run
# peaks a card of llava 30,952,716,332 B at 8 layers, 55,500,306,476 at 16,
# 61,637,204,012 at 18 and 64,705,652,780 at 19; moonshot 27,140,210,732 at
# 8, 52,245,413,932 at 16, 61,659,865,132 at 19 and 64,798,015,532 at 20.
# One-card f32 holds: llava 25,386,275,840 B at 2 layers, 34,558,399,488 at
# 4, 71,261,574,144 at 12 (4,587,529,830 B a layer: 62.1 GB at 10, 66.7 at
# 11); moonshot 11,545,982,464 at 2, 22,436,019,200 at 4, 70,311,148,544 at
# 13 (5,342,287,825 a layer: 59.6 GB at 11, 65.0 at 12).
FULL_PEAK_LIMIT = 64e9
HOLD_PEAK_LIMIT = 64e9
MIN_LAYERS = 8  # no cut below this
FULL_LAYERS = {"llava-next-34b": 18, "moonshot-v1-16b-a3b": 19}
HOLD_LAYERS = {"llava-next-34b": 10, "moonshot-v1-16b-a3b": 11}
FULL_STEPS = 3
FULL_OPT = dict(peak_lr=1e-3, warmup_steps=1, total_steps=FULL_STEPS)
TEMPER = 0.1  # q, k and in_proj scaled in the f32 hold (chip_smoke's TRAIN_TEMPER)
CARD_TIMEOUT_S = 300  # a collective on the cards ends within this, or raises
CKPT_ARCH = "phi3-mini-3.8b"  # its state after step 2 crosses to another mesh
BF16_PEAK_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)


def _inputs(arch: str, device="cpu"):
    """The REDUCED config, its seeded weights and its batch (`_batch`)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params

    cfg = get_config(arch, reduced=True)
    params = _to(init_params(cfg, torch.Generator().manual_seed(SEED), "cpu"), device)
    return cfg, params, _to(_batch(cfg, B, S), device)


def _batch(cfg, batch: int, seq: int) -> dict:
    """A training batch of ``cfg`` made from SEED with numpy, on the host:
    ``tokens`` (batch, seq); an audio model's ``codes`` (batch, seq,
    n_codebooks) in their place; a vision model's ``patch_embeds`` (batch,
    n_patches, d_model) beside them, in the model's dtype (they come
    first in the sequence)."""
    import torch

    rng = np.random.default_rng(SEED)
    if cfg.n_codebooks:
        codes = rng.integers(0, cfg.vocab_size, (batch, seq, cfg.n_codebooks))
        return {"codes": torch.from_numpy(codes.astype(np.int64))}
    out = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, seq)))}
    if cfg.frontend == "vision":
        patches = rng.standard_normal((batch, cfg.n_patches, cfg.d_model), dtype=np.float32)
        out["patch_embeds"] = torch.from_numpy(patches).to(getattr(torch, cfg.dtype))
    return out


def _prompt(batch: dict):
    """What prefill takes of a batch: the codes of an audio model, else the
    tokens (a vision model is served text only)."""
    return batch["codes"] if "codes" in batch else batch["tokens"]


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]


def _whole(t):
    """A DTensor gathered whole (a collective), a tensor as it is."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _full(t):
    """A (gathered) tensor as a numpy array, bf16 as its uint16 bit patterns."""
    import torch

    t = _whole(t).detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _opt():
    from repro_torch.train.optimizer import OptConfig

    return OptConfig(**OPT)


def _on_data(tokens, mesh, axes):
    """A batch tensor split over the data axes (as it is with no mesh)."""
    from repro_torch.sharding.rules import distribute_tree

    if mesh is None:
        return tokens
    return distribute_tree(tokens, (axes.data,) + (None,) * (tokens.ndim - 1), mesh)


def _batch_on_data(batch: dict, mesh, axes) -> dict:
    """Every tensor of a batch split over the data axes."""
    return {k: _on_data(v, mesh, axes) for k, v in batch.items()}


def _laid_out(params, batch, mesh, axes):
    """The weights per the rules and the batch over the data axes."""
    from repro_torch.sharding.rules import param_shardings

    return param_shardings(params, mesh, axes), _batch_on_data(batch, mesh, axes)


def _mesh_ctx(mesh, axes):
    import contextlib

    from repro_torch.sharding.rules import set_mesh_context

    return contextlib.nullcontext() if mesh is None else set_mesh_context(mesh, axes)


def compute(arch: str, mesh=None, axes=None, device="cpu") -> dict:
    """Prefill's last logits, 3 greedy decode steps (logits and tokens) on
    the contiguous cache (sharded per `serve_cache_specs` under a mesh), and
    one train step's loss, grad norm and updated parameters, as numpy arrays
    (gathered from the shards)."""
    import torch

    from repro_torch.models.serve import decode_step, prefill
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.train_step import TrainConfig, TrainState, make_train_step

    cfg, params, batch = _inputs(arch, device)
    if mesh is not None:
        params, batch = _laid_out(params, batch, mesh, axes)
    out = {}
    with _mesh_ctx(mesh, axes):
        with torch.no_grad():  # DTensors do not run under inference_mode
            logits, cache = prefill(params, cfg, _prompt(batch), max_len=S + DECODE_STEPS)
            out["logits"] = _full(logits)
            steps, picked = [], []
            for _ in range(DECODE_STEPS):
                tok = torch.argmax(_whole(logits), dim=-1)
                picked.append(tok.cpu().numpy())
                logits, cache = decode_step(params, cfg, _on_data(tok, mesh, axes), cache)
                steps.append(_full(logits))
            out["decode_logits"], out["decode_tokens"] = np.stack(steps), np.stack(picked)
            del cache
        step = make_train_step(cfg, _opt(), TrainConfig(remat=True))
        state, metrics = step(TrainState(params, adamw_init(params, _opt())), batch)
    out.update(loss=_full(metrics["loss"]), grad_norm=_full(metrics["grad_norm"]))
    if mesh is None:  # the one-rank gradients, which the comparison of updates reads
        from repro_torch.models.transformer import lm_loss
        from repro_torch.train.train_step import value_and_grad

        _, _, grads = value_and_grad(lambda p: lm_loss(p, cfg, batch), params)
        out.update({f"grad/{k}": _full(v) for k, v in _leaves(grads)})
    out.update({f"param/{k}": _full(v) for k, v in _leaves(state.params)})
    return out


def f32_floor(arch: str, device="cpu") -> float:
    """How far the one-rank f32 prefill logits lie from an f64 run."""
    import torch

    from repro_torch.models.serve import prefill

    cfg, params, batch = _inputs(arch, device)
    with torch.no_grad():
        got, _ = prefill(params, cfg, _prompt(batch), max_len=S)
        p64 = {k: ({kk: vv.double() for kk, vv in v.items()} if isinstance(v, dict)
                   else v.double()) for k, v in params.items()}
        want, _ = prefill(p64, dataclasses.replace(cfg, dtype="float64"), _prompt(batch),
                          max_len=S)
    return float((got.double() - want).abs().max())


def check_against_one_rank(got, want: dict, logit_tol: float, what: str) -> float:
    """Holds one rank's sharded `compute` results (a mapping) to the one-rank
    ones: loss within TOL, grad norm within TOL relative, prefill logits
    within ``logit_tol``, the decode steps' logits within DECODE_TOL with
    equal tokens, the updated parameters within TOL wherever the one-rank
    gradient is at least SIZEABLE_GRAD (AdamW's first step is g / (|g| +
    eps): a gradient below its own rounding may flip sign) and within 2 lr
    everywhere. Returns the largest decode logit gap."""
    lr = OPT["peak_lr"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=0, atol=TOL, err_msg=what)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=TOL, atol=0,
                               err_msg=what)
    d = float(np.max(np.abs(got["logits"] - want["logits"])))
    assert d <= logit_tol, (what, "prefill logits", d, logit_tol)
    np.testing.assert_array_equal(got["decode_tokens"], want["decode_tokens"], err_msg=what)
    dec = float(np.max(np.abs(got["decode_logits"] - want["decode_logits"])))
    assert dec <= DECODE_TOL, (what, "decode logits", dec)
    params = [k for k in want if k.startswith("param/")]
    assert params and set(params) == {k for k in got if k.startswith("param/")}, what
    for k in params:
        diff = np.abs(got[k] - want[k])
        g = np.abs(want["grad/" + k[len("param/"):]])
        assert diff.max() <= 2 * lr * (1 + 1e-3), (what, k, float(diff.max()))
        sized = g >= SIZEABLE_GRAD
        assert sized.any(), (what, k)
        assert diff[sized].max() <= TOL, (what, k, float(diff[sized].max()))
    return dec


# ------------------------------------------------------------ checkpoints
def ckpt_dir(out: str, arch: str, world: int) -> str:
    return os.path.join(out, f"ckpt_{arch}_w{world}")


def ref_ckpt_dir(out: str, arch: str) -> str:
    """Where the test writes a checkpoint with the reference's `save_checkpoint`."""
    return os.path.join(out, f"ref_ckpt_{arch}")


def ref_state_arrays(arch: str) -> dict:
    """The state the reference writes for ``arch`` (keys as its flatten
    prints them): the seeded REDUCED weights in bf16, seeded f32 moments,
    step 5."""
    import torch

    from repro_torch.train.checkpoint import _flatten

    like = _meta_state(arch, bf16=True)
    rng = np.random.default_rng(SEED + 1)
    _, params, _ = _inputs(arch)
    weights = {k: v.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
               for k, v in _leaves(params)}
    out = {}
    for key, leaf in _flatten(like):
        field, _, rest = key.partition("/")
        if field == ".params":
            out[key] = weights[rest]
        elif key == ".opt/.step":
            out[key] = np.int32(5)
        else:
            out[key] = rng.standard_normal(tuple(leaf.shape)).astype(np.float32)
    return out


def _meta_state(arch: str, bf16: bool = False):
    """A `TrainState`'s structure and shapes (meta tensors) for ``arch``."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.train_step import TrainState

    cfg = get_config(arch, reduced=True)
    if bf16:
        cfg = dataclasses.replace(cfg, dtype="bfloat16")
    params = init_params(cfg, None, "meta")
    return TrainState(params, adamw_init(params, _opt()))


def _gathered(state):
    """A state with every leaf gathered whole (a collective on every rank)."""
    from repro_torch.train.optimizer import tree_map

    return type(state)(tree_map(_whole, state.params),
                       state.opt._replace(step=_whole(state.opt.step),
                                          m=tree_map(_whole, state.opt.m),
                                          v=tree_map(_whole, state.opt.v)))


def _state_leaves(state, prefix: str) -> dict:
    from repro_torch.train.checkpoint import _flatten

    return {f"{prefix}{k}": _full(v) for k, v in _flatten(state)}


def _trained(arch: str, mesh, axes, device):
    """The state after one step on ``mesh``, its step function and batch."""
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.train_step import TrainConfig, TrainState, make_train_step

    cfg, params, batch = _inputs(arch, device)
    if mesh is not None:
        params, batch = _laid_out(params, batch, mesh, axes)
    step = make_train_step(cfg, _opt(), TrainConfig(remat=True))
    with _mesh_ctx(mesh, axes):
        state, _ = step(TrainState(params, adamw_init(params, _opt())), batch)
    return state, step, batch


def _stepped(step, state, batch, mesh, axes, prefix: str) -> dict:
    """One more step from ``state``: its loss, grad norm, updated parameters
    and first moments (gathered)."""
    with _mesh_ctx(mesh, axes):
        new, metrics = step(state, batch)
    out = {f"{prefix}loss": _full(metrics["loss"]),
           f"{prefix}grad_norm": _full(metrics["grad_norm"])}
    out.update({f"{prefix}param/{k}": _full(v) for k, v in _leaves(new.params)})
    out.update({f"{prefix}m/{k}": _full(v) for k, v in _leaves(new.opt.m)})
    return out


def save_flow(arch: str, out: str, world: int, mesh, axes, device) -> dict:
    """The state after one step saved sharded, and by rank 0 gathered (a
    one-rank save of the same state); in the world of CKPT_WORLD also the
    uninterrupted second step (``next/...``)."""
    import torch.distributed as dist

    from repro_torch.train.checkpoint import save_checkpoint

    state, step, batch = _trained(arch, mesh, axes, device)
    save_checkpoint(ckpt_dir(out, arch, world), state, step=1, extra={"arch": arch})
    whole = _gathered(state)
    if dist.get_rank() == 0:
        save_checkpoint(ckpt_dir(out, arch, world) + "_plain", whole, step=1,
                        extra={"arch": arch})
    del whole
    if world != CKPT_WORLD:
        return {}
    return _stepped(step, state, batch, mesh, axes, "next/")


def restore_flow(path: str, arch: str, mesh, axes, device, prefix: str, bf16: bool = False,
                 step_after: bool = False) -> tuple[dict, object]:
    """``path``'s checkpoint restored onto ``mesh`` per `state_shardings`:
    every leaf gathered (``<prefix><key>``), the leaves whose placements are
    not their layout's (``<prefix>misplaced``, a count), the leaves sharded
    on some mesh dim (``<prefix>sharded``); with ``step_after`` one step from
    it (``<prefix>step/...``). Returns (results, the restored state)."""
    from repro_torch.sharding.rules import state_shardings
    from repro_torch.train.checkpoint import _flatten, restore_checkpoint

    like = _meta_state(arch, bf16)
    layouts = state_shardings(like, mesh, axes)
    state, at = restore_checkpoint(path, like, layouts, device=device)
    want = dict(_flatten(layouts))
    got = _flatten(state)
    res = _state_leaves(state, prefix)
    res[f"{prefix}misplaced"] = np.int64(sum(
        tuple(leaf.placements) != want[k].placements for k, leaf in got))
    res[f"{prefix}sharded"] = np.int64(sum(
        any(p.is_shard() for p in leaf.placements) for _, leaf in got))
    res[f"{prefix}at"] = np.int64(at)
    if step_after:
        from repro_torch.train.train_step import TrainConfig, make_train_step

        cfg, _, batch = _inputs(arch, device)
        step = make_train_step(cfg, _opt(), TrainConfig(remat=True))
        res.update(_stepped(step, state, _batch_on_data(batch, mesh, axes), mesh, axes,
                            f"{prefix}step/"))
    return res, state


def _ready(out: str) -> str:
    return os.path.join(out, f"ckpt_w{CKPT_WORLD}.ready")


def checkpoint_flows(rank: int, world: int, out: str, mesh, axes, device) -> None:
    """`run`'s checkpoint part (see the module docstring); each rank writes
    ``ckpt_<arch>_w<world>_r<rank>.npz``."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train.checkpoint import save_checkpoint

    res = {a: save_flow(a, out, world, mesh, axes, device) for a in ARCHS}
    if world == CKPT_WORLD:
        if rank == 0:
            with open(_ready(out) + ".tmp", "w") as fh:
                fh.write("saved")
            os.replace(_ready(out) + ".tmp", _ready(out))
    else:
        deadline = time.monotonic() + READY_WAIT_S
        while not os.path.exists(_ready(out)):
            if time.monotonic() > deadline:
                raise TimeoutError(f"no 2 x 2 checkpoints after {READY_WAIT_S} s")
            time.sleep(0.2)
        on = {m: make_host_mesh(*m, device_type=mesh.device_type) for m in RESTORE_MESHES}
        for (nd, nm), m in on.items():
            for arch in ARCHS:
                got, _ = restore_flow(ckpt_dir(out, arch, CKPT_WORLD), arch, m, axes, device,
                                      f"restored_{nd}x{nm}/", step_after=(nd, nm) == (1, 2))
                res[arch].update(got)
        for arch in ARCHS:
            got, state = restore_flow(ref_ckpt_dir(out, arch), arch, on[RESTORE_MESHES[0]],
                                      axes, device, "ref/", bf16=True)
            res[arch].update(got)
            save_checkpoint(ref_ckpt_dir(out, arch) + "_resaved", state, step=5)
    dist.barrier()
    for arch in ARCHS:
        np.savez(os.path.join(out, f"ckpt_{arch}_w{world}_r{rank}.npz"), **res[arch])


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
        checkpoint_flows(rank, world, out, mesh, MeshAxes(), "cpu")
        with open(os.path.join(out, f"disagree_w{world}_r{rank}.txt"), "w") as fh:
            fh.write(disagreement(rank, mesh))
    finally:
        dist.destroy_process_group()


def disagreement(rank: int, mesh) -> str:
    """A tree every rank holds alike is laid out; then one whose leaf "b"
    rank 0 alone holds otherwise: the error `distribute_tree` raises, or
    "no error"."""
    import torch

    from repro_torch.sharding.rules import distribute_tree

    def tree(b):
        return {"a": torch.arange(8.0).reshape(4, 2), "b": {"c": torch.full((4,), b)}}

    specs = {"a": ("model", None), "b": {"c": (None,)}}
    distribute_tree(tree(1.0), specs, mesh)
    try:
        distribute_tree(tree(float(rank == 0)), specs, mesh)
    except ValueError as e:
        return str(e)
    return "no error"


# ------------------------------------------------------------ on the cards
def _card_world(rank: int, world: int, store: str, backend: str, card: int):
    """This process as rank ``rank`` of ``world`` on ``cuda:card``."""
    import torch
    import torch.distributed as dist

    if torch.cuda.device_count() <= card:
        raise RuntimeError(f"rank {rank} needs card {card}: {torch.cuda.device_count()} found")
    torch.cuda.set_device(card)
    dist.init_process_group(
        backend, init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=CARD_TIMEOUT_S),
    )
    return torch.device("cuda", card)


def run_cards(rank: int, world: int, store: str, out: str, backend: str) -> None:
    """One card a rank (``cuda:rank``) over ``backend``: `compute` of every
    arch on the world's mesh (``cards_<arch>_r<rank>.npz``), then
    `full_width` of FULL_ARCHS on the meshes ``<out>/plan.json`` names
    (``cards_full_<arch>_r<rank>.json``). An error is also written to
    ``cards_error_r<rank>.txt`` with the card's free and allocated bytes
    (the spawning process sees only the exit code)."""
    import traceback

    import torch
    import torch.distributed as dist

    dev = _card_world(rank, world, store, backend, rank)
    try:
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.sharding.rules import MeshAxes

        mesh = make_host_mesh(*MESHES[world], device_type="cuda")
        for arch in ARCHS:
            res = compute(arch, mesh, MeshAxes(), dev)
            again = compute(arch, mesh, MeshAxes(), dev)  # NCCL's order, run to run
            res["repeat_equal"] = np.bool_(all(np.array_equal(res[k], again[k]) for k in res))
            np.savez(os.path.join(out, f"cards_{arch}_r{rank}.npz"), **res)
        with open(os.path.join(out, "plan.json")) as fh:
            plan = json.load(fh)
        for arch in FULL_ARCHS:
            res = full_width(arch, plan[arch], out, dev)
            with open(os.path.join(out, f"cards_full_{arch}_r{rank}.json"), "w") as fh:
                json.dump(res, fh)
    except Exception:
        free, total = torch.cuda.mem_get_info(dev)
        with open(os.path.join(out, f"cards_error_r{rank}.txt"), "w") as fh:
            fh.write(f"{traceback.format_exc()}\ncard {dev}: {free} of {total} B free, "
                     f"{torch.cuda.memory_allocated(dev)} B allocated by this rank\n")
        raise
    finally:
        dist.destroy_process_group()


def run_shared_card(rank: int, world: int, store: str, out: str) -> None:
    """Two NCCL ranks on one card ask for a mesh: each writes the error it
    raised (``shared_r<rank>.txt``), or "no error"."""
    import torch.distributed as dist

    _card_world(rank, world, store, "nccl", 0)
    try:
        from repro_torch.launch.mesh import make_host_mesh

        try:
            make_host_mesh(1, world, device_type="cuda")
            msg = "no error"
        except RuntimeError as e:
            msg = str(e)
        with open(os.path.join(out, f"shared_r{rank}.txt"), "w") as fh:
            fh.write(msg)
    finally:
        dist.destroy_process_group()


def _tempered(params: dict) -> dict:
    for stack in ("blocks", "dense_blocks"):
        for w in ("wq", "wk", "in_proj"):
            if w in params.get(stack, {}):
                params[stack][w] = params[stack][w] * TEMPER
    return params


def _upcast(tree: dict) -> dict:
    """Every leaf of ``tree`` in f32, each replaced in place as it is made."""
    for k, v in tree.items():
        tree[k] = _upcast(v) if isinstance(v, dict) else v.float()
    return tree


def full_config(arch: str, dtype: str | None = None, layers: int | None = None):
    """``arch``'s full CONFIG at its FULL_LAYERS depth (or ``layers``), in
    ``dtype`` if given."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    return dataclasses.replace(cfg, n_layers=layers or FULL_LAYERS.get(arch, cfg.n_layers),
                               dtype=dtype or cfg.dtype)


def _full_batch(cfg, mesh, axes, device):
    return _batch_on_data(_to(_batch(cfg, FULL_BATCH, FULL_SEQ), device), mesh, axes)


def _sync_s(t0: float) -> float:
    import torch

    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _profiled_step(step, state, batch, mesh, axes):
    """One step under `torch.profiler` (device activities): its wall ms, the
    card's busy ms and the ms of NCCL kernels. Returns (state, numbers)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    # (a host without CUDA records host activities only: no device time)
    activity = ProfilerActivity.CUDA if torch.cuda.is_available() else ProfilerActivity.CPU
    with profile(activities=[activity]) as prof:
        t0 = time.perf_counter()
        with _mesh_ctx(mesh, axes):
            state, metrics = step(state, batch)
        float(_whole(metrics["loss"]))
        wall = _sync_s(t0)
    results = prof.profiler.kineto_results
    device = [e for e in (results.events() if results else [])
              if e.device_type() == DeviceType.CUDA]
    nccl = sum(e.duration_ns() for e in device if "nccl" in e.name().lower()) / 1e6
    busy = sum(e.duration_ns() for e in device) / 1e6
    return state, {"wall_ms": wall * 1e3, "busy_ms": busy, "nccl_ms": nccl,
                   "activities": len(device)}


def one_card(params: dict, cfg, device) -> tuple[float, float]:
    """Step 1's loss and gradient norm on one card: `value_and_grad` of
    `lm_loss` (remat, as the train step) on the whole weights ``params`` and
    the batch of `full_width`, with no mesh. The gradients are freed."""
    import torch

    from repro_torch.models.transformer import lm_loss
    from repro_torch.sharding.rules import MeshAxes
    from repro_torch.train.optimizer import global_norm
    from repro_torch.train.train_step import value_and_grad

    batch = _full_batch(cfg, None, MeshAxes(), device)
    loss, _, grads = value_and_grad(lambda p: lm_loss(p, cfg, batch, remat=True), params)
    out = float(loss), float(global_norm(grads))
    del loss, grads
    torch.cuda.empty_cache()
    return out


def full_width(arch: str, plan: dict, out: str, device) -> dict:
    """One of FULL_ARCHS at full width (at its `full_config` depth) on the
    cards of the world: (i) the f32 hold (tempered weights, at its
    HOLD_LAYERS depth): one card's `value_and_grad` (each rank on its own
    card), then the same weights sharded on the plan's mesh; (ii)
    FULL_STEPS bf16 steps from seeded weights laid out by `param_shardings`
    (step 1's loss and gradient norm beside one card's on the same weights,
    `one_card`, in bf16, and upcast to f32 where the arch runs whole: an f32
    copy of a cut llava or moonshot and its gradients would not fit a card;
    each step's host seconds; the peak bytes; one more step profiled);
    (iii) for CKPT_ARCH, the state after step 2 saved, and after the steps
    restored onto the plan's other mesh: each leaf against the saved state
    bit for bit, then step 3 there."""
    import torch

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.transformer import init_params, lm_loss
    from repro_torch.sharding.rules import MeshAxes, param_shardings
    from repro_torch.train.optimizer import OptConfig, adamw_init, global_norm
    from repro_torch.train.train_step import (
        TrainConfig,
        TrainState,
        make_train_step,
        value_and_grad,
    )

    axes = MeshAxes()
    mesh = make_host_mesh(*plan["mesh"], device_type="cuda")
    full = full_config(arch)
    res = {"arch": arch, "mesh": plan["mesh"], "device": torch.cuda.get_device_name(device),
           "layers": full.n_layers}

    # (i) the f32 hold
    cfg32 = full_config(arch, "float32", HOLD_LAYERS.get(arch))
    params = _tempered(init_params(cfg32, torch.Generator(device=device).manual_seed(SEED),
                                   device))
    torch.cuda.reset_peak_memory_stats(device)
    for where, m in (("one_card", None), ("sharded", mesh)):
        if m is not None:
            # the one-card pass's cached blocks back to the card first: the
            # mesh's NCCL communicators allocate their buffers outside the
            # allocator when first used, here
            torch.cuda.empty_cache()
            params = param_shardings(params, m, axes)
        batch = _full_batch(cfg32, m, axes, device)
        with _mesh_ctx(m, axes):
            loss, _, grads = value_and_grad(lambda p: lm_loss(p, cfg32, batch), params)
            gnorm = global_norm(grads)
        res[f"f32_{where}_loss"] = float(_whole(loss))
        res[f"f32_{where}_grad_norm"] = float(_whole(gnorm))
        if m is None:
            res["f32_one_card_peak_bytes"] = torch.cuda.max_memory_allocated(device)
        del loss, grads, gnorm
    res["f32_layers"] = cfg32.n_layers
    del params
    torch.cuda.empty_cache()

    # (ii) bf16 training; first step 1 on one card, on the weights upcast to
    # f32 (bf16's own error is their gap; where the arch runs whole) and as
    # drawn
    held = torch.cuda.memory_allocated(device)
    if arch not in FULL_LAYERS:
        params = _upcast(init_params(full, torch.Generator(device=device).manual_seed(SEED),
                                     device))
        torch.cuda.empty_cache()  # the bf16 leaves' blocks, before the f32 gradients
        res["f32_one_card_bf16_weights_loss"], res["f32_one_card_bf16_weights_grad_norm"] = (
            one_card(params, dataclasses.replace(full, dtype="float32"), device))
        del params
    params = init_params(full, torch.Generator(device=device).manual_seed(SEED), device)
    res["bf16_one_card_loss"], res["bf16_one_card_grad_norm"] = one_card(params, full, device)
    torch.cuda.reset_peak_memory_stats(device)
    params = param_shardings(params, mesh, axes)  # each whole leaf freed once laid out
    oc = OptConfig(**FULL_OPT)
    state = TrainState(params, adamw_init(params, oc))
    del params
    batch = _full_batch(full, mesh, axes, device)
    res["setup_peak_bytes"] = torch.cuda.max_memory_allocated(device)
    res["held_before_bytes"] = held
    res["state_bytes"] = torch.cuda.memory_allocated(device) - held
    step = make_train_step(full, oc, TrainConfig(remat=True))
    losses, gnorms, step_s, peaks = [], [], [], []
    saved = None
    for i in range(1, FULL_STEPS + 1):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        with _mesh_ctx(mesh, axes):
            state, metrics = step(state, batch)
        losses.append(float(_whole(metrics["loss"])))
        gnorms.append(float(_whole(metrics["grad_norm"])))
        step_s.append(_sync_s(t0))
        peaks.append(torch.cuda.max_memory_allocated(device))
        if i == 2 and arch == CKPT_ARCH:
            from repro_torch.train.checkpoint import save_checkpoint

            path = os.path.join(out, f"ckpt_{arch}")
            t0 = time.perf_counter()
            save_checkpoint(path, state, step=2, extra={"arch": arch})
            res["save_s"] = _sync_s(t0)
            res["ckpt_bytes"] = os.path.getsize(os.path.join(path, "ckpt.npz"))
            saved = state
    res.update(losses=losses, grad_norms=gnorms, step_s=step_s, peak_bytes=peaks)
    state, res["profiled"] = _profiled_step(step, state, batch, mesh, axes)
    del state, batch
    torch.cuda.empty_cache()

    # (iii) the checkpoint onto the other mesh
    if saved is not None:
        from repro_torch.sharding.rules import state_shardings
        from repro_torch.train.checkpoint import _flatten, restore_checkpoint

        other = make_host_mesh(*plan["other_mesh"], device_type="cuda")
        meta = init_params(full, None, "meta")
        like = TrainState(meta, adamw_init(meta, oc))
        t0 = time.perf_counter()
        restored, at = restore_checkpoint(path, like, state_shardings(like, other, axes))
        res["restore_s"] = _sync_s(t0)
        res["restored_at"] = at
        unequal = [k for (k, a), (_, b) in zip(_flatten(restored), _flatten(saved))
                   if not (a.dtype == b.dtype and torch.equal(_whole(a), _whole(b)))]
        res["restored_unequal"] = unequal
        res["restored_sharded_leaves"] = sum(
            any(p.is_shard() for p in leaf.placements) for _, leaf in _flatten(restored))
        del saved
        torch.cuda.empty_cache()
        with _mesh_ctx(other, axes):
            _, metrics = step(restored, _full_batch(full, other, axes, device))
        res["restored_step_loss"] = float(_whole(metrics["loss"]))
        del restored
        torch.cuda.empty_cache()
    return res


def dry_run(arch: str, mesh: tuple[int, int], layers: list[int]) -> dict[int, dict]:
    """The dry run of a FULL_BATCH x FULL_SEQ bf16 step of ``arch`` at full
    width on ``mesh`` at each depth of ``layers``
    (`chip_smoke.train_peak_reckoned`, one host process a depth, started
    together): depth -> its per-device peak, FLOPs and collectives."""
    import subprocess
    import sys

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"), OMP_NUM_THREADS="1")
    procs = {
        n: subprocess.Popen(
            [sys.executable, "-c", "import chip_smoke; chip_smoke.train_peak_reckoned("
             f"{arch!r}, {tuple(mesh)!r}, {n})"], cwd=root, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        for n in layers
    }
    found = {}
    for n, proc in procs.items():
        got, err = proc.communicate(timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"dry run of {arch} at {n} layers failed:\n{err[-2000:]}")
        found[n] = json.loads(got.strip().splitlines()[-1])
    return found


def _largest_under(peaks: dict[int, float], limit: float) -> int:
    """The largest depth under ``limit`` on the line through the peaks at the
    least and the most of their depths (a layer adds its weights, state and
    remat input alike)."""
    lo, hi = min(peaks), max(peaks)
    per_layer = (peaks[hi] - peaks[lo]) / (hi - lo)
    return lo + int((limit - peaks[lo]) // per_layer)


def full_depth_reckoned(arch: str, mesh: tuple[int, int] = (2, 2)) -> dict:
    """FULL_LAYERS' reckoning for ``arch`` (on the host, no card needed,
    with the torch the cards run): the dry-run peaks a card at MIN_LAYERS and twice that
    put on a line, the depth where the line meets FULL_PEAK_LIMIT checked by
    dry runs at it and one layer above. Returns the depth chosen (the
    largest checked under the limit, at least MIN_LAYERS) and every peak
    seen."""
    peaks = {n: c["peak"] for n, c in dry_run(arch, mesh, [MIN_LAYERS, 2 * MIN_LAYERS]).items()}
    guess = max(MIN_LAYERS, _largest_under(peaks, FULL_PEAK_LIMIT))
    peaks.update({n: c["peak"] for n, c in dry_run(arch, mesh, [guess, guess + 1]).items()})
    under = [n for n, p in peaks.items() if p <= FULL_PEAK_LIMIT]
    return {"arch": arch, "mesh": list(mesh), "layers": max([MIN_LAYERS] + under),
            "peaks": {str(n): peaks[n] for n in sorted(peaks)}}


def _hold_peak(arch: str, layers: int, device) -> int:
    """The peak bytes of one card's f32 `value_and_grad` of ``arch`` at
    ``layers`` (tempered weights, the full-width batch), from an empty card."""
    import torch

    from repro_torch.models.transformer import init_params

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    cfg = full_config(arch, "float32", layers)
    try:
        params = _tempered(init_params(cfg, torch.Generator(device=device).manual_seed(SEED),
                                       device))
        one_card(params, cfg, device)
        peak = torch.cuda.max_memory_allocated(device)
    except torch.cuda.OutOfMemoryError:  # past the card: past any limit
        peak = torch.cuda.get_device_properties(device).total_memory
    params = None
    torch.cuda.empty_cache()
    return peak


def hold_depth_reckoned(arch: str, device) -> dict:
    """HOLD_LAYERS' reckoning for ``arch`` on one card: the f32 hold's peak
    at 2 and 4 layers put on a line, the depth where it meets
    HOLD_PEAK_LIMIT run, and one layer fewer while that peaks over it.
    Returns the depth and every peak seen. Run by hand on a card:
    ``python3 -c "import sys, torch; sys.path[:0] = ['src', 'tests']; import
    torch_lm_shard_ranks as r; print(r.hold_depth_reckoned('llava-next-34b',
    torch.device('cuda', 0)))"``."""
    peaks = {n: _hold_peak(arch, n, device) for n in (2, 4)}
    depth = _largest_under(peaks, HOLD_PEAK_LIMIT)
    while depth > 1:
        peaks[depth] = _hold_peak(arch, depth, device)
        if peaks[depth] <= HOLD_PEAK_LIMIT:
            break
        depth -= 1
    return {"arch": arch, "layers": depth, "peaks": {str(n): peaks[n] for n in sorted(peaks)}}


def sensitivity(arch: str, device) -> list[dict]:
    """How far a reduction-order difference can move step 1 of ``arch`` at
    full width and depth in f32 on one card, tempered (as the f32 hold) and
    as drawn: `one_card` before and after the embedding is scaled by 1 +
    1e-7 of seeded noise. Returns both cases' numbers and peak bytes. Run by
    hand on a card: ``python3 -c "import sys, torch; sys.path[:0] = ['src',
    'tests']; import torch_lm_shard_ranks as r; print(r.sensitivity(
    'olmoe-1b-7b', torch.device('cuda', 0)))"``."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params

    cfg32 = dataclasses.replace(get_config(arch), dtype="float32")
    found = []
    for tempered in (True, False):
        p = init_params(cfg32, torch.Generator(device=device).manual_seed(SEED), device)
        if tempered:
            p = _tempered(p)
        base = one_card(p, cfg32, device)
        noise = torch.randn(p["embed"].shape, generator=torch.Generator(
            device=device).manual_seed(1), device=device)
        p["embed"] = p["embed"] * (1 + 1e-7 * noise)
        del noise
        nudged = one_card(p, cfg32, device)
        found.append({"tempered": tempered, "base": base, "nudged": nudged,
                      "loss_rel": abs(base[0] - nudged[0]) / abs(base[0]),
                      "gnorm_rel": abs(base[1] - nudged[1]) / abs(base[1]),
                      "peak": torch.cuda.max_memory_allocated(device)})
        del p
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    return found


def card_of_one(out: str, device) -> dict:
    """`chip_smoke.py` phase 16 in its own process group: a world of one over
    NCCL on ``device``, a 1 x 1 mesh of the card. Every arch's `compute` on
    the mesh held against no mesh; then each arch's state after one step on
    the mesh saved (the sharded save), restored with its `state_shardings`
    onto the mesh and with none (whole leaves on the card), both bit for bit
    the saved state, and one more step from the restored state against the
    same step from the saved one. Returns the largest gaps."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding.rules import MeshAxes
    from repro_torch.train.checkpoint import _flatten, restore_checkpoint, save_checkpoint

    if dist.is_initialized():
        raise RuntimeError("card_of_one makes its own process group")
    _card_world(0, 1, os.path.join(out, "store"), "nccl", device.index or 0)
    axes = MeshAxes()
    gaps = {"decode": 0.0, "restored_step": 0.0}
    try:
        mesh = make_host_mesh(1, 1, device_type="cuda")
        for arch in ARCHS:
            want = compute(arch, device=device)
            got = compute(arch, mesh, axes, device)
            floor = max(TOL, f32_floor(arch, device))
            gaps["decode"] = max(gaps["decode"], check_against_one_rank(
                got, want, floor, f"{arch} on a 1 x 1 card mesh"))
            state, step, batch = _trained(arch, mesh, axes, device)
            path = ckpt_dir(out, arch, 1)
            save_checkpoint(path, state, step=1)
            saved = _state_leaves(state, "")
            sharded, back = restore_flow(path, arch, mesh, axes, device, "")
            if sharded["misplaced"]:
                raise AssertionError(f"{arch}: {sharded['misplaced']} leaves restored off "
                                     "their layout")
            plain, _ = restore_checkpoint(path, _meta_state(arch), device=device)
            for k, a in saved.items():
                whole = _full(dict(_flatten(plain))[k])
                if not (np.array_equal(sharded[k], a) and np.array_equal(whole, a)
                        and whole.dtype == a.dtype):
                    raise AssertionError(f"{arch}: {k} restored unequal to the saved leaf")
            ahead = _stepped(step, state, batch, mesh, axes, "")
            again = _stepped(step, back, batch, mesh, axes, "")
            gap = max(float(np.max(np.abs(ahead[k] - again[k]))) for k in ahead)
            gaps["restored_step"] = max(gaps["restored_step"], gap)
            if gap > TOL:
                raise AssertionError(f"{arch}: the step from the restored state is {gap} off")
            del state, back, plain
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    return gaps
