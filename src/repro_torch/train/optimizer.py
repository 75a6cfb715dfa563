"""AdamW with cosine or WSD (Warmup-Stable-Decay, MiniCPM) schedules.

Counterpart of `repro.train.optimizer`. The update is the reference's
formula transcribed op for op in f32 and cast back to each leaf's dtype
(bf16 weights have no f32 master copy, as there); not ``torch.optim.AdamW``,
which decays before the step and divides by ``sqrt(v)/sqrt(bc2) + eps``.
Every float leaf gets the gradient step and the weight decay, norms
included. Trees are walked in sorted-key order, JAX's leaf order, so the
global norm sums its per-leaf f32 sums in the reference's order.

Optimizer state dtype is configurable: f32 moments by default; ``m_dtype`` /
``v_dtype`` can be bf16 for memory-constrained runs.

Sharded leaves (DTensors, under `repro_torch.sharding`'s mesh): the moments
take each parameter's layout and the step count is replicated on their mesh
(`sharding.state_shardings`, the layout a restored checkpoint takes), the
global norm sums every shard (its f32 sums are all-reduced), and the
elementwise update runs on each rank's local shard, its gradient first laid
out as its parameter.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import torch
from torch.distributed.tensor import DTensor, Replicate

Tensor = torch.Tensor

# elements a leaf is updated in at a time: elementwise f32 arithmetic gives
# the same bits in any split, and the f32 temporaries of a large stacked
# leaf (an MoE expert stack) stay within a few of these chunks
UPDATE_CHUNK = 1 << 25


@dataclasses.dataclass(frozen=True)
class OptConfig:
    peak_lr: float = 3e-4
    min_lr_ratio: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"  # cosine | wsd | constant
    wsd_decay_frac: float = 0.1  # WSD: fraction of steps in final decay
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0  # 0 = no clipping
    m_dtype: str = "float32"
    v_dtype: str = "float32"


class AdamWState(NamedTuple):
    step: Tensor  # () int32
    m: Any  # tree like params
    v: Any


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of nested dicts (and of the trees ``rest`` of
    the same structure), keeping the first tree's key order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    """The leaves of nested dicts (sorted-key order) and tuples, JAX's flatten order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, tuple):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def lr_at(cfg: OptConfig, step: Tensor) -> Tensor:
    """The learning rate at ``step`` (a tensor), in f32; 0 at step 0."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    if cfg.schedule == "cosine":
        decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
    elif cfg.schedule == "wsd":
        # stable at peak until the final decay_frac, then linear to min
        decay_start = 1.0 - cfg.wsd_decay_frac
        frac = torch.clamp((t - decay_start) / cfg.wsd_decay_frac, 0.0, 1.0)
        decay = 1.0 - (1.0 - cfg.min_lr_ratio) * frac
    elif cfg.schedule == "constant":
        decay = torch.ones_like(t)
    else:
        raise ValueError(cfg.schedule)
    return cfg.peak_lr * warm * decay


def adamw_init(params: Any, cfg: OptConfig) -> AdamWState:
    def zeros(dt: str):
        # zeros_like keeps a sharded leaf's layout (and a plain leaf's device)
        return tree_map(lambda p: torch.zeros_like(p, dtype=getattr(torch, dt),
                                                   memory_format=torch.contiguous_format),
                        params)

    leaf = tree_leaves(params)[0]
    if isinstance(leaf, DTensor):  # sharded params: the count replicated on their mesh
        mesh = leaf.device_mesh
        step = DTensor.from_local(
            torch.zeros((), dtype=torch.int32, device=leaf.to_local().device), mesh,
            [Replicate()] * mesh.ndim, run_check=False)
    else:
        step = torch.zeros((), dtype=torch.int32, device=leaf.device)
    return AdamWState(step=step, m=zeros(cfg.m_dtype), v=zeros(cfg.v_dtype))


def global_norm(tree: Any) -> Tensor:
    """sqrt of the sum of every leaf's f32 sum of squares, leaves in sorted-key order."""
    total = 0
    for x in tree_leaves(tree):
        total = total + torch.sum(x.float() ** 2)
    return torch.sqrt(total)


def _upd(p, g, m, v, scale, lr, bc1, bc2, cfg: OptConfig):
    """The reference's per-leaf update, in f32, on flat slices."""
    b1, b2 = cfg.b1, cfg.b2
    g = g.float() * scale
    m_new = b1 * m.float() + (1 - b1) * g
    v_new = b2 * v.float() + (1 - b2) * g * g
    del g
    mhat = m_new / bc1
    vhat = v_new / bc2
    delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p.float()
    del mhat, vhat
    p_new = p.float() - lr * delta
    return p_new, m_new, v_new


@torch.no_grad()
def adamw_update(
    params: Any, grads: Any, state: AdamWState, cfg: OptConfig
) -> tuple[Any, AdamWState, dict]:
    """One AdamW step. Returns (new params, new state, {"grad_norm", "lr"});
    the inputs are left as they were."""
    count = state.step.to_local() if isinstance(state.step, DTensor) else state.step
    step = count + 1
    gnorm = global_norm(grads)
    scale = (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
             if cfg.grad_clip else 1.0)
    lr = lr_at(cfg, step)
    stepf = step.to(torch.float32)
    bc1 = 1 - cfg.b1 ** stepf
    bc2 = 1 - cfg.b2 ** stepf

    def upd(p, g, m, v):
        if isinstance(p, DTensor):
            return _upd_sharded(upd, p, g, m, v)
        outs = (torch.empty_like(p), torch.empty_like(m), torch.empty_like(v))
        flat = [t.reshape(-1) for t in (p, g, m, v)]
        views = [o.view(-1) for o in outs]
        for lo in range(0, flat[0].numel(), UPDATE_CHUNK):
            sl = slice(lo, lo + UPDATE_CHUNK)
            new = _upd(*(t[sl] for t in flat), scale, lr, bc1, bc2, cfg)
            for out, val in zip(views, new):
                out[sl] = val
        return outs

    if isinstance(gnorm, DTensor):
        # the update runs on local shards: the replicated scalars as plain ones
        gnorm_r = gnorm.full_tensor()
        scale = scale.full_tensor() if isinstance(scale, DTensor) else scale
    out = tree_map(upd, params, grads, state.m, state.v)
    if isinstance(gnorm, DTensor):
        gnorm = gnorm_r
    pick = lambda i: tree_map(lambda t: t[i], out)  # noqa: E731
    new_step = step
    if isinstance(state.step, DTensor):
        new_step = DTensor.from_local(step, state.step.device_mesh, state.step.placements,
                                      run_check=False)
    return pick(0), AdamWState(new_step, pick(1), pick(2)), {"grad_norm": gnorm, "lr": lr}


def _upd_sharded(upd, p, g, m, v):
    """`adamw_update`'s leaf update of a DTensor leaf: on the local shards,
    the gradient laid out as the parameter first."""
    if tuple(g.placements) != tuple(p.placements):
        g = g.redistribute(p.device_mesh, p.placements)
    outs = upd(p.to_local(), g.to_local(), m.to_local(), v.to_local())
    return tuple(DTensor.from_local(o, p.device_mesh, p.placements, run_check=False,
                                    shape=p.shape, stride=p.stride()) for o in outs)
