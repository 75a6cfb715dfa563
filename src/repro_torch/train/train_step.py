"""Training steps: standard fwd/bwd/update, and the paper-adapted MVS step.

Counterpart of `repro.train.train_step`. `make_train_step` builds the step
used by the trainer: ``torch.autograd.grad`` of `lm_loss` (each block
checkpointed with ``remat``) with respect to every parameter leaf, then the
AdamW update. Under a mesh (`repro_torch.sharding.set_mesh_context`, the
state laid out by `sharding.param_shardings` and `adamw_init`, or restored
with `sharding.state_shardings`) the same step runs as one program on every
rank, its sharding constraints in the models.

`make_mvs_train_step` is the paper's technique transplanted to LM training:
a cheap forward pass yields per-sequence losses; sequences are
Poisson-sampled with p_i ∝ ĝ_i = sqrt(g_i² + λh_i²) (paper eq. 9, with the
per-sequence loss as g and its square as the h proxy), kept sequences are
reweighted 1/p_i, and the masked batch is used for the (expensive) fwd+bwd —
shrinking the effective working set exactly the way Alg. 7 compacts ELLPACK
pages. The threshold comes from `repro_torch.core.sampling.mvs_threshold`,
whose sums have the same bits on every call on the card. The uniforms of the
draw are an argument of the step: its caller draws them from an explicit
`torch.Generator` (``torch.rand(B, generator=g)``), or passes the
reference's own.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.core.sampling import mvs_threshold
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import forward, init_params, lm_loss, next_token_nll
from repro_torch.train.optimizer import (
    AdamWState,
    OptConfig,
    adamw_init,
    adamw_update,
    tree_leaves,
    tree_map,
)

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The step's options. ``unroll_layers`` is kept for parity with the
    reference, where it unrolls the layer scan in Python; the port's layer
    loop is already Python, so it has no effect here."""

    remat: bool = True
    unroll_layers: bool = False
    mvs_f: float = 1.0  # sequence sampling ratio (1.0 = off)
    mvs_lambda: float = 1.0


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState


def init_state(cfg: ModelConfig, opt_cfg: OptConfig, generator: torch.Generator | None,
               device: str | torch.device) -> TrainState:
    """Random weights from ``generator`` on ``device`` (see `init_params`)
    and a zero optimizer state."""
    params = init_params(cfg, generator, device)
    return TrainState(params=params, opt=adamw_init(params, opt_cfg))


def value_and_grad(loss_fn, params: dict):
    """(loss, metrics) of ``loss_fn(params)`` and its gradient, a tree like
    ``params``."""
    p = tree_map(lambda t: t.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss, metrics = loss_fn(p)
        leaves = tree_leaves(p)
        grads = torch.autograd.grad(loss, leaves)
    by_id = {id(t): _as_param(g, t) for t, g in zip(leaves, grads)}
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, tree_map(lambda t: by_id[id(t)], p)


def _as_param(g: Tensor, p: Tensor) -> Tensor:
    """A sharded gradient laid out as its parameter (a partial sum reduced)."""
    if isinstance(g, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def make_train_step(cfg: ModelConfig, opt_cfg: OptConfig, tc: TrainConfig = TrainConfig()):
    """Returns step(state, batch) -> (state, metrics); metrics hold ``loss``,
    ``nll``, ``moe_aux``, ``grad_norm`` and ``lr`` as 0-d tensors."""

    def step(state: TrainState, batch: dict):
        loss, metrics, grads = value_and_grad(
            lambda p: lm_loss(p, cfg, batch, remat=tc.remat), state.params)
        params, opt, opt_metrics = adamw_update(state.params, grads, state.opt, opt_cfg)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return TrainState(params, opt), metrics

    return step


@torch.no_grad()
def sequence_losses(params, cfg: ModelConfig, batch: dict) -> Tensor:
    """Cheap forward: per-sequence mean NLL (the gradient-magnitude proxy)."""
    logits, _ = forward(params, cfg, batch, remat=False)
    nll = next_token_nll(logits, cfg, batch)
    return torch.mean(nll, dim=tuple(range(1, nll.ndim)))


def mvs_sequence_mask(uniforms: Tensor, seq_loss: Tensor, f: float, lam: float):
    """Paper eq. 9 over sequences: ĝ = sqrt(g² + λ h²), g = seq loss, h = g²-proxy.
    Sequence i is kept where ``uniforms[i] < p_i``. Returns (keep, weight)."""
    g = seq_loss
    h = seq_loss * seq_loss
    g_hat = torch.sqrt(g * g + lam * h * h)
    mu = mvs_threshold(g_hat, f * g.shape[0])
    p = torch.clamp(g_hat / torch.clamp(mu, min=1e-30), 0.0, 1.0)
    keep = uniforms.to(p.device) < p
    weight = torch.where(keep, 1.0 / torch.clamp(p, min=1e-12), 0.0)
    return keep, weight


def make_mvs_train_step(cfg: ModelConfig, opt_cfg: OptConfig, tc: TrainConfig):
    """Gradient-based sequence-sampled training step (paper Alg. 7 for LMs):
    step(state, batch, uniforms) -> (state, metrics), ``uniforms`` the
    batch's (B,) draws; metrics hold ``loss``, ``nll``, ``kept``,
    ``grad_norm`` and ``lr``. Like the reference it reads ``batch["tokens"]``
    only, so codebook and vision configs are refused."""
    if not 0.0 < tc.mvs_f <= 1.0:
        raise ValueError(f"mvs_f must lie in (0, 1], got {tc.mvs_f}")
    if cfg.n_codebooks or cfg.frontend == "vision":
        raise ValueError(f"{cfg.name}: the MVS step trains on text tokens only, not "
                         f"{'codebook' if cfg.n_codebooks else 'vision'} inputs")

    def step(state: TrainState, batch: dict, uniforms: Tensor):
        seq_loss = sequence_losses(state.params, cfg, batch)
        keep, weight = mvs_sequence_mask(uniforms, seq_loss, tc.mvs_f, tc.mvs_lambda)

        def loss_fn(p):
            logits, aux = forward(p, cfg, batch, remat=tc.remat)
            per_seq = torch.mean(next_token_nll(logits, cfg, batch), dim=1)
            loss = torch.sum(per_seq * weight) / torch.clamp(torch.sum(weight), min=1e-6)
            return loss + 0.01 * aux, {"nll": loss, "kept": torch.mean(keep.float())}

        loss, metrics, grads = value_and_grad(loss_fn, state.params)
        params, opt, opt_metrics = adamw_update(state.params, grads, state.opt, opt_cfg)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return TrainState(params, opt), metrics

    return step
