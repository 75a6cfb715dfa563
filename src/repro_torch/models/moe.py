"""Token-choice top-k MoE with GROUPED capacity-bounded dispatch (GShard-style).

Counterpart of `repro.models.moe`. Tokens are processed in groups (one group
per sequence): routing ranks and capacity C = ceil(group_tokens * k / E *
capacity_factor) are computed within each group, and the scatter into
per-expert buffers is a batched per-group scatter. Overflowing assignments
are dropped (Switch/GShard semantics); the residual stream carries them
unchanged. The expert matmuls run over every expert's C slots, so a decode
step (one token a group, C = 8) reads every expert's weights.

Routing ties: the reference's ``lax.top_k`` puts the lower expert index
first among equal logits, and router logits are rounded to the model dtype
before the f32 cast, so ties are common in bf16. ``torch.topk`` promises no
order among ties, so `route` takes the first k of a stable descending sort,
which orders ties by index as the reference does. The order matters beyond
which experts are chosen: the dispatch ranks (and so which assignment is
dropped at capacity) and the aux loss's ``ids[..., 0]`` follow it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.sharding.rules import (
    P,
    activation_spec,
    constrain_act,
    current_mesh_axes,
    fit_spec,
    on_shards,
)

Tensor = torch.Tensor


def moe_capacity(group_tokens: int, n_experts: int, top_k: int, capacity_factor: float) -> int:
    cap = int(group_tokens * top_k * capacity_factor / n_experts)
    return max(8, -(-cap // 8) * 8)  # round up to 8 (the reference's TPU-friendly shapes)


def route(router_logits: Tensor, top_k: int) -> tuple[Tensor, Tensor]:
    """(..., E) logits -> (..., k) expert ids + normalized weights."""
    vals, ids = torch.sort(router_logits, dim=-1, descending=True, stable=True)
    weights = torch.softmax(vals[..., :top_k].float(), dim=-1)
    return ids[..., :top_k], weights


def dispatch_indices(
    expert_ids: Tensor,  # (G, A) flattened assignments per group
    n_experts: int,
    capacity: int,
) -> tuple[Tensor, Tensor]:
    """Per-assignment (slot index, keep mask) under per-group expert capacity.

    Rank within (group, expert) in assignment order via a one-hot cumsum:
    integer, so deterministic on the card as on the host.
    """
    ids = expert_ids.long()
    onehot = F.one_hot(ids, n_experts).to(torch.int32)  # (G, A, E)
    ranks = torch.cumsum(onehot, dim=1, dtype=torch.int32) - 1
    rank = torch.gather(ranks, 2, ids[..., None])[..., 0]
    keep = rank < capacity
    slot = ids * capacity + torch.clamp(rank, max=capacity - 1)
    return slot, keep


def _dispatch(x: Tensor, router_w: Tensor, top_k: int, C: int):
    """Route each group's tokens and scatter them into the expert buffers:
    (buf (G, E, C, d), logits, ids, weights, slot, keep)."""
    G, N, d = x.shape
    E = router_w.shape[1]
    logits = torch.einsum("gnd,de->gne", x, router_w.to(x.dtype)).float()
    ids, weights = route(logits, top_k)  # (G,N,k)

    flat_ids = ids.reshape(G, N * top_k)
    slot, keep = dispatch_indices(flat_ids, E, C)  # (G, N*k)
    slot = torch.where(keep, slot, E * C)  # dropped -> a discarded extra row

    x_rep = torch.repeat_interleave(x, top_k, dim=1)  # (G, N*k, d)
    # kept slots are unique, so a plain scatter writes what the reference's
    # add into zeros does; every dropped assignment lands on the discarded extra row
    buf = torch.zeros((G, E * C + 1, d), dtype=x.dtype, device=x.device)
    buf.scatter_(1, slot[..., None].expand(G, N * top_k, d), x_rep)
    return buf[:, : E * C].reshape(G, E, C, d), logits, ids, weights, slot, keep


def _experts(buf: Tensor, w_gate: Tensor, w_up: Tensor, w_down: Tensor, dtype) -> Tensor:
    """Every expert's SwiGLU over its buffer: (G, E, C, d) -> (G, E, C, d)."""
    g = torch.einsum("gecd,edf->gecf", buf, w_gate.to(dtype))
    u = torch.einsum("gecd,edf->gecf", buf, w_up.to(dtype))
    return torch.einsum("gecf,efd->gecd", F.silu(g) * u, w_down.to(dtype))


def _combine(y: Tensor, slot: Tensor, keep: Tensor, weights: Tensor, top_k: int) -> Tensor:
    """Each assignment's expert output, router-weighted, summed per token:
    y (G, E*C, d) -> (G, N, d)."""
    G, EC, d = y.shape
    safe_slot = torch.clamp(slot, 0, EC - 1)
    gathered = torch.gather(y, 1, safe_slot[..., None].expand(G, slot.shape[1], d))
    gathered = gathered.masked_fill(~keep[..., None], 0)
    return torch.sum(
        gathered.reshape(G, -1, top_k, d) * weights[..., None].to(y.dtype), dim=2
    )


def moe_block(
    x: Tensor,  # (G, N, d) grouped tokens (group = sequence)
    router_w: Tensor,  # (d, E)
    w_gate: Tensor,  # (E, d, ff)
    w_up: Tensor,  # (E, d, ff)
    w_down: Tensor,  # (E, ff, d)
    top_k: int,
    capacity_factor: float,
) -> tuple[Tensor, Tensor]:
    """Returns (output (G, N, d), aux load-balancing loss scalar).

    Under a mesh the routing, the scatter into the buffers and the combine
    run on each rank's groups (groups over the data axes, the rest whole:
    their sorts, scatters and gathers are per group); the expert matmuls
    run on the buffers laid out as ``"moe_buf"`` (experts over ``model``),
    each rank with its experts' whole weights."""
    G, N, d = x.shape
    E = router_w.shape[1]
    C = moe_capacity(N, E, top_k, capacity_factor)
    ctx = current_mesh_axes()
    grp = fit_spec(x.shape, P(ctx[1].data)) if ctx else None
    buf, logits, ids, weights, slot, keep = on_shards(
        lambda xs, rw: _dispatch(xs, rw, top_k, C), (x, router_w), (grp, P()),
        (grp,) * 6)
    buf = constrain_act(buf, "moe_buf")

    # expert SwiGLU (grouped matmuls); under a mesh on each rank's groups
    # and experts, every expert's weights whole
    bs = fit_spec(buf.shape, activation_spec("moe_buf", ctx[1])) if ctx else None
    ws = fit_spec(w_gate.shape, P(ctx[1].model)) if ctx else None
    y = on_shards(lambda b, wg, wu, wd: _experts(b, wg, wu, wd, x.dtype),
                  (buf, w_gate, w_up, w_down), (bs, ws, ws, ws), bs)
    y = constrain_act(y, "moe_buf").reshape(G, E * C, d)

    # combine: batched gather of each assignment's output, router-weighted
    combined = on_shards(lambda *a: _combine(*a, top_k), (y, slot, keep, weights),
                         (grp,) * 4, grp)

    # Switch-style load-balance aux loss
    probs = torch.softmax(logits, dim=-1)  # (G,N,E)
    frac_tokens = torch.mean(F.one_hot(ids[..., 0], E).float(), dim=(0, 1))
    frac_probs = torch.mean(probs, dim=(0, 1))
    aux = E * torch.sum(frac_tokens * frac_probs)
    return combined.to(x.dtype), aux
