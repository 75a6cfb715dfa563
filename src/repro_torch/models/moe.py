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


def moe_block(
    x: Tensor,  # (G, N, d) grouped tokens (group = sequence)
    router_w: Tensor,  # (d, E)
    w_gate: Tensor,  # (E, d, ff)
    w_up: Tensor,  # (E, d, ff)
    w_down: Tensor,  # (E, ff, d)
    top_k: int,
    capacity_factor: float,
) -> tuple[Tensor, Tensor]:
    """Returns (output (G, N, d), aux load-balancing loss scalar)."""
    G, N, d = x.shape
    E = router_w.shape[1]
    C = moe_capacity(N, E, top_k, capacity_factor)
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
    buf = buf[:, : E * C].reshape(G, E, C, d)

    # expert SwiGLU (grouped matmuls)
    g = torch.einsum("gecd,edf->gecf", buf, w_gate.to(x.dtype))
    u = torch.einsum("gecd,edf->gecf", buf, w_up.to(x.dtype))
    y = torch.einsum("gecf,efd->gecd", F.silu(g) * u, w_down.to(x.dtype))
    y = y.reshape(G, E * C, d)

    # combine: batched gather of each assignment's output, router-weighted
    safe_slot = torch.clamp(slot, 0, E * C - 1)
    gathered = torch.gather(y, 1, safe_slot[..., None].expand(G, N * top_k, d))  # (G, N*k, d)
    gathered = gathered.masked_fill(~keep[..., None], 0)
    combined = torch.sum(
        gathered.reshape(G, N, top_k, d) * weights[..., None].to(x.dtype), dim=2
    )

    # Switch-style load-balance aux loss
    probs = torch.softmax(logits, dim=-1)  # (G,N,E)
    frac_tokens = torch.mean(F.one_hot(ids[..., 0], E).float(), dim=(0, 1))
    frac_probs = torch.mean(probs, dim=(0, 1))
    aux = E * torch.sum(frac_tokens * frac_probs)
    return combined.to(x.dtype), aux
