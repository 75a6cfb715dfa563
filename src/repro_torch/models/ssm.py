"""Mamba-2 SSD (state-space duality) layer: chunked scan + O(1)-state decode.

Counterpart of `repro.models.ssm`, after the minimal SSD formulation (Dao &
Gu 2024, arXiv:2405.21060): within each chunk of length Q the output is a
masked quadratic form (attention-like); across chunks a low-rank state
(heads, head_dim, state) is carried by a recurrence, here a loop over the
chunks. Prefill uses `ssd_scan`; decode uses `ssd_decode_step`, one
recurrent state update per token. Contractions whose reference asks for an
f32 result take f32 inputs (an exact cast).

Parameter layout per layer (n_groups = 1):
  in_proj : (d, 2*d_inner + 2*state + heads)   -> z, x, B, C, dt
  conv_w  : (conv_width, d_inner + 2*state)    causal depthwise conv
  A_log   : (heads,)   dt_bias : (heads,)   D : (heads,)
  norm_w  : (d_inner,)  (gated RMSNorm)      out_proj : (d_inner, d)
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


class SSMState(NamedTuple):
    conv: Tensor  # (B, conv_width-1, d_inner + 2*state) rolling conv inputs
    ssm: Tensor  # (B, heads, head_dim, state)


def _segsum(x: Tensor) -> Tensor:
    """log-space segment sums: out[..., i, j] = sum_{k in (j, i]} x[..., k]."""
    T = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=x.device), 0)
    return torch.where(mask, out, -torch.inf)


def ssd_scan(
    xbc: Tensor,  # (B, S, d_inner + 2*state) post-conv activations
    dt: Tensor,  # (B, S, H) softplus'd step sizes, f32
    A: Tensor,  # (H,) negative decay rates, f32
    d_inner: int,
    n_state: int,
    head_dim: int,
    chunk: int,
    initial_state: Tensor | None = None,
) -> tuple[Tensor, Tensor]:
    """Chunked SSD. Returns (y (B,S,d_inner) f32, final_state (B,H,P,N) f32)."""
    Bsz, S, _ = xbc.shape
    H = d_inner // head_dim
    P, N = head_dim, n_state

    x = xbc[..., :d_inner].reshape(Bsz, S, H, P)
    Bmat = xbc[..., d_inner : d_inner + N]  # (B,S,N) single group
    Cmat = xbc[..., d_inner + N :]  # (B,S,N)

    pad = (-S) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        Bmat = F.pad(Bmat, (0, 0, 0, pad))
        Cmat = F.pad(Cmat, (0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
    nC = (S + pad) // chunk
    Q = chunk

    xc = x.reshape(Bsz, nC, Q, H, P)
    Bc = Bmat.reshape(Bsz, nC, Q, N).float()
    Cc = Cmat.reshape(Bsz, nC, Q, N).float()
    dtc = dt.reshape(Bsz, nC, Q, H)

    dA = dtc * A[None, None, None, :]  # (B,nC,Q,H) log decay per step
    dA_cum = torch.cumsum(dA, dim=2)  # within-chunk cumulative

    # ---- intra-chunk (quadratic, attention-like) ----
    L = torch.exp(_segsum(dA.permute(0, 1, 3, 2)))  # (B,nC,H,Q,Q)
    CB = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)
    scores = CB[:, :, None] * L  # (B,nC,H,Q,Q)
    xdt = xc * dtc[..., None]  # weight inputs by dt (f32)
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", scores, xdt.float())

    # ---- chunk states: contribution of each chunk to the carried state ----
    decay_to_end = torch.exp(dA_cum[:, :, -1:, :] - dA_cum)  # (B,nC,Q,H)
    states = torch.einsum(
        "bcqn,bcqh,bcqhp->bchpn", Bc, (dtc * decay_to_end).float(), xc.float()
    )  # (B,nC,H,P,N)

    # ---- inter-chunk recurrence over chunk states ----
    chunk_decay = torch.exp(torch.sum(dA, dim=2))  # (B,nC,H)
    carry = (
        initial_state.float()
        if initial_state is not None
        else torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=xbc.device)
    )
    # state entering chunk c: the carry before step c
    prev = []
    for c in range(nC):
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)  # (B,nC,H,P,N)

    # ---- inter-chunk output: y_off = C @ (decayed prev state) ----
    state_decay = torch.exp(dA_cum)  # decay from chunk start to position q
    y_off = torch.einsum("bcqn,bcqh,bchpn->bcqhp", Cc, state_decay.float(), prev_states)

    y = (y_diag + y_off).reshape(Bsz, nC * Q, H, P)[:, :S]
    return y.reshape(Bsz, S, d_inner), carry


def ssd_decode_step(
    xbc: Tensor,  # (B, d_inner + 2*state) single-token post-conv activations
    dt: Tensor,  # (B, H) f32
    A: Tensor,  # (H,) f32
    state: Tensor,  # (B, H, P, N) f32
    d_inner: int,
    n_state: int,
    head_dim: int,
) -> tuple[Tensor, Tensor]:
    """Recurrent single-token update: h' = e^(dt*A) h + dt * B x ; y = C h'."""
    Bsz = xbc.shape[0]
    H = d_inner // head_dim
    P, N = head_dim, n_state
    x = xbc[:, :d_inner].reshape(Bsz, H, P)
    Bv = xbc[:, d_inner : d_inner + N]
    Cv = xbc[:, d_inner + N :]
    decay = torch.exp(dt * A[None, :])  # (B,H)
    upd = torch.einsum("bn,bh,bhp->bhpn", Bv.float(), dt.float(), x.float())
    state = state * decay[..., None, None] + upd
    y = torch.einsum("bn,bhpn->bhp", Cv.float(), state)
    return y.reshape(Bsz, d_inner), state


def causal_conv(x: Tensor, conv_w: Tensor, cache: Tensor | None = None):
    """Depthwise causal conv, width W. x (B,S,C), conv_w (W,C).

    The reference's shifted sum, term by term in the input dtype. Returns
    (y (B,S,C), new_cache (B,W-1,C)): the cache carries the last W-1 inputs
    for streaming decode.
    """
    W = conv_w.shape[0]
    if cache is None:
        xp = F.pad(x, (0, 0, W - 1, 0))
    else:
        xp = torch.cat([cache.to(x.dtype), x], dim=1)
    ys = sum(
        xp[:, i : i + x.shape[1], :] * conv_w[i] for i in range(W)
    )
    new_cache = xp[:, xp.shape[1] - (W - 1) :, :]
    return F.silu(ys), new_cache
