"""Core transformer layers: RMSNorm, RoPE, GQA attention (chunked,
optional sliding window), SwiGLU MLP. Plain functions on tensors over
parameter dicts, no framework.

Counterpart of `repro.models.layers`. Attention is the reference's
two-level chunking: a loop over query blocks and, inside it, an
online-softmax loop over KV blocks, so a long prefill never materialises an
S x S score matrix. Decode attends with a masked softmax over the cache.

Where the reference contracts low-precision inputs with
``preferred_element_type=float32`` (an f32 result), the port casts the
inputs to f32 before the product: the cast is exact, and a bf16 matmul in
torch would round its result to bf16. RMSNorm and RoPE run in f32 and cast
back, as in the reference.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

NEG_INF = -1e30


def rms_norm(x: Tensor, weight: Tensor, eps: float = 1e-5) -> Tensor:
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * weight.float()).to(dtype)


def rope_angles(positions: Tensor, head_dim: int, theta: float) -> tuple[Tensor, Tensor]:
    """cos/sin tables for given integer positions; shape (..., head_dim/2)."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32, device=positions.device) / half
    freqs = 1.0 / (theta**exps)
    ang = positions[..., None].float() * freqs  # (..., half)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: Tensor, cos: Tensor, sin: Tensor) -> Tensor:
    """x: (B, S, H, D); cos/sin: (B, S, D/2) or (S, D/2)."""
    dtype = x.dtype
    x = x.float()
    x1, x2 = x.chunk(2, dim=-1)
    if cos.ndim == 2:  # (S, half) -> broadcast batch
        cos = cos[None, :, None, :]
        sin = sin[None, :, None, :]
    else:  # (B, S, half)
        cos = cos[:, :, None, :]
        sin = sin[:, :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def _attn_chunk(q, k, v, q_pos, k_pos, window: int, scale: float):
    """Attention of one query block against one KV block with online-softmax
    statistics returned: (acc, m, l). Shapes:
      q (B, Cq, KH, G, D), k/v (B, Ck, KH, D); positions (Cq,), (Ck,).
    ``window`` <= 0 means full causal attention.
    """
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float())
    s = s * scale
    causal = q_pos[:, None] >= k_pos[None, :]
    if window > 0:
        causal &= q_pos[:, None] - k_pos[None, :] < window
    s = torch.where(causal[None, None, None], s, NEG_INF)
    m = torch.amax(s, dim=-1)  # (B,H,G,Cq)
    p = torch.exp(s - m[..., None])
    l = torch.sum(p, dim=-1)
    acc = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v.dtype).float(), v.float())
    return acc, m, l


def chunked_attention(
    q: Tensor,  # (B, Sq, H, D)
    k: Tensor,  # (B, Sk, KH, D)
    v: Tensor,  # (B, Sk, KH, D)
    q_positions: Tensor,  # (Sq,) global positions of queries
    k_positions: Tensor,  # (Sk,)
    window: int = 0,  # 0 = full causal
    q_chunk: int = 512,
    kv_chunk: int = 1024,
) -> Tensor:
    """Causal (optionally sliding-window) GQA attention, O(Cq*Ck) live memory."""
    B, Sq, H, D = q.shape
    _, Sk, KH, _ = k.shape
    G = H // KH
    scale = 1.0 / math.sqrt(D)
    q = q.reshape(B, Sq, KH, G, D)

    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Sk)
    nq = -(-Sq // q_chunk)
    nk = -(-Sk // kv_chunk)
    # pad to multiples
    pq = nq * q_chunk - Sq
    pk = nk * kv_chunk - Sk
    if pq:
        q = F.pad(q, (0, 0, 0, 0, 0, 0, 0, pq))
        q_positions = F.pad(q_positions, (0, pq), value=-1)
    if pk:
        k = F.pad(k, (0, 0, 0, 0, 0, pk))
        v = F.pad(v, (0, 0, 0, 0, 0, pk))
        k_positions = F.pad(k_positions, (0, pk), value=2**30)

    blocks = []
    for qi in range(nq):
        qb = q[:, qi * q_chunk : (qi + 1) * q_chunk]
        qp = q_positions[qi * q_chunk : (qi + 1) * q_chunk]
        acc = torch.zeros((B, KH, G, q_chunk, D), dtype=torch.float32, device=q.device)
        m = torch.full((B, KH, G, q_chunk), -math.inf, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, KH, G, q_chunk), dtype=torch.float32, device=q.device)
        for j in range(nk):
            ks = slice(j * kv_chunk, (j + 1) * kv_chunk)
            a, mj, lj = _attn_chunk(qb, k[:, ks], v[:, ks], qp, k_positions[ks], window, scale)
            m_new = torch.maximum(m, mj)
            r_old = torch.exp(m - m_new)
            r_new = torch.exp(mj - m_new)
            acc = acc * r_old[..., None] + a * r_new[..., None]
            l = l * r_old + lj * r_new
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-30)
        blocks.append(out.to(q.dtype))
    # blocks: nq x (B, KH, G, q_chunk, D) -> (B, Sq, H, D)
    out = torch.cat(blocks, dim=3).permute(0, 3, 1, 2, 4).reshape(B, nq * q_chunk, H, D)
    return out[:, :Sq]


def decode_attention(
    q: Tensor,  # (B, 1, H, D) single new token
    k_cache: Tensor,  # (B, L, KH, D)
    v_cache: Tensor,  # (B, L, KH, D)
    lengths: Tensor,  # (B,) valid cache lengths (the new token is at lengths-1)
    window: int = 0,
) -> Tensor:
    """Single-step decode attention over a (padded) KV cache."""
    B, L, KH, D = k_cache.shape
    H = q.shape[2]
    G = H // KH
    scale = 1.0 / math.sqrt(D)
    qr = q.reshape(B, KH, G, D)
    s = torch.einsum("bhgd,blhd->bhgl", qr.float(), k_cache.float())
    s = s * scale
    pos = torch.arange(L, device=k_cache.device)[None, :]
    valid = pos < lengths[:, None]
    if window > 0:
        valid &= pos >= lengths[:, None] - window
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgl,blhd->bhgd", p.to(v_cache.dtype).float(), v_cache.float())
    return out.reshape(B, 1, H, D).to(q.dtype)


def ring_decode_attention(
    q: Tensor,  # (B, 1, H, D)
    k_ring: Tensor,  # (B, W, KH, D) ring buffer (keys pre-roped at write time)
    v_ring: Tensor,  # (B, W, KH, D)
    valid_len,  # int or scalar tensor: filled slots (== W once wrapped)
) -> Tensor:
    """Decode attention over a sliding-window ring buffer.

    Slot order doesn't matter for softmax (RoPE was applied at write time);
    only a validity mask over filled slots is needed.
    """
    B, W, KH, D = k_ring.shape
    H = q.shape[2]
    G = H // KH
    scale = 1.0 / math.sqrt(D)
    qr = q.reshape(B, KH, G, D)
    s = torch.einsum("bhgd,blhd->bhgl", qr.float(), k_ring.float())
    s = s * scale
    valid = torch.arange(W, device=k_ring.device)[None, :] < valid_len
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgl,blhd->bhgd", p.to(v_ring.dtype).float(), v_ring.float())
    return out.reshape(B, 1, H, D).to(q.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def swiglu(x: Tensor, w_gate: Tensor, w_up: Tensor, w_down: Tensor) -> Tensor:
    g = torch.einsum("bsd,df->bsf", x, w_gate.to(x.dtype))
    u = torch.einsum("bsd,df->bsf", x, w_up.to(x.dtype))
    return torch.einsum("bsf,fd->bsd", F.silu(g) * u, w_down.to(x.dtype))


# ---------------------------------------------------------------------------
# Initialization helpers
# ---------------------------------------------------------------------------


# a 2-D table's or head's f32 draw block: at most this many elements (2 MiB),
# below every full config's largest layer slice (smollm-135m's 884,736)
DRAW_BLOCK = 1 << 19


def dense_init(generator: torch.Generator | None, shape: tuple[int, ...], dtype: torch.dtype,
               device: torch.device, scale: float | None = None) -> Tensor:
    """Normal weights times ``scale`` (default 1/sqrt(shape[0]), the
    reference's rule, which for a layer-stacked shape reads the layer count),
    drawn in f32 from ``generator`` on ``device``.

    The result is allocated once, in ``dtype``, and filled one block along
    dim 0 at a time: one layer of a stacked (3-D or more) shape, or rows of
    a 2-D table or head, at most DRAW_BLOCK elements a block (one row at
    least). Each block is drawn in f32, scaled in place and cast into the
    result, so a draw holds one f32 block beside its result, never the whole
    shape in f32 (llava-next-34b's ``w_gate`` would take 35 GB). With no
    generator (the meta device, where nothing is drawn) the shape is made
    whole."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    if generator is None:
        w = torch.randn(shape, dtype=torch.float32, device=device)
        return (w * scale).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=device)
    row = math.prod(shape[1:])
    rows = 1 if len(shape) >= 3 else max(1, DRAW_BLOCK // max(row, 1))
    for i in range(0, shape[0], rows):
        n = min(rows, shape[0] - i)
        block = torch.randn((n, *shape[1:]), generator=generator, dtype=torch.float32,
                            device=device)
        out[i : i + n].copy_(block.mul_(scale))
    return out
