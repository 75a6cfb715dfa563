"""Serving: prefill + single-token decode for every family.

Counterpart of `repro.models.serve`. Cache layouts per family:
  dense / moe      contiguous KVCache or PagedKVCache (layer-stacked)
  ssm              SSMServeState: rolling conv cache + (H, P, N) SSD state per
                   layer, O(1) in sequence length
  hybrid (hymba)   per-layer mix: ring caches (window) for SWA layers, full
                   caches for global layers, plus SSM state; decode runs layer
                   by layer, so cache shapes may differ across layers.

Caches are written in place (`repro_torch.models.kvcache`); each call
returns the cache with its token count advanced. Run under
``torch.inference_mode()``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.kvcache import KVCache, PagedKVCache
from repro_torch.models.transformer import (
    _attention,
    _mlp,
    _moe_ffn,
    _ssm_in,
    _ssm_mix,
    _ssm_out,
    layer_slice,
    model_dtype,
    project_logits,
)

Tensor = torch.Tensor


class SSMServeState(NamedTuple):
    conv: Tensor  # (L, B, conv_w-1, d_inner + 2*state)
    ssm: Tensor  # (L, B, H, P, N) float32
    length: int

    @classmethod
    def init(cls, cfg: ModelConfig, batch: int, n_layers: int | None = None,
             dtype=torch.bfloat16, *, device: torch.device):
        Lc = n_layers if n_layers is not None else cfg.n_layers
        di, N = cfg.d_inner, cfg.ssm_state
        return cls(
            torch.zeros((Lc, batch, cfg.ssm_conv - 1, di + 2 * N), dtype=dtype, device=device),
            torch.zeros((Lc, batch, cfg.ssm_heads, cfg.ssm_head_dim, N), dtype=torch.float32,
                        device=device),
            0,
        )


class HybridCaches(NamedTuple):
    """Per-layer caches for the layer-by-layer hybrid serve path."""

    attn: tuple  # per layer: (k, v), each (B, alloc, KH, hd)
    ssm: SSMServeState


# ---------------------------------------------------------------------------
# attention-family helpers
# ---------------------------------------------------------------------------


def _qkv_token(bp_l, cfg: ModelConfig, xn: Tensor, pos: Tensor):
    """q, k, v of one token, roped at ``pos`` ((1,) int tensor)."""
    q = torch.einsum("bsd,dhk->bshk", xn, bp_l["wq"].to(xn.dtype))
    k = torch.einsum("bsd,dhk->bshk", xn, bp_l["wk"].to(xn.dtype))
    v = torch.einsum("bsd,dhk->bshk", xn, bp_l["wv"].to(xn.dtype))
    cos, sin = L.rope_angles(pos, cfg.head_dim, cfg.rope_theta)
    return L.apply_rope(q, cos, sin), L.apply_rope(k, cos, sin), v


def _write(k_cache: Tensor, v_cache: Tensor, k: Tensor, v: Tensor, start: int) -> None:
    """Write (B, S, KH, hd) into (B, alloc, KH, hd) caches at ``start``, in place."""
    end = start + k.shape[1]
    if end > k_cache.shape[1]:
        raise ValueError(f"KV cache write of positions {start}..{end - 1} past its "
                         f"{k_cache.shape[1]} slots")
    k_cache[:, start:end] = k.to(k_cache.dtype)
    v_cache[:, start:end] = v.to(v_cache.dtype)


def _position(length: int, device) -> Tensor:
    # a fill on the device: a tensor built from a host list would be a
    # pageable copy, which waits for the queued work
    return torch.full((1,), length, dtype=torch.int64, device=device)


# ---------------------------------------------------------------------------
# SSM helpers (token-level mirror of transformer._ssm_mix)
# ---------------------------------------------------------------------------


def _ssm_decode_layer(bp_l, cfg: ModelConfig, x, conv_cache, state):
    z, xbc, dt_raw = _ssm_in(bp_l, cfg, x)
    dt = F.softplus(dt_raw.float() + bp_l["dt_bias"].float())
    xbc_conv, conv_cache = ssm_lib.causal_conv(xbc, bp_l["conv_w"].to(x.dtype), cache=conv_cache)
    A = -torch.exp(bp_l["A_log"].float())
    y, state = ssm_lib.ssd_decode_step(
        xbc_conv[:, 0], dt[:, 0], A, state, cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim
    )
    out = _ssm_out(bp_l, cfg, x, y[:, None, :], xbc_conv[..., : cfg.d_inner], z)
    return out, conv_cache, state


def _ssm_prefill_layer(bp_l, cfg: ModelConfig, x):
    """Full-seq SSD returning (out, conv_cache, final_state)."""
    _, xbc, _ = _ssm_in(bp_l, cfg, x)
    W = cfg.ssm_conv
    conv_cache = xbc[:, -(W - 1) :, :] if x.shape[1] >= W - 1 else F.pad(
        xbc, (0, 0, W - 1 - x.shape[1], 0)
    )
    out, state = _ssm_mix(bp_l, cfg, x)
    return out, conv_cache.to(x.dtype), state


# ---------------------------------------------------------------------------
# Public serve API
# ---------------------------------------------------------------------------


def _embed_tokens(params, cfg: ModelConfig, tokens: Tensor) -> Tensor:
    dtype = model_dtype(cfg)
    if cfg.n_codebooks:
        emb = params["codebook_embed"]
        return sum(emb[k][tokens[..., k]] for k in range(cfg.n_codebooks)).to(dtype)
    return params["embed"][tokens].to(dtype)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, paged: bool = False,
               page_size: int = 256, *, device: torch.device):
    dtype = model_dtype(cfg)
    if cfg.family == "ssm":
        return SSMServeState.init(cfg, batch, dtype=dtype, device=device)
    if cfg.family == "hybrid":
        attn = []
        for i in range(cfg.n_layers):
            w = cfg.attn_window(i)
            alloc = min(w, max_len) if w > 0 else max_len
            shape = (batch, alloc, cfg.n_kv_heads, cfg.head_dim)
            attn.append((torch.zeros(shape, dtype=dtype, device=device),
                         torch.zeros(shape, dtype=dtype, device=device)))
        return HybridCaches(attn=tuple(attn),
                            ssm=SSMServeState.init(cfg, batch, dtype=dtype, device=device))
    if paged:
        return PagedKVCache.init(
            cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim,
            page_size=page_size, dtype=dtype, device=device,
        )
    return KVCache.init(cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim, dtype,
                        device=device)


def decode_step(params, cfg: ModelConfig, tokens: Tensor, cache):
    """One decode step. tokens: (B,) int — or (B, K) for codebook models.
    Returns (logits (B, V) or (B, K, V), the cache one token longer)."""
    toks = tokens[:, None] if tokens.ndim == 1 else tokens[:, None, :]
    x = _embed_tokens(params, cfg, toks)  # (B,1,d)

    if cfg.family in ("dense", "moe"):
        x, cache = _decode_attn_families(params, cfg, x, cache)
    elif cfg.family == "ssm":
        x, cache = _decode_ssm(params, cfg, x, cache)
    else:
        x, cache = _decode_hybrid(params, cfg, x, cache)

    x = L.rms_norm(x, params["final_norm"], cfg.rms_eps)
    logits = project_logits(params, cfg, x)
    return logits[:, 0], cache


def _attn_layers(params, cfg: ModelConfig):
    """(global layer index, layer weights, is MoE) for the attention families."""
    n_dense = cfg.first_k_dense if cfg.family == "moe" else 0
    for gl in range(cfg.n_layers):
        if gl < n_dense:
            yield gl, layer_slice(params["dense_blocks"], gl), False
        else:
            yield gl, layer_slice(params["blocks"], gl - n_dense), cfg.family == "moe"


def _decode_attn_families(params, cfg: ModelConfig, x, cache):
    paged = isinstance(cache, PagedKVCache)
    B = x.shape[0]
    if paged:
        pos = cache.lengths[:1].long()
        lengths = cache.lengths + 1
    else:
        pos = _position(cache.length, x.device)
        lengths = torch.full((B,), cache.length + 1, dtype=torch.int32, device=x.device)
    for gl, bp_l, moe in _attn_layers(params, cfg):
        xn = L.rms_norm(x, bp_l["attn_norm"], cfg.rms_eps)
        q, k, v = _qkv_token(bp_l, cfg, xn, pos)
        if paged:
            cache.write_token(k, v, gl)
            kf, vf = cache.gather_layer(gl)
        else:
            cache.update_layer(k, v, gl)
            kf, vf = cache.k[gl], cache.v[gl]
        out = L.decode_attention(q, kf, vf, lengths, window=cfg.attn_window(gl))
        x = x + torch.einsum("bshk,hkd->bsd", out, bp_l["wo"].to(x.dtype))
        if moe:
            f, _ = _moe_ffn(bp_l, cfg, x)
            x = x + f
        else:
            x = x + _mlp(bp_l, cfg, x)
    return x, cache.advanced(1)


def _decode_ssm(params, cfg: ModelConfig, x, cache: SSMServeState):
    for i in range(cfg.n_layers):
        bp_l = layer_slice(params["blocks"], i)
        y, conv_l, state_l = _ssm_decode_layer(bp_l, cfg, x, cache.conv[i], cache.ssm[i])
        x = x + y
        cache.conv[i] = conv_l
        cache.ssm[i] = state_l
    return x, SSMServeState(cache.conv, cache.ssm, cache.length + 1)


def _decode_hybrid(params, cfg: ModelConfig, x, cache: HybridCaches):
    conv, state = cache.ssm.conv, cache.ssm.ssm
    length = cache.ssm.length
    pos = _position(length, x.device)
    for i in range(cfg.n_layers):
        bp_l = layer_slice(params["blocks"], i)
        win = cfg.attn_window(i)
        kc, vc = cache.attn[i]
        alloc = kc.shape[1]
        xn = L.rms_norm(x, bp_l["attn_norm"], cfg.rms_eps)
        q, k, v = _qkv_token(bp_l, cfg, xn, pos)
        if win > 0 and alloc == win:  # ring cache
            _write(kc, vc, k, v, length % win)
            # ring slots hold the last `win` tokens; all valid once filled
            out = L.ring_decode_attention(q, kc, vc, min(length + 1, win))
        else:
            _write(kc, vc, k, v, length)
            lengths = torch.full((x.shape[0],), length + 1, dtype=torch.int32, device=x.device)
            out = L.decode_attention(q, kc, vc, lengths, window=win)
        a = torch.einsum("bshk,hkd->bsd", out, bp_l["wo"].to(x.dtype))
        s, conv[i], state[i] = _ssm_decode_layer(bp_l, cfg, x, conv[i], state[i])
        a = L.rms_norm(a, bp_l["fuse_norm_attn"], cfg.rms_eps)
        s = L.rms_norm(s, bp_l["fuse_norm_ssm"], cfg.rms_eps)
        x = x + 0.5 * (a + s)
        x = x + _mlp(bp_l, cfg, x)
    return x, HybridCaches(attn=cache.attn, ssm=SSMServeState(conv, state, length + 1))


def prefill(params, cfg: ModelConfig, tokens: Tensor, max_len: int, paged: bool = False):
    """Run the prompt through the model, filling caches. Returns (last_logits, cache).

    Attention families compute each layer's prompt K/V as the forward pass
    does and write them into the cache right away."""
    B, S = tokens.shape[:2]
    dev = tokens.device
    if cfg.family != "ssm" and S > max_len:
        raise ValueError(f"a prompt of {S} tokens does not fit max_len {max_len}")
    cache = init_cache(cfg, B, max_len, paged=paged, device=dev)
    x = _embed_tokens(params, cfg, tokens)
    positions = torch.arange(S, device=dev)

    if cfg.family in ("dense", "moe"):
        rows = torch.arange(B, device=dev)
        for gl, bp_l, moe in _attn_layers(params, cfg):
            a, (k, v) = _attention(bp_l, cfg, x, positions, cfg.attn_window(gl))
            x = x + a
            if moe:
                f, _ = _moe_ffn(bp_l, cfg, x)
                x = x + f
            else:
                x = x + _mlp(bp_l, cfg, x)
            if not paged:
                cache.update_layer(k, v, gl)
                continue
            # one page-sized block at a time, each into its page of every
            # sequence's pool
            P = cache.page_size
            for b in range(-(-S // P)):
                s0 = b * P
                blk = min(P, S - s0)
                page_ids = cache.page_table[:, b].long()  # (B,)
                cache.k_pages[gl, rows, page_ids, :blk] = k[:, s0 : s0 + blk].to(
                    cache.k_pages.dtype)
                cache.v_pages[gl, rows, page_ids, :blk] = v[:, s0 : s0 + blk].to(
                    cache.v_pages.dtype)
        if paged:
            cache = PagedKVCache(
                cache.k_pages, cache.v_pages, cache.page_table,
                torch.full((B,), S, dtype=torch.int32, device=dev), S,
            )
        else:
            cache = cache.advanced(S)
    elif cfg.family == "ssm":
        for i in range(cfg.n_layers):
            bp_l = layer_slice(params["blocks"], i)
            y, cache.conv[i], cache.ssm[i] = _ssm_prefill_layer(bp_l, cfg, x)
            x = x + y
        cache = SSMServeState(cache.conv, cache.ssm, S)
    else:  # hybrid
        conv, state = cache.ssm.conv, cache.ssm.ssm
        for i in range(cfg.n_layers):
            bp_l = layer_slice(params["blocks"], i)
            win = cfg.attn_window(i)
            a, (k, v) = _attention(bp_l, cfg, x, positions, win)
            s, conv[i], state[i] = _ssm_prefill_layer(bp_l, cfg, x)
            a = L.rms_norm(a, bp_l["fuse_norm_attn"], cfg.rms_eps)
            s = L.rms_norm(s, bp_l["fuse_norm_ssm"], cfg.rms_eps)
            x = x + 0.5 * (a + s)
            x = x + _mlp(bp_l, cfg, x)
            kc0, vc0 = cache.attn[i]
            if win > 0 and kc0.shape[1] == win:
                take = min(win, S)
                # last `take` tokens land at ring slots (S - take + j) % win
                idxs = torch.arange(S - take, S, device=dev) % win
                kc0[:, idxs] = k[:, -take:].to(kc0.dtype)
                vc0[:, idxs] = v[:, -take:].to(vc0.dtype)
            else:
                _write(kc0, vc0, k, v, 0)
        cache = HybridCaches(attn=cache.attn, ssm=SSMServeState(conv, state, S))

    # project only the last position: full-sequence logits are a large
    # tensor that would be sliced away at once
    x_last = L.rms_norm(x[:, -1:], params["final_norm"], cfg.rms_eps)
    logits = project_logits(params, cfg, x_last)
    return logits[:, 0], cache
