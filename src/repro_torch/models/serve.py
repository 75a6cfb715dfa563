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
``torch.inference_mode()``. The residual stream takes the reference's
``"act"`` constraint after every block, a no-op with no mesh set.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

from repro_torch.models import layers as L
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.kvcache import KVCache, PagedKVCache
from repro_torch.models.transformer import (
    _attention,
    _c,
    heads_out,
    heads_proj,
    lookup,
    _mlp,
    _moe_ffn,
    _ssm_in,
    _ssm_mix,
    _ssm_out,
    layer_slice,
    model_dtype,
    project_logits,
)

from repro_torch.sharding.rules import (
    P,
    assign,
    constrain,
    current_mesh_axes,
    placements,
    serve_cache_specs,
    spec_of,
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
    q = heads_proj(xn, bp_l["wq"])
    k = heads_proj(xn, bp_l["wk"])
    v = heads_proj(xn, bp_l["wv"])
    cos, sin = L.rope_angles(pos, cfg.head_dim, cfg.rope_theta)
    return L.apply_rope(q, cos, sin), L.apply_rope(k, cos, sin), v


def _write(k_cache: Tensor, v_cache: Tensor, k: Tensor, v: Tensor, start: int) -> None:
    """Write (B, S, KH, hd) into (B, alloc, KH, hd) caches at ``start``, in place."""
    end = start + k.shape[1]
    if end > k_cache.shape[1]:
        raise ValueError(f"KV cache write of positions {start}..{end - 1} past its "
                         f"{k_cache.shape[1]} slots")
    assign(k_cache, (slice(None), slice(start, end)), k.to(k_cache.dtype))
    assign(v_cache, (slice(None), slice(start, end)), v.to(v_cache.dtype))


def _like_cache(q: Tensor, k_cache: Tensor) -> Tensor:
    """A token's queries (B, 1, H, hd) laid out as a sharded (B, len, KH, hd)
    cache: batch and head_dim split as the cache splits them, heads whole
    (the attention splits them into KV groups); ``q`` itself otherwise."""
    if not isinstance(k_cache, DTensor):
        return q
    spec = spec_of(k_cache)
    return constrain(q, P(spec[0], None, None, spec[3]))


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
        return sum(lookup(emb[k], tokens[..., k]) for k in range(cfg.n_codebooks)).to(dtype)
    return lookup(params["embed"], tokens).to(dtype)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, paged: bool = False,
               page_size: int = 256, *, device: torch.device):
    """A zeroed cache of ``batch`` sequences of up to ``max_len`` tokens on
    ``device``. Under a mesh its tensors are DTensors laid out per
    `serve_cache_specs`, each rank allocating only its shard."""
    ctx = current_mesh_axes()
    if ctx is None:
        return _init_cache(cfg, batch, max_len, paged, page_size, device)
    mesh, axes = ctx
    with FakeTensorMode():  # the global cache's structure and shapes, nothing made
        meta = _init_cache(cfg, batch, max_len, paged, page_size, torch.device("meta"))
    specs = serve_cache_specs(meta, mesh, axes, batch)

    def shard(leaf, spec, name):
        if not isinstance(leaf, Tensor):
            return leaf
        pl = placements(spec, mesh)
        shape, off = compute_local_shape_and_global_offset(leaf.shape, mesh, pl)
        if name == "page_table":  # every row is arange(max_pages)
            local = torch.arange(off[1], off[1] + shape[1], dtype=leaf.dtype, device=device)
            local = local[None].repeat(shape[0], 1)
        else:
            local = torch.zeros(shape, dtype=leaf.dtype, device=device)
        return DTensor.from_local(local, mesh, pl, run_check=False, shape=leaf.shape,
                                  stride=leaf.stride())

    def walk(tree, spec, name=""):
        if isinstance(tree, tuple) and hasattr(tree, "_fields"):
            return type(tree)(*(walk(t, sp, f) for t, sp, f in zip(tree, spec, tree._fields)))
        if isinstance(tree, tuple):
            return tuple(walk(t, sp) for t, sp in zip(tree, spec))
        return shard(tree, spec, name)

    return walk(meta, specs)


def _init_cache(cfg: ModelConfig, batch: int, max_len: int, paged: bool, page_size: int,
                device: torch.device):
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
        out = L.decode_attention(_like_cache(q, kf), kf, vf, lengths,
                                 window=cfg.attn_window(gl))
        x = _c(x + heads_out(out, bp_l["wo"].to(x.dtype)), "act")
        if moe:
            f, _ = _moe_ffn(bp_l, cfg, x)
            x = _c(x + f, "act")
        else:
            x = _c(x + _mlp(bp_l, cfg, x), "act")
    return x, cache.advanced(1)


def _decode_ssm(params, cfg: ModelConfig, x, cache: SSMServeState):
    for i in range(cfg.n_layers):
        bp_l = layer_slice(params["blocks"], i)
        y, conv_l, state_l = _ssm_decode_layer(bp_l, cfg, x, cache.conv[i], cache.ssm[i])
        x = _c(x + y, "act")
        assign(cache.conv, i, conv_l)
        assign(cache.ssm, i, state_l)
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
            out = L.ring_decode_attention(_like_cache(q, kc), kc, vc, min(length + 1, win))
        else:
            _write(kc, vc, k, v, length)
            lengths = torch.full((x.shape[0],), length + 1, dtype=torch.int32, device=x.device)
            out = L.decode_attention(_like_cache(q, kc), kc, vc, lengths, window=win)
        a = heads_out(out, bp_l["wo"].to(x.dtype))
        s, conv_l, state_l = _ssm_decode_layer(bp_l, cfg, x, conv[i], state[i])
        assign(conv, i, conv_l)
        assign(state, i, state_l)
        a = L.rms_norm(a, bp_l["fuse_norm_attn"], cfg.rms_eps)
        s = L.rms_norm(s, bp_l["fuse_norm_ssm"], cfg.rms_eps)
        x = _c(x + 0.5 * (a + s), "act")
        x = _c(x + _mlp(bp_l, cfg, x), "act")
    return x, HybridCaches(attn=cache.attn, ssm=SSMServeState(conv, state, length + 1))


def prefill(params, cfg: ModelConfig, tokens: Tensor, max_len: int, paged: bool = False):
    """Run the prompt through the model, filling caches. Returns (last_logits, cache).

    Attention families compute each layer's prompt K/V as the forward pass
    does and write them into the cache right away."""
    B, S = tokens.shape[:2]
    dev = tokens.device
    if cfg.family != "ssm" and S > max_len:
        raise ValueError(f"a prompt of {S} tokens does not fit max_len {max_len}")
    if paged and current_mesh_axes() is not None:
        raise NotImplementedError("prefill under a mesh fills a contiguous cache: paged=False")
    cache = init_cache(cfg, B, max_len, paged=paged, device=dev)
    # same sequence-parallel residual-stream sharding as training
    x = _c(_embed_tokens(params, cfg, tokens), "act")
    positions = torch.arange(S, device=dev)

    if cfg.family in ("dense", "moe"):
        rows = torch.arange(B, device=dev)
        for gl, bp_l, moe in _attn_layers(params, cfg):
            a, (k, v) = _attention(bp_l, cfg, x, positions, cfg.attn_window(gl))
            x = _c(x + a, "act")
            if moe:
                f, _ = _moe_ffn(bp_l, cfg, x)
                x = _c(x + f, "act")
            else:
                x = _c(x + _mlp(bp_l, cfg, x), "act")
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
            y, conv_l, state_l = _ssm_prefill_layer(bp_l, cfg, x)
            assign(cache.conv, i, conv_l)
            assign(cache.ssm, i, state_l)
            x = _c(x + y, "act")
        cache = SSMServeState(cache.conv, cache.ssm, S)
    else:  # hybrid
        conv, state = cache.ssm.conv, cache.ssm.ssm
        for i in range(cfg.n_layers):
            bp_l = layer_slice(params["blocks"], i)
            win = cfg.attn_window(i)
            a, (k, v) = _attention(bp_l, cfg, x, positions, win)
            s, conv_l, state_l = _ssm_prefill_layer(bp_l, cfg, x)
            assign(conv, i, conv_l)
            assign(state, i, state_l)
            a = L.rms_norm(a, bp_l["fuse_norm_attn"], cfg.rms_eps)
            s = L.rms_norm(s, bp_l["fuse_norm_ssm"], cfg.rms_eps)
            x = _c(x + 0.5 * (a + s), "act")
            x = _c(x + _mlp(bp_l, cfg, x), "act")
            kc0, vc0 = cache.attn[i]
            if win > 0 and kc0.shape[1] == win:
                take = min(win, S)
                # last `take` tokens land at ring slots (S - take + j) % win
                idxs = torch.arange(S - take, S, device=dev) % win
                assign(kc0, (slice(None), idxs), k[:, -take:].to(kc0.dtype))
                assign(vc0, (slice(None), idxs), v[:, -take:].to(vc0.dtype))
            else:
                _write(kc0, vc0, k, v, 0)
        cache = HybridCaches(attn=cache.attn, ssm=SSMServeState(conv, state, S))

    # project only the last position: full-sequence logits are a large
    # tensor that would be sliced away at once
    x_last = L.rms_norm(x[:, -1:], params["final_norm"], cfg.rms_eps)
    logits = project_logits(params, cfg, x_last)
    return logits[:, 0], cache
