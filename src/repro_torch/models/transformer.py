"""Decoder LM assembly for every assigned family: init, forward, logits and
the training loss.

Counterpart of `repro.models.transformer`. Layer weights are STACKED along
a leading (n_layers,) axis, the reference's layout, so the reference's
parameter tree carries over leaf for leaf (`params_from_numpy`); the
reference's ``lax.scan`` over that axis is a Python loop over the layer
index here. MoE configs with ``first_k_dense`` use two stacks. With
``remat`` each block call runs under `torch.utils.checkpoint` (the
reference's ``jax.checkpoint`` of the layer body): the backward recomputes a
layer's activations from its input instead of keeping them, which changes
memory, never values. The reference's sharding constraints are no-ops
without a mesh, and the port has no mesh for these models yet, so they are
left out.
"""
from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.config import ModelConfig

Tensor = torch.Tensor


def model_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ===========================================================================
# Parameter initialization
# ===========================================================================


def _attn_params(gen, cfg: ModelConfig, dtype, dev, n_layers):
    d, H, KH, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "wq": L.dense_init(gen, (n_layers, d, H, hd), dtype, dev),
        "wk": L.dense_init(gen, (n_layers, d, KH, hd), dtype, dev),
        "wv": L.dense_init(gen, (n_layers, d, KH, hd), dtype, dev),
        "wo": L.dense_init(gen, (n_layers, H, hd, d), dtype, dev, scale=0.02),
        "attn_norm": torch.ones((n_layers, d), dtype=dtype, device=dev),
    }


def _mlp_params(gen, cfg: ModelConfig, dtype, dev, n_layers):
    d, ff = cfg.d_model, cfg.d_ff
    return {
        "w_gate": L.dense_init(gen, (n_layers, d, ff), dtype, dev),
        "w_up": L.dense_init(gen, (n_layers, d, ff), dtype, dev),
        "w_down": L.dense_init(gen, (n_layers, ff, d), dtype, dev, scale=0.02),
        "mlp_norm": torch.ones((n_layers, d), dtype=dtype, device=dev),
    }


def _moe_params(gen, cfg: ModelConfig, dtype, dev, n_layers):
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": L.dense_init(gen, (n_layers, d, E), dtype, dev, scale=0.02),
        "w_gate": L.dense_init(gen, (n_layers, E, d, ff), dtype, dev, scale=1 / math.sqrt(d)),
        "w_up": L.dense_init(gen, (n_layers, E, d, ff), dtype, dev, scale=1 / math.sqrt(d)),
        "w_down": L.dense_init(gen, (n_layers, E, ff, d), dtype, dev, scale=0.02),
        "mlp_norm": torch.ones((n_layers, d), dtype=dtype, device=dev),
    }


def _ssm_params(gen, cfg: ModelConfig, dtype, dev, n_layers):
    d, di, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    proj_in = 2 * di + 2 * N + H
    a = torch.linspace(1.0, 16.0, H, dtype=torch.float32, device=dev)
    return {
        "ssm_norm_in": torch.ones((n_layers, d), dtype=dtype, device=dev),
        "in_proj": L.dense_init(gen, (n_layers, d, proj_in), dtype, dev),
        "conv_w": L.dense_init(gen, (n_layers, cfg.ssm_conv, di + 2 * N), dtype, dev, scale=0.5),
        "A_log": torch.log(a[None].repeat(n_layers, 1)).to(dtype),
        "dt_bias": torch.zeros((n_layers, H), dtype=dtype, device=dev),
        "D": torch.ones((n_layers, H), dtype=dtype, device=dev),
        "gate_norm": torch.ones((n_layers, di), dtype=dtype, device=dev),
        "out_proj": L.dense_init(gen, (n_layers, di, d), dtype, dev, scale=0.02),
    }


def init_params(cfg: ModelConfig, generator: torch.Generator | None,
                device: str | torch.device) -> dict:
    """Random weights for ``cfg`` in its dtype on ``device``, drawn from
    ``generator`` (a `torch.Generator` on that device; None only on the meta
    device, where nothing is drawn). The tree and its shapes are the
    reference's ``init_params``; the values come from torch's generator, so
    they differ from the reference's (carry those with `params_from_numpy`)."""
    dev = torch.device(device)
    dtype = model_dtype(cfg)
    Lc = cfg.n_layers
    gen = generator
    params: dict[str, Any] = {}
    if cfg.n_codebooks:
        params["codebook_embed"] = L.dense_init(
            gen, (cfg.n_codebooks, cfg.vocab_size, cfg.d_model), dtype, dev, scale=0.02)
    else:
        params["embed"] = L.dense_init(gen, (cfg.vocab_size, cfg.d_model), dtype, dev, scale=0.02)

    blocks: dict[str, Any] = {}
    if cfg.family == "dense":
        blocks.update(_attn_params(gen, cfg, dtype, dev, Lc))
        blocks.update(_mlp_params(gen, cfg, dtype, dev, Lc))
    elif cfg.family == "moe":
        n_moe = Lc - cfg.first_k_dense
        blocks.update(_attn_params(gen, cfg, dtype, dev, n_moe))
        blocks.update(_moe_params(gen, cfg, dtype, dev, n_moe))
        if cfg.first_k_dense:
            dense: dict[str, Any] = {}
            dense.update(_attn_params(gen, cfg, dtype, dev, cfg.first_k_dense))
            dense.update(_mlp_params(gen, cfg, dtype, dev, cfg.first_k_dense))
            params["dense_blocks"] = dense
    elif cfg.family == "ssm":
        blocks.update(_ssm_params(gen, cfg, dtype, dev, Lc))
    elif cfg.family == "hybrid":
        blocks.update(_attn_params(gen, cfg, dtype, dev, Lc))
        blocks.update(_ssm_params(gen, cfg, dtype, dev, Lc))
        blocks.update(_mlp_params(gen, cfg, dtype, dev, Lc))
        blocks["fuse_norm_attn"] = torch.ones((Lc, cfg.d_model), dtype=dtype, device=dev)
        blocks["fuse_norm_ssm"] = torch.ones((Lc, cfg.d_model), dtype=dtype, device=dev)
    params["blocks"] = blocks
    params["final_norm"] = torch.ones((cfg.d_model,), dtype=dtype, device=dev)
    if cfg.n_codebooks:
        params["codebook_head"] = L.dense_init(
            gen, (cfg.n_codebooks, cfg.d_model, cfg.vocab_size), dtype, dev, scale=0.02)
    elif not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(gen, (cfg.d_model, cfg.vocab_size), dtype, dev,
                                         scale=0.02)
    return params


def _leaves(tree: dict, prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def param_count(params: dict) -> int:
    return sum(int(p.numel()) for _, p in _leaves(params))


def param_bytes(params: dict) -> int:
    return sum(p.numel() * p.element_size() for _, p in _leaves(params))


def _to_tensor(a: np.ndarray) -> Tensor:
    """A numpy leaf as a tensor of the same dtype and bits. An
    ``ml_dtypes.bfloat16`` array (what ``np.asarray`` gives for a bf16 JAX
    array), which ``torch.from_numpy`` refuses, is carried as its 16-bit
    patterns and reinterpreted."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def params_from_numpy(tree: dict, cfg: ModelConfig, device: str | torch.device) -> dict:
    """The reference's ``init_params`` tree, its leaves as numpy arrays (f32
    or ``ml_dtypes.bfloat16``), as the port's parameters on ``device``, bit
    for bit. The keys, shapes and dtype must be those `init_params` gives
    for ``cfg``; anything else raises."""
    want = dict(_leaves(init_params(cfg, None, "meta")))
    got = dict(_leaves(tree))
    if set(got) != set(want):
        raise ValueError(f"parameter tree keys differ from {cfg.name}'s: "
                         f"missing {sorted(set(want) - set(got))}, "
                         f"unexpected {sorted(set(got) - set(want))}")

    def convert(sub: dict, prefix: str) -> dict:
        out = {}
        for k, v in sub.items():
            if isinstance(v, dict):
                out[k] = convert(v, f"{prefix}{k}/")
                continue
            t = _to_tensor(np.asarray(v))
            w = want[f"{prefix}{k}"]
            if t.shape != w.shape or t.dtype != w.dtype:
                raise ValueError(f"{prefix}{k}: {tuple(t.shape)} {t.dtype}, expected "
                                 f"{tuple(w.shape)} {w.dtype}")
            out[k] = t.to(device)
        return out

    return convert(tree, "")


def layer_slice(tree: dict, i: int) -> dict:
    """Layer ``i``'s weights of a layer-stacked dict (views)."""
    return {k: v[i] for k, v in tree.items()}


# ===========================================================================
# Embedding / frontends (stubs per assignment: precomputed embeddings)
# ===========================================================================


def embed_inputs(params: dict, cfg: ModelConfig, batch: dict) -> tuple[Tensor, Tensor]:
    """Returns (x (B,S,d), positions (S,)). Frontends are STUBS: vision/audio
    inputs arrive as precomputed embeddings/codes in the batch dict."""
    dtype = model_dtype(cfg)
    if cfg.n_codebooks:  # audio: codes (B, S, K)
        codes = batch["codes"]
        emb = params["codebook_embed"]  # (K, V, d)
        x = sum(emb[k][codes[..., k]] for k in range(cfg.n_codebooks))
    else:
        x = params["embed"][batch["tokens"]]  # (B,S,d)
        if cfg.frontend == "vision":
            patches = batch["patch_embeds"].to(dtype)  # (B,P,d) precomputed
            x = torch.cat([patches, x], dim=1)
    S = x.shape[1]
    return x.to(dtype), torch.arange(S, device=x.device)


# ===========================================================================
# Blocks (prefill mode: full sequences)
# ===========================================================================


def _attention(bp, cfg: ModelConfig, x, positions, window: int, q_chunk=512, kv_chunk=1024):
    xn = L.rms_norm(x, bp["attn_norm"], cfg.rms_eps)
    q = torch.einsum("bsd,dhk->bshk", xn, bp["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", xn, bp["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", xn, bp["wv"].to(x.dtype))
    cos, sin = L.rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    q = L.apply_rope(q, cos, sin)
    k = L.apply_rope(k, cos, sin)
    out = L.chunked_attention(
        q, k, v, positions, positions, window=window, q_chunk=q_chunk, kv_chunk=kv_chunk
    )
    return torch.einsum("bshk,hkd->bsd", out, bp["wo"].to(x.dtype)), (k, v)


def _mlp(bp, cfg: ModelConfig, x):
    xn = L.rms_norm(x, bp["mlp_norm"], cfg.rms_eps)
    return L.swiglu(xn, bp["w_gate"], bp["w_up"], bp["w_down"])


def _moe_ffn(bp, cfg: ModelConfig, x):
    """Grouped dispatch: one group per sequence."""
    xn = L.rms_norm(x, bp["mlp_norm"], cfg.rms_eps)
    return moe_lib.moe_block(
        xn, bp["router"], bp["w_gate"], bp["w_up"], bp["w_down"],
        cfg.top_k, cfg.capacity_factor,
    )


def _ssm_in(bp, cfg: ModelConfig, x):
    """The mixer's input projection split into (z, xbc, dt_raw)."""
    xn = L.rms_norm(x, bp["ssm_norm_in"], cfg.rms_eps)
    proj = torch.einsum("bsd,dp->bsp", xn, bp["in_proj"].to(x.dtype))
    di, N = cfg.d_inner, cfg.ssm_state
    return proj[..., :di], proj[..., di : 2 * di + 2 * N], proj[..., 2 * di + 2 * N :]


def _ssm_out(bp, cfg: ModelConfig, x, y, xin, z):
    """Skip connection D * x, gated norm and output projection."""
    y = y + xin.float() * torch.repeat_interleave(bp["D"].float(), cfg.ssm_head_dim, dim=-1)
    y = y.to(x.dtype) * F.silu(z)
    y = L.rms_norm(y, bp["gate_norm"], cfg.rms_eps)
    return torch.einsum("bsi,id->bsd", y, bp["out_proj"].to(x.dtype))


def _ssm_mix(bp, cfg: ModelConfig, x, state=None, chunk=None):
    """Full-sequence SSD mixer. Returns (out (B,S,d), final_state)."""
    z, xbc, dt_raw = _ssm_in(bp, cfg, x)
    dt = F.softplus(dt_raw.float() + bp["dt_bias"].float())
    xbc_conv, _ = ssm_lib.causal_conv(xbc, bp["conv_w"].to(x.dtype))
    A = -torch.exp(bp["A_log"].float())
    y, final_state = ssm_lib.ssd_scan(
        xbc_conv, dt, A, cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim,
        chunk or cfg.ssm_chunk, initial_state=state,
    )
    return _ssm_out(bp, cfg, x, y, xbc_conv[..., : cfg.d_inner], z), final_state


def dense_block(bp, cfg: ModelConfig, x, positions, window):
    a, _ = _attention(bp, cfg, x, positions, window)
    x = x + a
    return x + _mlp(bp, cfg, x)


def moe_block(bp, cfg: ModelConfig, x, positions, window):
    a, _ = _attention(bp, cfg, x, positions, window)
    x = x + a
    f, aux = _moe_ffn(bp, cfg, x)
    return x + f, aux


def ssm_block(bp, cfg: ModelConfig, x, positions, window):
    y, _ = _ssm_mix(bp, cfg, x)
    return x + y


def hybrid_block(bp, cfg: ModelConfig, x, positions, window):
    """Hymba: attention and SSM heads in parallel on the same input, fused."""
    a, _ = _attention(bp, cfg, x, positions, window)
    s, _ = _ssm_mix(bp, cfg, x)
    a = L.rms_norm(a, bp["fuse_norm_attn"], cfg.rms_eps)
    s = L.rms_norm(s, bp["fuse_norm_ssm"], cfg.rms_eps)
    x = x + 0.5 * (a + s)
    return x + _mlp(bp, cfg, x)


# ===========================================================================
# Full forward
# ===========================================================================


def _call(block, remat: bool, *args):
    """One block call, under a non-reentrant checkpoint with ``remat``."""
    if remat:
        return checkpoint(block, *args, use_reentrant=False)
    return block(*args)


def forward(params: dict, cfg: ModelConfig, batch: dict,
            remat: bool = False) -> tuple[Tensor, Tensor]:
    """Forward pass over whole sequences. Returns (logits, moe_aux_loss).

    logits: (B, S, V) — or (B, S, K, V) for codebook (audio) models. With
    ``remat`` each block is checkpointed (training; the loss's default)."""
    x, positions = embed_inputs(params, cfg, batch)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    blocks = params["blocks"]

    if cfg.family == "moe":
        for i in range(cfg.first_k_dense):
            x = _call(dense_block, remat, layer_slice(params["dense_blocks"], i), cfg, x,
                      positions, cfg.attn_window(i))
        for i in range(cfg.n_layers - cfg.first_k_dense):
            x, a = _call(moe_block, remat, layer_slice(blocks, i), cfg, x, positions,
                         cfg.attn_window(i + cfg.first_k_dense))
            aux = aux + a
    else:
        block = {"dense": dense_block, "ssm": ssm_block, "hybrid": hybrid_block}[cfg.family]
        for i in range(cfg.n_layers):
            x = _call(block, remat, layer_slice(blocks, i), cfg, x, positions,
                      cfg.attn_window(i))

    x = L.rms_norm(x, params["final_norm"], cfg.rms_eps)
    return project_logits(params, cfg, x), aux


def project_logits(params: dict, cfg: ModelConfig, x: Tensor) -> Tensor:
    if cfg.n_codebooks:
        return torch.einsum("bsd,kdv->bskv", x, params["codebook_head"].to(x.dtype))
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return torch.einsum("bsd,dv->bsv", x, head.to(x.dtype))


def _token_nll(logits: Tensor, labels: Tensor) -> Tensor:
    """-log softmax(logits)[label], the log-softmax in f32."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(lp, -1, labels[..., None].long())[..., 0]


def next_token_nll(logits: Tensor, cfg: ModelConfig, batch: dict) -> Tensor:
    """Each position's next-token NLL: (B, S-1, K) for codebook models, else
    (B, S-1) over the text positions (a vision model's patch positions come
    first and predict nothing)."""
    if cfg.n_codebooks:
        return _token_nll(logits[:, :-1], batch["codes"][:, 1:])
    if cfg.frontend == "vision":
        logits = logits[:, batch["patch_embeds"].shape[1]:]
    return _token_nll(logits[:, :-1], batch["tokens"][:, 1:])


def lm_loss(params: dict, cfg: ModelConfig, batch: dict, remat: bool = True):
    """Next-token cross entropy (+0.01 * MoE aux). Returns (loss, metrics):
    the mean NLL over every predicted position (codebooks included), or over
    the positions ``batch["loss_mask"]`` keeps (text models)."""
    logits, aux = forward(params, cfg, batch, remat=remat)
    nll = next_token_nll(logits, cfg, batch)
    mask = None if cfg.n_codebooks else batch.get("loss_mask")
    if mask is not None:
        mask = mask[:, 1:].to(nll.dtype)
        loss = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    else:
        loss = torch.mean(nll)
    return loss + 0.01 * aux, {"nll": loss, "moe_aux": aux}
