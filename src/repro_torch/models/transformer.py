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
memory, never values.

Under a mesh (`repro_torch.sharding.set_mesh_context`, the weights DTensors
laid out by `param_specs`) the reference's sharding constraints sit where
they sit there (`_c`: the residual stream, the logits); with no mesh set
they return their input itself, and every result is what it was. Where
XLA's partitioner places a layout by itself, the port places it at the
call site:
  * ``"act_batch_only"`` (the sequence gathered, Megatron sequence
    parallelism's all-gather) at the inputs of the column-parallel products
    and of ``wo``: DTensor's matmul rules do not take a (batch, sequence)
    split flattened into one strided dim;
  * `sharding.on_shards` runs the attention core (queries by batch and
    sequence), the SSD conv, scan and gate (by batch), the embedding
    lookup and the loss (by the table's and the logits' shards) on local
    shards, where DTensor has no rule or a costly one;
  * the loss over sharded logits is Megatron's vocab-parallel cross
    entropy (logsumexp minus the label's logit, reduced across the vocab
    shards with `sharding.sum_across`), so the vocabulary stays split.
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
from repro_torch.sharding.rules import (
    P,
    constrain,
    constrain_act,
    current_mesh_axes,
    fit_spec,
    max_across,
    on_shards,
    set_mesh_context,
    spec_of,
    sum_across,
)

Tensor = torch.Tensor


def _c(x: Tensor, kind: str) -> Tensor:
    """Constrain activation sharding if a mesh context is ambient (axes that
    do not divide a dim are dropped, as `constrain_act` does)."""
    return constrain_act(x, kind)


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
    they differ from the reference's (carry those with `params_from_numpy`).
    Each drawn leaf is allocated once and filled a layer or a row block at a
    time (`layers.dense_init`): the draw's peak is the weights and one f32
    block, which lets llava-next-34b's 68.8 GB of bf16 weights be drawn on
    one 80 GB card."""
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


def lookup(table: Tensor, ids: Tensor) -> Tensor:
    """``table[ids]``. On a sharded table (under a mesh) the lookup runs on
    each rank's shard of the table as the rules lay it out, with every id:
    a rank gathers its slice of ``d`` for every id, and where the vocab is
    split over an axis it looks up only the ids in its slice of rows (zeros
    elsewhere), summed across the vocab shards. The table's gradient then
    comes back in the table's own layout. (DTensor's own embedding rule mislays its partial
    lookups' mask once the ids are split, and an index's backward, an
    ``index_put``, it does not lay out in every torch version.)"""
    if not hasattr(table, "device_mesh"):
        return table[ids]
    mesh = table.device_mesh
    vocab_axis, d_axis = spec_of(table)
    every = P(*([None] * ids.ndim))
    if not isinstance(vocab_axis, str):  # whole (or over several axes: gathered)
        return on_shards(lambda t, i: t[i], (table, ids), (P(None, d_axis), every),
                         P(*every, d_axis))
    n_local = table.shape[0] // mesh.size(mesh.mesh_dim_names.index(vocab_axis))
    offset = mesh.get_local_rank(vocab_axis) * n_local

    def local(t, i):
        i = i.long() - offset
        inside = (i >= 0) & (i < t.shape[0])
        got = t[torch.clamp(i, 0, t.shape[0] - 1)].masked_fill(~inside[..., None], 0)
        return sum_across(got, mesh, vocab_axis)

    return on_shards(local, (table, ids), (P(vocab_axis, d_axis), every), P(*every, d_axis))


def embed_inputs(params: dict, cfg: ModelConfig, batch: dict) -> tuple[Tensor, Tensor]:
    """Returns (x (B,S,d), positions (S,)). Frontends are STUBS: vision/audio
    inputs arrive as precomputed embeddings/codes in the batch dict."""
    dtype = model_dtype(cfg)
    if cfg.n_codebooks:  # audio: codes (B, S, K)
        codes = batch["codes"]
        emb = params["codebook_embed"]  # (K, V, d)
        x = sum(lookup(emb[k], codes[..., k]) for k in range(cfg.n_codebooks))
    else:
        x = lookup(params["embed"], batch["tokens"])  # (B,S,d)
        if cfg.frontend == "vision":
            patches = batch["patch_embeds"].to(dtype)  # (B,P,d) precomputed
            x = torch.cat([patches, x], dim=1)
    S = x.shape[1]
    return x.to(dtype), torch.arange(S, device=x.device)


# ===========================================================================
# Blocks (prefill mode: full sequences)
# ===========================================================================


def heads_proj(xn: Tensor, w: Tensor) -> Tensor:
    """(B, S, d) x (d, H, hd) -> (B, S, H, hd). A weight whose heads do not
    divide the model axis is sharded on head_dim (the rules' fallback); its
    product is taken with head_dim outermost, so the product's reshapes
    split a flattened (head_dim, heads) dim at its sharded outer part.
    (``torch.einsum`` orders the dims it flattens by label, so head_dim's
    label ``a`` sorts before the heads' ``h``.)"""
    w = w.to(xn.dtype)
    if _shards_dim(w, 2):
        return torch.einsum("bsd,dah->bsah", xn, w.transpose(1, 2)).transpose(2, 3)
    return torch.einsum("bsd,dhk->bshk", xn, w)


def heads_out(out: Tensor, wo: Tensor) -> Tensor:
    """(B, S, H, hd) x (H, hd, d) -> (B, S, d), head_dim outermost where
    ``wo`` is sharded on it (see `heads_proj`). Under a mesh the heads'
    outputs are gathered over ``model`` first (the attention core splits
    them by sequence, decode by head_dim), so the product splits only
    ``wo``'s dims."""
    out = _c(out, "act_batch_only")
    wo = wo.to(out.dtype)
    if _shards_dim(wo, 1):
        return torch.einsum("bsah,ahd->bsd", out.transpose(2, 3), wo.transpose(0, 1))
    return torch.einsum("bshk,hkd->bsd", out, wo)


def _shards_dim(x: Tensor, dim: int) -> bool:
    """Whether ``x`` is a DTensor sharded on ``dim``."""
    return any(pl.is_shard() and pl.dim % x.ndim == dim
               for pl in getattr(x, "placements", ()))


def attend(q: Tensor, k: Tensor, v: Tensor, positions: Tensor, window: int,
           q_chunk: int = 512, kv_chunk: int = 1024) -> Tensor:
    """`layers.chunked_attention` of a whole sequence. Under a mesh it runs
    on each rank's shard: queries split by batch over the data axes and by
    sequence over ``model`` (each rank attends its query rows, with their
    positions, to every key of its batch rows), keys and values by batch."""
    def fn(q, k, v, qp, kp):
        return L.chunked_attention(q, k, v, qp, kp, window=window, q_chunk=q_chunk,
                                   kv_chunk=kv_chunk)

    ctx = current_mesh_axes()
    if ctx is None:
        return fn(q, k, v, positions, positions)
    axes = ctx[1]
    qs = fit_spec(q.shape, P(axes.data, axes.model))
    kvs = fit_spec(k.shape, P(axes.data))
    return on_shards(fn, (q, k, v, positions, positions), (qs, kvs, kvs, P(qs[1]), P(None)),
                     qs)


def _attention(bp, cfg: ModelConfig, x, positions, window: int, q_chunk=512, kv_chunk=1024):
    xn = _c(L.rms_norm(x, bp["attn_norm"], cfg.rms_eps), "act_batch_only")
    q = heads_proj(xn, bp["wq"])
    k = heads_proj(xn, bp["wk"])
    v = heads_proj(xn, bp["wv"])
    # the angles as replicated DTensors under a mesh: the rope's backward
    # then multiplies DTensors only, which needs no implicit replication on
    # the thread that runs it (on CUDA, the autograd engine's own)
    cos, sin = (constrain(t, P()) for t in L.rope_angles(positions, cfg.head_dim,
                                                          cfg.rope_theta))
    q = L.apply_rope(q, cos, sin)
    k = L.apply_rope(k, cos, sin)
    out = attend(q, k, v, positions, window, q_chunk=q_chunk, kv_chunk=kv_chunk)
    return heads_out(out, bp["wo"].to(x.dtype)), (k, v)


def _mlp(bp, cfg: ModelConfig, x):
    xn = _c(L.rms_norm(x, bp["mlp_norm"], cfg.rms_eps), "act_batch_only")
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
    xn = _c(L.rms_norm(x, bp["ssm_norm_in"], cfg.rms_eps), "act_batch_only")
    proj = torch.einsum("bsd,dp->bsp", xn, bp["in_proj"].to(x.dtype))
    di, N = cfg.d_inner, cfg.ssm_state
    return proj[..., :di], proj[..., di : 2 * di + 2 * N], proj[..., 2 * di + 2 * N :]


def _ssm_gate(cfg: ModelConfig, dtype, y, xin, z, D, gate_norm):
    """Skip connection D * x and gated norm."""
    y = y + xin.float() * torch.repeat_interleave(D.float(), cfg.ssm_head_dim, dim=-1)
    y = y.to(dtype) * F.silu(z)
    return L.rms_norm(y, gate_norm, cfg.rms_eps)


def _ssm_out(bp, cfg: ModelConfig, x, y, xin, z):
    """Skip connection D * x, gated norm and output projection."""
    y = _ssm_gate(cfg, x.dtype, y, xin, z, bp["D"], bp["gate_norm"])
    return torch.einsum("bsi,id->bsd", y, bp["out_proj"].to(x.dtype))


def _ssm_mix(bp, cfg: ModelConfig, x, state=None, chunk=None):
    """Full-sequence SSD mixer. Returns (out (B,S,d), final_state)."""
    z, xbc, dt_raw = _ssm_in(bp, cfg, x)
    dt = F.softplus(dt_raw.float() + bp["dt_bias"].float())
    A = -torch.exp(bp["A_log"].float())

    def mix(xbc, conv_w, dt, A, state, z, D, gate_norm):
        xbc_conv, _ = ssm_lib.causal_conv(xbc, conv_w.to(x.dtype))
        y, final_state = ssm_lib.ssd_scan(
            xbc_conv, dt, A, cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim,
            chunk or cfg.ssm_chunk, initial_state=state,
        )
        return _ssm_gate(cfg, x.dtype, y, xbc_conv[..., : cfg.d_inner], z, D,
                         gate_norm), final_state

    # under a mesh the conv, the scan and the gate run per sequence: batch
    # over the data axes, the rest whole (the heads need not divide the
    # model axis, and the scan and D's broadcast split d_inner into them)
    ctx = current_mesh_axes()
    rows = fit_spec(xbc.shape, P(ctx[1].data)) if ctx else None
    y, final_state = on_shards(
        mix, (xbc, bp["conv_w"], dt, A, state, z, bp["D"], bp["gate_norm"]),
        (rows, P(), rows, P(), rows if state is not None else None, rows, P(), P()),
        (rows, rows))
    return torch.einsum("bsi,id->bsd", y, bp["out_proj"].to(x.dtype)), final_state


def dense_block(bp, cfg: ModelConfig, x, positions, window):
    a, _ = _attention(bp, cfg, x, positions, window)
    x = x + _c(a, "act")
    return x + _c(_mlp(bp, cfg, x), "act")


def moe_block(bp, cfg: ModelConfig, x, positions, window):
    a, _ = _attention(bp, cfg, x, positions, window)
    x = x + _c(a, "act")
    f, aux = _moe_ffn(bp, cfg, x)
    return x + _c(f, "act"), aux


def ssm_block(bp, cfg: ModelConfig, x, positions, window):
    y, _ = _ssm_mix(bp, cfg, x)
    return x + _c(y, "act")


def hybrid_block(bp, cfg: ModelConfig, x, positions, window):
    """Hymba: attention and SSM heads in parallel on the same input, fused."""
    a, _ = _attention(bp, cfg, x, positions, window)
    s, _ = _ssm_mix(bp, cfg, x)
    a = L.rms_norm(a, bp["fuse_norm_attn"], cfg.rms_eps)
    s = L.rms_norm(s, bp["fuse_norm_ssm"], cfg.rms_eps)
    x = x + _c(0.5 * (a + s), "act")
    return x + _c(_mlp(bp, cfg, x), "act")


# ===========================================================================
# Full forward
# ===========================================================================


def _call(block, remat: bool, *args):
    """One block call, under a non-reentrant checkpoint with ``remat``. The
    backward's recompute runs the block again under the mesh of the forward:
    on CUDA the autograd engine runs a backward on its own device thread,
    which the ambient mesh (a contextvar) does not reach, and the block would
    then run its per-shard computations on DTensors."""
    if not remat:
        return block(*args)
    ctx = current_mesh_axes()
    if ctx is None:
        return checkpoint(block, *args, use_reentrant=False)

    def under_mesh(*a):
        with set_mesh_context(*ctx):
            return block(*a)

    return checkpoint(under_mesh, *args, use_reentrant=False)


def forward(params: dict, cfg: ModelConfig, batch: dict,
            remat: bool = False) -> tuple[Tensor, Tensor]:
    """Forward pass over whole sequences. Returns (logits, moe_aux_loss).

    logits: (B, S, V) — or (B, S, K, V) for codebook (audio) models. With
    ``remat`` each block is checkpointed (training; the loss's default)."""
    x, positions = embed_inputs(params, cfg, batch)
    x = _c(x, "act")
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
        head = params["codebook_head"].to(x.dtype)
        if current_mesh_axes() is not None:
            # one product a codebook: einsum would flatten (codebook, vocab)
            # into one dim whose vocab part is sharded, and fail to split it
            x = _c(x, "act_batch_only")
            return torch.stack([torch.einsum("bsd,dv->bsv", x, head[k])
                                for k in range(cfg.n_codebooks)], dim=2)
        return torch.einsum("bsd,kdv->bskv", x, head)
    head = _tied_head(params["embed"]) if cfg.tie_embeddings else params["lm_head"]
    x = _c(x, "act_batch_only")
    return _c(torch.einsum("bsd,dv->bsv", x, head.to(x.dtype)), "logits")


def _tied_head(embed: Tensor) -> Tensor:
    """The output head tied to ``embed`` (V, d): its transpose. A sharded
    table whose vocab is whole (it does not divide ``model``) is gathered
    whole for the product first, so the head's gradient comes back through
    that gather in the table's own layout, as the lookup's does, and the two
    add up there (DTensor cannot always add a partial sum to a shard)."""
    if hasattr(embed, "device_mesh") and spec_of(embed)[0] is None:
        embed = constrain(embed, P(None, None))
    return embed.T


def _token_nll(logits: Tensor, labels: Tensor) -> Tensor:
    """-log softmax(logits)[label], the log-softmax in f32. Sharded logits
    (DTensors) run it on each rank's shard: where the vocab is split over an
    axis, as Megatron's vocab-parallel cross entropy, logsumexp minus the
    label's logit with the max, the sum and the label's pick reduced across
    the vocab shards, so no rank holds the whole vocabulary."""
    if hasattr(logits, "device_mesh"):
        return _sharded_nll(logits, labels)
    lp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(lp, -1, labels[..., None].long())[..., 0]


def _sharded_nll(logits: Tensor, labels: Tensor) -> Tensor:
    mesh = logits.device_mesh
    spec = spec_of(logits)
    vocab_axis = spec[-1] if isinstance(spec[-1], str) else None
    spec = P(*spec[:-1], vocab_axis)  # a vocab over several axes: gathered
    rows = P(*spec[:-1])

    if vocab_axis is None:
        def local(x, lab):
            lp = torch.log_softmax(x.float(), dim=-1)
            return -torch.gather(lp, -1, lab[..., None].long())[..., 0]
    else:
        n_local = logits.shape[-1] // mesh.size(mesh.mesh_dim_names.index(vocab_axis))
        offset = mesh.get_local_rank(vocab_axis) * n_local

        def local(x, lab):
            x = x.float()
            m = max_across(torch.amax(x.detach(), dim=-1, keepdim=True), mesh, vocab_axis)
            total = sum_across(torch.sum(torch.exp(x - m), dim=-1, keepdim=True), mesh,
                               vocab_axis)
            idx = lab.long() - offset
            inside = (idx >= 0) & (idx < x.shape[-1])
            got = torch.gather(x, -1, torch.clamp(idx, 0, x.shape[-1] - 1)[..., None])
            picked = sum_across(got.masked_fill(~inside[..., None], 0.0), mesh, vocab_axis)
            return (torch.log(total) + m - picked)[..., 0]

    return on_shards(local, (logits, labels), (spec, rows), rows)


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
