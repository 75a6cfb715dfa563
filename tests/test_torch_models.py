"""The port's LM scaffold (`repro_torch.models`, `repro_torch.configs`)
against the reference's, on the CPU at f32.

Configs equal field for field; each layer function, cache, the MoE routing
and dispatch and the SSD scan match the reference on the same numpy inputs
within 1e-5 (integer outputs exactly); `forward` over every reduced arch
matches within 1e-4 on the reference's own weights, carried across with
`params_from_numpy`.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import kvcache as jkv
from repro.models import layers as jL
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro.models import transformer as jt
from repro_torch.configs import registry as treg
from repro_torch.models import kvcache as tkv
from repro_torch.models import layers as tL
from repro_torch.models import moe as tmoe
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as tt
from repro_torch.models.config import ModelConfig

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **(tol or TOL))


def _normal(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


# ------------------------------------------------------------------ configs
def test_registry_equals_reference():
    assert treg.LM_ARCHS == jreg.LM_ARCHS
    assert treg.ALL_ARCHS == jreg.ALL_ARCHS
    for arch in treg.ALL_ARCHS:
        assert treg.get_module(arch).__name__ == "repro_torch" + jreg.get_module(arch).__name__[5:]
    with pytest.raises(ValueError, match="unknown arch"):
        treg.get_config("gpt-5")


@pytest.mark.parametrize("arch", jreg.LM_ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_lm_configs_equal_reference(arch, reduced):
    got, want = treg.get_config(arch, reduced), jreg.get_config(arch, reduced)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.param_count() == want.param_count()
    assert got.active_param_count() == want.active_param_count()
    assert (got.subquadratic, got.d_inner, got.ssm_heads) == (
        want.subquadratic, want.d_inner, want.ssm_heads)
    assert [got.attn_window(i) for i in range(got.n_layers)] == [
        want.attn_window(i) for i in range(want.n_layers)]


def test_model_config_validates_like_reference():
    with pytest.raises(ValueError, match="unknown family"):
        ModelConfig(name="x", family="rnn", n_layers=1, d_model=8, vocab_size=8)
    assert ModelConfig(name="x", family="dense", n_layers=1, d_model=64, vocab_size=8,
                       n_heads=4).head_dim == 16


# ------------------------------------------------------------------ layers
def test_norm_and_rope_match_reference():
    rng = np.random.default_rng(0)
    x, w = _normal(rng, 2, 5, 3, 16), _normal(rng, 16)
    _close(tL.rms_norm(_t(x), _t(w), 1e-5), jL.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))
    pos = np.arange(7, 12)
    for theta in (10000.0, 500000.0):
        cos, sin = tL.rope_angles(_t(pos), 16, theta)
        jcos, jsin = jL.rope_angles(jnp.asarray(pos), 16, theta)
        _close(cos, jcos)
        _close(sin, jsin)
        _close(tL.apply_rope(_t(x), cos, sin),
               jL.apply_rope(jnp.asarray(x), jcos, jsin))
    bpos = np.stack([pos, pos + 3])  # (B, S) positions
    cos, sin = tL.rope_angles(_t(bpos), 16, 10000.0)
    jcos, jsin = jL.rope_angles(jnp.asarray(bpos), 16, 10000.0)
    _close(tL.apply_rope(_t(x), cos, sin), jL.apply_rope(jnp.asarray(x), jcos, jsin))


@pytest.mark.parametrize("window,qc,kc", [(0, 16, 32), (0, 7, 13), (16, 128, 128), (5, 8, 8)])
def test_chunked_attention_matches_reference(window, qc, kc):
    rng = np.random.default_rng(0)
    B, S, H, KH, D = 2, 67, 6, 2, 16
    q, k, v = _normal(rng, B, S, H, D), _normal(rng, B, S, KH, D), _normal(rng, B, S, KH, D)
    pos = np.arange(S)
    got = tL.chunked_attention(_t(q), _t(k), _t(v), _t(pos), _t(pos), window=window,
                               q_chunk=qc, kv_chunk=kc)
    want = jL.chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                jnp.asarray(pos), jnp.asarray(pos), window=window,
                                q_chunk=qc, kv_chunk=kc)
    assert got.shape == (B, S, H, D)
    _close(got, want)


@pytest.mark.parametrize("window", [0, 3])
def test_decode_attention_matches_reference(window):
    rng = np.random.default_rng(1)
    B, Lc, H, KH, D = 3, 11, 4, 2, 8
    q, k, v = _normal(rng, B, 1, H, D), _normal(rng, B, Lc, KH, D), _normal(rng, B, Lc, KH, D)
    lengths = np.array([1, 6, 11], np.int32)
    _close(tL.decode_attention(_t(q), _t(k), _t(v), _t(lengths), window=window),
           jL.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(lengths), window=window))


@pytest.mark.parametrize("valid_len", [1, 3, 8])
def test_ring_decode_attention_matches_reference(valid_len):
    rng = np.random.default_rng(2)
    B, W, H, KH, D = 2, 8, 4, 1, 8
    q, k, v = _normal(rng, B, 1, H, D), _normal(rng, B, W, KH, D), _normal(rng, B, W, KH, D)
    got = tL.ring_decode_attention(_t(q), _t(k), _t(v), valid_len)
    _close(got, jL.ring_decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         valid_len))
    # the unfilled slots do not count
    k2, v2 = k.copy(), v.copy()
    k2[:, valid_len:] = v2[:, valid_len:] = 99.0
    _close(tL.ring_decode_attention(_t(q), _t(k2), _t(v2), valid_len), got.numpy())


def test_swiglu_matches_reference():
    rng = np.random.default_rng(3)
    x = _normal(rng, 2, 5, 16)
    wg, wu, wd = _normal(rng, 16, 24), _normal(rng, 16, 24), _normal(rng, 24, 16)
    _close(tL.swiglu(_t(x), _t(wg), _t(wu), _t(wd)),
           jL.swiglu(*(jnp.asarray(a) for a in (x, wg, wu, wd))))


# ------------------------------------------------------------------ caches
def _cache_pair(kind, rng, n_layers=2, batch=3, n_kv=2, hd=4, **kw):
    tcls, jcls = getattr(tkv, kind), getattr(jkv, kind)
    return (tcls.init(n_layers, batch, *kw["len"], n_kv, hd, dtype=torch.float32,
                      device=torch.device("cpu"), **kw.get("extra", {})),
            jcls.init(n_layers, batch, *kw["len"], n_kv, hd, dtype=jnp.float32,
                      **kw.get("extra", {})))


def test_kv_cache_matches_reference():
    rng = np.random.default_rng(4)
    tc, jc = _cache_pair("KVCache", rng, len=(9,))
    for layer, s in ((0, 4), (1, 4)):
        k, v = _normal(rng, 3, s, 2, 4), _normal(rng, 3, s, 2, 4)
        tc = tc.update_layer(_t(k), _t(v), layer)
        jc = jc.update_layer(jnp.asarray(k), jnp.asarray(v), layer)
    tc, jc = tc.advanced(4), jc.advanced(4)
    k, v = _normal(rng, 3, 5, 2, 4), _normal(rng, 3, 5, 2, 4)
    tc = tc.update_layer(_t(k), _t(v), 1).advanced(5)
    jc = jc.update_layer(jnp.asarray(k), jnp.asarray(v), 1).advanced(5)
    assert tc.length == int(jc.length) == 9
    np.testing.assert_array_equal(tc.k.numpy(), np.asarray(jc.k))
    np.testing.assert_array_equal(tc.v.numpy(), np.asarray(jc.v))
    # the reference clamps a start past the end; the port raises
    with pytest.raises(ValueError, match="past its max_len"):
        tc.update_layer(_t(k[:, :1]), _t(v[:, :1]), 0)


def test_ring_kv_cache_matches_reference():
    rng = np.random.default_rng(5)
    tc, jc = _cache_pair("RingKVCache", rng, len=(4,))
    for step in range(7):  # wraps the 4-slot ring
        k, v = _normal(rng, 3, 1, 2, 4), _normal(rng, 3, 1, 2, 4)
        tc = tc.write_token(_t(k), _t(v), step % 2)
        jc = jc.write_token(jnp.asarray(k), jnp.asarray(v), step % 2)
        np.testing.assert_array_equal(tc.relative_positions().numpy(),
                                      np.asarray(jc.relative_positions()))
        tc, jc = tc._replace(length=tc.length + 1), jc._replace(length=jc.length + 1)
    assert tc.window == jc.window == 4
    np.testing.assert_array_equal(tc.k.numpy(), np.asarray(jc.k))
    np.testing.assert_array_equal(tc.v.numpy(), np.asarray(jc.v))


@pytest.mark.parametrize("page_size,slack", [(4, 0), (3, 2)])
def test_paged_kv_cache_matches_reference(page_size, slack):
    rng = np.random.default_rng(6)
    extra = dict(page_size=page_size, slack_pages=slack)
    tc, jc = _cache_pair("PagedKVCache", rng, len=(10,), extra=extra)
    np.testing.assert_array_equal(tc.page_table.numpy(), np.asarray(jc.page_table))
    assert tc.k_pages.shape == jc.k_pages.shape and tc.page_size == jc.page_size
    # a shuffled page table: the pages of a sequence need not be in order
    table = np.stack([rng.permutation(tc.page_table.shape[1] + slack)[: tc.page_table.shape[1]]
                      for _ in range(3)]).astype(np.int32)
    tc = tc._replace(page_table=_t(table))
    jc = jc._replace(page_table=jnp.asarray(table))
    capacity = table.shape[1] * page_size
    for _ in range(capacity):
        for layer in (0, 1):
            k, v = _normal(rng, 3, 1, 2, 4), _normal(rng, 3, 1, 2, 4)
            tc = tc.write_token(_t(k), _t(v), layer)
            jc = jc.write_token(jnp.asarray(k), jnp.asarray(v), layer)
        tc, jc = tc.advanced(1), jc.advanced(1)
        for layer in (0, 1):
            for a, b in zip(tc.gather_layer(layer), jc.gather_layer(layer)):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))
    np.testing.assert_array_equal(tc.k_pages.numpy(), np.asarray(jc.k_pages))
    assert tc.max_length == capacity
    with pytest.raises(ValueError, match="past its"):
        tc.write_token(_t(k), _t(v), 0)


# ------------------------------------------------------------------ MoE
@pytest.mark.parametrize("shape,top_k", [((4, 6, 8), 2), ((2, 5, 64), 8), ((3, 16), 3)])
def test_route_matches_reference_with_planted_ties(shape, top_k):
    rng = np.random.default_rng(7)
    # few distinct values, so most rows tie, at the k-th place and elsewhere
    logits = rng.integers(0, 4, size=shape).astype(np.float32) * 0.25
    logits[..., :3] = 1.0  # a three-way tie at the top of every row
    ids, w = tmoe.route(_t(logits), top_k)
    jids, jw = jmoe.route(jnp.asarray(logits), top_k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    _close(w, jw)
    # bf16-rounded router logits, as the MoE block makes them
    bf = np.asarray(jnp.asarray(rng.normal(size=shape) * 0.02, jnp.bfloat16).astype(jnp.float32))
    ids, w = tmoe.route(_t(bf), top_k)
    jids, jw = jmoe.route(jnp.asarray(bf), top_k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    _close(w, jw)


@pytest.mark.parametrize("n_experts,capacity", [(4, 1), (8, 3), (8, 16)])
def test_dispatch_indices_equal_reference(n_experts, capacity):
    rng = np.random.default_rng(8)
    ids = rng.integers(0, n_experts, size=(3, 40)).astype(np.int32)
    slot, keep = tmoe.dispatch_indices(_t(ids), n_experts, capacity)
    jslot, jkeep = jmoe.dispatch_indices(jnp.asarray(ids), n_experts, capacity)
    np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))


def test_dispatch_drops_overflow_like_reference():
    ids = np.array([[0, 1, 0, 1, 0, 2]], np.int32)
    _, keep = tmoe.dispatch_indices(_t(ids), 4, 1)
    assert keep.numpy().tolist() == [[True, True, False, False, False, True]]
    assert tmoe.moe_capacity(4096, 64, 6, 1.25) == jmoe.moe_capacity(4096, 64, 6, 1.25)
    assert tmoe.moe_capacity(1, 64, 8, 1.25) == jmoe.moe_capacity(1, 64, 8, 1.25) == 8


@pytest.mark.parametrize("capacity_factor", [8.0, 0.5])
def test_moe_block_matches_reference(capacity_factor):
    rng = np.random.default_rng(9)
    G, N, d, E, ff, k = 3, 32, 16, 8, 32, 2
    x = _normal(rng, G, N, d)
    rw = _normal(rng, d, E, scale=0.1)
    wg, wu, wd = (_normal(rng, E, d, ff, scale=0.1), _normal(rng, E, d, ff, scale=0.1),
                  _normal(rng, E, ff, d, scale=0.1))
    out, aux = tmoe.moe_block(*(_t(a) for a in (x, rw, wg, wu, wd)), top_k=k,
                              capacity_factor=capacity_factor)
    jout, jaux = jax.jit(jmoe.moe_block, static_argnums=(5, 6))(
        *(jnp.asarray(a) for a in (x, rw, wg, wu, wd)), k, capacity_factor)
    _close(out, jout)
    _close(aux, jaux)
    if capacity_factor < 1:  # capacity 8 of 16 assignments an expert on average: drops
        ids, _ = tmoe.route(torch.einsum("gnd,de->gne", _t(x), _t(rw)), k)
        _, keep = tmoe.dispatch_indices(ids.reshape(G, N * k), E, tmoe.moe_capacity(N, E, k, 0.5))
        assert not bool(keep.all())


# ------------------------------------------------------------------ SSD
def _ssd_inputs(rng, B, S, d_inner, N, P):
    H = d_inner // P
    xbc = _normal(rng, B, S, d_inner + 2 * N)
    dt = np.abs(_normal(rng, B, S, H)) * 0.1
    A = -np.abs(_normal(rng, H))
    return xbc, dt, A


@pytest.mark.parametrize("chunk", [8, 16, 64])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_scan_matches_reference(chunk, with_state):
    rng = np.random.default_rng(10)
    B, S, d_inner, N, P = 2, 37, 32, 8, 8
    xbc, dt, A = _ssd_inputs(rng, B, S, d_inner, N, P)
    h0 = _normal(rng, B, d_inner // P, P, N) if with_state else None
    y, hf = tssm.ssd_scan(_t(xbc), _t(dt), _t(A), d_inner, N, P, chunk,
                          initial_state=None if h0 is None else _t(h0))
    jy, jhf = jax.jit(jssm.ssd_scan, static_argnums=(3, 4, 5, 6))(
        jnp.asarray(xbc), jnp.asarray(dt), jnp.asarray(A), d_inner, N, P, chunk,
        None if h0 is None else jnp.asarray(h0))
    _close(y, jy)
    _close(hf, jhf)


def test_ssd_decode_step_matches_reference():
    rng = np.random.default_rng(11)
    B, d_inner, N, P = 3, 32, 8, 8
    xbc, dt, A = _ssd_inputs(rng, B, 1, d_inner, N, P)
    state = _normal(rng, B, d_inner // P, P, N)
    y, s = tssm.ssd_decode_step(_t(xbc[:, 0]), _t(dt[:, 0]), _t(A), _t(state), d_inner, N, P)
    jy, js = jssm.ssd_decode_step(jnp.asarray(xbc[:, 0]), jnp.asarray(dt[:, 0]),
                                  jnp.asarray(A), jnp.asarray(state), d_inner, N, P)
    _close(y, jy)
    _close(s, js)


@pytest.mark.parametrize("S", [1, 2, 9])
def test_causal_conv_matches_reference(S):
    rng = np.random.default_rng(12)
    x, w, cache = _normal(rng, 2, S, 6), _normal(rng, 4, 6), _normal(rng, 2, 3, 6)
    for c in (None, cache):
        y, nc = tssm.causal_conv(_t(x), _t(w), None if c is None else _t(c))
        jy, jnc = jssm.causal_conv(jnp.asarray(x), jnp.asarray(w),
                                   None if c is None else jnp.asarray(c))
        _close(y, jy)
        np.testing.assert_array_equal(nc.numpy(), np.asarray(jnc))


# ------------------------------------------------------------------ forward
def _batch(cfg, rng, B, S):
    if cfg.n_codebooks:
        batch = {"codes": rng.integers(0, cfg.vocab_size, (B, S, cfg.n_codebooks))}
    else:
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S))}
    if cfg.frontend == "vision":
        batch["patch_embeds"] = _normal(rng, B, cfg.n_patches, cfg.d_model)
    return batch


@pytest.mark.parametrize("arch", jreg.LM_ARCHS)
def test_forward_matches_reference(arch):
    jcfg, cfg = jreg.get_config(arch, reduced=True), treg.get_config(arch, reduced=True)
    # one compiled program a config: far quicker here than op-by-op dispatch
    init = jax.jit(jt.init_params, static_argnums=1)
    tree = jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(1), jcfg))
    params = tt.params_from_numpy(tree, cfg, "cpu")
    assert tt.param_count(params) == jt.param_count(tree)
    batch = _batch(cfg, np.random.default_rng(13), 2, 24)
    fwd = jax.jit(lambda p, b: jt.forward(p, jcfg, b, remat=False))
    jlogits, jaux = fwd(tree, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.inference_mode():
        logits, aux = tt.forward(params, cfg, {k: _t(v) for k, v in batch.items()})
    S = 24 + (cfg.n_patches if cfg.frontend == "vision" else 0)
    want_shape = (2, S, cfg.n_codebooks, cfg.vocab_size) if cfg.n_codebooks else (
        2, S, cfg.vocab_size)
    assert tuple(logits.shape) == want_shape == jlogits.shape
    _close(logits, jlogits, rtol=1e-4, atol=1e-4)
    _close(aux, jaux, rtol=1e-4, atol=1e-4)
    assert math.isfinite(float(aux))
