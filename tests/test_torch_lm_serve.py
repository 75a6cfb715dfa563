"""The port's LM serving path (`repro_torch.models.serve`) against the
reference's, on the CPU.

Both packages serve the same weights: the reference's ``init_params`` tree,
carried to the port by `params_from_numpy`. At f32, prefill and 5 greedy
decode steps give logits within 1e-4 and equal tokens, for every reduced
arch and the four serve cases of ``tests/test_models.py`` (dense and MoE,
contiguous and paged; SSM; the hybrid, whose 8-slot ring wraps over a
24-token prompt). In bf16 one arch of each family is held, teacher-forced
on the reference's tokens, within a tolerance relative to the largest
logit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import serve as js
from repro.models import transformer as jt
from repro.models.config import ModelConfig as JModelConfig
from repro_torch.configs import registry as treg
from repro_torch.models import serve as ts
from repro_torch.models import transformer as tt
from repro_torch.models.config import ModelConfig

B, S, STEPS = 2, 24, 5
TOL = dict(rtol=1e-4, atol=1e-4)
# bf16 logits against the reference's, teacher-forced: both round every
# product and activation to bf16, in different orders (XLA may also keep
# excess precision between fused ops), so they agree to a few bf16 ulps of
# the largest logit
BF16_REL_TOL = 0.03

# the serve cases of tests/test_models.py
CASE_KW = {
    "dense": dict(family="dense", n_layers=3, d_model=64, vocab_size=128, n_heads=4,
                  n_kv_heads=2, d_ff=128, dtype="float32"),
    "moe": dict(family="moe", n_layers=3, d_model=64, vocab_size=128, n_heads=4, n_kv_heads=4,
                d_ff=64, n_experts=4, top_k=2, first_k_dense=1, capacity_factor=8.0,
                dtype="float32"),
    "ssm": dict(family="ssm", n_layers=3, d_model=64, vocab_size=128, ssm_state=16,
                ssm_head_dim=16, ssm_chunk=8, dtype="float32"),
    "hyb": dict(family="hybrid", n_layers=4, d_model=64, vocab_size=128, n_heads=4,
                n_kv_heads=2, d_ff=128, ssm_state=16, ssm_head_dim=16, ssm_chunk=8,
                swa_window=8, n_global_layers=2, dtype="float32"),
}
BF16_ARCHS = ["llama3.2-1b", "olmoe-1b-7b", "mamba2-130m", "hymba-1.5b"]

_weights: dict = {}
# one compiled program a config: far quicker here than op-by-op dispatch
_jinit = jax.jit(jt.init_params, static_argnums=1)
_jprefill = jax.jit(js.prefill, static_argnums=(1, 3, 4))


def _configs(name: str, dtype: str = "float32"):
    if name in CASE_KW:
        jcfg = JModelConfig(name=name, **CASE_KW[name])
        cfg = ModelConfig(name=name, **CASE_KW[name])
    else:
        jcfg, cfg = jreg.get_config(name, reduced=True), treg.get_config(name, reduced=True)
    return dataclasses.replace(jcfg, dtype=dtype), dataclasses.replace(cfg, dtype=dtype)


def _reference_tree(name: str, jcfg) -> dict:
    """The reference's weights for a config, built once a module."""
    key = (name, jcfg.dtype)
    if key not in _weights:
        _weights[key] = jax.tree_util.tree_map(
            np.asarray, _jinit(jax.random.PRNGKey(0), jcfg))
    return _weights[key]


def _prompts(cfg, seed=0):
    rng = np.random.default_rng(seed)
    shape = (B, S, cfg.n_codebooks) if cfg.n_codebooks else (B, S)
    return rng.integers(0, cfg.vocab_size, shape)


def _serve_both(name, paged=False, dtype="float32", steps=STEPS):
    """(reference logits, port logits, reference tokens, port tokens), one of
    each for prefill and every decode step. In f32 each package follows its
    own greedy tokens; in bf16 both are fed the reference's."""
    jcfg, cfg = _configs(name, dtype)
    tree = _reference_tree(name, jcfg)
    params = tt.params_from_numpy(tree, cfg, "cpu")
    prompts = _prompts(cfg)
    forced = dtype != "float32"
    jl, jc = _jprefill(tree, jcfg, jnp.asarray(prompts, jnp.int32), S + steps, paged)
    with torch.inference_mode():
        tl, tc = ts.prefill(params, cfg, torch.from_numpy(prompts), max_len=S + steps,
                            paged=paged)
    jdec = jax.jit(lambda t, c: js.decode_step(tree, jcfg, t, c))
    out = ([np.asarray(jl, np.float32)], [tl.float().numpy()], [], [])
    for _ in range(steps):
        jtok = jnp.argmax(jl, -1).astype(jnp.int32)
        ttok = torch.from_numpy(np.array(jtok)) if forced else torch.argmax(tl, -1)
        out[2].append(np.asarray(jtok))
        out[3].append(ttok.numpy())
        jl, jc = jdec(jtok, jc)
        with torch.inference_mode():
            tl, tc = ts.decode_step(params, cfg, ttok, tc)
        out[0].append(np.asarray(jl, np.float32))
        out[1].append(tl.float().numpy())
    return out


def _assert_f32_match(name, paged=False):
    jls, tls, jtoks, ttoks = _serve_both(name, paged)
    for step, (a, b) in enumerate(zip(tls, jls)):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, err_msg=f"step {step}", **TOL)
    for a, b in zip(ttoks, jtoks):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", jreg.LM_ARCHS)
def test_reduced_arch_serves_like_reference(arch):
    _assert_f32_match(arch)


@pytest.mark.parametrize("arch", ["musicgen-large", "olmoe-1b-7b"])
def test_reduced_arch_serves_paged_like_reference(arch):
    _assert_f32_match(arch, paged=True)


@pytest.mark.parametrize("case,paged", [("dense", False), ("dense", True), ("moe", False),
                                        ("moe", True), ("ssm", False), ("hyb", False)])
def test_serve_case_matches_reference(case, paged):
    _assert_f32_match(case, paged)


@pytest.mark.parametrize("arch", BF16_ARCHS)
def test_bf16_serving_stays_close_to_reference(arch):
    jls, tls, _, _ = _serve_both(arch, dtype="bfloat16")
    for step, (a, b) in enumerate(zip(tls, jls)):
        assert np.all(np.isfinite(a))
        err = np.abs(a - b).max() / np.abs(b).max()
        assert err <= BF16_REL_TOL, f"{arch} step {step}: {err}"


def test_hybrid_ring_wraps_at_this_prompt():
    _, cfg = _configs("hyb")
    windows = [cfg.attn_window(i) for i in range(cfg.n_layers)]
    assert 0 < max(windows) < S and 0 in windows  # ring and global layers both present
    with torch.inference_mode():
        params = tt.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        _, cache = ts.prefill(params, cfg, torch.from_numpy(_prompts(cfg)), max_len=S + 1)
    assert [kc.shape[1] for kc, _ in cache.attn] == [w or S + 1 for w in windows]


# ------------------------------------------------- the port against itself
@pytest.mark.parametrize("case", list(CASE_KW))
def test_prefill_and_decode_match_forward(case):
    _, cfg = _configs(case)
    params = tt.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    toks = torch.from_numpy(_prompts(cfg, seed=1))
    ext = torch.cat([toks, toks[:, :1]], dim=1)
    with torch.inference_mode():
        full, _ = tt.forward(params, cfg, {"tokens": ext})
        lg, cache = ts.prefill(params, cfg, toks, max_len=S + 8)
        np.testing.assert_allclose(lg.numpy(), full[:, S - 1].numpy(), atol=1e-3)
        lg, cache = ts.decode_step(params, cfg, ext[:, S], cache)
        np.testing.assert_allclose(lg.numpy(), full[:, S].numpy(), atol=1e-3)


@pytest.mark.parametrize("case", ["dense", "hyb"])
def test_decode_past_max_len_raises(case):
    # the reference's dynamic_update_slice would clamp and overwrite the
    # last slot; the port refuses the write
    _, cfg = _configs(case)
    params = tt.init_params(cfg, torch.Generator().manual_seed(2), "cpu")
    toks = torch.from_numpy(_prompts(cfg))
    with torch.inference_mode():
        lg, cache = ts.prefill(params, cfg, toks, max_len=S + 1)
        lg, cache = ts.decode_step(params, cfg, torch.argmax(lg, -1), cache)
        with pytest.raises(ValueError, match="past its"):
            ts.decode_step(params, cfg, torch.argmax(lg, -1), cache)
        with pytest.raises(ValueError, match="does not fit"):
            ts.prefill(params, cfg, toks, max_len=S - 1)


# ------------------------------------------------------------- weights
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_numpy_is_bit_exact(dtype):
    jcfg, cfg = _configs("olmoe-1b-7b", dtype)
    tree = _reference_tree("olmoe-1b-7b", jcfg)
    params = tt.params_from_numpy(tree, cfg, "cpu")
    got = dict(tt._leaves(params))
    want = dict(tt._leaves(tree))
    assert set(got) == set(want)
    for k, w in want.items():
        t = got[k]
        assert t.dtype == getattr(torch, dtype) and tuple(t.shape) == w.shape
        bits = np.uint16 if dtype == "bfloat16" else np.uint32
        np.testing.assert_array_equal(
            t.view(torch.int16 if dtype == "bfloat16" else torch.int32).numpy().view(bits),
            np.ascontiguousarray(w).view(bits), err_msg=k)


def test_params_from_numpy_refuses_a_mismatched_tree():
    jcfg, cfg = _configs("dense")
    tree = _reference_tree("dense", jcfg)
    with pytest.raises(ValueError, match="keys differ"):
        tt.params_from_numpy({**tree, "extra": np.zeros(3, np.float32)}, cfg, "cpu")
    blocks = dict(tree["blocks"], wq=tree["blocks"]["wq"][:1])
    with pytest.raises(ValueError, match="wq"):
        tt.params_from_numpy({**tree, "blocks": blocks}, cfg, "cpu")
    with pytest.raises(ValueError, match="final_norm"):
        tt.params_from_numpy({**tree, "final_norm": tree["final_norm"].astype(np.float16)},
                             cfg, "cpu")


@pytest.mark.parametrize("arch", jreg.LM_ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_init_params_has_the_reference_tree(arch, reduced):
    """Keys, shapes and dtypes of the port's init against the reference's,
    at full width on the meta device (nothing allocated)."""
    jcfg, cfg = jreg.get_config(arch, reduced), treg.get_config(arch, reduced)
    shapes = jax.eval_shape(lambda key: jt.init_params(key, jcfg), jax.random.PRNGKey(0))
    want = dict(tt._leaves(shapes))
    got = dict(tt._leaves(tt.init_params(cfg, None, "meta")))
    assert set(got) == set(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape, k
        assert str(got[k].dtype) == f"torch.{w.dtype}", k
    assert tt.param_count(got) == sum(int(np.prod(w.shape)) for w in want.values())
