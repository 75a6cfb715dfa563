"""The port's weight draw (`repro_torch.models.layers.dense_init` through
`transformer.init_params`) at every arch's full config, on the CPU.

The draw allocates each leaf once in the model's dtype and fills it one
block along dim 0 at a time, so a full-width draw never holds a whole f32
copy of a stacked tensor (88 GB for llava-next-34b's ``w_gate`` drawn whole).
Here, with a generator on the meta device (nothing allocated):

* every f32 tensor the draw makes is at most one layer of the stacked
  tensor it fills, a 2-D table's or head's blocks at most
  `layers.DRAW_BLOCK` elements, and the largest at most the config's
  largest layer slice;
* the drawn tree's keys, shapes and dtypes are the reference's
  ``jax.eval_shape(init_params)``.

At REDUCED, on real tensors: the same seed draws the same weights, another
seed others; every drawn leaf of 4,096 elements or more has a standard
deviation within 5% of the reference's rule (``dense_init``'s scale, or the
embeddings' 0.02), a rule checked against the reference's own draw within
the same 5%. The standard error of a sample standard deviation over n
normal draws is 1/sqrt(2n) of it, 1.1% at n = 4,096: 5% is 4.5 of them.
"""
import dataclasses
import math

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import registry as jreg
from repro.models import transformer as jt
from repro_torch.configs import registry as treg
from repro_torch.models import layers as tl
from repro_torch.models import transformer as tt

ARCHS = list(treg.LM_ARCHS)
STD_RTOL = 0.05
MIN_STD_ELEMS = 4096

_jinit = jax.jit(jt.init_params, static_argnums=1)


class _F32Allocs(TorchDispatchMode):
    """Records the element count of every f32 tensor an op makes (views and
    in-place results, which alias an input, are not new tensors), into the
    list ``into`` names at the time."""

    def __init__(self):
        super().__init__()
        self.into: list = []
        self.every: list = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if all(r.alias_info is None for r in func._schema.returns):
            for t in out if isinstance(out, (tuple, list)) else (out,):
                if isinstance(t, torch.Tensor) and t.dtype == torch.float32:
                    self.into.append(t.numel())
                    self.every.append(t.numel())
        return out


def _meta_draw(cfg, monkeypatch):
    """``init_params`` with a generator on the meta device: the tree, and
    each ``dense_init`` call's (shape, dtype, the f32 tensors it made), and
    every f32 tensor the whole draw made."""
    mode = _F32Allocs()
    calls = []
    draw = tl.dense_init

    def spy(gen, shape, dtype, device, scale=None):
        made: list = []
        calls.append((tuple(shape), dtype, made))
        mode.into = made
        try:
            return draw(gen, shape, dtype, device, scale)
        finally:
            mode.into = []

    monkeypatch.setattr(tl, "dense_init", spy)
    with mode:
        params = tt.init_params(cfg, torch.Generator().manual_seed(0), "meta")
    return params, calls, mode.every


def _largest_layer_slice(params: dict) -> int:
    """Elements of the largest one-layer slice of a layer-stacked tensor."""
    return max(math.prod(v.shape[1:]) for k, v in tt._leaves(params)
               if k.split("/")[0] in ("blocks", "dense_blocks") and v.ndim >= 3)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_draw_holds_one_f32_block_at_a_time(arch, monkeypatch):
    cfg = treg.get_config(arch)
    params, calls, every = _meta_draw(cfg, monkeypatch)
    largest = _largest_layer_slice(params)
    assert calls, arch
    for shape, dtype, made in calls:
        row = math.prod(shape[1:])
        bound = row if len(shape) >= 3 else max(tl.DRAW_BLOCK, row)
        assert dtype == getattr(torch, cfg.dtype)
        # f32 made here: the blocks' draws (their scaling is in place); in
        # an f32 model the result is f32 too, allocated once
        blocks = made[1:] if dtype == torch.float32 else made
        assert blocks and max(blocks) <= bound, (shape, max(blocks), bound)
        assert sum(blocks) == math.prod(shape), shape  # every element drawn once
    assert max(every) <= largest, (max(every), largest)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_draw_has_the_reference_tree(arch, monkeypatch):
    jcfg, cfg = jreg.get_config(arch), treg.get_config(arch)
    shapes = jax.eval_shape(lambda key: jt.init_params(key, jcfg), jax.random.PRNGKey(0))
    want = dict(tt._leaves(shapes))
    got = dict(tt._leaves(_meta_draw(cfg, monkeypatch)[0]))
    assert set(got) == set(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape, k
        assert str(got[k].dtype) == f"torch.{w.dtype}", k


def _same_weights(a: dict, b: dict) -> bool:
    return all(torch.equal(x, dict(tt._leaves(b))[k]) for k, x in tt._leaves(a))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_same_seed_draws_the_same_weights(arch, dtype, monkeypatch):
    # blocks of 1,000 elements: a 2-D table drawn in several row blocks
    monkeypatch.setattr(tl, "DRAW_BLOCK", 1000)
    cfg = dataclasses.replace(treg.get_config(arch, reduced=True), dtype=dtype)
    a = tt.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    b = tt.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    c = tt.init_params(cfg, torch.Generator().manual_seed(4), "cpu")
    assert _same_weights(a, b)
    assert not _same_weights(a, c)
    assert all(x.dtype == getattr(torch, dtype) for _, x in tt._leaves(a))


def _rule_scale(key: str, shape: tuple, cfg) -> float | None:
    """The reference's scale of a drawn leaf (``repro/models/transformer.py``
    ``init_params`` and its ``_*_params``; ``dense_init``'s default
    1/sqrt(shape[0]), the stack's layer count), None for a leaf it does not
    draw (norms, ``A_log``, ``dt_bias``, ``D``)."""
    name = key.split("/")[-1]
    if name in ("embed", "codebook_embed", "lm_head", "codebook_head", "wo", "w_down",
                "router", "out_proj"):
        return 0.02
    if name == "conv_w":
        return 0.5
    if name in ("w_gate", "w_up") and key.startswith("blocks/") and cfg.family == "moe":
        return 1 / math.sqrt(cfg.d_model)
    if name in ("wq", "wk", "wv", "w_gate", "w_up", "in_proj"):
        return 1 / math.sqrt(shape[0])
    return None


@pytest.mark.parametrize("block", [None, 1000])
@pytest.mark.parametrize("arch", ARCHS)
def test_drawn_std_follows_the_reference_rule(arch, block, monkeypatch):
    if block is not None:
        monkeypatch.setattr(tl, "DRAW_BLOCK", block)
    jcfg, cfg = jreg.get_config(arch, reduced=True), treg.get_config(arch, reduced=True)
    ref = dict(tt._leaves(jax.tree_util.tree_map(np.asarray,
                                                 _jinit(jax.random.PRNGKey(0), jcfg))))
    got = dict(tt._leaves(tt.init_params(cfg, torch.Generator().manual_seed(0), "cpu")))
    checked = 0
    for key, w in got.items():
        if w.numel() < MIN_STD_ELEMS:
            continue
        scale = _rule_scale(key, tuple(w.shape), cfg)
        if scale is None:  # not drawn: the same constants in both packages (f32 ulps)
            np.testing.assert_allclose(w.numpy(), ref[key], rtol=1e-6, err_msg=key)
            continue
        for who, std in (("port", float(w.double().std())),
                         ("reference", float(np.std(ref[key].astype(np.float64))))):
            assert abs(std / scale - 1) <= STD_RTOL, (key, who, std, scale)
        checked += 1
    assert checked >= 3, arch
