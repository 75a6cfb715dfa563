"""The port's AdamW and schedules (`repro_torch.train.optimizer`) against
the reference's, on the CPU.

`lr_at` over every step of each schedule within LR_RTOL (f32 cos and
divisions may round an ulp or two apart); `global_norm` and `adamw_update`
on the same random numpy trees (f32 and bf16 parameters, bf16 moments,
clipping on and off, weight decay on and off, from a state several steps
in) within 1e-6 relative to each leaf's largest value, the bf16 results
also within one bf16 rounding of their own value.
"""
import itertools
import zlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.train import optimizer as jopt
from repro_torch.train import optimizer as topt

LR_RTOL = 5e-7  # a few f32 ulps
RTOL = 1e-6


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == ml_dtypes.bfloat16 else x


def _pair(a: np.ndarray, dtype: str):
    """(jax array, torch tensor) of the same values in ``dtype``."""
    if dtype == "bfloat16":
        b = a.astype(ml_dtypes.bfloat16)
        return jnp.asarray(b), torch.from_numpy(b.view(np.int16).copy()).view(torch.bfloat16)
    return jnp.asarray(a.astype(np.float32)), torch.from_numpy(a.astype(np.float32))


def _tree(rng, scale=1.0, positive=False):
    shapes = {"embed": (17, 8), "blocks": {"wq": (2, 8, 3, 4), "norm": (2, 8), "A_log": (2, 3)},
              "final_norm": (8,), "lm_head": (8, 17)}

    def draw(s):
        if isinstance(s, dict):
            return {k: draw(v) for k, v in s.items()}
        x = rng.normal(size=s) * scale
        # a few tiny entries: AdamW's first-step amplification
        x.flat[:: 7] *= 1e-7
        return np.abs(x) if positive else x

    return draw(shapes)


def _split(tree, dtype):
    if isinstance(tree, dict):
        pairs = {k: _split(v, dtype) for k, v in tree.items()}
        return ({k: p[0] for k, p in pairs.items()}, {k: p[1] for k, p in pairs.items()})
    return _pair(tree, dtype)


def _leaves(jtree, ttree):
    return list(zip(jax.tree_util.tree_leaves(jtree), topt.tree_leaves(ttree)))


@pytest.mark.parametrize("schedule", ["cosine", "wsd", "constant"])
@pytest.mark.parametrize("warmup,total", [(100, 1000), (0, 37), (5, 5)])
def test_lr_at_matches_reference(schedule, warmup, total):
    kw = dict(peak_lr=3e-4, warmup_steps=warmup, total_steps=total, schedule=schedule,
              min_lr_ratio=0.1, wsd_decay_frac=0.1)
    steps = np.arange(total + 1, dtype=np.int32)
    want = np.asarray(jopt.lr_at(jopt.OptConfig(**kw), jnp.asarray(steps)))
    got = topt.lr_at(topt.OptConfig(**kw), torch.from_numpy(steps))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=LR_RTOL, atol=0)
    assert float(topt.lr_at(topt.OptConfig(**kw), torch.tensor(0))) == 0.0 or warmup == 0


def test_lr_at_unknown_schedule_raises_like_reference():
    with pytest.raises(ValueError, match="linear"):
        jopt.lr_at(jopt.OptConfig(schedule="linear"), jnp.asarray(3))
    with pytest.raises(ValueError, match="linear"):
        topt.lr_at(topt.OptConfig(schedule="linear"), torch.tensor(3))


def test_global_norm_matches_reference():
    rng = np.random.default_rng(0)
    for dtype in ("float32", "bfloat16"):
        jt, tt = _split(_tree(rng, scale=3.0), dtype)
        np.testing.assert_allclose(float(topt.global_norm(tt)), float(jopt.global_norm(jt)),
                                   rtol=RTOL)


def test_tree_leaves_are_in_jax_order():
    tree = _tree(np.random.default_rng(1))
    jt, tt = _split(tree, "float32")
    for a, b in _leaves(jt, tt):
        assert np.array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("p_dtype,mv_dtype,grad_clip,wd", [
    (p, mv, c, w)
    for p, mv, c, w in itertools.product(("float32", "bfloat16"), ("float32", "bfloat16"),
                                         (0.0, 1.0), (0.0, 0.1))
])
def test_adamw_update_matches_reference(p_dtype, mv_dtype, grad_clip, wd):
    rng = np.random.default_rng(zlib.crc32(repr((p_dtype, mv_dtype, grad_clip, wd)).encode()))
    kw = dict(peak_lr=1e-2, warmup_steps=3, total_steps=20, schedule="cosine",
              weight_decay=wd, grad_clip=grad_clip, m_dtype=mv_dtype, v_dtype=mv_dtype)
    jcfg, tcfg = jopt.OptConfig(**kw), topt.OptConfig(**kw)
    jp, tp = _split(_tree(rng), p_dtype)
    jm, tm = _split(_tree(rng, 0.1), mv_dtype)
    jv, tv = _split(_tree(rng, 0.01, positive=True), mv_dtype)
    jstate = jopt.AdamWState(jnp.asarray(4, jnp.int32), jm, jv)
    tstate = topt.AdamWState(torch.tensor(4, dtype=torch.int32), tm, tv)
    for it in range(2):
        jg, tg = _split(_tree(rng, scale=2.0 if it else 0.5), p_dtype)
        jp, jstate, jmet = jopt.adamw_update(jp, jg, jstate, jcfg)
        before = [t.clone() for t in topt.tree_leaves((tp, tstate.m, tstate.v))]
        tp2, tstate2, tmet = topt.adamw_update(tp, tg, tstate, tcfg)
        # the inputs are left as they were
        assert all(torch.equal(a, b)
                   for a, b in zip(before, topt.tree_leaves((tp, tstate.m, tstate.v))))
        tp, tstate = tp2, tstate2
        assert int(tstate.step) == int(jstate.step) == 5 + it
        np.testing.assert_allclose(float(tmet["grad_norm"]), float(jmet["grad_norm"]), rtol=RTOL)
        np.testing.assert_allclose(float(tmet["lr"]), float(jmet["lr"]), rtol=LR_RTOL)
        for jtree, ttree in ((jp, tp), (jstate.m, tstate.m), (jstate.v, tstate.v)):
            for a, b in _leaves(jtree, ttree):
                assert str(b.dtype).endswith(str(a.dtype)), (a.dtype, b.dtype)
                want, got = _np(a), _np(b)
                # relative to the leaf's largest value (p - lr * delta can
                # cancel); a bf16 result may round the other way where the
                # f32 value before the cast differs by an ulp: one bf16 ulp
                rtol = 2.0 ** -8 if b.dtype == torch.bfloat16 else RTOL
                np.testing.assert_allclose(got, want, rtol=rtol,
                                           atol=RTOL * np.abs(want).max())


def test_adamw_init_and_no_clip():
    params = {"a": torch.ones(3, dtype=torch.bfloat16), "b": {"c": torch.zeros(2, 2)}}
    st = topt.adamw_init(params, topt.OptConfig(m_dtype="bfloat16"))
    assert st.step.dtype == torch.int32 and int(st.step) == 0
    assert st.m["a"].dtype == torch.bfloat16 and st.v["b"]["c"].dtype == torch.float32
    # grad_clip = 0 never clips: a huge gradient moves every element by ~lr
    cfg = topt.OptConfig(peak_lr=1.0, warmup_steps=0, schedule="constant", grad_clip=0.0,
                         weight_decay=0.0)
    p = {"w": torch.zeros(4)}
    new, _, met = topt.adamw_update(p, {"w": torch.full((4,), 1e6)}, topt.adamw_init(p, cfg), cfg)
    np.testing.assert_allclose(float(met["grad_norm"]), 2e6, rtol=1e-6)
    np.testing.assert_allclose(new["w"].numpy(), -np.ones(4), rtol=1e-6)


def test_update_chunks_give_the_same_bits(monkeypatch):
    rng = np.random.default_rng(3)
    _, tp = _split(_tree(rng), "bfloat16")
    _, tg = _split(_tree(rng), "bfloat16")
    cfg = topt.OptConfig(peak_lr=1e-2, warmup_steps=1)
    st = topt.adamw_init(tp, cfg)
    whole = topt.adamw_update(tp, tg, st, cfg)
    monkeypatch.setattr(topt, "UPDATE_CHUNK", 5)
    split = topt.adamw_update(tp, tg, st, cfg)
    for a, b in zip(topt.tree_leaves((whole[0], whole[1].m, whole[1].v)),
                    topt.tree_leaves((split[0], split[1].m, split[1].v))):
        assert torch.equal(a, b)
