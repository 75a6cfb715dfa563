"""The port's LM training path (`repro_torch.train`, `lm_loss`) against the
reference's, on the CPU at f32.

Both packages start from the reference's ``init_params`` weights, carried to
the port by `params_from_numpy`, with the query, key and SSM input
projections scaled by TEMPER. At the reference's init those weights are
large (its ``dense_init`` scales a stacked leaf by 1/sqrt(n_layers)), and
the gradients are then ill-conditioned: a 1e-7 relative nudge of the
embeddings moves the port's OWN gradients by up to 5e-5 of a leaf's largest
(smollm-135m REDUCED) and 7e-4 (hymba-1.5b REDUCED's dt_bias), which is
where the two packages' f32 roundings leave them (1.6e-4 and 6.7e-4). With
the projections tempered the same nudge moves them by at most 1e-6, bar one
leaf (below), and the packages agree within GRAD_RTOL.

- `lm_loss` and its gradient, leaf by leaf, for the dense, MoE (with
  assignments dropped at capacity), SSM, hybrid, codebook and vision
  REDUCED configs and a ``loss_mask``, the port with remat on and off
  against the reference's jitted ``value_and_grad`` (remat on, its default);
  the port's remat on and off give the same bits.
- 3 steps of `make_train_step` (dense and MoE) and of `make_mvs_train_step`
  fed the reference's own uniforms, against the reference's jitted steps:
  metrics, and every parameter within PARAM_ATOL (trouble elements below).
- `mvs_sequence_mask` on equal uniforms: keep equal, weights within 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import transformer as jt
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch.configs import registry as treg
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as tt
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts

B, S = 2, 24
TEMPER = 0.1
# a leaf's gradient against the reference's, relative to the leaf's max |grad|
GRAD_RTOL = 1e-5
# hymba-1.5b REDUCED's A_log gradient is a sum over every position, batch
# row and state entry that cancels to ~1e-2 of its terms: on the tempered
# weights a 1e-7 nudge of the embeddings still moves it by 9.4e-6 of its
# largest, and the packages differ by 2.9e-5 there
LEAF_RTOL = {"A_log": 1e-4}
OC_KW = dict(peak_lr=1e-2, warmup_steps=2, total_steps=40, schedule="wsd")
# updated parameters: trouble spot of AdamW's first steps, whose direction
# m/(sqrt(v)+eps) is ~sign(g) for an element whose gradient is tiny, so a
# rounding of g moves it by up to 2 lr. Elements whose |g| stays above
# SMALL_GRAD of their leaf's largest at every step are held to PARAM_ATOL;
# the rest only to the most two runs of 3 steps can part (2 x the summed lr)
PARAM_ATOL = 1e-3 * OC_KW["peak_lr"]
SMALL_GRAD = 1e-3
MAX_PAST_FRACTION = 1e-3

CASES = {
    "dense": ("smollm-135m", {}),
    "moe_drops": ("olmoe-1b-7b", {"capacity_factor": 0.5}),
    "ssm": ("mamba2-130m", {}),
    "hybrid": ("hymba-1.5b", {}),
    "codebook": ("musicgen-large", {}),
    "vision": ("llava-next-34b", {}),
    "loss_mask": ("smollm-135m", {}),
}

_trees: dict = {}
_jinit = jax.jit(jt.init_params, static_argnums=1)


def _configs(arch: str, **kw):
    jcfg = dataclasses.replace(jreg.get_config(arch, reduced=True), **kw)
    cfg = dataclasses.replace(treg.get_config(arch, reduced=True), **kw)
    return jcfg, cfg


def _tree(arch: str, jcfg) -> dict:
    """The reference's weights for ``arch`` (seed 1), projections tempered."""
    if arch not in _trees:
        tree = jax.tree_util.tree_map(np.asarray, _jinit(jax.random.PRNGKey(1), jcfg))
        for stack in ("blocks", "dense_blocks"):
            for w in ("wq", "wk", "in_proj"):
                if w in tree.get(stack, {}):
                    tree[stack][w] = (tree[stack][w] * TEMPER).astype(tree[stack][w].dtype)
        _trees[arch] = tree
    return _trees[arch]


def _batch(cfg, rng, b=B, s=S, mask=False):
    if cfg.n_codebooks:
        batch = {"codes": rng.integers(0, cfg.vocab_size, (b, s, cfg.n_codebooks))}
    else:
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s))}
    if cfg.frontend == "vision":
        batch["patch_embeds"] = rng.normal(size=(b, cfg.n_patches, cfg.d_model)).astype(
            np.float32)
    if mask:
        batch["loss_mask"] = (rng.random((b, s)) < 0.6).astype(np.float32)
    return batch


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _ref_leaves(tree) -> dict:
    return {"/".join(str(p.key) for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


# ------------------------------------------------------------ loss and grads
@pytest.mark.parametrize("case", list(CASES))
def test_lm_loss_and_grads_match_reference(case, monkeypatch):
    arch, kw = CASES[case]
    jcfg, cfg = _configs(arch, **kw)
    tree = _tree(arch, jcfg)
    batch = _batch(cfg, np.random.default_rng(3), mask=case == "loss_mask")
    vg = jax.jit(jax.value_and_grad(lambda p, b: jt.lm_loss(p, jcfg, b, remat=True),
                                    has_aux=True))
    (jloss, jmet), jgrads = vg(tree, _j(batch))
    want = _ref_leaves(jgrads)

    dropped = []
    if case == "moe_drops":
        real = tmoe.dispatch_indices

        def spy(*a):
            slot, keep = real(*a)
            dropped.append(int((~keep).sum()))
            return slot, keep

        monkeypatch.setattr(tmoe, "dispatch_indices", spy)
    params = tt.params_from_numpy(tree, cfg, "cpu")
    got = {}
    for remat in (True, False):
        loss, met, grads = tts.value_and_grad(
            lambda p: tt.lm_loss(p, cfg, _t(batch), remat=remat), params)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
        np.testing.assert_allclose(float(met["nll"]), float(jmet["nll"]), rtol=1e-6)
        np.testing.assert_allclose(float(met["moe_aux"]), float(jmet["moe_aux"]), rtol=1e-6)
        got[remat] = dict(tt._leaves(grads))
        assert set(got[remat]) == set(want)
        for key, g in got[remat].items():
            w = want[key]
            tol = LEAF_RTOL.get(key.split("/")[-1], GRAD_RTOL) * np.abs(w).max()
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=tol, err_msg=key)
    for key in got[True]:  # remat changes memory, never values
        assert torch.equal(got[True][key], got[False][key]), key
    if case == "moe_drops":
        assert sum(dropped) > 0, "the MoE case must drop assignments at capacity"


def test_lm_loss_mask_weights_positions():
    """The masked mean counts only kept positions; a zero mask gives 0."""
    _, cfg = _configs("smollm-135m")
    params = tt.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = _t(_batch(cfg, np.random.default_rng(4)))
    with torch.no_grad():
        full, _ = tt.lm_loss(params, cfg, batch, remat=False)
        ones, _ = tt.lm_loss(params, cfg, dict(batch, loss_mask=torch.ones(B, S)), remat=False)
        zero, _ = tt.lm_loss(params, cfg, dict(batch, loss_mask=torch.zeros(B, S)), remat=False)
    np.testing.assert_allclose(float(ones), float(full), rtol=1e-6)
    assert float(zero) == 0.0


# ------------------------------------------------------------------- steps
def _run_steps(arch: str, mvs: bool):
    jcfg, cfg = _configs(arch)
    tree = _tree(arch, jcfg)
    joc, toc = jopt.OptConfig(**OC_KW), topt.OptConfig(**OC_KW)
    tc_kw = dict(mvs_f=0.5) if mvs else {}
    rng = np.random.default_rng(5)
    batches = [_batch(cfg, rng, b=4) for _ in range(3)]

    jstate = jts.TrainState(jax.tree_util.tree_map(jnp.asarray, tree),
                            jopt.adamw_init(tree, joc))
    if mvs:
        jstep = jax.jit(jts.make_mvs_train_step(jcfg, joc, jts.TrainConfig(**tc_kw)))
    else:
        jstep = jax.jit(jts.make_train_step(jcfg, joc))
    params = tt.params_from_numpy(tree, cfg, "cpu")
    tstate = tts.TrainState(params, topt.adamw_init(params, toc))
    if mvs:
        tstep = tts.make_mvs_train_step(cfg, toc, tts.TrainConfig(**tc_kw))
    else:
        tstep = tts.make_train_step(cfg, toc)

    metrics, grads = [], []
    m_prev = {k: v.double() for k, v in tt._leaves(tstate.opt.m)}
    for i, batch in enumerate(batches):
        if mvs:
            key = jax.random.PRNGKey(i)
            u = torch.from_numpy(np.array(jax.random.uniform(key, (4,))))
            jstate, jm = jstep(jstate, _j(batch), key)
            tstate, tm = tstep(tstate, _t(batch), u)
        else:
            jstate, jm = jstep(jstate, _j(batch))
            tstate, tm = tstep(tstate, _t(batch))
        metrics.append(({k: float(v) for k, v in tm.items()},
                        {k: float(v) for k, v in jm.items()}))
        # the port's gradient of this step, from its first moment
        m_now = {k: v.double() for k, v in tt._leaves(tstate.opt.m)}
        grads.append({k: (m_now[k] - toc.b1 * m_prev[k]) / (1 - toc.b1) for k in m_now})
        m_prev = m_now
    return tstate, jstate, metrics, grads, toc


@pytest.mark.parametrize("arch,mvs", [("smollm-135m", False), ("olmoe-1b-7b", False),
                                      ("smollm-135m", True)])
def test_three_steps_match_reference(arch, mvs):
    tstate, jstate, metrics, grads, toc = _run_steps(arch, mvs)
    for got, want in metrics:
        assert set(got) == set(want)
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)
        np.testing.assert_allclose(got["nll"], want["nll"], rtol=1e-6)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=1e-5)
        np.testing.assert_allclose(got["lr"], want["lr"], rtol=1e-6)
        if mvs:
            assert got["kept"] == want["kept"]
        else:
            np.testing.assert_allclose(got["moe_aux"], want["moe_aux"], rtol=1e-6, atol=1e-7)
    if mvs:
        assert len({got["kept"] for got, _ in metrics}) > 1  # the draws did differ
    assert int(tstate.opt.step) == int(jstate.opt.step) == 3

    lr_sum = sum(got["lr"] for got, _ in metrics)
    want = _ref_leaves(jstate.params)
    n_past = n_all = 0
    for key, p in tt._leaves(tstate.params):
        diff = np.abs(p.numpy().astype(np.float64) - want[key])
        small = np.zeros(diff.shape, bool)
        for g in grads:
            g = g[key].abs().numpy()
            small |= g < SMALL_GRAD * g.max()
        past = diff > PARAM_ATOL
        assert not (past & ~small).any(), (
            f"{key}: {int((past & ~small).sum())} elements with sizeable gradients past "
            f"{PARAM_ATOL} (max {diff[~small].max():.3e})")
        assert diff.max() <= 2 * lr_sum, key
        n_past += int(past.sum())
        n_all += diff.size
    assert n_past <= MAX_PAST_FRACTION * n_all, (n_past, n_all)
    # the moments too: m within the gradients' tolerance of its scale
    for key, m in tt._leaves(tstate.opt.m):
        w = _ref_leaves(jstate.opt.m)[key]
        np.testing.assert_allclose(m.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max(),
                                   err_msg=key)


def test_mvs_step_refuses_codebook_and_vision():
    oc = topt.OptConfig(**OC_KW)
    for arch in ("musicgen-large", "llava-next-34b"):
        with pytest.raises(ValueError, match="text tokens only"):
            tts.make_mvs_train_step(treg.get_config(arch, reduced=True), oc,
                                    tts.TrainConfig(mvs_f=0.5))
    with pytest.raises(ValueError, match="mvs_f"):
        tts.make_mvs_train_step(treg.get_config("smollm-135m", reduced=True), oc,
                                tts.TrainConfig(mvs_f=0.0))


# ---------------------------------------------------------------- MVS mask
@pytest.mark.parametrize("seq_loss,f", [
    ([10.0, 10.0, 0.01, 0.01], 0.5),  # tests/test_train.py's case
    (np.random.default_rng(7).gamma(2.0, 1.5, 64).tolist(), 0.3),
    (np.random.default_rng(8).random(33).tolist(), 0.8),
])
def test_mvs_sequence_mask_equal_uniforms(seq_loss, f):
    losses = np.asarray(seq_loss, np.float32)
    keeps = []
    for s in range(50):
        key = jax.random.PRNGKey(s)
        jkeep, jw = jts.mvs_sequence_mask(key, jnp.asarray(losses), f=f, lam=1.0)
        u = torch.from_numpy(np.array(jax.random.uniform(key, losses.shape)))
        keep, w = tts.mvs_sequence_mask(u, torch.from_numpy(losses), f=f, lam=1.0)
        np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
        np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6)
        keeps.append(keep.numpy())
    if len(losses) == 4:  # the reference test's own claims, on the port
        rate = np.mean(keeps, axis=0)
        assert rate[0] > rate[2] and rate[1] > rate[3]
        assert rate[0] > 0.95


def test_sequence_losses_match_reference():
    for arch in ("smollm-135m", "musicgen-large", "llava-next-34b"):
        jcfg, cfg = _configs(arch)
        tree = _tree(arch, jcfg)
        batch = _batch(cfg, np.random.default_rng(9))
        want = jax.jit(lambda p, b: jts.sequence_losses(p, jcfg, b))(tree, _j(batch))
        got = tts.sequence_losses(tt.params_from_numpy(tree, cfg, "cpu"), cfg, _t(batch))
        assert got.shape == (B,)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
