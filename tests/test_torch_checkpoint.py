"""The port's checkpoints (`repro_torch.train.checkpoint`) against the
reference's format, on the CPU.

A training state saved by the port restores through the reference's
`restore_checkpoint`, and one saved by the reference restores through the
port's, bit for bit, bf16 leaves and the int32 step included; both write
the same keys in the same order. Also: the shape-mismatch error and the
atomic publish (no ``ckpt.tmp.npz`` left behind).
"""
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.models.config import ModelConfig as JModelConfig
from repro.train import checkpoint as jck
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch.models.config import ModelConfig
from repro_torch.train import checkpoint as tck
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts

# tests/test_train.py's tiny dense config, in bf16
KW = dict(name="t", family="dense", n_layers=2, d_model=64, vocab_size=128, n_heads=4,
          n_kv_heads=2, d_ff=128, dtype="bfloat16")
OC = dict(peak_lr=1e-2, warmup_steps=2, total_steps=40, schedule="wsd")


def _bits(x) -> tuple:
    """A leaf's shape, item size and bytes, whichever package holds it."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        x = (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    if x.dtype == ml_dtypes.bfloat16:
        x = x.view(np.int16)
    return x.shape, x.itemsize, x.tobytes()


def _port_state(dtype="bfloat16", m_dtype="float32"):
    """A port state with every leaf non-trivial: seeded weights, two AdamW
    steps from seeded gradients."""
    cfg = ModelConfig(**dict(KW, dtype=dtype))
    oc = topt.OptConfig(**OC, m_dtype=m_dtype)
    st = tts.init_state(cfg, oc, torch.Generator().manual_seed(2), "cpu")
    gen = torch.Generator().manual_seed(3)
    for _ in range(2):
        grads = topt.tree_map(
            lambda p: torch.randn(p.shape, generator=gen).to(p.dtype), st.params)
        params, opt, _ = topt.adamw_update(st.params, grads, st.opt, oc)
        st = tts.TrainState(params, opt)
    return cfg, st


def _ref_state():
    jcfg = JModelConfig(**KW)
    oc = jopt.OptConfig(**OC)
    st = jts.init_state(jax.random.PRNGKey(1), jcfg, oc)
    for i in range(2):
        g = jax.tree_util.tree_map(
            lambda p: jax.random.normal(jax.random.PRNGKey(10 + i), p.shape).astype(p.dtype),
            st.params)
        params, opt, _ = jopt.adamw_update(st.params, g, st.opt, oc)
        st = jts.TrainState(params, opt)
    return jcfg, st


def _ref_keys(state) -> list[str]:
    return [k for k, _ in jck._flatten(state)[0]]


def test_port_checkpoint_restores_through_reference(tmp_path):
    _, st = _port_state()
    tck.save_checkpoint(str(tmp_path), st, step=7, extra={"arch": "t"})
    assert sorted(os.listdir(tmp_path)) == ["ckpt.npz", "manifest.json"]
    jcfg, jst = _ref_state()
    like = jax.eval_shape(lambda: jst)
    restored, step = jck.restore_checkpoint(str(tmp_path), like)
    assert step == 7
    manifest = json.loads((tmp_path / "manifest.json").read_text())
    assert manifest["keys"] == _ref_keys(jst)
    assert len(manifest["keys"]) == 37 and manifest["keys"][0] == ".params/blocks/attn_norm"
    assert manifest["keys"][-1] == ".opt/.v/lm_head" and ".opt/.step" in manifest["keys"]
    assert manifest["extra"] == {"arch": "t"}
    assert set(manifest["bf16_keys"]) == {k for k in manifest["keys"] if k.startswith(".params")}
    port = dict(tck._flatten(st))
    for key, leaf in jck._flatten(restored)[0]:
        assert leaf.dtype == jnp.dtype(
            "bfloat16" if key in manifest["bf16_keys"] else port[key].numpy().dtype), key
        assert _bits(leaf) == _bits(port[key]), key


@pytest.mark.parametrize("device", [None, "cpu"])
def test_reference_checkpoint_restores_through_port(tmp_path, device):
    jcfg, jst = _ref_state()
    jck.save_checkpoint(str(tmp_path), jst, step=11, extra={"arch": "t"})
    cfg = ModelConfig(**KW)
    oc = topt.OptConfig(**OC)
    if device is None:  # a real state to restore into: its devices are kept
        like = tts.init_state(cfg, oc, torch.Generator().manual_seed(0), "cpu")
    else:  # shapes only
        like = tts.init_state(cfg, oc, None, "meta")
    restored, step = tck.restore_checkpoint(str(tmp_path), like, device=device)
    assert step == 11
    assert isinstance(restored, tts.TrainState) and isinstance(restored.opt, topt.AdamWState)
    assert list(restored.params) == list(like.params)  # the port's key order kept
    ref = dict(jck._flatten(jst)[0])
    got = tck._flatten(restored)
    assert [k for k, _ in got] == list(ref)
    for key, leaf in got:
        assert leaf.device.type == "cpu"
        assert _bits(leaf) == _bits(ref[key]), key
    assert restored.opt.step.dtype == torch.int32 and int(restored.opt.step) == 2
    assert restored.params["embed"].dtype == torch.bfloat16


def test_port_roundtrip_f32_and_bf16_moments(tmp_path):
    for dtype, m_dtype in (("float32", "bfloat16"), ("bfloat16", "bfloat16")):
        _, st = _port_state(dtype, m_dtype)
        d = str(tmp_path / f"{dtype}-{m_dtype}")
        tck.save_checkpoint(d, st, step=3)
        back, step = tck.restore_checkpoint(d, st)
        assert step == 3
        for (ka, a), (kb, b) in zip(tck._flatten(st), tck._flatten(back)):
            assert ka == kb and a.dtype == b.dtype and torch.equal(a, b), ka


def test_shape_mismatch_raises(tmp_path):
    _, st = _port_state()
    tck.save_checkpoint(str(tmp_path), st, step=1)
    other = ModelConfig(**dict(KW, d_model=32, d_ff=64))
    like = tts.init_state(other, topt.OptConfig(**OC), None, "meta")
    with pytest.raises(ValueError, match="shape mismatch for .params/blocks/attn_norm"):
        tck.restore_checkpoint(str(tmp_path), like, device="cpu")


def test_atomic_publish_replaces_and_leaves_no_tmp(tmp_path, monkeypatch):
    _, st = _port_state()
    tck.save_checkpoint(str(tmp_path), st, step=1)
    # a save that dies while writing leaves the published checkpoint intact
    real = np.savez

    def dies(path, **arrays):
        real(path, **{k: v[:0] if v.ndim else v for k, v in list(arrays.items())[:1]})
        raise OSError("disk gone")

    monkeypatch.setattr(np, "savez", dies)
    with pytest.raises(OSError):
        tck.save_checkpoint(str(tmp_path), st, step=2)
    monkeypatch.setattr(np, "savez", real)
    back, step = tck.restore_checkpoint(str(tmp_path), st)
    assert step == 1 and torch.equal(back.params["embed"], st.params["embed"])
    # the next save publishes over it, and nothing temporary stays behind
    params, opt, _ = topt.adamw_update(st.params, st.params, st.opt, topt.OptConfig(**OC))
    tck.save_checkpoint(str(tmp_path), tts.TrainState(params, opt), step=2)
    assert sorted(os.listdir(tmp_path)) == ["ckpt.npz", "manifest.json"]
    back, step = tck.restore_checkpoint(str(tmp_path), st)
    assert step == 2 and torch.equal(back.params["embed"], params["embed"])
