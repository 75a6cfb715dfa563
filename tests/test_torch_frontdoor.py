"""The rest of the front door in the port against the reference, on the CPU.

`GradientBooster.get_params` / `set_params` give and take the reference's
keys and values (flat fields, ``policy``, ``sampling__*``, ``policy__*``)
and raise its `ValueError`s; `train_in_core` grows the reference's trees;
`ExternalGradientBooster` warns `FutureWarning` and fits what the
reference's alias fits; `repro_torch.core.outofcore.PageSet` is the DMatrix
module's; `predict_tree_raw` equals the reference's bit for bit on a
reference-fitted forest with NaNs, and `predict_forest_raw` is allclose to
it at rtol = atol = 1e-6 (the reference sums the trees in XLA's order, the
port in tree order). The paper configuration (`configs/xgb_paper.py`) has
the reference's fields and values.
"""
import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from oracle import assert_forests_equal

import repro.core as jcore
import repro_torch.core as tcore
from repro.core.booster import BoosterParams as JBoosterParams
from repro.core.booster import GradientBooster as JBooster
from repro.core.booster import train_in_core as j_train_in_core
from repro.core.outofcore import ExternalGradientBooster as JExternal
from repro.core.policy import ExecutionPolicy as JPolicy
from repro.core.tree import predict_forest_raw as j_predict_forest_raw
from repro.core.tree import predict_tree_raw as j_predict_tree_raw
from repro.core.tree import stack_trees as j_stack_trees
from repro_torch.core.booster import BoosterParams, GradientBooster, train_in_core
from repro_torch.core.outofcore import ExternalGradientBooster
from repro_torch.core.policy import ExecutionPolicy
from repro_torch.core.tree import predict_forest_raw, predict_tree_raw, stack_trees

CPU = torch.device("cpu")
PARAMS = dict(n_estimators=3, max_depth=4, max_bin=16, objective="binary:logistic", seed=0)
FRONT_DOOR = ("train_in_core", "ExternalGradientBooster", "predict_tree_raw",
              "predict_forest_raw", "stack_trees")


def _data(n=600, m=6, seed=3, missing=0.1):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, m)).astype(np.float32)
    X[rng.random(X.shape) < missing] = np.nan
    y = ((np.nan_to_num(X[:, 0]) + 0.5 * np.nan_to_num(X[:, 1])) > 0).astype(np.float32)
    return X, y


def _plain(v):
    """A value comparable across packages: dataclasses as dicts."""
    return dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v


@pytest.mark.parametrize("deep", [True, False])
def test_get_params_matches_reference(deep):
    kw = dict(PARAMS, max_leaves=5, early_stopping_rounds=2)
    pol = dict(mode="in_core", hist_budget_bytes=4096, page_codec="bitpack")
    got = GradientBooster(BoosterParams(**kw), policy=ExecutionPolicy(**pol), device="cpu")
    want = JBooster(JBoosterParams(**kw), policy=JPolicy(**pol))
    g, w = got.get_params(deep=deep), want.get_params(deep=deep)
    assert set(g) == set(w)
    for key in w:
        if key != "policy":
            assert _plain(g[key]) == _plain(w[key]), key
    assert _plain(g["policy"]) == _plain(w["policy"])


def test_params_round_trip_and_nested_updates():
    b = GradientBooster(BoosterParams(**PARAMS), device="cpu")
    jb = JBooster(JBoosterParams(**PARAMS))
    updates = dict(max_depth=3, sampling__method="mvs", sampling__f=0.3,
                   policy__mode="out_of_core", policy__grad_transport="f16")
    assert b.set_params(**updates) is b
    jb.set_params(**updates)
    got, want = b.get_params(), jb.get_params()
    for key in want:
        assert _plain(got[key]) == _plain(want[key]), key
    # clone semantics: the shallow params rebuild an equal estimator
    shallow = b.get_params(deep=False)
    policy = shallow.pop("policy")
    clone = GradientBooster(BoosterParams(**shallow), policy=policy, device="cpu")
    assert clone.get_params() == b.get_params()
    assert clone.params == b.params and clone.policy == b.policy
    assert b.hist_cache.quantizer.mode == "f16"  # the store follows the policy


@pytest.mark.parametrize("bad", [{"nope": 1}, {"tree__depth": 3}])
def test_set_params_errors_match_reference(bad):
    with pytest.raises(ValueError) as want:
        JBooster(JBoosterParams(**PARAMS)).set_params(**bad)
    with pytest.raises(ValueError) as got:
        GradientBooster(BoosterParams(**PARAMS), device="cpu").set_params(**bad)
    assert str(got.value) == str(want.value)


def test_train_in_core_matches_reference():
    X, y = _data()
    got = train_in_core(X, y, BoosterParams(**PARAMS), device="cpu")
    want = j_train_in_core(X, y, JBoosterParams(**PARAMS))
    assert got.decision_.mode == want.decision_.mode == "in_core"
    assert_forests_equal(got.trees, want.trees)
    np.testing.assert_allclose(got.predict_margin(X), np.asarray(want.predict_margin(X)),
                               rtol=1e-5, atol=1e-5)


def test_external_gradient_booster_matches_reference_alias(tmp_path):
    X, y = _data(900)
    source = [(X[:300], y[:300]), (X[300:600], y[300:600]), (X[600:], y[600:])]
    with pytest.warns(FutureWarning, match="ExternalGradientBooster is deprecated"):
        got = ExternalGradientBooster(BoosterParams(**PARAMS), cache_dir=str(tmp_path / "t"),
                                      page_bytes=2048, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        want = JExternal(JBoosterParams(**PARAMS), cache_dir=str(tmp_path / "j"), page_bytes=2048)
    got.fit(source)
    want.fit(source)
    assert got.decision_.mode == want.decision_.mode == "out_of_core"
    assert got.pages.n_pages == want.pages.n_pages > 1
    assert got.pages.store is not None and got.stats.disk_read_bytes > 0
    np.testing.assert_array_equal(got.labels_, want.labels_)
    assert_forests_equal(got.trees, want.trees)
    np.testing.assert_allclose(got.margins_.numpy(), want.margins_, rtol=1e-5, atol=1e-5)
    # resume rebuilds the margins from a checkpoint, as the alias did
    got.save(str(tmp_path / "ckpt"))
    back = ExternalGradientBooster.resume(str(tmp_path / "ckpt"), source,
                                          cache_dir=str(tmp_path / "r"), page_bytes=2048,
                                          device="cpu")
    np.testing.assert_array_equal(back.margins_.numpy(), got.margins_.numpy())


def test_pageset_reexport():
    import repro_torch.core.outofcore as ooc
    from repro_torch.data.dmatrix import PageSet

    assert ooc.PageSet is PageSet
    with pytest.raises(AttributeError):
        ooc.NotAThing


@pytest.fixture(scope="module")
def ref_forest():
    """A reference-fitted forest on rows with NaNs, and the port's copy."""
    X, y = _data(500, 7, seed=11, missing=0.2)
    jb = JBooster(JBoosterParams(**dict(PARAMS, n_estimators=4, max_depth=5)),
                  policy=JPolicy(mode="in_core")).fit(X, y)
    tb = GradientBooster.from_numpy_state(
        BoosterParams(**dict(PARAMS, n_estimators=4, max_depth=5)),
        jb.trees, jb.cuts.values, jb.cuts.ptrs, jb.base_margin_, device="cpu",
    )
    return X, jb, tb


def test_predict_tree_raw_bitwise_reference(ref_forest):
    X, jb, tb = ref_forest
    for jt, tt in zip(jb.trees, tb.trees):
        want = np.asarray(j_predict_tree_raw(jt, jnp.asarray(X), 5))
        got = predict_tree_raw(tt, torch.from_numpy(X), 5).numpy()
        np.testing.assert_array_equal(got, want)


def test_predict_forest_raw_matches_reference(ref_forest):
    X, jb, tb = ref_forest
    forest = stack_trees(tb.trees)
    assert forest.feature.shape == (4, tb.trees[0].feature.shape[0])
    want = np.asarray(j_predict_forest_raw(j_stack_trees(jb.trees), jnp.asarray(X), 5, 0.3,
                                           jb.base_margin_))
    got = predict_forest_raw(forest, torch.from_numpy(X), 5, 0.3, tb.base_margin_).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_core_reexports_the_front_door():
    for name in FRONT_DOOR:
        assert name in tcore.__all__ and hasattr(tcore, name)
    assert sorted(tcore.__all__) == sorted(jcore.__all__)


@pytest.mark.parametrize("name", ["CONFIG", "REDUCED"])
def test_paper_config_matches_reference(name):
    import repro.configs.xgb_paper as jpaper
    import repro_torch.configs.xgb_paper as tpaper

    assert dataclasses.asdict(getattr(tpaper, name)) == dataclasses.asdict(getattr(jpaper, name))
    assert [f.name for f in dataclasses.fields(tpaper.GBDTConfig)] == [
        f.name for f in dataclasses.fields(jpaper.GBDTConfig)
    ]
