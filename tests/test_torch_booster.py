"""The whole in-core slice of the port against the reference, on the CPU.

`repro` and `repro_torch` (``device="cpu"``: the kernels' plain versions)
fit the same numpy data. Trees must agree under `assert_trees_equal` (equal
structure and routing, splits equal up to f32 ties, leaves within 1e-4
relative); margins within rtol=1e-5, atol=1e-5, because the two packages sum
histograms and sigmoids in a different f32 order. Serving a given forest is
exact: a checkpoint written by either package predicts equal margins, bit
for bit, in the other.
"""
import ast
import os
from pathlib import Path

import numpy as np
import pytest
import torch
from oracle import assert_forests_equal

from conftest import MAX_BIN, MAX_DEPTH
from repro.core.booster import GradientBooster as JBooster
from repro.data.dmatrix import IterDMatrix as JIterDMatrix
from repro_torch.core.booster import (
    BoosterParams,
    CheckpointCorruptError,
    GradientBooster,
)
from repro_torch.core.policy import ExecutionPolicy
from repro_torch.data.dmatrix import ArrayDMatrix, PagedDMatrix
from repro_torch.serve import PackedForest

PARAMS = dict(n_estimators=4, max_depth=MAX_DEPTH, max_bin=MAX_BIN, learning_rate=0.3)
SRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def data():
    from repro_torch.data.synthetic import make_classification

    X, y = make_classification(512, 8, class_sep=1.5, flip_y=0.02, missing_rate=0.05, seed=11)
    Xe, ye = make_classification(256, 8, class_sep=1.5, missing_rate=0.05, seed=11, batch=1)
    return X, y, Xe, ye


@pytest.fixture(scope="module", params=["binary:logistic", "reg:squarederror"])
def fitted(request, data):
    X, y, Xe, ye = data
    kw = dict(PARAMS, objective=request.param)
    port = GradientBooster(device="cpu", **kw).fit(X, y, eval_set=(Xe, ye))
    ref = JBooster(**kw).fit(X, y, eval_set=(Xe, ye))
    return port, ref


def test_fit_grows_the_reference_trees(fitted):
    port, ref = fitted
    assert port.decision_.mode == ref.decision_.mode == "in_core"
    assert_forests_equal(port.trees, ref.trees)


def test_margins_and_eval_history_match_reference(fitted, data):
    port, ref = fitted
    X, _, Xe, _ = data
    for rows in (X, Xe):
        np.testing.assert_allclose(
            port.predict_margin(rows), np.asarray(ref.predict_margin(rows)),
            rtol=1e-5, atol=1e-5,
        )
    np.testing.assert_allclose(
        [r.value for r in port.eval_history], [r.value for r in ref.eval_history],
        rtol=1e-5, atol=1e-5,
    )
    assert port.base_margin_ == ref.base_margin_
    np.testing.assert_allclose(port.predict(Xe), np.asarray(ref.predict(Xe)), rtol=1e-5,
                               atol=1e-5)


def test_reference_checkpoint_serves_bitwise_on_the_port(fitted, data, tmp_path):
    port, ref = fitted
    X, _, Xe, _ = data
    ref.save(str(tmp_path / "ref"))
    loaded = GradientBooster.load(str(tmp_path / "ref"), device="cpu")
    assert loaded.params.objective == ref.params.objective
    for rows in (X, Xe):
        np.testing.assert_array_equal(
            loaded.predict_margin(rows), np.asarray(ref.predict_margin(rows))
        )
    # and the other way: a port checkpoint serves bitwise on the reference
    port.save(str(tmp_path / "port"))
    back = JBooster.load(str(tmp_path / "port"))
    np.testing.assert_array_equal(np.asarray(back.predict_margin(Xe)), port.predict_margin(Xe))


def test_from_numpy_state_takes_reference_trees(fitted, data):
    _, ref = fitted
    _, _, Xe, _ = data
    b = GradientBooster.from_numpy_state(
        BoosterParams(**{**PARAMS, "objective": ref.params.objective}), ref.trees,
        ref.cuts.values, ref.cuts.ptrs, ref.base_margin_, device="cpu",
    )
    np.testing.assert_array_equal(b.predict_margin(Xe), np.asarray(ref.predict_margin(Xe)))


def test_fused_predict_equals_per_tree_loop(fitted, data):
    port, _ = fitted
    _, _, Xe, _ = data
    forest = port.packed_forest()
    bins = forest.quantize(Xe)
    assert torch.equal(forest.predict_margin_bins(bins), forest.predict_margin_per_tree(bins))
    head = PackedForest.from_booster(port, (0, 2))
    assert head.n_trees == 2
    empty = port.packed_forest((1, 1))
    assert torch.equal(empty.predict_margin_bins(bins), torch.full((bins.shape[0],),
                       np.float32(port.base_margin_)))


def test_refit_boosts_on_from_held_trees(data):
    X, y, Xe, _ = data
    kw = dict(PARAMS, n_estimators=2, objective="binary:logistic")
    port = GradientBooster(device="cpu", **kw).fit(X, y).fit(X, y)
    ref = JBooster(**kw).fit(X, y).fit(X, y)
    assert len(port.trees) == len(ref.trees) == 4
    assert_forests_equal(port.trees, ref.trees)
    np.testing.assert_allclose(port.predict_margin(Xe), np.asarray(ref.predict_margin(Xe)),
                               rtol=1e-5, atol=1e-5)


def test_early_stopping_matches_reference(data):
    X, y, Xe, ye = data
    kw = dict(PARAMS, n_estimators=30, objective="binary:logistic", early_stopping_rounds=2,
              learning_rate=1.0)
    port = GradientBooster(device="cpu", **kw).fit(X, y, eval_set=(Xe, ye))
    ref = JBooster(**kw).fit(X, y, eval_set=(Xe, ye))
    assert len(port.trees) == len(ref.trees) < 30
    assert port.best_iteration_ == ref.best_iteration_


def test_checkpoint_corruption_is_detected(fitted, tmp_path):
    port, _ = fitted
    path = str(tmp_path / "ck")
    port.save(path)
    port.save(path)  # rotates the first into ck.prev
    with open(os.path.join(path, "model.npz"), "r+b") as fh:
        fh.seek(10)
        fh.write(b"\x00garbage\x00")
    with pytest.raises(CheckpointCorruptError, match="model.npz") as err:
        GradientBooster.load(path, device="cpu")
    assert err.value.last_good == f"{path}.prev"
    assert GradientBooster.last_good_checkpoint(path) == f"{path}.prev"


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch, fitted, tmp_path):
    port, _ = fitted
    port.save(str(tmp_path / "ck"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GradientBooster(**PARAMS)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GradientBooster.load(str(tmp_path / "ck"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GradientBooster.from_numpy_state(
            port.params, [], port.cuts.values, port.cuts.ptrs, 0.0
        )
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        GradientBooster(device="meta", **PARAMS)


@pytest.mark.parametrize("case", [
    "lossguide", "out_of_core", "hist_budget",
])
def test_unported_paths_raise_not_implemented(case, data, tmp_path):
    """Corners that were once unported now fit the reference's trees: a page
    cache the reference wrote bitpacked ("out_of_core", streamed and decoded
    by the port), best-first growth ("lossguide") and the budgeted histogram
    store ("hist_budget", which also books the reference's spills)."""
    from repro.core.policy import ExecutionPolicy as JPolicy
    from repro.data.dmatrix import PagedDMatrix as JPagedDMatrix

    X, y, Xe, _ = data
    kw = dict(PARAMS, n_estimators=1)
    if case == "out_of_core":
        cache = str(tmp_path / "bitpack")
        JIterDMatrix([(X, y)], max_bin=MAX_BIN, cache_dir=cache, page_codec="bitpack")
        policy = ExecutionPolicy(mode="out_of_core", page_codec="bitpack")
        port = GradientBooster(device="cpu", policy=policy, **kw).fit(PagedDMatrix(cache))
        ref = JBooster(policy=JPolicy(mode="out_of_core", page_codec="bitpack"), **kw)
        ref.fit(JPagedDMatrix(cache))
        assert_forests_equal(port.trees, ref.trees)
        assert port.stats.wire_bytes == ref.stats.wire_bytes < port.stats.logical_bytes
        assert port.stats.logical_bytes == ref.stats.logical_bytes
        return
    kw.update(n_estimators=2, objective="binary:logistic")
    policy, jpolicy = ExecutionPolicy(), JPolicy()
    if case == "hist_budget":
        policy, jpolicy = ExecutionPolicy(hist_budget_bytes=4096), JPolicy(hist_budget_bytes=4096)
    if case == "lossguide":
        kw.update(grow_policy="lossguide", max_leaves=4)
    port = GradientBooster(device="cpu", policy=policy, **kw).fit(X, y)
    ref = JBooster(policy=jpolicy, **kw).fit(X, y)
    assert_forests_equal(port.trees, ref.trees)
    np.testing.assert_allclose(port.predict_margin(Xe), np.asarray(ref.predict_margin(Xe)),
                               rtol=1e-5, atol=1e-5)
    for f in ("hist_spills", "hist_fetches", "hist_spill_bytes", "hist_fetch_bytes"):
        assert getattr(port.stats, f) == getattr(ref.stats, f), f
    assert (port.stats.hist_spills > 0) == (case == "hist_budget")


def test_fit_accepts_dmatrix_and_pinned_cuts(data):
    X, y, Xe, _ = data
    dm = ArrayDMatrix(X, y, max_bin=MAX_BIN, device="cpu")
    a = GradientBooster(device="cpu", **PARAMS).fit(dm)
    b = GradientBooster(device="cpu", **PARAMS).fit(X, y, cuts=dm.cuts)
    np.testing.assert_array_equal(a.predict_margin(Xe), b.predict_margin(Xe))
    assert a.stats.host_to_device_bytes == X.shape[0] * X.shape[1]
    assert a.hist_cache.stats.node_rows_ratio >= 1.0


def test_port_imports_neither_jax_nor_the_reference():
    """The port stands alone: no module under src/repro_torch, nor
    chip_smoke.py, imports jax or anything of the `repro` package."""
    files = sorted(SRC.rglob("*.py")) + [SRC.parents[1] / "chip_smoke.py"]
    assert len(files) > 20
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                if name.split(".")[0] in ("jax", "jaxlib", "repro"):
                    bad.append(f"{path.name}: {name}")
    assert not bad, bad
