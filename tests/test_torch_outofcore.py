"""The out-of-core streaming slice of the port against the reference, on the
CPU.

The same numpy batches go through the reference (`repro`) and the port
(`repro_torch`, ``device="cpu"``: the kernels' plain versions). Pages must
be bitwise equal; a streaming fit is held against the reference's streaming
fit with the same page extents (never against in-core: per-page f32 sums
may break near-ties differently). Trees must agree under
`assert_trees_equal` (structure and routing exact, splits equal up to f32
ties, leaves within 1e-4 relative); margins and eval metrics within
rtol=1e-5, atol=1e-5, because the two packages sum histograms and sigmoids
in a different f32 order; the decision and the staged byte counts are
exact.
"""
import json
import os

import numpy as np
import pytest
import torch
from oracle import assert_forests_equal

from repro.core.booster import GradientBooster as JBooster
from repro.core.policy import ExecutionPolicy as JPolicy
from repro.data.dmatrix import ArrayDMatrix as JArrayDMatrix
from repro.data.dmatrix import IterDMatrix as JIterDMatrix
from repro.data.dmatrix import PagedDMatrix as JPagedDMatrix
from repro_torch.core.booster import GradientBooster
from repro_torch.core.policy import ExecutionPolicy
from repro_torch.data.dmatrix import ArrayDMatrix, IterDMatrix, PagedDMatrix
from repro_torch.data.synthetic import make_classification
from repro_torch.kernels import ops

M = 10
PAGE_BYTES = M * 150  # 150-row pages: 6 pages of 900 rows
PARAMS = dict(n_estimators=4, max_depth=3, max_bin=32, learning_rate=0.3)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def data():
    X, y = make_classification(900, M, class_sep=1.2, missing_rate=0.05, seed=21)
    Xe, ye = make_classification(300, M, class_sep=1.2, missing_rate=0.05, seed=21, batch=1)
    batches = [(X[i : i + 200], y[i : i + 200]) for i in range(0, 900, 200)]
    return X, y, Xe, ye, batches


def _assert_pages_equal(port_dm, ref_dm):
    assert port_dm.n_rows == ref_dm.n_rows and port_dm.n_bins == ref_dm.n_bins
    for f in ("values", "ptrs", "min_vals"):
        np.testing.assert_array_equal(getattr(port_dm.cuts, f), getattr(ref_dm.cuts, f))
    np.testing.assert_array_equal(port_dm.labels, ref_dm.labels)
    ps, js = port_dm.page_set(), ref_dm.page_set()
    assert ps.page_extents == js.page_extents
    got = [p.bins for _, p in ps.iter_pages()]
    want = [p.bins for _, p in js.iter_pages()]
    assert len(got) == len(want) == ps.n_pages
    for a, b in zip(got, want):
        assert a.dtype == np.uint8
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("on_disk", [False, True])
def test_iter_and_paged_dmatrix_pages_equal_reference(data, tmp_path, on_disk):
    *_, batches = data
    kw = dict(max_bin=32, page_bytes=PAGE_BYTES)
    port_dir = str(tmp_path / "port") if on_disk else None
    ref_dir = str(tmp_path / "ref") if on_disk else None
    port = IterDMatrix(batches, cache_dir=port_dir, device="cpu", **kw)
    ref = JIterDMatrix(batches, cache_dir=ref_dir, **kw)
    assert port.n_pages == ref.n_pages == 6
    _assert_pages_equal(port, ref)
    if on_disk:
        # each package's cache reopens in the other
        _assert_pages_equal(PagedDMatrix(port_dir), JPagedDMatrix(ref_dir))
        _assert_pages_equal(PagedDMatrix(ref_dir), JPagedDMatrix(port_dir))
        assert port.stats.disk_write_bytes == ref.stats.disk_write_bytes


@pytest.fixture(scope="module", params=["binary:logistic", "reg:squarederror"])
def streamed(request, data, tmp_path_factory):
    X, y, Xe, ye, batches = data
    kw = dict(PARAMS, objective=request.param)
    if request.param == "reg:squarederror":
        # a continuous target: 0/1 labels under squared error make exact
        # gain ties between splits (equal to all 16 digits in f64), which
        # any two f32 summation orders may break differently (ROADMAP
        # queue 3); both packages' in-core builders and the port's paged
        # one break them alike, the reference's paged builder does not
        rng = np.random.default_rng(21)
        y = np.nan_to_num(X[:, 0]) + 0.5 * rng.normal(size=len(X)).astype(np.float32)
        ye = np.nan_to_num(Xe[:, 0]) + 0.5 * rng.normal(size=len(Xe)).astype(np.float32)
        batches = [(X[i : i + 200], y[i : i + 200]) for i in range(0, 900, 200)]
    cache = str(tmp_path_factory.mktemp("pages"))
    dm = IterDMatrix(batches, max_bin=32, page_bytes=PAGE_BYTES, cache_dir=cache, device="cpu")
    jdm = JIterDMatrix(batches, max_bin=32, page_bytes=PAGE_BYTES)
    port = GradientBooster(device="cpu", policy=ExecutionPolicy(mode="out_of_core"), **kw)
    port.fit(dm, eval_set=(Xe, ye))
    ref = JBooster(policy=JPolicy(mode="out_of_core"), **kw).fit(jdm, eval_set=(Xe, ye))
    return port, ref, cache


def test_streaming_fit_grows_the_reference_streaming_trees(streamed):
    port, ref, _ = streamed
    assert port.decision_.mode == ref.decision_.mode == "out_of_core"
    assert port.pages.n_pages == ref.pages.n_pages == 6
    assert_forests_equal(port.trees, ref.trees)


def test_streaming_margins_and_eval_match_reference(streamed, data):
    port, ref, _ = streamed
    X, _, Xe, _, _ = data
    np.testing.assert_allclose(port.margins_.numpy(), ref.margins_, rtol=1e-5, atol=1e-5)
    for rows in (X, Xe):
        np.testing.assert_allclose(port.predict_margin(rows), np.asarray(ref.predict_margin(rows)),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose([r.value for r in port.eval_history],
                               [r.value for r in ref.eval_history], rtol=1e-5, atol=1e-5)
    # the margins come from the final positions: equal to re-predicting
    np.testing.assert_array_equal(port.margins_.numpy(), port.predict_margin(X))


def test_streaming_stages_the_reference_bytes(streamed):
    """Both packages stage uint8 pages, two passes per level per tree."""
    port, ref, _ = streamed
    n_passes = 2 * PARAMS["max_depth"] * PARAMS["n_estimators"]
    assert port.stats.host_to_device_bytes == ref.stats.host_to_device_bytes
    assert port.stats.host_to_device_bytes == n_passes * 900 * M
    assert port.stats.logical_bytes == port.stats.wire_bytes == port.stats.host_to_device_bytes
    assert port.stats.disk_read_bytes > 0 and port.stats.page_loads == n_passes * 6
    assert 0.0 <= port.stats.overlap_ratio <= 1.0


def test_reference_cache_trains_the_same_trees(data, tmp_path):
    *_, batches = data
    cache = str(tmp_path / "ref")
    kw = dict(PARAMS, objective="binary:logistic")
    jdm = JIterDMatrix(batches, max_bin=32, page_bytes=PAGE_BYTES, cache_dir=cache)
    ref = JBooster(policy=JPolicy(mode="out_of_core"), **kw).fit(jdm)
    port = GradientBooster(device="cpu", policy=ExecutionPolicy(mode="out_of_core"), **kw)
    port.fit(PagedDMatrix(cache))
    assert_forests_equal(port.trees, ref.trees)
    np.testing.assert_allclose(port.margins_.numpy(), ref.margins_, rtol=1e-5, atol=1e-5)


def test_auto_policy_streams_over_budget_like_reference(data):
    *_, batches = data
    kw = dict(PARAMS, objective="binary:logistic", n_estimators=2)
    dm = IterDMatrix(batches, max_bin=32, page_bytes=PAGE_BYTES, device="cpu")
    jdm = JIterDMatrix(batches, max_bin=32, page_bytes=PAGE_BYTES)
    model = ExecutionPolicy().memory_model(dm, GradientBooster(device="cpu", **kw).params)
    budget = (model.out_of_core_bytes(dm.n_rows) + model.in_core_bytes(dm.n_rows)) // 2
    port = GradientBooster(device="cpu", policy=ExecutionPolicy(memory_budget_bytes=budget), **kw)
    port.fit(dm)
    ref = JBooster(policy=JPolicy(memory_budget_bytes=budget), **kw).fit(jdm)
    assert port.decision_.mode == ref.decision_.mode == "out_of_core"
    assert port.decision_.reason == ref.decision_.reason
    assert_forests_equal(port.trees, ref.trees)


def test_array_dmatrix_streams_its_own_pages(data):
    """A forced out-of-core fit of an ArrayDMatrix re-pages the same bins."""
    X, y, _, _, _ = data
    kw = dict(PARAMS, objective="binary:logistic", n_estimators=2)
    dm = ArrayDMatrix(X, y, max_bin=32, page_bytes=PAGE_BYTES, device="cpu")
    port = GradientBooster(device="cpu", policy=ExecutionPolicy(mode="out_of_core"), **kw)
    port.fit(dm)
    ref = JBooster(policy=JPolicy(mode="out_of_core"), **kw)
    ref.fit(JArrayDMatrix(X, y, max_bin=32, page_bytes=PAGE_BYTES))
    assert port.pages.n_pages == ref.pages.n_pages == 6
    assert_forests_equal(port.trees, ref.trees)


def test_batch_source_fit_quantises_on_the_device(data):
    """fit(batch source) builds an IterDMatrix on the booster's device; in
    core it grows the reference's trees."""
    X, y, Xe, _, batches = data
    kw = dict(PARAMS, objective="binary:logistic", n_estimators=2)
    port = GradientBooster(device="cpu", **kw).fit(batches)
    ref = JBooster(**kw).fit(batches)
    assert port.decision_.mode == ref.decision_.mode == "in_core"
    assert_forests_equal(port.trees, ref.trees)


def test_checkpoint_every_writes_a_loadable_forest(data, tmp_path):
    *_, Xe, _, batches = data
    ck = str(tmp_path / "ck")
    pol = ExecutionPolicy(mode="out_of_core", checkpoint_every=2, checkpoint_dir=ck)
    kw = dict(PARAMS, objective="binary:logistic", n_estimators=3)
    dm = IterDMatrix(batches, max_bin=32, page_bytes=PAGE_BYTES, device="cpu")
    b = GradientBooster(device="cpu", policy=pol, **kw).fit(dm)
    saved = GradientBooster.load(ck, device="cpu")
    assert len(saved.trees) == 2  # written after tree 2; tree 3 is not a multiple
    head = b.packed_forest((0, 2)).predict_margin(Xe)
    np.testing.assert_array_equal(saved.predict_margin(Xe), head)


def test_streams_with_a_device_page_cache(data):
    """device_cache_pages keeps pages resident: later passes hit, and the
    trees do not change."""
    *_, batches = data
    kw = dict(PARAMS, objective="binary:logistic", n_estimators=2)
    dm = IterDMatrix(batches, max_bin=32, page_bytes=PAGE_BYTES, device="cpu")
    plain = GradientBooster(device="cpu", policy=ExecutionPolicy(mode="out_of_core"), **kw)
    plain.fit(dm)
    h2d = dm.stats.host_to_device_bytes
    dm.stats.reset()
    cached = GradientBooster(
        device="cpu", policy=ExecutionPolicy(mode="out_of_core", device_cache_pages=6), **kw
    ).fit(dm)
    assert dm.stats.cache_hits > 0 and dm.stats.host_to_device_bytes == 900 * M
    assert dm.stats.host_to_device_bytes + dm.stats.cache_hit_bytes == h2d
    for a, b in zip(plain.trees, cached.trees):
        assert all(torch.equal(u, v) for u, v in zip(a, b))


def test_legacy_manifest_cache_trains_the_same_trees(data, tmp_path):
    """A cache whose manifest predates page codecs (no ``codec`` keys) reads
    as raw, as the reference reads it, and trains the same trees."""
    *_, batches = data
    cache = str(tmp_path / "legacy")
    kw = dict(PARAMS, objective="binary:logistic")
    IterDMatrix(batches, max_bin=32, page_bytes=PAGE_BYTES, cache_dir=cache, device="cpu")
    fresh = GradientBooster(device="cpu", policy=ExecutionPolicy(mode="out_of_core"), **kw)
    fresh.fit(PagedDMatrix(cache))
    path = os.path.join(cache, "manifest.json")
    with open(path) as fh:
        manifest = json.load(fh)
    for entry in manifest["pages"]:
        del entry["codec"]
    with open(path, "w") as fh:
        json.dump(manifest, fh)
    legacy = GradientBooster(device="cpu", policy=ExecutionPolicy(mode="out_of_core"), **kw)
    legacy.fit(PagedDMatrix(cache))
    ref = JBooster(policy=JPolicy(mode="out_of_core"), **kw).fit(JPagedDMatrix(cache))
    for a, b in zip(fresh.trees, legacy.trees):
        assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert torch.equal(fresh.margins_, legacy.margins_)
    assert_forests_equal(legacy.trees, ref.trees)


def test_node_map_histogram_needs_kernel_4():
    """The node_map path of the paged histogram runs kernel 4 (here its
    plain version) once per page: the page sum equals kernel 4 over the
    concatenated pages with the same level-local window."""
    from types import SimpleNamespace

    from repro_torch.kernels import ref

    rng = np.random.default_rng(4)
    bins = torch.from_numpy(rng.integers(0, 8, (50, 3)).astype(np.uint8))
    g = torch.from_numpy(rng.normal(size=50).astype(np.float32))
    h = torch.from_numpy(rng.random(50).astype(np.float32))
    pos = torch.from_numpy(rng.integers(-1, 9, 50).astype(np.int32))  # level [3, 7)
    node_map = torch.tensor([-1, 0, 1, -1], dtype=torch.int32)
    pages = [SimpleNamespace(index=i, device=bins[lo:hi],
                             host=SimpleNamespace(row_offset=lo, n_rows=hi - lo))
             for i, (lo, hi) in enumerate([(0, 20), (20, 50)])]
    positions = {0: pos[:20], 1: pos[20:]}
    got = ops.build_histogram_paged(iter(pages), g, h, positions, 3, 2, 8, node_map=node_map)
    level = torch.where((pos >= 3) & (pos < 7), pos - 3, -1)
    want = ref.build_histogram(bins, g, h, level, 2, 8, node_map=node_map)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_streaming_fit_stops_early_like_in_core(data):
    """Eval and early stopping are one loop for both engines: with the same
    bins the streaming fit stops where the in-core fit stops."""
    X, y, Xe, ye, _ = data
    kw = dict(PARAMS, objective="binary:logistic", n_estimators=30, learning_rate=1.0,
              early_stopping_rounds=2)
    dm = ArrayDMatrix(X, y, max_bin=32, page_bytes=PAGE_BYTES, device="cpu")
    stream = GradientBooster(device="cpu", policy=ExecutionPolicy(mode="out_of_core"), **kw)
    stream.fit(dm, eval_set=(Xe, ye))
    core = GradientBooster(device="cpu", **kw).fit(dm, eval_set=(Xe, ye))
    assert len(stream.trees) == len(core.trees) < 30
    assert stream.best_iteration_ == core.best_iteration_
    np.testing.assert_allclose([r.value for r in stream.eval_history],
                               [r.value for r in core.eval_history], rtol=1e-5, atol=1e-5)
