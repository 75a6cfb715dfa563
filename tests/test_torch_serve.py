"""The port's serving tier against the reference's, on the CPU.

One forest reaches both packages through a checkpoint the reference writes
and the port loads (``device="cpu"``: the kernels' plain versions). The same
rows, binned with the same cuts into pages of the same extents, go through
`repro.serve` and `repro_torch.serve` in every mode: rows resident or
streamed as pages (`ArrayDMatrix`, `IterDMatrix`, `PagedDMatrix`), the
forest resident or paged in tree-chunks, with or without pinned residency,
in both loop orders. Margins must be `array_equal` (serving a given forest
is exact in both packages), and the residency plans, chunk sizes and
ledgers (chunk hits and misses, h2d bytes) equal. The micro-batcher, the
serving terms of the byte model and the ``--forest`` server are held to
the reference the same way.
"""
import dataclasses
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core.booster import GradientBooster as JBooster
from repro.core.memory import DeviceMemoryModel as JModel
from repro.data.dmatrix import ArrayDMatrix as JArrayDMatrix
from repro.data.dmatrix import IterDMatrix as JIterDMatrix
from repro.data.dmatrix import PagedDMatrix as JPagedDMatrix
from repro.data.pages import TransferStats as JTransferStats
from repro.serve import ForestServer as JForestServer
from repro.serve import ServeStats as JServeStats
from repro.serve import engine as jengine
from repro_torch.core.booster import GradientBooster
from repro_torch.core.memory import DeviceMemoryModel
from repro_torch.data.dmatrix import ArrayDMatrix, IterDMatrix, PagedDMatrix
from repro_torch.data.pages import TransferStats
from repro_torch.kernels import ops
from repro_torch.pipeline import DevicePageCache, PageStream
from repro_torch.serve import (
    BatchServer,
    ForestServer,
    PackedForest,
    ServeStats,
    plan_residency,
    predict_margin_dmatrix,
    resolve_trees_per_chunk,
)
from repro_torch.serve import engine as tengine

from conftest import MAX_BIN

ROOT = Path(__file__).resolve().parents[1]
N_TREES, DEPTH, PAGE_BYTES = 12, 4, 512  # 64 rows a page at 8 features
NODE_BYTES = JModel().forest_node_bytes  # one staged chunk node, the reference's term


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(X, reference booster, port booster loaded from its checkpoint, path)."""
    from repro_torch.data.synthetic import make_classification

    X, y = make_classification(400, 8, class_sep=1.5, missing_rate=0.05, seed=23)
    ref = JBooster(n_estimators=N_TREES, max_depth=DEPTH, max_bin=MAX_BIN,
                   objective="binary:logistic").fit(X, y)
    path = str(tmp_path_factory.mktemp("serve") / "ck")
    ref.save(path)
    return X, ref, GradientBooster.load(path, device="cpu"), path


def _matrices(kind, X, ref, port, tmp_path):
    """The same rows as a (reference, port) DMatrix pair of one kind."""
    if kind == "array":
        kw = dict(max_bin=MAX_BIN, page_bytes=PAGE_BYTES)
        return (JArrayDMatrix(X, cuts=ref.cuts, **kw),
                ArrayDMatrix(X, cuts=port.cuts, device="cpu", **kw))
    batches = [(X[i : i + 100], None) for i in range(0, len(X), 100)]
    if kind == "iter":
        kw = dict(max_bin=MAX_BIN, page_bytes=PAGE_BYTES)
        return (JIterDMatrix(batches, cuts=ref.cuts, **kw),
                IterDMatrix(batches, cuts=port.cuts, device="cpu", **kw))
    JIterDMatrix(batches, max_bin=MAX_BIN, cuts=ref.cuts, page_bytes=PAGE_BYTES,
                 cache_dir=str(tmp_path / "ref"))
    IterDMatrix(batches, max_bin=MAX_BIN, cuts=port.cuts, page_bytes=PAGE_BYTES,
                cache_dir=str(tmp_path / "port"), device="cpu")
    return JPagedDMatrix(str(tmp_path / "ref")), PagedDMatrix(str(tmp_path / "port"))


def _worst(dm) -> int:
    return max(nr for _, nr in dm.page_set().page_extents)


def _force_order(monkeypatch, order):
    for mod in (jengine, tengine):
        plan = mod.plan_residency
        monkeypatch.setattr(
            mod, "plan_residency",
            lambda *a, _plan=plan, **k: dataclasses.replace(_plan(*a, **k), order=order),
        )


# mode: (trees_per_chunk, pin_chunks, chunks pinned beside a row page, order)
MODES = {
    "resident": (None, None, None, None),
    "chunk1": (1, False, None, None),
    "chunk3": (3, False, None, None),
    "chunk3_budget": (3, None, 2, None),
    "chunk3_budget_chunks_outer": (3, None, 2, "chunks_outer"),
    "chunk3_budget_pages_outer": (3, None, 2, "pages_outer"),
    "chunk1_budget_pages_outer": (1, None, 5, "pages_outer"),
    "chunk1_pin_all": (1, True, None, None),
    "chunk3_pin_all_pages_outer": (3, True, None, "pages_outer"),
}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("kind", ["array", "iter", "paged"])
def test_predict_margin_dmatrix_matches_reference(pair, tmp_path, monkeypatch, kind, mode):
    X, ref, port, _ = pair
    jdm, tdm = _matrices(kind, X, ref, port, tmp_path)
    assert jdm.page_set().page_extents == tdm.page_set().page_extents
    assert tdm.n_pages > 4
    tpc, pin, n_budget, order = MODES[mode]
    kw = dict(trees_per_chunk=tpc, pin_chunks=pin)
    if n_budget is not None:
        per_chunk = NODE_BYTES * tpc * port.packed_forest().n_total
        kw["serve_budget_bytes"] = _worst(tdm) * tdm.num_features + n_budget * per_chunk
    if order is not None:
        _force_order(monkeypatch, order)
    jss, tss = JServeStats(), ServeStats()
    jst, tst = JTransferStats(), TransferStats()
    want = jengine.predict_margin_dmatrix(ref.packed_forest(), jdm, stats=jst,
                                          serve_stats=jss, **kw)
    got = predict_margin_dmatrix(port.packed_forest(), tdm, stats=tst, serve_stats=tss, **kw)
    assert got.dtype == np.float32
    assert np.array_equal(got, want)
    assert np.array_equal(got, port.predict_margin(X))  # bitwise the resident forest
    ledger = ("predicts", "chunk_hits", "chunk_misses", "h2d_bytes")
    assert [getattr(tss, f) for f in ledger] == [getattr(jss, f) for f in ledger]
    assert tst.host_to_device_bytes == jst.host_to_device_bytes == tss.h2d_bytes
    assert (tst.cache_hits, tst.cache_misses) == (jst.cache_hits, jst.cache_misses)
    if tpc is not None and pin is not False and order is None:  # the plan's order saves
        legacy = TransferStats()
        predict_margin_dmatrix(port.packed_forest(), tdm, trees_per_chunk=tpc,
                               pin_chunks=False, stats=legacy)
        assert tst.host_to_device_bytes < legacy.host_to_device_bytes


@pytest.mark.parametrize("kind", ["array", "iter", "paged"])
def test_booster_predict_takes_any_dmatrix(pair, tmp_path, kind):
    X, ref, port, _ = pair
    jdm, tdm = _matrices(kind, X, ref, port, tmp_path)
    got = port.predict_margin(tdm)
    assert tdm.stats.host_to_device_bytes == tdm.n_rows * tdm.num_features  # one pass
    assert np.array_equal(got, np.asarray(ref.predict_margin(jdm)))
    assert np.array_equal(got, port.predict_margin(X))
    assert np.array_equal(port.predict(tdm), port.predict(X))
    assert np.array_equal(port.predict(tdm, output_margin=True), got)
    sub = port.predict_margin(tdm, iteration_range=(2, 5))
    assert np.array_equal(sub, np.asarray(ref.predict_margin(jdm, iteration_range=(2, 5))))


@pytest.mark.parametrize("rows", ["ndarray", "dmatrix"])
def test_forest_server_cross_request_residency(pair, rows):
    """A server's pins persist across requests in both packages alike: the
    second request stages no pinned chunk, and costs less."""
    X, ref, port, _ = pair
    n_total = port.packed_forest().n_total
    budget = 4 * NODE_BYTES * 2 * n_total
    if rows == "dmatrix":
        data = (JArrayDMatrix(X, cuts=ref.cuts, max_bin=MAX_BIN, page_bytes=PAGE_BYTES),
                ArrayDMatrix(X, cuts=port.cuts, max_bin=MAX_BIN, page_bytes=PAGE_BYTES,
                             device="cpu"))
        budget += _worst(data[1]) * X.shape[1]
    else:
        data = (X, X)
    ledgers = []
    for server_cls, booster, d, stats in (
        (JForestServer, ref, data[0], JServeStats()),
        (ForestServer, port, data[1], ServeStats()),
    ):
        server = server_cls(booster, trees_per_chunk=2, serve_budget_bytes=budget,
                            serve_stats=stats)
        outs, steps = [], []
        for _ in range(2):
            before = (stats.chunk_hits, stats.chunk_misses, stats.h2d_bytes)
            outs.append(np.asarray(server.predict_margin(d)))
            steps.append(tuple(a - b for a, b in zip(
                (stats.chunk_hits, stats.chunk_misses, stats.h2d_bytes), before)))
        ledgers.append((outs, steps, server.residency()))
    (j_outs, j_steps, j_res), (t_outs, t_steps, t_res) = ledgers
    assert all(np.array_equal(t, j) for t, j in zip(t_outs, j_outs))
    assert np.array_equal(t_outs[0], port.predict_margin(X))
    assert t_steps == j_steps and t_res == j_res
    assert t_res["pinned_chunks"] == 4
    (hits_1, misses_1, h2d_1), (hits_2, misses_2, h2d_2) = t_steps
    assert hits_2 >= hits_1 + 4 and misses_2 <= misses_1 - 4 and h2d_2 < h2d_1


@pytest.mark.parametrize("kw", [
    {}, dict(trees_per_chunk=3), dict(trees_per_chunk=5, pin_chunks=True),
    dict(trees_per_chunk=2, serve_budget_bytes=3 * NODE_BYTES * 2 * (2 ** (DEPTH + 1) - 1)),
], ids=["resident", "chunk3", "chunk5_pin_all", "chunk2_budget"])
def test_forest_server_raw_rows_match_reference(pair, kw):
    X, ref, port, _ = pair
    jss, tss = JServeStats(), ServeStats()
    jserver = JForestServer(ref, serve_stats=jss, **kw)
    tserver = ForestServer(port, serve_stats=tss, **kw)
    got = tserver.predict_margin(X)
    assert np.array_equal(got, np.asarray(jserver.predict_margin(X)))
    assert np.array_equal(got, port.predict_margin(X))
    assert tserver.stats.host_to_device_bytes == jserver.stats.host_to_device_bytes
    assert (tss.chunk_hits, tss.chunk_misses, tss.h2d_bytes) == (
        jss.chunk_hits, jss.chunk_misses, jss.h2d_bytes)
    assert tserver.residency() == jserver.residency()
    assert np.array_equal(tserver.predict(X), port.predict(X))


def test_byte_model_sizes_chunks_as_the_reference(pair):
    """A `DeviceMemoryModel` budget that fits 1 tree beside the worst-case
    page but 2 beside a measured 32-row launch: the same chunk sizes, the
    same margins and ledgers in both packages."""
    X, ref, port, _ = pair
    m = X.shape[1]
    per_tree = (2 ** (DEPTH + 1) - 1) * 24
    jdm = JArrayDMatrix(X, cuts=ref.cuts, max_bin=MAX_BIN, page_bytes=PAGE_BYTES)
    tdm = ArrayDMatrix(X, cuts=port.cuts, max_bin=MAX_BIN, page_bytes=PAGE_BYTES, device="cpu")
    worst = _worst(tdm)
    kw = dict(hbm_bytes=DeviceMemoryModel(num_features=m).serve_batch_bytes(worst) + per_tree,
              num_features=m, max_depth=DEPTH)
    jmodel, tmodel = JModel(**kw), DeviceMemoryModel(**kw)
    assert tmodel.max_trees_resident(worst) == 1 < tmodel.max_trees_resident(32) == 2
    for measured in (None, 32):
        stats = []
        for mod, forest, dm, model, ss in (
            (jengine, ref.packed_forest(), jdm, jmodel, JServeStats()),
            (tengine, port.packed_forest(), tdm, tmodel, ServeStats()),
        ):
            if measured:
                ss.record_batch(measured, 0, 0.0, [1e-3])
            out = mod.predict_margin_dmatrix(forest, dm, model=model, serve_stats=ss)
            stats.append((np.asarray(out), ss.chunk_hits, ss.chunk_misses, ss.h2d_bytes))
        (j_out, *j_ledger), (t_out, *t_ledger) = stats
        assert np.array_equal(t_out, j_out) and t_ledger == j_ledger
        assert np.array_equal(t_out, port.predict_margin(X))
    # raw rows: a 32-row request pages the forest in 2-tree chunks
    server = ForestServer(port, model=tmodel)
    got = server.predict_margin(X[:32])
    assert np.array_equal(got, port.predict_margin(X[:32]))
    assert np.array_equal(got, np.asarray(JForestServer(ref, model=jmodel).predict_margin(X[:32])))
    assert server.stats.host_to_device_bytes > 0
    none_fits = DeviceMemoryModel(hbm_bytes=tmodel.serve_batch_bytes(512), num_features=m,
                                  max_depth=DEPTH)
    with pytest.raises(ValueError, match="no tree"):
        resolve_trees_per_chunk(port.packed_forest(), 512, none_fits, None)


# ------------------------------------------------------------ byte model
@settings(max_examples=60, deadline=None, database=None)
@given(
    n_chunks=st.integers(0, 9), chunk=st.integers(1, 5000), last=st.integers(1, 5000),
    data_bytes=st.integers(0, 10**7), n_pages=st.integers(1, 40),
    max_bytes=st.one_of(st.none(), st.integers(0, 40_000)),
    reserve=st.integers(0, 20_000), pin=st.booleans(),
)
def test_plan_residency_matches_reference(n_chunks, chunk, last, data_bytes, n_pages,
                                          max_bytes, reserve, pin):
    chunk_bytes = [chunk] * max(n_chunks - 1, 0) + ([last] if n_chunks else [])
    args = (chunk_bytes, data_bytes, n_pages, max_bytes)
    got = plan_residency(*args, reserve_bytes=reserve, pin=pin)
    want = jengine.plan_residency(*args, reserve_bytes=reserve, pin=pin)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@settings(max_examples=60, deadline=None, database=None)
@given(
    n_trees=st.integers(1, 300), depth=st.integers(0, 10), m=st.integers(1, 600),
    batch_rows=st.integers(1, 200_000), hbm=st.integers(0, 2**31),
    explicit=st.one_of(st.none(), st.integers(0, 400)), no_model=st.booleans(),
)
def test_resolve_trees_per_chunk_matches_reference(n_trees, depth, m, batch_rows, hbm,
                                                   explicit, no_model):
    forest = types.SimpleNamespace(n_trees=n_trees, max_depth=depth)
    kw = dict(hbm_bytes=hbm, num_features=m, max_depth=depth)
    models = (None, None) if no_model else (DeviceMemoryModel(**kw), JModel(**kw))
    outcomes = []
    for fn, model in ((resolve_trees_per_chunk, models[0]),
                      (jengine.resolve_trees_per_chunk, models[1])):
        try:
            outcomes.append(fn(forest, batch_rows, model, explicit))
        except ValueError as e:
            outcomes.append(("ValueError", "fits no tree" in str(e)))
    assert outcomes[0] == outcomes[1]


@settings(max_examples=60, deadline=None, database=None)
@given(
    m=st.integers(1, 2000), depth=st.integers(0, 12), n_trees=st.integers(0, 5000),
    rows=st.integers(0, 10**7), measured=st.one_of(st.none(), st.integers(0, 4096)),
    hbm=st.integers(0, 2**36),
)
def test_byte_model_serving_terms_match_reference(m, depth, n_trees, rows, measured, hbm):
    kw = dict(hbm_bytes=hbm, num_features=m, max_depth=depth)
    got, want = DeviceMemoryModel(**kw), JModel(**kw)
    assert got.forest_node_bytes == want.forest_node_bytes == 24
    for name, args in (
        ("packed_forest_bytes", (n_trees,)), ("packed_forest_bytes", (n_trees, depth + 1)),
        ("serve_batch_bytes", (rows,)), ("serve_bytes", (rows, n_trees)),
        ("serve_batch_rows", (rows, measured)), ("serve_residency_budget", (rows,)),
        ("max_trees_resident", (rows,)), ("max_trees_resident", (rows, depth + 1)),
    ):
        assert getattr(got, name)(*args) == getattr(want, name)(*args), name
    assert got.serve_batch_bytes(rows) == rows * (4 * m + 4)


# --------------------------------------------------------- packed forest
def test_pack_page_roundtrip_chunk_and_nbytes_match_reference(pair):
    _, ref, port, _ = pair
    jf, tf = ref.packed_forest(), port.packed_forest()
    assert tf.nbytes == jf.nbytes == tf.n_trees * tf.n_total * (4 * 4 + 2)
    for lo, hi in ((0, N_TREES), (1, 4), (11, 12), (5, 5)):
        page = tf.pack_page(lo, hi)
        assert page.dtype == np.float32 and page.shape == (6, hi - lo, tf.n_total)
        assert page.flags.c_contiguous
        assert np.array_equal(page, jf.pack_page(lo, hi))
        arrays = PackedForest.unpack_page(torch.from_numpy(page))
        chunk, jchunk = tf.chunk(lo, hi), jf.chunk(lo, hi)
        assert chunk.n_trees == hi - lo and chunk.learning_rate == tf.learning_rate
        for name in ("feature", "split_bin", "split_value", "default_left", "is_leaf",
                     "leaf_value"):
            t = arrays[name]
            assert t.is_contiguous() and t.dtype == getattr(chunk, name).dtype
            assert torch.equal(t, getattr(chunk, name))
            assert np.array_equal(t.numpy(), np.asarray(getattr(jchunk, name)))


def test_empty_forest_passes_margins_through(pair):
    X, ref, port, _ = pair
    margin = torch.tensor([1.5, -2.0])
    empty = torch.zeros((0, 7))
    out = ops.predict_forest(
        torch.zeros((2, 4), dtype=torch.uint8), empty.int(), empty.int(), empty.bool(),
        empty.bool(), empty, 2, 0.3, margin,
    )
    assert torch.equal(out, margin)
    tdm = ArrayDMatrix(X, cuts=port.cuts, max_bin=MAX_BIN, page_bytes=PAGE_BYTES, device="cpu")
    forest = port.packed_forest(iteration_range=(3, 3))
    assert forest.n_trees == 0
    base = np.full(len(X), port.base_margin_, np.float32)
    assert np.array_equal(predict_margin_dmatrix(forest, tdm), base)
    assert np.array_equal(predict_margin_dmatrix(forest, tdm, trees_per_chunk=2), base)


def test_zero_row_dmatrix_returns_base_margins(pair):
    X, ref, port, _ = pair
    tdm = ArrayDMatrix(X[:0], cuts=port.cuts, max_bin=MAX_BIN, device="cpu")
    jdm = JArrayDMatrix(X[:0], cuts=ref.cuts, max_bin=MAX_BIN)
    for kw in ({}, dict(trees_per_chunk=2, pin_chunks=True)):
        got = predict_margin_dmatrix(port.packed_forest(), tdm, **kw)
        want = jengine.predict_margin_dmatrix(ref.packed_forest(), jdm, **kw)
        assert got.shape == (0,) and got.dtype == np.float32
        assert np.array_equal(got, want)


def test_forest_needs_cuts_and_raw_codecs(pair):
    X, ref, port, _ = pair
    blind = dataclasses.replace(port.packed_forest(), cuts=None)
    with pytest.raises(ValueError, match="no cuts"):
        blind.predict_margin(X)
    with pytest.raises(ValueError, match="no cuts"):
        ForestServer(blind, trees_per_chunk=1).predict_margin(X)
    tdm = ArrayDMatrix(X, cuts=port.cuts, max_bin=MAX_BIN, device="cpu")
    jdm = JArrayDMatrix(X, cuts=ref.cuts, max_bin=MAX_BIN)
    raw = predict_margin_dmatrix(port.packed_forest(), tdm, page_codec="raw")
    assert np.array_equal(raw, port.predict_margin(X))
    # the page codecs are lossless: every codec serves the raw margins, as
    # the reference's do
    for codec in ("bitpack", "delta-rle"):
        got = predict_margin_dmatrix(port.packed_forest(), tdm, trees_per_chunk=2,
                                     page_codec=codec)
        want = jengine.predict_margin_dmatrix(ref.packed_forest(), jdm, trees_per_chunk=2,
                                              page_codec=codec)
        assert np.array_equal(got, raw) and np.array_equal(got, np.asarray(want))
        server = ForestServer(port, trees_per_chunk=2, page_codec=codec)
        assert np.array_equal(server.predict_margin(X), raw)
    (page,) = list(tdm.page_set().stream(device="cpu", codec="bitpack"))
    assert torch.equal(page.device, torch.from_numpy(tdm.single_page_bins()))


def test_page_stream_keys_its_cache_by_tag_and_pins(pair):
    """Two streams over the same indices do not alias in one cache; a pinned
    key's fetch may return None, threaded or not, and still hits."""
    cache = DevicePageCache(max_pages=2, max_bytes=10_000)
    pages = [np.full((4, 8), i, np.uint8) for i in range(3)]
    for tag, value in (("a", 0), ("b", 100)):
        s = PageStream(lambda i, v=value: pages[i] + v, range(3), device="cpu", cache=cache,
                       cache_tag=tag, cache_pin=True, stats=TransferStats())
        assert [int(p.device[0, 0]) for p in s] == [value, value + 1, value + 2]
    assert cache.pinned_pages == 6 and cache.is_pinned(("a", 2)) and cache.is_pinned(("b", 0))
    for threaded in (False, True):
        stats = TransferStats()
        s = PageStream(lambda i: None, range(3), device="cpu", cache=cache, cache_tag="b",
                       threaded=threaded, stats=stats)
        assert [int(p.device[0, 0]) for p in s] == [100, 101, 102]
        assert stats.cache_hits == 3 and stats.host_to_device_bytes == 0


# ---------------------------------------------------------- micro-batcher
@pytest.mark.parametrize("trees_per_chunk", [None, 4])
def test_batch_server_matches_direct(pair, trees_per_chunk):
    X, _, port, _ = pair
    server = ForestServer(port, trees_per_chunk=trees_per_chunk)
    stats = ServeStats()
    with BatchServer(server.predict_margin, max_batch=32, max_delay_ms=5.0, stats=stats) as srv:
        futures = [srv.submit(X[i]) for i in range(100)]
        got = np.asarray([f.result(timeout=60.0) for f in futures], np.float32)
    assert np.array_equal(got, port.predict_margin(X[:100]))
    assert stats.requests == stats.rows == 100 and stats.batches >= 4
    assert stats.padded_rows == stats.batches * 32 - 100
    assert stats.max_launch_rows == 32
    assert 0.0 < stats.occupancy <= 1.0 and stats.p99_ms >= stats.p50_ms > 0.0
    assert stats.rows_per_s > 0.0 and stats.wall_seconds > 0.0


def test_batch_server_deadline_flush(pair):
    X, _, port, _ = pair
    forest = port.packed_forest()
    stats = ServeStats()
    with BatchServer(forest.predict_margin, max_batch=64, max_delay_ms=10.0,
                     stats=stats) as srv:
        out = srv.predict_one(X[0], timeout=30.0)  # only the deadline can flush it
    assert np.float32(out) == forest.predict_margin(X[:1])[0]
    assert stats.batches == 1 and stats.padded_rows == 63


def test_batch_server_delivers_errors_to_every_future():
    def boom(rows):
        raise RuntimeError("kernel exploded")

    with BatchServer(boom, max_batch=4, max_delay_ms=50.0) as srv:
        futures = [srv.submit(np.zeros(3, np.float32)) for _ in range(3)]
        for fut in futures:
            with pytest.raises(RuntimeError, match="kernel exploded"):
                fut.result(timeout=30.0)
    assert srv.stats.batches == 0


def test_batch_server_rejects_bad_input(pair):
    X, _, port, _ = pair
    srv = BatchServer(port.packed_forest().predict_margin, max_batch=8)
    try:
        with pytest.raises(ValueError, match="single feature row"):
            srv.submit(X[:2])
    finally:
        srv.close()
    with pytest.raises(RuntimeError, match="closed"):
        srv.submit(X[0])
    with pytest.raises(ValueError, match="max_batch"):
        BatchServer(lambda r: r, max_batch=0)


def test_batch_server_concurrent_clients_stress():
    """More client threads than cores submit at once under a short switch
    interval: every future gets its own row's answer and the ledger counts
    every request once."""
    import threading

    rows = np.random.default_rng(3).normal(size=(16, 40, 5)).astype(np.float32)
    got = np.zeros(rows.shape[:2], np.float32)
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with BatchServer(lambda b: b.sum(axis=1), max_batch=24, max_delay_ms=1.0) as srv:
            def client(k):
                futures = [srv.submit(r) for r in rows[k]]
                got[k] = [f.result(timeout=60.0) for f in futures]

            threads = [threading.Thread(target=client, args=(k,)) for k in range(len(rows))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60.0)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(prev)
    assert np.array_equal(got, rows.sum(axis=2))
    assert srv.stats.requests == srv.stats.rows == rows.shape[0] * rows.shape[1]
    assert len(srv.stats.latencies_s) == srv.stats.requests


def test_serve_stats_match_reference_on_the_same_records():
    got, want = ServeStats(), JServeStats()
    assert (got.p50_ms, got.p99_ms, got.occupancy, got.rows_per_s, got.chunk_hit_rate,
            got.h2d_bytes_per_request) == (0.0,) * 6
    assert (want.p50_ms, want.p99_ms) == (0.0, 0.0)
    for stats in (got, want):
        local = np.random.default_rng(5)
        for n in (3, 17, 32):
            stats.record_batch(n, 32 - n, 0.01, list(local.random(n) * 1e-2))
        stats.record_residency(5, 2, 4096)
        stats.record_residency(7, 0, 1024)
        stats.wall_seconds = 0.5
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for prop in ("p50_ms", "p99_ms", "occupancy", "rows_per_s", "chunk_hit_rate",
                 "h2d_bytes_per_request"):
        assert getattr(got, prop) == getattr(want, prop), prop
    assert got.max_launch_rows == 32 and got.predicts == 2
    got.reset()
    want.reset()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.requests == 0 and got.latencies_s == [] and got.occupancy == 0.0


# ------------------------------------------------------------ --forest server
def test_forest_server_command_runs_on_the_cpu(pair):
    _, _, _, path = pair
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--forest", path,
           "--device", "cpu", "--requests", "64", "--trees-per-chunk", "5",
           "--serve-budget-mib", "1"]
    out = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "served 64 requests" in out.stdout and "residency:" in out.stdout
    # LM mode (--arch) on the host: prefill, decode and the greedy continuation
    lm = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "smollm-135m",
         "--device", "cpu", "--tokens", "4"],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert lm.returncode == 0, lm.stderr
    lines = lm.stdout.splitlines()
    assert lines[0].startswith("prefill: 4x32 in ")
    assert lines[1].startswith("decode: 4 steps x batch 4 in ") and "tok/s" in lines[1]
    assert lines[2].startswith("greedy continuation (seq 0): [")
    assert len(lines[2].split("[", 1)[1].split(",")) == 5  # prefill's token + 4 decoded
    # without --device cpu it serves on the card, and with no card it raises
    no_card = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "smollm-135m",
         "--tokens", "1"],
        env=dict(env, CUDA_VISIBLE_DEVICES=""), capture_output=True, text=True, timeout=300,
    )
    assert no_card.returncode != 0 and "torch.cuda.is_available() is False" in no_card.stderr
