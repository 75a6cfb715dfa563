"""The port's synthetic data (`repro_torch.data.synthetic`) against the
reference's, on the CPU.

Both are numpy code seeded from (seed, batch): the same arguments must give
`array_equal` arrays, for every generator and both streaming sources, over
seeds, batch offsets, missing rates and tasks. An `IterDMatrix` built from
the port's HIGGS source must get the cuts and pages one built from the
reference's source gets.
"""
import dataclasses

import numpy as np
import pytest

from repro.data import synthetic as jsyn
from repro.data.dmatrix import IterDMatrix as JIterDMatrix
from repro_torch import data as tdata
from repro_torch.data import synthetic as tsyn
from repro_torch.data.dmatrix import IterDMatrix


def _equal(a, b):
    assert len(a) == len(b)
    for u, v in zip(a, b):
        assert u.dtype == v.dtype and u.shape == v.shape
        np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("seed", [0, 7, 123])
@pytest.mark.parametrize("batch", [0, 3, 1000])
@pytest.mark.parametrize("missing_rate", [0.0, 0.1])
def test_generators_equal_reference(seed, batch, missing_rate):
    _equal(tsyn.make_classification(301, 17, seed=seed, batch=batch, missing_rate=missing_rate,
                                    class_sep=1.3, flip_y=0.05),
           jsyn.make_classification(301, 17, seed=seed, batch=batch, missing_rate=missing_rate,
                                    class_sep=1.3, flip_y=0.05))
    _equal(tsyn.make_higgs_like(301, seed=seed, batch=batch, missing_rate=missing_rate),
           jsyn.make_higgs_like(301, seed=seed, batch=batch, missing_rate=missing_rate))
    _equal(tsyn.make_regression(301, 9, noise=0.3, seed=seed, batch=batch),
           jsyn.make_regression(301, 9, noise=0.3, seed=seed, batch=batch))


@pytest.mark.parametrize("task", ["classification", "higgs", "regression"])
@pytest.mark.parametrize("batch_offset", [0, 5])
@pytest.mark.parametrize("missing_rate", [0.0, 0.05])
def test_synthetic_source_equals_reference(task, batch_offset, missing_rate):
    kw = dict(n_rows=1000, num_features=12, batch_rows=300, task=task, seed=4,
              missing_rate=missing_rate, batch_offset=batch_offset)
    port, ref = tsyn.SyntheticSource(**kw), jsyn.SyntheticSource(**kw)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.num_features == (28 if task == "higgs" else 12)
    assert port.n_batches == ref.n_batches == 4
    got, want = list(port.iter_batches()), list(ref.iter_batches())
    assert [len(x) for x, _ in got] == [300, 300, 300, 100]
    for a, b in zip(got, want):
        _equal(a, b)
    # re-iterable, bit for bit
    for a, b in zip(port.iter_batches(), got):
        _equal(a, b)
    _equal(port.materialize(), ref.materialize())


def test_synthetic_source_refuses_an_unknown_task():
    with pytest.raises(ValueError):
        next(tsyn.SyntheticSource(n_rows=10, num_features=3, task="ranking").iter_batches())


@pytest.mark.parametrize("batch_rows", [64, 1000])
def test_array_source_equals_reference(batch_rows):
    X, y = tsyn.make_classification(250, 6, seed=2)
    port, ref = tsyn.ArraySource(X, y, batch_rows=batch_rows), jsyn.ArraySource(X, y, batch_rows)
    assert (port.n_rows, port.num_features) == (ref.n_rows, ref.num_features) == (250, 6)
    got, want = list(port.iter_batches()), list(ref.iter_batches())
    assert len(got) == len(want) == -(-250 // batch_rows)
    for a, b in zip(got, want):
        _equal(a, b)


def test_data_package_reexports_the_synthetic_names():
    for name in ("SyntheticSource", "ArraySource", "make_classification", "make_higgs_like",
                 "make_regression"):
        assert getattr(tdata, name) is getattr(tsyn, name)


def test_iter_dmatrix_from_the_higgs_source_matches_reference():
    kw = dict(n_rows=1500, num_features=5, batch_rows=400, task="higgs", seed=9,
              missing_rate=0.05)
    port = IterDMatrix(tsyn.SyntheticSource(**kw), max_bin=32, page_bytes=28 * 256,
                       device="cpu")
    ref = JIterDMatrix(jsyn.SyntheticSource(**kw), max_bin=32, page_bytes=28 * 256)
    for field in ("values", "ptrs", "min_vals"):
        np.testing.assert_array_equal(getattr(port.cuts, field), getattr(ref.cuts, field))
    ps, js = port.page_set(), ref.page_set()
    assert ps.n_pages == js.n_pages == 6
    assert ps.page_extents == js.page_extents
    for (_, a), (_, b) in zip(ps.iter_pages(), js.iter_pages()):
        np.testing.assert_array_equal(a.bins, b.bins)
