"""The port's numpy copies and data surface against the reference.

`repro_torch` keeps its own copies of the reference's numpy-only modules
(quantile sketch, ELLPACK binning, synthetic data), so it imports nothing
of `repro`. On the same inputs each copy must
give the reference's exact result.
"""
import numpy as np
import pytest

from repro.core.ellpack import bin_batch as j_bin_batch
from repro.core.memory import DeviceMemoryModel as JModel
from repro.core.quantile import sketch_dense as j_sketch_dense
from repro.data.dmatrix import ArrayDMatrix as JArrayDMatrix
from repro.data.synthetic import make_classification as j_make_classification
from repro_torch.core.ellpack import bin_batch
from repro_torch.core.memory import DeviceMemoryModel
from repro_torch.core.policy import ExecutionPolicy
from repro_torch.core.quantile import sketch_dense
from repro_torch.data.dmatrix import ArrayDMatrix
from repro_torch.data.synthetic import make_classification


@pytest.mark.parametrize("n,m,max_bin,missing", [(300, 4, 16, 0.0), (700, 6, 32, 0.1),
                                                 (50, 3, 256, 0.3)])
def test_sketch_and_bins_equal_reference(n, m, max_bin, missing):
    X, _ = make_classification(n, m, missing_rate=missing, seed=n)
    jX, _ = j_make_classification(n, m, missing_rate=missing, seed=n)
    np.testing.assert_array_equal(X, jX)
    cuts, jcuts = sketch_dense(X, max_bin), j_sketch_dense(X, max_bin)
    for f in ("values", "ptrs", "min_vals"):
        np.testing.assert_array_equal(getattr(cuts, f), getattr(jcuts, f))
    np.testing.assert_array_equal(bin_batch(X, cuts), j_bin_batch(X, jcuts))


def test_threaded_sketch_equals_reference():
    """Each batch summarises its features on a thread pool and merges into
    the running sketch; over several batches the cuts must be the
    reference's exactly."""
    X, _ = make_classification(600, 9, missing_rate=0.1, seed=5)
    cuts, jcuts = sketch_dense(X, 32, batch_rows=250), j_sketch_dense(X, 32, batch_rows=250)
    for f in ("values", "ptrs", "min_vals"):
        np.testing.assert_array_equal(getattr(cuts, f), getattr(jcuts, f))


def test_array_dmatrix_matches_reference():
    X, y = make_classification(400, 5, missing_rate=0.05, seed=1)
    dm = ArrayDMatrix(X, y, max_bin=64, device="cpu")
    jdm = JArrayDMatrix(X, y, max_bin=64)
    assert (dm.n_rows, dm.num_features, dm.n_bins) == (jdm.n_rows, jdm.num_features, jdm.n_bins)
    assert dm.estimated_device_bytes() == jdm.estimated_device_bytes()
    np.testing.assert_array_equal(dm.single_page_bins(), jdm.single_page_bins())
    with pytest.raises(ValueError, match="no labels"):
        ArrayDMatrix(X, device="cpu").require_labels()


@pytest.mark.parametrize("kw", [{}, {"max_depth": 12, "hist_budget_bytes": 1 << 20},
                                {"max_leaves": 31, "hist_retained_levels": 3}])
def test_byte_model_matches_reference(kw):
    a, b = DeviceMemoryModel(**kw), JModel(**kw)
    for n in (0, 10**6, 10**8):
        assert a.in_core_bytes(n) == b.in_core_bytes(n)
        assert a.out_of_core_bytes(n) == b.out_of_core_bytes(n)
        assert a.sampled_bytes(n, 0.3) == b.sampled_bytes(n, 0.3)
    assert a.max_rows_in_core() == b.max_rows_in_core()
    assert a.max_rows_sampled(0.1) == b.max_rows_sampled(0.1)


def test_policy_decides_like_reference():
    from repro.core.booster import BoosterParams as JParams
    from repro.core.policy import ExecutionPolicy as JPolicy
    from repro_torch.core.booster import BoosterParams

    X, y = make_classification(2000, 20, seed=2)
    dm = ArrayDMatrix(X, y, max_bin=32, device="cpu")
    jdm = JArrayDMatrix(X, y, max_bin=32)
    def outcome(policy, d, params):
        try:
            dec = policy.decide(d, params)
        except ValueError as err:  # nothing fits: both must say so, alike
            return ("error", str(err))
        return (dec.mode, dec.sampling_f, dec.reason)

    for budget in (None, 10**6, 10**5, 5 * 10**4):
        got = outcome(ExecutionPolicy(memory_budget_bytes=budget), dm, BoosterParams(max_depth=4))
        want = outcome(JPolicy(memory_budget_bytes=budget), jdm, JParams(max_depth=4))
        assert got == want
