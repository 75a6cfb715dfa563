"""`repro_torch.core.histcache` against the reference `HistogramStore`.

The build/derive plan is integer logic and must equal the reference's
exactly; the sibling derivation ``parent - built`` is one elementwise f32
subtraction in both packages, so expanded levels are equal bit for bit. A
tree grown with subtraction must match the full build (`assert_trees_equal`:
equal up to f32 ties).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from oracle import assert_trees_equal

from repro.core.histcache import HistogramStore as JStore
from repro.core.histcache import level_row_counts as j_level_row_counts
from repro_torch.core.booster import bin_valid_from_cuts
from repro_torch.core.ellpack import create_ellpack_inmemory
from repro_torch.core.histcache import HistogramStore, level_row_counts
from repro_torch.core.tree import TreeParams, grow_tree

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("offset,count", [(0, 1), (3, 4), (7, 8), (15, 16)])
def test_level_row_counts_match_reference(offset, count):
    rng = np.random.default_rng(count)
    pos = rng.integers(-1, 40, 700).astype(np.int32)
    got = level_row_counts(torch.from_numpy(pos), offset, count).numpy()
    want = np.asarray(j_level_row_counts(jnp.asarray(pos), offset, count))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", range(4))
def test_plan_and_expand_match_reference_bitwise(seed):
    rng = np.random.default_rng(seed)
    m, n_bins = 5, 8
    store, jstore = HistogramStore(), JStore()
    parent = rng.normal(size=(1, m, n_bins, 2)).astype(np.float32)
    for count in (1, 2, 4, 8):
        counts = None if count == 1 else rng.integers(0, 50, count).astype(np.int32)
        if count > 2:  # ties between siblings build the left child
            counts[2] = counts[3]
        plan = store.plan(count, None if counts is None else torch.from_numpy(counts), CPU)
        jplan = jstore.plan(count, None if counts is None else jnp.asarray(counts))
        assert plan.source == ("build" if count == 1 else "device") == jplan.source
        assert plan.n_build == jplan.n_build
        np.testing.assert_array_equal(plan.build_nodes.numpy(), np.asarray(jplan.build_nodes))
        if count > 1:
            np.testing.assert_array_equal(plan.node_map.numpy(), np.asarray(jplan.node_map))
        built = (parent if count == 1 else rng.normal(size=(count // 2, m, n_bins, 2))).astype(
            np.float32
        )
        got = store.expand(plan, torch.from_numpy(built)).numpy()
        want = np.asarray(jstore.expand(jplan, jnp.asarray(built)))
        np.testing.assert_array_equal(got, want)
    assert store.stats.built_nodes == jstore.stats.built_nodes
    assert store.stats.derived_nodes == jstore.stats.derived_nodes
    assert store.stats.built_rows == jstore.stats.built_rows
    assert store.stats.total_rows == jstore.stats.total_rows


def test_disabled_store_always_builds_everything():
    store = HistogramStore(enabled=False)
    store.expand(store.plan(1, None, CPU), torch.zeros(1, 2, 4, 2))
    plan = store.plan(2, torch.tensor([3, 5], dtype=torch.int32), CPU)
    assert plan.source == "build" and plan.node_map is None
    assert plan.build_nodes.tolist() == [1, 2]


def test_budgeted_store_is_queued():
    """A budgeted store (ported since this test was named) plans and expands
    every level as the unbudgeted one does, bit for bit, and resolves and
    books its spills as the reference's store under the same budget."""
    for budget in (0, 300, 1 << 20):
        _check_budgeted_store(budget)


def _check_budgeted_store(budget: int) -> None:
    rng = np.random.default_rng(budget)
    m, n_bins = 3, 4  # one node is 96 bytes
    free, tight, jtight = HistogramStore(), HistogramStore(budget_bytes=budget), JStore(
        budget_bytes=budget
    )
    for count in (1, 2, 4, 8, 16):
        counts = None if count == 1 else rng.integers(0, 50, count).astype(np.int32)
        tc = None if counts is None else torch.from_numpy(counts)
        want = free.plan(count, tc, CPU)
        got = tight.plan(count, tc, CPU)
        jgot = jtight.plan(count, None if counts is None else jnp.asarray(counts))
        assert got.source == jgot.source
        assert got.n_build == want.n_build
        np.testing.assert_array_equal(got.build_nodes.numpy(), want.build_nodes.numpy())
        built = rng.normal(size=(got.n_build, m, n_bins, 2)).astype(np.float32)
        full = tight.expand(got, torch.from_numpy(built)).numpy()
        np.testing.assert_array_equal(full, free.expand(want, torch.from_numpy(built)).numpy())
        np.testing.assert_array_equal(full, np.asarray(jtight.expand(jgot, jnp.asarray(built))))
        assert tight.device_bytes == jtight.device_bytes <= budget
    for f in ("hist_spills", "hist_fetches", "hist_spill_bytes", "hist_fetch_bytes"):
        assert getattr(tight.transfer_stats, f) == getattr(jtight.transfer_stats, f), f
    assert (tight.transfer_stats.hist_spills > 0) == (budget < 16 * m * n_bins * 2 * 4)


def test_subtraction_tree_matches_full_build(small_classification):
    X, _ = small_classification
    rng = np.random.default_rng(3)
    ell = create_ellpack_inmemory(X, max_bin=32, device=CPU)
    cuts, bins = ell.cuts, ell.single_page().bins
    g = torch.from_numpy(rng.normal(size=X.shape[0]).astype(np.float32))
    h = torch.from_numpy((rng.random(X.shape[0]) + 0.1).astype(np.float32))
    bv = bin_valid_from_cuts(cuts, 32, CPU)
    tb = torch.from_numpy(bins)
    results = {
        sub: grow_tree(tb, g, h, 32, bv, TreeParams(max_depth=4, hist_subtraction=sub),
                       cuts.values, cuts.ptrs)
        for sub in (True, False)
    }
    assert_trees_equal(
        results[True].tree, results[False].tree,
        got_positions=results[True].positions, want_positions=results[False].positions,
    )
