"""The port's tiered, budgeted `HistogramStore` against the reference's, on
the CPU.

The bar, as in the reference's own suite: an unlimited budget is the
untiered store bit for bit; under a tight budget spilling changes where a
histogram lives, never what it holds, so at ``retained_levels=1`` the trees
equal the unbudgeted store's bit for bit (host round trips are exact) in
core and paged; ancestor chains (``retained_levels >= 2``) re-associate f32
sums, so there trees are held under `assert_trees_equal`. The spill order
(level order depthwise, lowest frontier gain first best-first), the
`TransferStats` counters and the `HistCacheStats` ledger equal the
reference's on the same inputs, and so does the byte model the policy
decides with.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from oracle import assert_trees_equal

from repro.core.booster import GradientBooster as JBooster
from repro.core.histcache import HistogramStore as JStore
from repro.core.histcache import level_row_counts as j_level_row_counts
from repro.core.histcache import node_row_counts as j_node_row_counts
from repro.core.memory import DeviceMemoryModel as JModel
from repro.core.policy import ExecutionPolicy as JPolicy
from repro_torch.core.booster import BoosterParams, GradientBooster
from repro_torch.core.histcache import (
    HistogramStore,
    LevelPlan,
    level_row_counts,
    node_row_counts,
)
from repro_torch.core.memory import DeviceMemoryModel
from repro_torch.core.policy import ExecutionPolicy
from repro_torch.core.tree import TreeParams
from repro_torch.fault import FaultPlan, FaultSpec
from repro_torch.fault import inject as fault_inject
from test_torch_lossguide import Inputs, _identical

CPU = torch.device("cpu")
DEEP = 10  # spill must engage at depth >= 10
LEDGER = ("hist_spills", "hist_fetches", "hist_spill_bytes", "hist_fetch_bytes",
          "device_to_host_bytes", "host_to_device_bytes")
STATS = ("levels", "built_nodes", "derived_nodes", "chain_derived_nodes", "rebuilt_nodes")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _same_ledger(store, jstore):
    for f in LEDGER:
        assert getattr(store.transfer_stats, f) == getattr(jstore.transfer_stats, f), f
    for f in STATS:
        assert getattr(store.stats, f) == getattr(jstore.stats, f), f


def _budgeted(budget, retained=1):
    return HistogramStore(budget_bytes=budget, retained_levels=retained), JStore(
        budget_bytes=budget, retained_levels=retained
    )


# --------------------------------------------------- unlimited-budget identity
def test_unlimited_budget_is_the_untiered_store_bit_for_bit():
    inp = Inputs(700, 5, 16, 0.0, seed=0)
    tp = TreeParams(max_depth=6)
    want = inp.grow(tp, HistogramStore())
    store = HistogramStore(budget_bytes=1 << 40, retained_levels=3)
    got = inp.grow(tp, store)
    _identical(got.tree, want.tree)
    assert torch.equal(got.positions, want.positions)
    assert store.transfer_stats.hist_spills == store.transfer_stats.hist_fetches == 0


# ----------------------------------------------- deep-tree spill, both builders
@pytest.mark.parametrize("grow_policy,max_leaves", [("depthwise", 0), ("lossguide", 48)])
def test_deep_tree_tight_budget_in_core(grow_policy, max_leaves):
    """A budget that spills at depth >= 10 changes no bit of the tree; the
    best-first spill and fetch ledger equals the reference's (the depthwise
    ledger is held against it at depth 6 below: the reference takes ~25 s
    to compile a depth-10 in-core build)."""
    inp = Inputs(900, 4, 8, 0.05, seed=1)
    tp = TreeParams(max_depth=DEEP, grow_policy=grow_policy, max_leaves=max_leaves)
    want = inp.grow(tp, HistogramStore())
    store, jstore = _budgeted(2048)
    got = inp.grow(tp, store)
    _identical(got.tree, want.tree)
    if grow_policy == "lossguide":
        inp.j_grow(tp, jstore)
        _same_ledger(store, jstore)
    ts = store.transfer_stats
    assert ts.hist_spills > 0 and ts.hist_fetches > 0
    assert ts.host_to_device_bytes >= ts.hist_fetch_bytes  # the fetch is page traffic


@pytest.mark.parametrize("grow_policy,max_leaves,budget", [
    ("depthwise", 0, 2048), ("lossguide", 24, 512),
])
def test_deep_tree_tight_budget_paged(grow_policy, max_leaves, budget):
    inp = Inputs(900, 4, 8, 0.0, seed=2)
    tp = TreeParams(max_depth=DEEP, grow_policy=grow_policy, max_leaves=max_leaves)
    want, want_pos, _ = inp.paged(tp, store=HistogramStore())
    store, jstore = _budgeted(budget)
    got, pos, _ = inp.paged(tp, store=store)
    _identical(got, want)
    assert torch.equal(pos, want_pos)
    if grow_policy == "lossguide":  # the reference compiles depth 10 in ~25 s
        inp.j_paged(tp, store=jstore)
        _same_ledger(store, jstore)
    assert store.transfer_stats.hist_spills > 0 and store.transfer_stats.hist_fetches > 0


# ------------------------------------------------------------ budget boundaries
def _level_bytes(m, max_bin, depth):
    return (2**depth) * m * max_bin * 2 * 4


def test_budget_exactly_one_level_never_spills():
    n, m, max_bin, md = 600, 4, 8, 6
    inp = Inputs(n, m, max_bin, 0.0, seed=4)
    tp = TreeParams(max_depth=md)
    want = inp.grow(tp, HistogramStore())
    fits = HistogramStore(budget_bytes=_level_bytes(m, max_bin, md - 1))
    _identical(inp.grow(tp, fits).tree, want.tree)
    assert fits.transfer_stats.hist_spills == 0
    store, jstore = _budgeted(_level_bytes(m, max_bin, md - 1) - 1)
    _identical(inp.grow(tp, store).tree, want.tree)
    inp.j_grow(tp, jstore)
    _same_ledger(store, jstore)
    assert store.transfer_stats.hist_spills > 0


def test_budget_zero_spills_everything_and_stays_bit_exact():
    n, m, max_bin, md = 600, 4, 8, 6
    inp = Inputs(n, m, max_bin, 0.0, seed=5)
    tp = TreeParams(max_depth=md)
    want = inp.grow(tp, HistogramStore())
    store, jstore = _budgeted(0)
    _identical(inp.grow(tp, store).tree, want.tree)
    inp.j_grow(tp, jstore)
    _same_ledger(store, jstore)
    ts = store.transfer_stats
    assert ts.hist_spills == md and ts.hist_fetches == md - 1
    assert ts.hist_spill_bytes > ts.hist_fetch_bytes  # the last level is never fetched


# ------------------------------------------------------------- eviction order
def _fake_level(depth, m=2, max_bin=4):
    return torch.ones((2**depth, m, max_bin, 2)) * (depth + 1)


def test_depthwise_eviction_is_level_order():
    """One retained level: stale levels are dropped free, and the levels
    that outgrow the budget leave the device in level order."""
    store = HistogramStore(budget_bytes=2 * 64)  # levels 0 and 1 fit
    spilled = []
    for depth in range(4):
        plan = LevelPlan(node_map=None, n_build=2**depth, count=2**depth)
        store.expand(plan, _fake_level(depth))
        for d in range(depth):
            assert store.tier_of(("L", d)) is None
        if (2**depth) * 64 <= store.budget_bytes:
            assert store.tier_of(("L", depth)) == "device"
        else:
            assert store.tier_of(("L", depth)) == "host"
            spilled.append(depth)
    assert spilled == [2, 3]
    assert store.transfer_stats.hist_spills == 2


def test_lossguide_eviction_is_lru_by_frontier_gain():
    """The coldest frontier leaf (lowest split gain) spills first."""
    node = torch.ones((2, 4, 2))  # 64 B
    store = HistogramStore(budget_bytes=2 * 64)
    store.put_node(1, node)
    store.put_node(2, node * 2)
    store.note_gain(1, 5.0)
    store.note_gain(2, 1.0)
    store.put_node(3, node * 3)  # over budget: node 2 (gain 1.0) goes
    assert [store.tier_of(("N", k)) for k in (1, 2, 3)] == ["device", "host", "device"]
    store.note_gain(3, 0.5)
    store.put_node(4, node * 4)  # now node 3 is the coldest
    assert store.tier_of(("N", 3)) == "host" and store.tier_of(("N", 1)) == "device"
    # a fetch of a spill is the spilled bits
    assert torch.equal(store._fetch(("N", 3), CPU), node * 3)


def test_inflight_spills_are_bounded_and_fetch_exact():
    store = HistogramStore(budget_bytes=0)
    for d in range(4):
        store._put(("L", d), _fake_level(d), kind="level", priority=float(d))
        store._enforce_budget()
    assert len(store._inflight) <= store.max_inflight_spills
    done = [k for k, v in store._host.items() if v is not None]
    assert done  # the oldest were completed by the depth bound
    for key in list(store._host):
        assert torch.equal(store._fetch(key, CPU), _fake_level(key[1]))


# ------------------------------------------- K-level ancestor-chain derivation
def _expand_children(store, parent, left, jnp_in=False):
    counts = (jnp.asarray if jnp_in else torch.tensor)([3, 5], dtype=(
        jnp.int32 if jnp_in else torch.int32))
    plan = store.plan_node(parent, counts)
    assert plan.node_map is not None
    built = jnp.asarray(left)[None] if jnp_in else torch.from_numpy(left)[None]
    return plan, store.expand_node(parent, plan, built)


@pytest.mark.parametrize("m,n_bins,seed", [(2, 4, 0), (5, 8, 1), (6, 16, 2)])
def test_chain_derivation_matches_the_reference_bitwise(m, n_bins, seed):
    """hist(3) = hist(1) - hist(4) when node 3 was spilled and its ancestor
    retired on the device: the same subtractions in the same order as the
    reference's chain, so the same bits; and up to f32 order the directly
    tracked histogram."""
    rng = np.random.default_rng(seed)
    h0, l1, l3 = (rng.normal(size=(m, n_bins, 2)).astype(np.float32) for _ in range(3))
    direct = HistogramStore(retained_levels=3)
    direct.put_node(0, torch.from_numpy(h0))
    _expand_children(direct, 0, l1)
    _, direct_c34 = _expand_children(direct, 1, l3)

    store, jstore = HistogramStore(retained_levels=3), JStore(retained_levels=3)
    store.put_node(0, torch.from_numpy(h0))
    jstore.put_node(0, jnp.asarray(h0))
    for s, j in ((store, False), (jstore, True)):
        _expand_children(s, 0, l1, j)
        _expand_children(s, 1, l3, j)
        s.note_gain(3, 0.0)
        s.note_gain(4, 10.0)
        s.budget_bytes = int(4 * h0.nbytes)  # room for 2, 4 and ancestors 0, 1
        s._enforce_budget()
        assert [s.tier_of(("N", k)) for k in (3, 4, 1)] == ["host", "device", "device"]
    plan = store.plan_node(3, torch.tensor([3, 5], dtype=torch.int32))
    jplan = jstore.plan_node(3, jnp.asarray([3, 5], jnp.int32))
    assert plan.source == jplan.source == "derived"
    assert store.stats.chain_derived_nodes == jstore.stats.chain_derived_nodes == 1
    derived = store._device[("N", 3)].numpy()
    np.testing.assert_array_equal(derived, np.asarray(jstore._device[("N", 3)]))
    np.testing.assert_allclose(derived, direct_c34[0].numpy(), rtol=1e-5, atol=1e-5)
    built = rng.normal(size=(1, m, n_bins, 2)).astype(np.float32)
    got = store.expand_node(3, plan, torch.from_numpy(built)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jstore.expand_node(3, jplan,
                                                                     jnp.asarray(built))))


@pytest.mark.parametrize("n,m,max_bin,budget,retained,pop_batch,seed", [
    (600, 3, 8, 0, 1, 1, 0), (600, 5, 16, 1024, 3, 1, 1), (600, 2, 8, 8192, 2, 1, 2),
    (600, 4, 8, 1024, 2, 3, 3), (600, 4, 16, 0, 3, 2, 4),
])
def test_budgeted_store_matches_unlimited_and_reference(n, m, max_bin, budget, retained,
                                                        pop_batch, seed):
    """Tight budgets and K-level chains: the tree the unlimited store grows
    (bit for bit at K = 1), and the reference's spills, fetches, chain
    derivations and rebuilds."""
    inp = Inputs(n, m, max_bin, 0.0, seed)
    tp = TreeParams(max_depth=8, grow_policy="lossguide", max_leaves=24, pop_batch=pop_batch)
    want = inp.grow(tp, HistogramStore())
    store, jstore = _budgeted(budget, retained)
    got = inp.grow(tp, store)
    if retained == 1:
        _identical(got.tree, want.tree)
    assert_trees_equal(got.tree, want.tree, got_positions=got.positions,
                       want_positions=want.positions)
    inp.j_grow(tp, jstore)
    _same_ledger(store, jstore)
    assert store.device_bytes == jstore.device_bytes <= budget


def test_fetch_retries_injected_faults_and_stays_exact():
    """A transient fault at "hist_store.fetch" is retried under the store's
    policy and booked in `io_retries`; the tree does not change."""
    inp = Inputs(800, 4, 16, 0.0, seed=9)
    tp = TreeParams(max_depth=6)
    want = inp.grow(tp, HistogramStore())
    store = HistogramStore(budget_bytes=0)
    plan = FaultPlan.of(FaultSpec(site="hist_store.fetch", at=2, count=1, action="raise"))
    with fault_inject.injected(plan):
        got = inp.grow(tp, store)
    _identical(got.tree, want.tree)
    ts = store.transfer_stats
    assert ts.io_retries == 1 and ts.hist_fetches == 5
    assert ts.stream_fetch_seconds == ts.stream_stage_seconds == 0.0  # a private ledger


def test_rebuild_when_nothing_resolves():
    store, jstore = HistogramStore(), JStore()
    plan = store.plan_node(99, torch.tensor([3, 5], dtype=torch.int32))
    jplan = jstore.plan_node(99, jnp.asarray([3, 5], jnp.int32))
    assert plan.node_map is None and plan.n_build == jplan.n_build == 2
    assert plan.source == jplan.source == "build"
    assert plan.build_nodes.tolist() == [199, 200]
    assert store.stats.rebuilt_nodes == jstore.stats.rebuilt_nodes == 1


def test_store_validates_arguments():
    with pytest.raises(ValueError, match="budget_bytes"):
        HistogramStore(budget_bytes=-1)
    with pytest.raises(ValueError, match="retained_levels"):
        HistogramStore(retained_levels=0)
    with pytest.raises(ValueError, match="grad transport") as err:
        HistogramStore(grad_transport="fp4")
    with pytest.raises(ValueError) as jerr:
        JStore(grad_transport="fp4")
    assert str(err.value) == str(jerr.value)
    assert HistogramStore(grad_transport="f16").quantizer.mode == JStore(
        grad_transport="f16").quantizer.mode == "f16"
    with pytest.raises(ValueError, match="hist_budget_bytes"):
        ExecutionPolicy(hist_budget_bytes=-1)
    with pytest.raises(ValueError, match="hist_retained_levels"):
        ExecutionPolicy(hist_retained_levels=0)


@pytest.mark.parametrize("offset,nodes", [(3, [3, 4, 9, 10]), (0, [0]), (7, [8, 7, 20])])
def test_row_counts_match_reference(offset, nodes):
    rng = np.random.default_rng(offset)
    pos = rng.integers(-1, 25, 700).astype(np.int32)
    np.testing.assert_array_equal(
        level_row_counts(torch.from_numpy(pos), offset, 4).numpy(),
        np.asarray(j_level_row_counts(jnp.asarray(pos), offset, 4)),
    )
    np.testing.assert_array_equal(
        node_row_counts(torch.from_numpy(pos), torch.tensor(nodes)).numpy(),
        np.asarray(j_node_row_counts(jnp.asarray(pos), jnp.asarray(nodes, jnp.int32))),
    )


# ----------------------------------------------- byte model + policy decisions
@pytest.mark.parametrize("kw", [
    dict(max_depth=8), dict(max_depth=8, max_leaves=16), dict(max_depth=12),
    dict(max_depth=10, max_leaves=64, hist_budget_bytes=0), dict(max_depth=10, hist_budget_bytes=0),
    dict(max_depth=12, max_leaves=256, hist_budget_bytes=16 << 20, hist_retained_levels=2),
])
def test_byte_model_matches_reference(kw):
    model = DeviceMemoryModel(num_features=10, max_bin=16, **kw)
    jmodel = JModel(num_features=10, max_bin=16, **kw)
    for k in (0, 1, 3):
        assert model.histogram_bytes(retained_levels=k) == jmodel.histogram_bytes(
            retained_levels=k)
    assert model.hist_bytes == jmodel.hist_bytes
    assert model.fixed_bytes == jmodel.fixed_bytes


class _FakeDM:
    n_rows, num_features, n_bins, page_bytes = 1200, 28, 32, 8192

    def estimated_device_bytes(self):
        return self.n_rows * self.num_features


@pytest.mark.parametrize("budget,hist_budget,params", [
    (1_890_000, None, dict(max_depth=8)),
    (500_000, None, dict(max_depth=8, grow_policy="lossguide", max_leaves=16)),
    (1_000_000, None, dict(max_depth=8, grow_policy="lossguide", max_leaves=128)),
    (1_000_000, 0, dict(max_depth=8, grow_policy="lossguide", max_leaves=128)),
])
def test_policy_decides_as_the_reference(budget, hist_budget, params):
    from repro.core.booster import BoosterParams as JParams

    pol = ExecutionPolicy(mode="auto", memory_budget_bytes=budget, hist_budget_bytes=hist_budget)
    jpol = JPolicy(mode="auto", memory_budget_bytes=budget, hist_budget_bytes=hist_budget)
    d = pol.decide(_FakeDM(), BoosterParams(max_bin=32, **params))
    jd = jpol.decide(_FakeDM(), JParams(max_bin=32, **params))
    assert (d.mode, d.reason) == (jd.mode, jd.reason)


def test_histograms_alone_over_budget_raise_and_name_the_remedy():
    dm, params = _FakeDM(), BoosterParams(max_depth=8, max_bin=32)
    with pytest.raises(ValueError, match="lossguide"):
        ExecutionPolicy(mode="auto", memory_budget_bytes=500_000).decide(dm, params)
    lg = BoosterParams(max_depth=8, max_bin=32, grow_policy="lossguide", max_leaves=128)
    with pytest.raises(ValueError, match="hist_budget_bytes"):
        ExecutionPolicy(mode="auto", memory_budget_bytes=400_000).decide(dm, lg)
    d = ExecutionPolicy(mode="auto", memory_budget_bytes=400_000, hist_budget_bytes=0).decide(
        dm, lg)
    assert d.mode == "in_core"


# ------------------------------------------------------------------- boosters
def _xy(seed, n=500, m=6):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, m)).astype(np.float32)
    return X, (X[:, 0] + rng.normal(scale=0.2, size=n) > 0).astype(np.float32)


def test_booster_threads_hist_knobs_and_ledger():
    X, y = _xy(7)
    kw = dict(n_estimators=3, max_depth=DEEP, max_bin=16, objective="binary:logistic", seed=0,
              grow_policy="lossguide", max_leaves=32)
    knobs = dict(mode="in_core", hist_budget_bytes=2048, hist_retained_levels=2)
    b = GradientBooster(device="cpu", policy=ExecutionPolicy(**knobs), **kw).fit(X, y)
    ref = JBooster(policy=JPolicy(**knobs), **kw).fit(X, y)
    free = GradientBooster(device="cpu", policy=ExecutionPolicy(mode="in_core"), **kw).fit(X, y)
    assert b.hist_cache.budget_bytes == 2048 and b.hist_cache.retained_levels == 2
    assert b.stats.hist_spill_bytes > 0 and b.stats.hist_fetch_bytes > 0
    for f in LEDGER:
        assert getattr(b.stats, f) >= 0
        assert getattr(b.stats, f) == getattr(ref.stats, f) or f == "host_to_device_bytes", f
    np.testing.assert_allclose(b.predict_margin(X), free.predict_margin(X), rtol=1e-4, atol=1e-5)


def test_resumed_fit_keeps_ledger_wired():
    import dataclasses

    X, y = _xy(10, 400, 5)
    params = BoosterParams(n_estimators=2, max_depth=DEEP, max_bin=16,
                           objective="binary:logistic", seed=0, grow_policy="lossguide",
                           max_leaves=24)
    b = GradientBooster(params, device="cpu",
                        policy=ExecutionPolicy(mode="in_core", hist_budget_bytes=1024))
    b.fit(X, y)
    first = b.stats.hist_spills
    assert first > 0
    b.params = dataclasses.replace(b.params, n_estimators=4)
    b.fit(X, y, start_iteration=2)
    assert b.stats.hist_spills > first
