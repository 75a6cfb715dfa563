"""Best-first (lossguide) growth in the port against the reference, on the CPU.

The same numpy inputs go through `repro` and `repro_torch` (``device="cpu"``:
the kernels' plain versions), in every builder: in core at ``pop_batch`` 1
and 4 and ``max_leaves`` 8, 32 and full; paged, with page skipping on and
off (the same trees, and the reference's ``pages_skipped``); sampled; and
elastic. Trees are held under `assert_trees_equal` (structure and row
routing exact, splits equal up to f32 ties, leaves within 1e-4 relative);
a paged build is held against the reference's paged build, never against
in-core routing (per-page f32 sums break near-ties their own way). Within
the port, a full-budget lossguide tree equals the depthwise tree bit for
bit: the plain histograms sum each node's rows in row order, whatever the
build set. A reference lossguide forest, arrays sized by
``effective_max_depth``, predicts bit for bit in the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from oracle import assert_forests_equal, assert_positions_are_leaves, assert_trees_equal
from torch_sampled_oracle import patch_sample, tie_routed_rows

import repro.core.booster as j_booster_mod
import repro_torch.core.booster as booster_mod
from repro.core.booster import GradientBooster as JBooster
from repro.core.booster import bin_valid_from_cuts as j_bin_valid
from repro.core.ellpack import EllpackPage as JEllpackPage
from repro.core.ellpack import create_ellpack_inmemory as j_create
from repro.core.histcache import HistogramStore as JStore
from repro.core.outofcore import build_tree_paged as j_build_tree_paged
from repro.core.policy import ExecutionPolicy as JPolicy
from repro.core.sampling import SamplingConfig as JSamplingConfig
from repro.core.tree import TreeParams as JTreeParams
from repro.core.tree import grow_tree as j_grow_tree
from repro.data.dmatrix import IterDMatrix as JIterDMatrix
from repro.data.pages import TransferStats as JTransferStats
from repro.pipeline import PageStream as JPageStream
from repro_torch.core.booster import BoosterParams, GradientBooster, bin_valid_from_cuts
from repro_torch.core.ellpack import Binner, EllpackPage, create_ellpack_inmemory
from repro_torch.core.histcache import HistogramCache, HistogramStore
from repro_torch.core.outofcore import build_tree_paged
from repro_torch.core.policy import ExecutionPolicy
from repro_torch.core.sampling import SamplingConfig
from repro_torch.core.tree import TreeParams, grow_tree, predict_tree_bins
from repro_torch.data.dmatrix import IterDMatrix
from repro_torch.data.pages import TransferStats
from repro_torch.data.synthetic import make_classification
from repro_torch.pipeline import PageStream

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class Inputs:
    """One numpy problem in both packages' in-core forms."""

    def __init__(self, n, m, max_bin, missing_rate, seed, sort_by=None):
        rng = np.random.default_rng(seed)
        X = rng.normal(size=(n, m)).astype(np.float32)
        if missing_rate:
            X[rng.random((n, m)) < missing_rate] = np.nan
        if sort_by is not None:  # rows sorted by one feature: pages hold ranges
            X = X[np.argsort(np.nan_to_num(X[:, sort_by], nan=np.inf), kind="stable")]
        # continuous random gradients: exact gain ties are vanishingly rare
        self.g = rng.normal(size=n).astype(np.float32)
        self.h = (rng.random(n) + 0.1).astype(np.float32)
        self.max_bin = max_bin
        self.jell = j_create(X, max_bin=max_bin)
        self.ell = create_ellpack_inmemory(X, max_bin=max_bin, device=CPU)
        self.bins = self.ell.single_page().bins
        np.testing.assert_array_equal(self.bins, self.jell.single_page().bins)
        self.bv = bin_valid_from_cuts(self.ell.cuts, max_bin, CPU)
        self.jbv = j_bin_valid(self.jell.cuts, max_bin)

    def grow(self, tp: TreeParams, store=None):
        cuts = self.ell.cuts
        return grow_tree(
            torch.from_numpy(self.bins), torch.from_numpy(self.g), torch.from_numpy(self.h),
            self.max_bin, self.bv, tp, cuts.values, cuts.ptrs, hist_cache=store,
        )

    def j_grow(self, tp: TreeParams, store=None):
        cuts = self.jell.cuts
        return j_grow_tree(
            jnp.asarray(self.bins.astype(np.int32)), jnp.asarray(self.g), jnp.asarray(self.h),
            self.max_bin, self.jbv, _jtp(tp), cuts.values, cuts.ptrs, hist_cache=store,
        )

    def extents(self, n_pages):
        cuts = np.linspace(0, len(self.bins), n_pages + 1).astype(int)
        return [(int(cuts[i]), int(cuts[i + 1] - cuts[i])) for i in range(n_pages)]

    def paged(self, tp: TreeParams, n_pages=3, store=None, page_skipping=True):
        """The port's paged build over ``n_pages`` host pages; returns (tree,
        positions, stats)."""
        extents = self.extents(n_pages)
        pages = [EllpackPage(self.bins[lo : lo + nr], lo) for lo, nr in extents]
        stats = store.transfer_stats if store is not None else TransferStats()

        def make_stream(indices=None):
            return PageStream.from_host_pages(
                pages, indices=indices, to_array=lambda p: np.ascontiguousarray(p.bins),
                device="cpu", stats=stats,
            )

        cuts = self.ell.cuts
        tree, pos = build_tree_paged(
            make_stream, extents, torch.from_numpy(self.g), torch.from_numpy(self.h),
            self.max_bin, self.bv, tp, cuts.values, cuts.ptrs, hist_cache=store,
            page_skipping=page_skipping,
        )
        return tree, torch.cat([pos[i] for i in range(n_pages)]), stats

    def j_paged(self, tp: TreeParams, n_pages=3, store=None, page_skipping=True):
        extents = self.extents(n_pages)
        pages = [JEllpackPage(self.bins[lo : lo + nr], lo) for lo, nr in extents]
        stats = store.transfer_stats if store is not None else JTransferStats()

        def make_stream(indices=None):
            return JPageStream.from_host_pages(
                pages, indices=indices, to_array=lambda p: np.ascontiguousarray(p.bins),
                put=lambda a: jax.device_put(a).astype(jnp.int32), stats=stats,
            )

        cuts = self.jell.cuts
        tree, pos = j_build_tree_paged(
            make_stream, extents, jnp.asarray(self.g), jnp.asarray(self.h), self.max_bin,
            self.jbv, _jtp(tp), cuts.values, cuts.ptrs, hist_cache=store,
            page_skipping=page_skipping,
        )
        return tree, jnp.concatenate([pos[i] for i in range(n_pages)]), stats


def _jtp(tp: TreeParams) -> JTreeParams:
    return JTreeParams(
        max_depth=tp.max_depth, hist_subtraction=tp.hist_subtraction,
        grow_policy=tp.grow_policy, max_leaves=tp.max_leaves, pop_batch=tp.pop_batch,
    )


def _lossguide(max_depth, max_leaves, pop_batch=1, **kw):
    return TreeParams(max_depth=max_depth, grow_policy="lossguide", max_leaves=max_leaves,
                      pop_batch=pop_batch, **kw)


def _identical(got, want):
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f"TreeArrays.{f} differs"


# --------------------------------------------------------------------- in core
@pytest.mark.parametrize("pop_batch", [1, 4])
@pytest.mark.parametrize("max_leaves", [8, 32, 0])
def test_in_core_lossguide_matches_reference(max_leaves, pop_batch):
    # 2,000 rows keep depth-5 nodes large: on nodes of a few rows two
    # features can cut the rows into the same two sets, mirrored, and the
    # packages' f32 gains then tie-break apart (depthwise too)
    inp = Inputs(2000, 6, 16, 0.05, seed=7)
    tp = _lossguide(5, max_leaves, pop_batch)
    store, jstore = HistogramStore(), JStore()
    got, want = inp.grow(tp, store), inp.j_grow(tp, jstore)
    assert got.tree.n_total == tp.n_total_nodes == _jtp(tp).n_total_nodes
    assert_trees_equal(got.tree, want.tree, got_positions=got.positions,
                       want_positions=want.positions)
    assert_positions_are_leaves(got.tree, got.positions)
    for f in ("levels", "built_nodes", "derived_nodes", "rebuilt_nodes"):
        assert getattr(store.stats, f) == getattr(jstore.stats, f), f
    assert store.stats.built_rows == jstore.stats.built_rows
    assert store.stats.total_rows == jstore.stats.total_rows


@pytest.mark.parametrize("pop_batch", [1, 3])
@pytest.mark.parametrize("n,m,max_bin,max_depth,missing_rate,seed", [
    (400, 5, 8, 3, 0.0, 0), (300, 3, 16, 4, 0.1, 1), (150, 8, 16, 2, 0.0, 2),
])
def test_full_budget_equals_depthwise_bitwise(n, m, max_bin, max_depth, missing_rate, seed,
                                              pop_batch):
    inp = Inputs(n, m, max_bin, missing_rate, seed)
    dw = inp.grow(TreeParams(max_depth=max_depth))
    lg = inp.grow(_lossguide(max_depth, 2**max_depth, pop_batch))
    _identical(lg.tree, dw.tree)
    assert torch.equal(lg.positions, dw.positions)


def test_respects_max_leaves_and_picks_best_gain_first():
    inp = Inputs(500, 6, 16, 0.05, seed=7)
    full = inp.grow(_lossguide(4, 16))
    n_leaves_full = len(np.unique(full.positions.numpy()))
    for budget in (2, 3, 5):
        res = inp.grow(_lossguide(4, budget))
        assert len(np.unique(res.positions.numpy())) == min(budget, n_leaves_full)
        assert_positions_are_leaves(res.tree, res.positions)
        want = inp.j_grow(_lossguide(4, budget))
        assert_trees_equal(res.tree, want.tree, got_positions=res.positions,
                           want_positions=want.positions)
    # max_leaves=2 is a stump whose one split is the depthwise root split
    stump = inp.grow(_lossguide(4, 2))
    dw = inp.grow(TreeParams(max_depth=4))
    assert int(stump.tree.feature[0]) == int(dw.tree.feature[0])
    assert int(stump.tree.split_bin[0]) == int(dw.tree.split_bin[0])
    assert stump.tree.is_leaf.tolist()[:3] == [False, True, True]


@pytest.mark.parametrize("max_depth,grow_policy,max_leaves", [
    (30, "lossguide", 8), (6, "depthwise", 0), (5, "lossguide", 0), (12, "lossguide", 256),
    (12, "lossguide", 8), (4, "depthwise", 9), (3, "lossguide", 1),
])
def test_tree_params_capacity_matches_reference(max_depth, grow_policy, max_leaves):
    tp = TreeParams(max_depth=max_depth, grow_policy=grow_policy, max_leaves=max_leaves)
    jtp = _jtp(tp)
    for f in ("effective_max_depth", "n_total_nodes", "leaf_budget"):
        assert getattr(tp, f) == getattr(jtp, f), f


def test_leaf_bounded_tree_builds_and_predicts_with_small_arrays():
    tp = _lossguide(30, 8)
    assert (tp.effective_max_depth, tp.n_total_nodes, tp.leaf_budget) == (7, 255, 8)
    inp = Inputs(300, 4, 8, 0.0, seed=3)
    res = inp.grow(tp)
    assert res.tree.n_total == 255
    assert_positions_are_leaves(res.tree, res.positions)
    pred = predict_tree_bins(res.tree, torch.from_numpy(inp.bins), tp.max_depth)
    assert torch.equal(pred, res.tree.leaf_value[res.positions.long()])


def test_grow_policy_validation():
    with pytest.raises(ValueError, match="grow_policy"):
        TreeParams(grow_policy="bestfirst")
    with pytest.raises(ValueError, match="max_leaves"):
        TreeParams(max_leaves=-1)
    with pytest.raises(ValueError, match="pop_batch"):
        TreeParams(pop_batch=0)


def test_subtraction_ledger_and_off_switch():
    """Per-node subtraction builds one child a pop and at most half the
    rows; turning it off changes no tree."""
    inp = Inputs(400, 5, 16, 0.0, seed=11)
    cache = HistogramCache(enabled=True)
    sub = inp.grow(_lossguide(4, 16), cache)
    full = inp.grow(_lossguide(4, 16, hist_subtraction=False))
    assert_trees_equal(sub.tree, full.tree, got_positions=sub.positions,
                       want_positions=full.positions)
    assert cache.stats.built_nodes > 0
    assert cache.stats.built_nodes == cache.stats.derived_nodes
    assert cache.stats.built_rows <= cache.stats.total_rows / 2 + 1e-6


# ----------------------------------------------------------------------- paged
@pytest.mark.parametrize("pop_batch", [1, 4])
@pytest.mark.parametrize("sort_by", [None, 0])
def test_paged_lossguide_matches_reference_with_and_without_skipping(sort_by, pop_batch):
    inp = Inputs(2000, 5, 16, 0.05, seed=5, sort_by=sort_by)
    tp = _lossguide(5, 12, pop_batch)
    on, on_pos, on_stats = inp.paged(tp, n_pages=4)
    off, off_pos, off_stats = inp.paged(tp, n_pages=4, page_skipping=False)
    _identical(on, off)
    assert torch.equal(on_pos, off_pos)
    want, want_pos, want_stats = inp.j_paged(tp, n_pages=4)
    assert_trees_equal(on, want, got_positions=on_pos, want_positions=want_pos)
    assert on_stats.pages_skipped == want_stats.pages_skipped
    assert on_stats.host_to_device_bytes == want_stats.host_to_device_bytes
    assert off_stats.pages_skipped == 0
    if sort_by is not None and pop_batch == 1:
        # pages hold ranges of the sorted feature, so a single popped node's
        # rows can miss whole pages (a batch of 4 pops reaches every page)
        assert on_stats.pages_skipped > 0
        assert on_stats.host_to_device_bytes < off_stats.host_to_device_bytes


def test_paged_depthwise_skips_nothing():
    inp = Inputs(400, 4, 8, 0.0, seed=8, sort_by=1)
    tree, pos, stats = inp.paged(TreeParams(max_depth=4), n_pages=4)
    want, want_pos, _ = inp.j_paged(TreeParams(max_depth=4), n_pages=4)
    assert stats.pages_skipped == 0
    assert_trees_equal(tree, want, got_positions=pos, want_positions=want_pos)


def test_zero_argument_stream_streams_every_page():
    inp = Inputs(300, 4, 8, 0.0, seed=9, sort_by=0)
    extents = inp.extents(3)
    pages = [EllpackPage(inp.bins[lo : lo + nr], lo) for lo, nr in extents]
    stats = TransferStats()
    cuts = inp.ell.cuts
    tree, _ = build_tree_paged(
        lambda: PageStream.from_host_pages(pages, to_array=lambda p: p.bins, device="cpu",
                                           stats=stats),
        extents, torch.from_numpy(inp.g), torch.from_numpy(inp.h), 8, inp.bv,
        _lossguide(4, 8), cuts.values, cuts.ptrs,
    )
    skipped, _, _ = inp.paged(_lossguide(4, 8), n_pages=3, page_skipping=False)
    _identical(tree, skipped)
    assert stats.pages_skipped == 0


# ------------------------------------------------------- boosters, all engines
@pytest.fixture(scope="module")
def data():
    X, y = make_classification(900, 10, class_sep=1.2, missing_rate=0.05, seed=21)
    Xe, ye = make_classification(300, 10, class_sep=1.2, missing_rate=0.05, seed=21, batch=1)
    return X, y, Xe, ye


LG = dict(n_estimators=3, max_depth=5, max_bin=32, learning_rate=0.3,
          objective="reg:squarederror", grow_policy="lossguide", max_leaves=10)


@pytest.mark.parametrize("mode", ["in_core", "out_of_core"])
def test_lossguide_booster_matches_reference(data, mode):
    X, y, Xe, ye = data
    batches = [(X[i : i + 300], y[i : i + 300]) for i in range(0, 900, 300)]
    port = GradientBooster(device="cpu", policy=ExecutionPolicy(mode=mode), **LG).fit(
        IterDMatrix(batches, max_bin=32, page_bytes=10 * 150, device="cpu"), eval_set=(Xe, ye)
    )
    ref = JBooster(policy=JPolicy(mode=mode), **LG).fit(
        JIterDMatrix(batches, max_bin=32, page_bytes=10 * 150), eval_set=(Xe, ye)
    )
    assert port.decision_.mode == ref.decision_.mode == mode
    assert_forests_equal(port.trees, ref.trees)
    np.testing.assert_allclose(port.predict_margin(Xe), np.asarray(ref.predict_margin(Xe)),
                               rtol=1e-5, atol=1e-5)
    assert port.stats.pages_skipped == ref.stats.pages_skipped
    assert port.stats.host_to_device_bytes == ref.stats.host_to_device_bytes


def test_sampled_lossguide_matches_reference(monkeypatch, data):
    X, y, Xe, ye = data
    patch_sample(monkeypatch, j_booster_mod, len(X), 0.4, lambda x, g: jnp.asarray(x))
    masks = patch_sample(monkeypatch, booster_mod, len(X), 0.4,
                         lambda x, g: torch.from_numpy(x).to(g.device))
    batches = [(X[i : i + 300], y[i : i + 300]) for i in range(0, 900, 300)]
    mvs = dict(method="mvs", f=0.4)
    kw = dict(LG, objective="binary:logistic", pop_batch=2)
    port = GradientBooster(device="cpu", policy=ExecutionPolicy(mode="out_of_core"), **kw,
                           sampling=SamplingConfig(**mvs))
    port.fit(IterDMatrix(batches, max_bin=32, page_bytes=10 * 150, device="cpu"))
    ref = JBooster(policy=JPolicy(mode="out_of_core"), **kw, sampling=JSamplingConfig(**mvs))
    ref.fit(JIterDMatrix(batches, max_bin=32, page_bytes=10 * 150))
    assert port.decision_.mode == ref.decision_.mode == "sampled"
    assert_forests_equal(port.trees, ref.trees)
    # off the rows a default-direction tie routes apart (a node whose kept
    # rows miss none of its feature: both directions share one gain)
    capacity = port._sampled_capacity(len(X), SamplingConfig(**mvs))
    xb = Binner(port.cuts, "cpu").to_host(X)
    (tie,) = tie_routed_rows(port.trees, ref.trees, masks, capacity, xb, xb)
    assert tie.mean() < 0.01
    np.testing.assert_allclose(port.margins_.numpy()[~tie], ref.margins_[~tie],
                               rtol=1e-5, atol=1e-5)


def test_reference_lossguide_checkpoint_predicts_bitwise_in_the_port(data, tmp_path):
    """A reference lossguide forest whose arrays are sized by
    ``effective_max_depth`` (255 nodes at max_depth 12, max_leaves 8) loads
    by checkpoint and by `from_numpy_state` and predicts bit for bit; the
    port's own lossguide checkpoint predicts bit for bit in the reference."""
    X, y, Xe, _ = data
    kw = dict(LG, max_depth=12, max_leaves=8, objective="binary:logistic")
    ref = JBooster(**kw).fit(X, y)
    assert ref.trees[0].n_total == 255
    ref.save(str(tmp_path / "ref"))
    loaded = GradientBooster.load(str(tmp_path / "ref"), device="cpu")
    state = GradientBooster.from_numpy_state(
        BoosterParams(**kw), ref.trees, ref.cuts.values, ref.cuts.ptrs, ref.base_margin_,
        device="cpu",
    )
    want = np.asarray(ref.predict_margin(Xe))
    for b in (loaded, state):
        assert b.params.max_leaves == 8 and b.trees[0].n_total == 255
        np.testing.assert_array_equal(b.predict_margin(Xe), want)
    port = GradientBooster(device="cpu", **kw).fit(X, y)
    assert port.trees[0].n_total == 255
    port.save(str(tmp_path / "port"))
    back = JBooster.load(str(tmp_path / "port"))
    np.testing.assert_array_equal(np.asarray(back.predict_margin(Xe)), port.predict_margin(Xe))


def test_elastic_lossguide_matches_reference_in_core(tmp_path):
    """The elastic trainer grows lossguide trees through the same driver:
    one 2-node window a pop (kernel 4 with the plan's ``node_map`` on the
    card), summed over two shards, held against the reference's in-core
    lossguide fit of the concatenated rows."""
    from repro_torch.distributed import ElasticConfig, ElasticTrainer, prepare_shards

    X, y = make_classification(600, 8, class_sep=1.5, flip_y=0.02, seed=11)
    kw = dict(n_estimators=2, max_depth=4, max_bin=32, objective="binary:logistic",
              grow_policy="lossguide", max_leaves=6, pop_batch=1)
    shards = prepare_shards(X, y, 2, str(tmp_path / "shards"), max_bin=32, page_bytes=4096,
                            device="cpu")
    cfg = ElasticConfig(n_workers=2, rpc_timeout_s=180.0, heartbeat_timeout_s=120.0,
                        env={"OMP_NUM_THREADS": "1"})
    tr = ElasticTrainer(shards, BoosterParams(seed=0, **kw), checkpoint_dir=str(tmp_path / "ck"),
                        config=cfg, device="cpu")
    got = tr.fit()
    want = JBooster(seed=0, **kw).fit(X, y)
    assert got.trees[0].n_total == 2**5 - 1
    assert_forests_equal(got.trees, want.trees)
    np.testing.assert_allclose(got.predict_margin(X), np.asarray(want.predict_margin(X)),
                               rtol=1e-5, atol=1e-5)
    # every pop's parent resolved on the device: one built child a pop
    assert tr._hist_store.stats.built_nodes == tr._hist_store.stats.derived_nodes > 0
