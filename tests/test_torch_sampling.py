"""Gradient-based sampling and the sampled path (Alg. 7) of the port against
the reference, on the CPU.

`jax.random` and `torch.Generator` draw different streams, so the samplers
are held against the reference in their deterministic parts (λ, μ, the MVS
probabilities and weights, the GOSS top set and weights) and in their draws
by statistics. Whole fits are held against the reference with both
packages' ``sample`` replaced by one that hands out the same numpy
``(keep, weight)`` each round: trees under `assert_forests_equal`, margins
within rtol = atol = 1e-5 (the two packages sum f32 in another order), the
decision and the staged bytes exact. A sampled fit is compared with the
reference's sampled fit, never with in-core or streaming routing (ROADMAP
queue 3's near-ties).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from oracle import assert_forests_equal
from torch_sampled_oracle import patch_sample, tie_routed_rows

import repro.core.booster as j_booster_mod
import repro_torch.core.booster as booster_mod
from repro.core import ellpack as j_ellpack
from repro.core import sampling as j_sampling
from repro.core.booster import GradientBooster as JBooster
from repro.core.policy import ExecutionPolicy as JPolicy
from repro.core.sampling import SamplingConfig as JSamplingConfig
from repro.data.dmatrix import ArrayDMatrix as JArrayDMatrix
from repro.data.dmatrix import IterDMatrix as JIterDMatrix
from repro_torch.core import ellpack
from repro_torch.core.ellpack import Binner
from repro_torch.core import sampling
from repro_torch.core.booster import GradientBooster
from repro_torch.core.policy import ExecutionPolicy
from repro_torch.core.sampling import SamplingConfig
from repro_torch.data.dmatrix import ArrayDMatrix, IterDMatrix, PagedDMatrix
from repro_torch.data.synthetic import make_classification

M = 10
PAGE_BYTES = M * 150  # 150-row pages: 6 pages of 900 rows
PARAMS = dict(n_estimators=3, max_depth=3, max_bin=32, learning_rate=0.3,
              objective="binary:logistic")
MVS = dict(method="mvs", f=0.3)


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


def _grads(seed: int, n: int):
    rng = np.random.default_rng(seed)
    return rng.normal(size=n).astype(np.float32), rng.random(n).astype(np.float32)


def _gen(seed: int = 0) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


# ------------------------------------------------------------------ samplers
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_estimate_mvs_lambda_matches_reference(seed):
    g, h = _grads(seed, 777)
    want = float(j_sampling.estimate_mvs_lambda(jnp.asarray(g), jnp.asarray(h)))
    got = float(sampling.estimate_mvs_lambda(torch.from_numpy(g), torch.from_numpy(h)))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # the paper's example: (6/3)^2
    assert np.isclose(float(sampling.estimate_mvs_lambda(torch.tensor([1.0, 2.0, 3.0]),
                                                         torch.ones(3))), 4.0)


@pytest.mark.parametrize("n,f", [(10, 0.5), (1000, 0.1), (1000, 0.3), (1000, 0.7), (4096, 0.05),
                                 (333, 1.0)])
def test_mvs_threshold_matches_reference(n, f):
    rng = np.random.default_rng(n)
    g_hat = np.abs(rng.normal(size=n)).astype(np.float32) + 1e-3
    want = float(j_sampling.mvs_threshold(jnp.asarray(g_hat), f * n))
    got = sampling.mvs_threshold(torch.from_numpy(g_hat), f * n)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-5)


@pytest.mark.parametrize("lam", [None, 0.5])
def test_mvs_probabilities_and_weights_match_reference(lam):
    g, h = _grads(3, 2000)
    f = 0.2
    gt, ht = torch.from_numpy(g), torch.from_numpy(h)
    lam_t = sampling.estimate_mvs_lambda(gt, ht) if lam is None else torch.tensor(lam)
    lam_j = j_sampling.estimate_mvs_lambda(jnp.asarray(g), jnp.asarray(h)) if lam is None \
        else jnp.asarray(lam, jnp.float32)
    g_hat = jnp.sqrt(jnp.asarray(g) ** 2 + lam_j * jnp.asarray(h) ** 2)
    mu = j_sampling.mvs_threshold(g_hat, f * len(g))
    want_p = np.asarray(jnp.clip(g_hat / jnp.maximum(mu, 1e-30), 0.0, 1.0))
    np.testing.assert_allclose(sampling.mvs_probabilities(gt, ht, f, lam_t).numpy(), want_p,
                               rtol=1e-5, atol=1e-7)
    _, want_w = j_sampling._mvs_sample(jax.random.PRNGKey(0), jnp.asarray(g), jnp.asarray(h),
                                       f, lam_j)
    _, got_w = sampling.sample(_gen(), gt, ht, SamplingConfig(method="mvs", f=f, mvs_lambda=lam))
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), rtol=1e-5)


@pytest.mark.parametrize("a,b", [(0.2, 0.1), (0.1, 0.3), (0.3, 0.4)])
def test_goss_top_set_and_weights_match_reference(a, b):
    g, h = _grads(4, 1000)
    _, want_w = j_sampling._goss_sample(jax.random.PRNGKey(0), jnp.asarray(g), jnp.asarray(h),
                                        a, b)
    cfg = SamplingConfig(method="goss", goss_a=a, goss_b=b)
    keep, got_w = sampling.sample(_gen(), torch.from_numpy(g), torch.from_numpy(h), cfg)
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))
    # the top set is the rows at or above the k-th largest |g|
    k = max(int(a * len(g)), 1)
    threshold = np.sort(np.abs(g))[len(g) - k]
    top = np.abs(g) >= threshold
    np.testing.assert_array_equal(got_w.numpy() == 1.0, top)
    assert keep.numpy()[top].all()


@pytest.mark.parametrize("n", [0, 1, 7, 1023, 1024, 1025, 5000, 1024 * 1024 + 3])
def test_prefix_sums_are_inclusive_sums(n):
    """The row-blocked scan behind μ: inclusive sums within f32 rounding of
    the f64 sums, bitwise the sequential `torch.cumsum` inside one row."""
    x = torch.from_numpy(np.random.default_rng(n).random(n).astype(np.float32))
    got = sampling.prefix_sums(x)
    assert got.dtype == torch.float32 and got.shape == (n,)
    want = torch.cumsum(x.double(), 0)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6)
    if n <= sampling.SCAN_ROW:
        assert torch.equal(got, torch.cumsum(x, 0))
    assert torch.equal(got, sampling.prefix_sums(x))


@pytest.mark.parametrize("f", [0.1, 0.3, 0.7])
def test_mvs_threshold_solves_expected_size(f):
    rng = np.random.default_rng(0)
    g_hat = torch.from_numpy(np.abs(rng.normal(size=1000)).astype(np.float32))
    mu = sampling.mvs_threshold(g_hat, f * 1000)
    assert abs(float(torch.clamp(g_hat / mu, 0, 1).sum()) - f * 1000) < 1.0


@pytest.mark.parametrize("n,f,seed", [(10, 0.05, 1), (64, 0.5, 2), (257, 0.9, 3), (500, 1.0, 4),
                                      (123, 0.2, 5)])
def test_mvs_expected_size_property(n, f, seed):
    rng = np.random.default_rng(seed)
    g_hat = torch.from_numpy(np.abs(rng.normal(size=n)).astype(np.float32) + 1e-3)
    p = torch.clamp(g_hat / sampling.mvs_threshold(g_hat, f * n), 0, 1)
    assert float(p.sum()) <= n + 1e-3
    assert abs(float(p.sum()) - min(f * n, n)) < max(1.0, 0.02 * n)


def test_mvs_large_gradients_always_kept():
    g = torch.full((100,), 0.01)
    g[:5] = 100.0
    keep, w = sampling.sample(_gen(), g, torch.full((100,), 1e-6),
                              SamplingConfig(method="mvs", f=0.2, mvs_lambda=0.0))
    assert bool(keep[:5].all())
    np.testing.assert_allclose(w[:5].numpy(), 1.0, rtol=1e-5)


def test_mvs_gradient_sum_is_unbiased():
    g, h = (torch.from_numpy(a) for a in _grads(1, 4000))
    cfg = SamplingConfig(method="mvs", f=0.3, mvs_lambda=0.5)
    totals = []
    for s in range(30):
        keep, w = sampling.sample(_gen(s), g, h, cfg)
        totals.append(float(torch.where(keep, g * w, 0.0).sum()))
    true = float(g.sum())
    spread = np.std(totals) / np.sqrt(len(totals)) * 4 + 1e-3
    assert abs(np.mean(totals) - true) < spread + 0.05 * abs(true) + 1.0


def test_goss_keeps_its_top_fraction():
    g = torch.from_numpy(_grads(2, 1000)[0])
    keep, w = sampling.sample(_gen(), g, torch.ones(1000),
                              SamplingConfig(method="goss", goss_a=0.2, goss_b=0.1))
    top = np.argsort(-np.abs(g.numpy()))[:200]
    assert keep.numpy()[top].all()
    np.testing.assert_allclose(w.numpy()[top], 1.0)
    rest = keep.numpy() & ~np.isin(np.arange(1000), top)
    assert rest.any()
    np.testing.assert_allclose(w.numpy()[rest], (1 - 0.2) / 0.1, rtol=1e-5)
    # about b / (1 - a) of the rest is drawn
    assert abs(rest.sum() / 800 - 0.1 / 0.8) < 0.05


def test_uniform_rate_and_none_keeps_everything():
    g = torch.zeros(20000)
    keep, w = sampling.sample(_gen(), g, g, SamplingConfig(method="uniform", f=0.25))
    assert abs(float(keep.float().mean()) - 0.25) < 0.02 and float(w.max()) == 1.0
    for cfg in (SamplingConfig(method="none"), SamplingConfig(method="uniform", f=1.0)):
        keep, w = sampling.sample(_gen(), g[:10], g[:10], cfg)
        assert keep.dtype == torch.bool and bool(keep.all()) and bool((w == 1.0).all())


@pytest.mark.parametrize("method", ["uniform", "goss", "mvs"])
def test_fixed_generator_seed_draws_the_same_mask(method):
    g, h = (torch.from_numpy(a) for a in _grads(5, 3000))
    cfg = SamplingConfig(method=method, f=0.3)
    (k1, w1), (k2, w2) = (sampling.sample(_gen(7), g, h, cfg) for _ in range(2))
    assert torch.equal(k1, k2) and torch.equal(w1, w2)
    assert k1.dtype == torch.bool and bool((w1[k1] > 0).all()) and bool(w1[k1].isfinite().all())
    assert not torch.equal(sampling.sample(_gen(8), g, h, cfg)[0], k1)


# ------------------------------------------------------------ ellpack helpers
def _pages(rng, sizes, m=7):
    pages, jpages, off = [], [], 0
    for nr in sizes:
        bins = rng.integers(0, 256, (nr, m)).astype(np.uint8)
        pages.append(ellpack.EllpackPage(bins, off))
        jpages.append(j_ellpack.EllpackPage(bins, off))
        off += nr
    return pages, jpages, off


@pytest.mark.parametrize("frac", [0.0, 0.05, 0.5, 1.0])
def test_compact_equals_reference(frac):
    rng = np.random.default_rng(9)
    pages, jpages, n = _pages(rng, [40, 1, 77, 13])
    sel = rng.permutation(n)[: int(frac * n)]  # unsorted, as a caller may pass it
    page, ids = ellpack.compact(pages, sel)
    jpage, jids = j_ellpack.compact(jpages, sel)
    np.testing.assert_array_equal(page.bins, jpage.bins)
    np.testing.assert_array_equal(ids, jids)
    assert page.bins.dtype == jpage.bins.dtype and ids.dtype == jids.dtype
    assert page.row_offset == jpage.row_offset == 0


def test_row_ids_and_iter_pages_equal_reference():
    rng = np.random.default_rng(10)
    pages, jpages, _ = _pages(rng, [5, 9, 3])
    for p, jp in zip(pages, jpages):
        np.testing.assert_array_equal(p.row_ids, jp.row_ids)
    mat = ellpack.EllpackMatrix(cuts=None, pages=pages)
    jmat = j_ellpack.EllpackMatrix(cuts=None, pages=jpages)
    got, want = list(mat.iter_pages()), list(jmat.iter_pages())
    assert len(got) == len(want) == 3
    for p, jp in zip(got, want):
        np.testing.assert_array_equal(p.bins, jp.bins)
        assert p.row_offset == jp.row_offset


@pytest.mark.parametrize("n,m,page_bytes", [(0, 5, 100), (1, 1, 1), (1000, 500, 32 << 20),
                                            (1_000_000, 500, 32 << 20), (999, 7, 700)])
def test_num_pages_and_ellpack_bytes_equal_reference(n, m, page_bytes):
    assert ellpack.estimate_ellpack_bytes(n, m) == j_ellpack.estimate_ellpack_bytes(n, m)
    assert ellpack.num_pages(n, m, page_bytes) == j_ellpack.num_pages(n, m, page_bytes)


@pytest.mark.parametrize("method", ["uniform", "goss", "mvs"])
@pytest.mark.parametrize("n", [1, 900, 5000, 1_000_000])
def test_sampled_capacity_equals_reference(method, n):
    port, ref = GradientBooster(device="cpu"), JBooster()
    for f in (0.05, 0.1, 0.3, 0.5, 1.0):
        for a, b in ((0.2, 0.1), (0.6, 0.4)):
            kw = dict(method=method, f=f, goss_a=a, goss_b=b)
            assert port._sampled_capacity(n, SamplingConfig(**kw)) == \
                ref._sampled_capacity(n, JSamplingConfig(**kw))


# ------------------------------------------- whole fits, the same masks in both
def _patch_masks(monkeypatch, n_rows: int, keep_frac: float):
    """Both packages' ``sample`` hand out the same numpy (keep, weight) in
    round order; returns the masks of the port's rounds."""
    patch_sample(monkeypatch, j_booster_mod, n_rows, keep_frac, lambda x, g: jnp.asarray(x))
    return patch_sample(monkeypatch, booster_mod, n_rows, keep_frac,
                        lambda x, g: torch.from_numpy(x).to(g.device))


def _assert_fits_agree(port, ref, X, Xe, masks):
    """Trees under `assert_forests_equal`; margins within 1e-5 on every row
    but those a default-direction tie routes apart (`tie_routed_rows`,
    under 1% of them); decision and staged bytes exact."""
    assert port.decision_.mode == ref.decision_.mode
    assert port.decision_.sampling_f == ref.decision_.sampling_f
    assert_forests_equal(port.trees, ref.trees)
    capacity = len(X)
    if port.decision_.mode == "sampled":
        capacity = port._sampled_capacity(
            len(X), SamplingConfig(method="mvs", f=port.decision_.sampling_f))
    binner = Binner(port.cuts, "cpu")
    xb, eb = binner.to_host(X), binner.to_host(Xe)
    tie_x, tie_e = tie_routed_rows(port.trees, ref.trees, masks, capacity, xb, xb, eb)
    assert tie_x.mean() < 0.01 and tie_e.mean() < 0.01
    if ref.margins_ is not None:
        np.testing.assert_allclose(port.margins_.numpy()[~tie_x], ref.margins_[~tie_x],
                                   rtol=1e-5, atol=1e-5)
    for rows, tie in ((X, tie_x), (Xe, tie_e)):
        np.testing.assert_allclose(port.predict_margin(rows)[~tie],
                                   np.asarray(ref.predict_margin(rows))[~tie],
                                   rtol=1e-5, atol=1e-5)
    if not tie_e.any():
        np.testing.assert_allclose([r.value for r in port.eval_history],
                                   [r.value for r in ref.eval_history], rtol=1e-5, atol=1e-5)
    assert port.stats.host_to_device_bytes == ref.stats.host_to_device_bytes


@pytest.mark.parametrize("method", ["uniform", "goss", "mvs"])
def test_in_core_sampled_fit_matches_reference(monkeypatch, data, method):
    X, y, Xe, ye, _ = data
    masks = _patch_masks(monkeypatch, len(X), 0.4)
    cfg = dict(method=method, f=0.4)
    port = GradientBooster(device="cpu", **PARAMS, sampling=SamplingConfig(**cfg))
    port.fit(ArrayDMatrix(X, y, max_bin=32, device="cpu"), eval_set=(Xe, ye))
    ref = JBooster(**PARAMS, sampling=JSamplingConfig(**cfg))
    ref.fit(JArrayDMatrix(X, y, max_bin=32), eval_set=(Xe, ye))
    assert port.decision_.mode == "in_core"
    _assert_fits_agree(port, ref, X, Xe, masks)


@pytest.mark.parametrize("on_disk", [False, True])
def test_forced_out_of_core_with_mvs_matches_reference(monkeypatch, data, tmp_path, on_disk):
    X, y, Xe, ye, batches = data
    masks = _patch_masks(monkeypatch, len(X), 0.3)
    dm = IterDMatrix(batches, max_bin=32, page_bytes=PAGE_BYTES, device="cpu",
                     cache_dir=str(tmp_path / "port") if on_disk else None)
    jdm = JIterDMatrix(batches, max_bin=32, page_bytes=PAGE_BYTES,
                       cache_dir=str(tmp_path / "ref") if on_disk else None)
    port = GradientBooster(device="cpu", policy=ExecutionPolicy(mode="out_of_core"),
                           **PARAMS, sampling=SamplingConfig(**MVS))
    port.fit(dm, eval_set=(Xe, ye))
    ref = JBooster(policy=JPolicy(mode="out_of_core"), **PARAMS,
                   sampling=JSamplingConfig(**MVS)).fit(jdm, eval_set=(Xe, ye))
    assert port.decision_.mode == "sampled" and port.pages.n_pages == 6
    _assert_fits_agree(port, ref, X, Xe, masks)
    # capacity 900 rows (min(n, ...)): one compacted page a tree, and one
    # margin pass over the 6 pages, cached after the first tree
    assert port._device_cache is not None and port._device_cache.max_pages == 6
    assert port.stats.host_to_device_bytes == (PARAMS["n_estimators"] + 1) * 900 * M
    assert port.stats.cache_hits == 6 * (PARAMS["n_estimators"] - 1)


def test_policy_chosen_sampled_fit_matches_reference(monkeypatch, data):
    """No sampling configured; an auto budget that fits neither in core nor
    streaming: the policy picks MVS at its largest fitting fraction."""
    X, y, Xe, ye, batches = data
    masks = _patch_masks(monkeypatch, len(X), 0.5)
    dm = IterDMatrix(batches, max_bin=32, page_bytes=PAGE_BYTES, device="cpu")
    model = ExecutionPolicy().memory_model(dm, GradientBooster(device="cpu", **PARAMS).params)
    budget = (model.sampled_bytes(dm.n_rows, 0.5) + model.out_of_core_bytes(dm.n_rows)) // 2
    port = GradientBooster(device="cpu", **PARAMS,
                           policy=ExecutionPolicy(mode="auto", memory_budget_bytes=budget))
    port.fit(dm, eval_set=(Xe, ye))
    ref = JBooster(policy=JPolicy(mode="auto", memory_budget_bytes=budget), **PARAMS)
    ref.fit(JIterDMatrix(batches, max_bin=32, page_bytes=PAGE_BYTES), eval_set=(Xe, ye))
    assert port.decision_.mode == "sampled" and port.decision_.sampling_f == 0.5
    assert port.decision_.reason == ref.decision_.reason
    _assert_fits_agree(port, ref, X, Xe, masks)


def test_capacity_cut_matches_reference(monkeypatch):
    """5,000 rows at f = 0.1: capacity 1,024; the masks keep ~1,500 rows,
    so ``sel[:capacity]`` drops the last of them."""
    X, y = make_classification(5000, M, class_sep=1.2, missing_rate=0.05, seed=22)
    Xe, ye = make_classification(300, M, class_sep=1.2, missing_rate=0.05, seed=22, batch=1)
    batches = [(X[i : i + 1000], y[i : i + 1000]) for i in range(0, 5000, 1000)]
    masks = _patch_masks(monkeypatch, len(X), 0.3)
    cfg = dict(method="mvs", f=0.1)
    port = GradientBooster(device="cpu", policy=ExecutionPolicy(mode="out_of_core"),
                           **PARAMS, sampling=SamplingConfig(**cfg))
    port.fit(IterDMatrix(batches, max_bin=32, page_bytes=M * 1000, device="cpu"),
             eval_set=(Xe, ye))
    ref = JBooster(policy=JPolicy(mode="out_of_core"), **PARAMS, sampling=JSamplingConfig(**cfg))
    ref.fit(JIterDMatrix(batches, max_bin=32, page_bytes=M * 1000), eval_set=(Xe, ye))
    capacity = port._sampled_capacity(5000, SamplingConfig(**cfg))
    assert capacity == 1024 and min(int(m.sum()) for m in masks) > capacity
    _assert_fits_agree(port, ref, X, Xe, masks)
    # 5 pages: cached after the first margin pass
    assert port.stats.host_to_device_bytes == (PARAMS["n_estimators"] * capacity + 5000) * M


# ------------------------------------------------------------ within the port
@pytest.mark.parametrize("method", ["uniform", "goss", "mvs"])
def test_sampled_fit_resumes_bit_for_bit(data, tmp_path, method):
    X, y, _, _, batches = data
    cache = str(tmp_path / "pages")
    IterDMatrix(batches, max_bin=32, page_bytes=PAGE_BYTES, cache_dir=cache, device="cpu")
    kw = dict(PARAMS, n_estimators=4, seed=5, sampling=SamplingConfig(method=method, f=0.3))
    policy = ExecutionPolicy(mode="out_of_core")
    full = GradientBooster(device="cpu", policy=policy, **kw).fit(PagedDMatrix(cache))
    part = GradientBooster(device="cpu", policy=policy, **dict(kw, n_estimators=2))
    part.fit(PagedDMatrix(cache))
    part.save(str(tmp_path / "ck"))
    resumed = GradientBooster.resume(str(tmp_path / "ck"), PagedDMatrix(cache), device="cpu")
    resumed.params = full.params
    resumed.fit(PagedDMatrix(cache), start_iteration=2)
    assert resumed.decision_.mode == "sampled"
    for a, b in zip(full.trees, resumed.trees, strict=True):
        assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert torch.equal(full.margins_, resumed.margins_)
    np.testing.assert_array_equal(full.predict_margin(X), resumed.predict_margin(X))


@pytest.mark.parametrize("mode", ["in_core", "out_of_core"])
def test_two_sampled_fits_with_one_seed_are_identical(data, mode):
    X, y, *_ = data
    kw = dict(PARAMS, seed=3, sampling=SamplingConfig(**MVS))
    fits = [GradientBooster(device="cpu", policy=ExecutionPolicy(mode=mode), **kw)
            .fit(ArrayDMatrix(X, y, max_bin=32, page_bytes=PAGE_BYTES, device="cpu"))
            for _ in range(2)]
    for a, b in zip(fits[0].trees, fits[1].trees, strict=True):
        assert all(torch.equal(u, v) for u, v in zip(a, b))
    np.testing.assert_array_equal(fits[0].predict_margin(X), fits[1].predict_margin(X))
    other = GradientBooster(device="cpu", policy=ExecutionPolicy(mode=mode), **dict(kw, seed=4))
    other.fit(ArrayDMatrix(X, y, max_bin=32, page_bytes=PAGE_BYTES, device="cpu"))
    assert not np.array_equal(other.predict_margin(X), fits[0].predict_margin(X))


def test_sampling_reduces_device_traffic(data):
    X, y, *_ = data
    dm = ArrayDMatrix(X, y, max_bin=32, page_bytes=PAGE_BYTES, device="cpu")
    policy = ExecutionPolicy(mode="out_of_core")
    full = GradientBooster(device="cpu", policy=policy, **PARAMS).fit(dm)
    full_bytes = full.stats.host_to_device_bytes
    mvs = GradientBooster(device="cpu", policy=policy, **PARAMS,
                          sampling=SamplingConfig(method="mvs", f=0.2))
    mvs.fit(ArrayDMatrix(X, y, max_bin=32, page_bytes=PAGE_BYTES, device="cpu"))
    assert full.decision_.mode == "out_of_core" and mvs.decision_.mode == "sampled"
    assert mvs.stats.host_to_device_bytes < full_bytes


@pytest.mark.parametrize("page_rows,n_pages,cached", [(150, 6, True), (100, 9, False),
                                                      (75, 12, False)])
def test_auto_page_cache_only_for_few_pages(data, page_rows, n_pages, cached):
    X, y, *_ = data
    dm = ArrayDMatrix(X, y, max_bin=32, page_bytes=M * page_rows, device="cpu")
    b = GradientBooster(device="cpu", policy=ExecutionPolicy(mode="out_of_core"),
                        **dict(PARAMS, n_estimators=2), sampling=SamplingConfig(**MVS))
    b.fit(dm)
    assert b.decision_.mode == "sampled" and b.pages.n_pages == n_pages
    assert (b._device_cache is not None) == cached
    assert b.stats.cache_hits == (n_pages if cached else 0)
    # an explicit count overrides the auto rule; streaming has no auto cache
    b2 = GradientBooster(device="cpu", policy=ExecutionPolicy(mode="out_of_core",
                                                              device_cache_pages=3),
                         **dict(PARAMS, n_estimators=1), sampling=SamplingConfig(**MVS))
    assert b2.fit(dm)._device_cache.max_pages == 3
    b3 = GradientBooster(device="cpu", policy=ExecutionPolicy(mode="out_of_core"),
                         **dict(PARAMS, n_estimators=1))
    assert b3.fit(dm)._device_cache is None


def test_batch_source_trains_on_the_sampled_path(data):
    """A forced ``sampled`` policy on a batch source (host-RAM pages) picks
    MVS at the largest fitting fraction and trains."""
    X, y, Xe, ye, batches = data
    b = GradientBooster(device="cpu", policy=ExecutionPolicy(mode="sampled"), **PARAMS)
    b.fit(lambda: iter(batches), eval_set=(Xe, ye))
    assert b.decision_.mode == "sampled" and b.decision_.sampling_f == 0.5
    assert len(b.trees) == PARAMS["n_estimators"] and b.eval_history[-1].value > 0.8
    assert np.all(np.isfinite(b.margins_.numpy()))
