"""`repro_torch.core.split.evaluate_splits` against the reference.

Same numpy histograms into both packages. Gains sum f32 in another order
(cumsum), so they are allclose(rtol=1e-5, atol=1e-5); the chosen split
(feature, bin, default direction) must be identical, including the
first-arg-max tie-break and the last-bin rule for default-left.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.split import SplitParams as JSplitParams
from repro.core.split import evaluate_splits as j_evaluate
from repro.core.split import leaf_weight as j_leaf_weight
from repro_torch.core.split import SplitParams, evaluate_splits, leaf_weight


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _both(hist, node_g, node_h, bin_valid, **split):
    got = evaluate_splits(
        torch.from_numpy(hist), torch.from_numpy(node_g), torch.from_numpy(node_h),
        torch.from_numpy(bin_valid), SplitParams(**split),
    )
    want = j_evaluate(
        jnp.asarray(hist), jnp.asarray(node_g), jnp.asarray(node_h),
        jnp.asarray(bin_valid), JSplitParams(**split),
    )
    return got, want


def _assert_same(got, want):
    for name in ("feature", "split_bin", "default_left", "should_split"):
        np.testing.assert_array_equal(
            getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name
        )
    for name in ("gain", "left_g", "left_h", "right_g", "right_h"):
        np.testing.assert_allclose(
            getattr(got, name).numpy(), np.asarray(getattr(want, name)),
            rtol=1e-5, atol=1e-5, err_msg=name,
        )


def _random_level(seed, n_nodes=4, m=6, n_bins=16, missing=True):
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(n_nodes, m, n_bins)).astype(np.float32)
    h = rng.random((n_nodes, m, n_bins)).astype(np.float32) * 5
    nbf = rng.integers(2, n_bins + 1, m)
    bin_valid = np.arange(n_bins)[None, :] < nbf[:, None]
    g[:, ~bin_valid] = 0
    h[:, ~bin_valid] = 0
    hist = np.stack([g, h], axis=-1)
    # the same missing mass for every feature of a node, as real histograms have
    miss_g = rng.normal(size=n_nodes).astype(np.float32) if missing else 0 * g[:, 0, 0]
    miss_h = rng.random(n_nodes).astype(np.float32) * 3 if missing else 0 * g[:, 0, 0]
    node_g = (g[:, 0].sum(axis=1) + miss_g).astype(np.float32)
    node_h = (h[:, 0].sum(axis=1) + miss_h).astype(np.float32)
    return hist, node_g, node_h, bin_valid


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("split", [
    {}, {"reg_lambda": 0.5, "gamma": 0.3, "min_child_weight": 0.1},
])
def test_random_levels_match_reference(seed, split):
    _assert_same(*_both(*_random_level(seed), **split))


def test_ties_take_the_first_argmax():
    """Two identical features: the gains tie exactly, and both packages pick
    the lower feature index."""
    hist, node_g, node_h, bin_valid = _random_level(7, n_nodes=2, m=3, missing=False)
    hist[:, 2] = hist[:, 0]
    bin_valid[2] = bin_valid[0]
    hist[:, 1] = 0.0  # an empty feature: all its splits fail min_child_weight
    got, want = _both(hist, node_g, node_h, bin_valid)
    _assert_same(got, want)
    assert (got.feature.numpy() != 2).all()


def test_last_bin_is_default_right_only():
    """All the missing mass carries the signal, so the best split sends
    every non-missing row one way: at the last real bin that is only legal
    with missing rows going right (default-left would empty the right child)."""
    n_bins = 4
    hist = np.zeros((1, 1, n_bins, 2), np.float32)
    hist[0, 0, :, 0] = [-2.0, -2.0, -2.0, -2.0]
    hist[0, 0, :, 1] = [2.0, 2.0, 2.0, 2.0]
    node_g = np.asarray([-8.0 + 10.0], np.float32)  # missing rows: g = +10
    node_h = np.asarray([8.0 + 4.0], np.float32)
    bin_valid = np.ones((1, n_bins), bool)
    got, want = _both(hist, node_g, node_h, bin_valid)
    _assert_same(got, want)
    assert int(got.split_bin[0]) == n_bins - 1 and not bool(got.default_left[0])


def test_no_valid_split_is_not_taken():
    hist = np.zeros((2, 3, 8, 2), np.float32)
    node = np.zeros(2, np.float32)
    got, want = _both(hist, node, node, np.ones((3, 8), bool))
    _assert_same(got, want)
    assert not got.should_split.any()


def test_leaf_weight_matches_reference():
    g = np.asarray([1.5, -2.0, 0.0], np.float32)
    h = np.asarray([3.0, 0.5, 0.0], np.float32)
    np.testing.assert_array_equal(
        leaf_weight(torch.from_numpy(g), torch.from_numpy(h), 1.0).numpy(),
        np.asarray(j_leaf_weight(jnp.asarray(g), jnp.asarray(h), 1.0)),
    )


@pytest.mark.parametrize("chunk_nodes", [1, 3, 8])
def test_chunked_levels_equal_one_chunk(monkeypatch, chunk_nodes):
    """Node chunks bound the temporaries and change no bit: a level split
    into chunks of ``chunk_nodes`` nodes gives every field of the one-chunk
    result exactly, and still the reference's splits."""
    from repro_torch.core import split as split_mod

    hist, node_g, node_h, bin_valid = _random_level(7, n_nodes=19, m=5, n_bins=12)
    args = (torch.from_numpy(hist), torch.from_numpy(node_g), torch.from_numpy(node_h),
            torch.from_numpy(bin_valid), SplitParams())
    monkeypatch.setattr(split_mod, "CHUNK_BYTES", 1 << 40)
    whole = evaluate_splits(*args)
    monkeypatch.setattr(split_mod, "CHUNK_BYTES", chunk_nodes * 5 * 12 * 4)
    chunked = evaluate_splits(*args)
    for name in whole.__dataclass_fields__:
        assert torch.equal(getattr(chunked, name), getattr(whole, name)), name
    _assert_same(chunked, _both(hist, node_g, node_h, bin_valid)[1])
