"""Kernel 4, the level-window / ``node_map`` histogram, against the
reference on the CPU.

The same numpy inputs go through the port's plain version
(`repro_torch.kernels.ref.build_histogram`, which `ops` runs for CPU
tensors), the reference's jnp oracle (`repro.kernels.ref.build_histogram`)
and the reference's Pallas kernel in interpret mode. Histograms sum f32 in
another order in each, so they are allclose(rtol=1e-5, atol=1e-6); the
node_map remap is integer and equal. The CUDA kernel is held against the
plain version on the card in `tests/test_torch_cuda.py`.
"""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro.kernels.histogram import build_histogram as pallas_build_histogram
from repro_torch.kernels import ops, ref

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(seed, n, m, n_bins, window, dtype=np.uint8):
    """Bins with MISSING_BIN cells, gradients, and level-local positions
    with -1 rows and rows past the window."""
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, n_bins, (n, m))
    bins[rng.random((n, m)) < 0.1] = 255
    g = (rng.normal(size=n) * 3).astype(np.float32)
    h = rng.random(n).astype(np.float32)
    pos = rng.integers(-1, window + 3, n).astype(np.int32)
    return bins.astype(dtype), g, h, pos


def _node_map(seed, window):
    """Build slots for half the window (the smaller child of each pair),
    -1 for the derived half, as `HistogramStore.plan` makes them."""
    rng = np.random.default_rng(seed)
    left = rng.random(window // 2) < 0.5
    slots = np.arange(window // 2, dtype=np.int32)
    return np.stack([np.where(left, slots, -1), np.where(left, -1, slots)], 1).reshape(-1)


CASES = [
    # n, m, n_bins, window, with node_map
    (300, 5, 16, 8, True),
    (300, 5, 16, 8, False),
    (257, 3, 32, 2, True),
    (64, 9, 255, 16, True),
    (1, 1, 4, 2, False),
]


@pytest.mark.parametrize("dtype", [np.uint8, np.int32])
@pytest.mark.parametrize("n,m,n_bins,window,mapped", CASES)
def test_plain_version_matches_reference_and_pallas(n, m, n_bins, window, mapped, dtype):
    bins, g, h, pos = _inputs(n + window, n, m, n_bins, window, dtype)
    node_map = _node_map(n, window) if mapped else None
    n_nodes = window // 2 if mapped else window
    t_map = None if node_map is None else torch.from_numpy(node_map)
    t_args = (torch.from_numpy(bins), torch.from_numpy(g), torch.from_numpy(h),
              torch.from_numpy(pos))
    got = ref.build_histogram(*t_args, n_nodes, n_bins, node_map=t_map)
    assert got.shape == (n_nodes, m, n_bins, 2) and got.dtype == torch.float32
    assert torch.equal(ops.build_histogram(*t_args, n_nodes, n_bins, node_map=t_map), got)
    j_args = (jnp.asarray(bins.astype(np.int32)), jnp.asarray(g), jnp.asarray(h),
              jnp.asarray(pos))
    j_map = None if node_map is None else jnp.asarray(node_map)
    want = np.asarray(j_ref.build_histogram(*j_args, n_nodes, n_bins, node_map=j_map))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    pallas = np.asarray(pallas_build_histogram(
        *j_args, n_nodes=n_nodes, n_bins=n_bins, node_map=j_map, interpret=True
    ))
    np.testing.assert_allclose(got.numpy(), pallas, **TOL)


def test_apply_node_map_matches_reference():
    pos = np.asarray([-5, -1, 0, 1, 2, 3, 4, 7, 100], np.int32)
    node_map = np.asarray([1, -1, 0, -1], np.int32)
    got = ref.apply_node_map(torch.from_numpy(pos), torch.from_numpy(node_map))
    want = np.asarray(j_ref.apply_node_map(jnp.asarray(pos), jnp.asarray(node_map)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), [-1, -1, 1, -1, 0, -1, -1, -1, -1])
    empty = ref.apply_node_map(torch.from_numpy(pos), torch.zeros(0, dtype=torch.int32))
    assert torch.equal(empty, torch.full_like(empty, -1))


def test_slots_past_n_nodes_match_nothing():
    """A node_map slot or a position at or past n_nodes contributes to no bin,
    as in the reference (which drops them before its scatter)."""
    bins = torch.zeros((4, 2), dtype=torch.uint8)
    ones = torch.ones(4)
    pos = torch.tensor([0, 1, 2, 3], dtype=torch.int32)
    out = ref.build_histogram(bins, ones, ones, pos, 2, 4)
    assert out[:, :, 0, 0].tolist() == [[1.0, 1.0], [1.0, 1.0]]
    out = ref.build_histogram(bins, ones, ones, pos, 1, 4,
                              node_map=torch.tensor([0, 5, -1, 0], dtype=torch.int32))
    assert out[0, :, 0, 0].tolist() == [2.0, 2.0]


def _pages(bins, bounds, wrap):
    return [
        SimpleNamespace(index=i, device=wrap(bins[lo:hi]),
                        host=SimpleNamespace(row_offset=lo, n_rows=hi - lo))
        for i, (lo, hi) in enumerate(bounds)
    ]


@pytest.mark.parametrize("mapped", [True, False])
def test_paged_node_map_path_matches_reference(mapped):
    """The window mask and kernel 4 once per page, pages summed in f32 in
    stream order, against the reference's paged entry point (impl="ref")
    over the same pages and global positions."""
    rng = np.random.default_rng(5)
    n, m, n_bins, offset, window = 700, 6, 32, 7, 8  # level 3 of a tree
    bins = rng.integers(0, n_bins, (n, m)).astype(np.uint8)
    bins[rng.random((n, m)) < 0.05] = 255
    g = rng.normal(size=n).astype(np.float32)
    h = rng.random(n).astype(np.float32)
    # rows at level 3, frozen at shallower leaves, and inactive
    pos = rng.integers(-1, offset + window + 4, n).astype(np.int32)
    node_map = _node_map(3, window) if mapped else None
    count = window // 2 if mapped else window
    bounds = [(0, 256), (256, 512), (512, 700)]

    got = ops.build_histogram_paged(
        iter(_pages(torch.from_numpy(bins), bounds, lambda b: b)),
        torch.from_numpy(g), torch.from_numpy(h),
        {i: torch.from_numpy(pos[lo:hi]) for i, (lo, hi) in enumerate(bounds)},
        offset, count, n_bins,
        node_map=None if node_map is None else torch.from_numpy(node_map),
    )
    want = j_ops.build_histogram_paged(
        iter(_pages(bins.astype(np.int32), bounds, jnp.asarray)),
        jnp.asarray(g), jnp.asarray(h),
        {i: jnp.asarray(pos[lo:hi]) for i, (lo, hi) in enumerate(bounds)},
        offset, count, n_bins,
        node_map=None if node_map is None else jnp.asarray(node_map), impl="ref",
    )
    assert got.shape == (count, m, n_bins, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # and the same sum as kernel 4 over the concatenated pages
    level = torch.from_numpy(np.where((pos >= offset) & (pos < offset + window),
                                      pos - offset, -1).astype(np.int32))
    whole = ref.build_histogram(
        torch.from_numpy(bins), torch.from_numpy(g), torch.from_numpy(h), level, count,
        n_bins, node_map=None if node_map is None else torch.from_numpy(node_map),
    )
    torch.testing.assert_close(got, whole, **TOL)


def test_library_hash_covers_included_headers(tmp_path, monkeypatch):
    """Both histogram libraries are named by a hash that covers the shared
    header, so editing it rebuilds both (and no other library)."""
    import shutil

    from repro_torch.kernels import _build

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {n: _build._lib_path(n) for n in _build.SOURCES}
    header = csrc / "hist_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _build._lib_path(n) for n in _build.SOURCES}
    changed = sorted(n for n in _build.SOURCES if before[n] != after[n])
    assert changed == ["hist_window", "histogram"]
