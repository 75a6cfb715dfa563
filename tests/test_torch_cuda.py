"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without a CUDA device (the kernels have no
CPU mode). This file imports neither JAX nor the reference, so it also runs
on a GPU machine without JAX:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Partition, forest and binning must equal the plain versions bit for bit
(binning also equals the host `bin_batch`, for float32 and float64 input);
both histogram kernels are allclose(rtol=1e-5, atol=1e-5) to their plain
versions (which sum f32 in another order) and equal to themselves across
runs (fixed-point accumulation), and the level-window kernel (kernel 4)
equals the node-set kernel (kernel 1) bit for bit on equivalent inputs.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.ellpack import Binner, bin_batch
from repro_torch.core.quantile import sketch_dense
from repro_torch.kernels import ellpack_bin as k_bin
from repro_torch.kernels import forest as k_forest
from repro_torch.kernels import histogram as k_hist
from repro_torch.kernels import partition as k_part
from repro_torch.kernels import ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _bins(rng, n, m, n_bins, dtype):
    bins = rng.integers(0, n_bins, (n, m))
    bins[rng.random((n, m)) < 0.05] = 255
    return torch.from_numpy(bins.astype(dtype))


@pytest.mark.parametrize("dtype", [np.uint8, np.int32])
@pytest.mark.parametrize("n,m,n_bins,n_nodes,n_build", [
    (3000, 13, 64, 9, 4), (1, 1, 1, 1, 1), (5000, 7, 256, 300, 120), (777, 40, 255, 3, 3),
])
def test_histogram_kernel_matches_plain(dev, dtype, n, m, n_bins, n_nodes, n_build):
    rng = np.random.default_rng(n + m)
    bins = _bins(rng, n, m, n_bins, dtype)
    g = torch.from_numpy(rng.normal(size=n).astype(np.float32) * 50)
    h = torch.from_numpy(rng.random(n).astype(np.float32))
    pos = torch.from_numpy(rng.integers(-1, n_nodes, n).astype(np.int32))
    nodes = torch.from_numpy(np.sort(rng.choice(n_nodes, n_build, replace=False)).astype(np.int32))
    args = (bins, g, h, pos, nodes)
    want = ref.build_histogram_nodes(*args, n_bins)
    got = k_hist.build_histogram_nodes(*(a.to(dev) for a in args), n_bins)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    again = k_hist.build_histogram_nodes(*(a.to(dev) for a in args), n_bins)
    assert torch.equal(got, again)


def test_histogram_kernel_empty_build_set_and_rows(dev):
    bins = torch.zeros((0, 3), dtype=torch.uint8, device=dev)
    empty_f = torch.zeros(0, device=dev)
    empty_i = torch.zeros(0, dtype=torch.int32, device=dev)
    nodes = torch.tensor([0, 1], dtype=torch.int32, device=dev)
    out = k_hist.build_histogram_nodes(bins, empty_f, empty_f, empty_i, nodes, 8)
    assert out.shape == (2, 3, 8, 2) and not out.any()


def _window_inputs(rng, n, m, n_bins, window, mapped, dtype):
    """Level-local positions with -1 rows and rows past the window, and a
    node_map building the smaller child of each pair (-1 = derived)."""
    bins = _bins(rng, n, m, n_bins, dtype)
    g = torch.from_numpy(rng.normal(size=n).astype(np.float32) * 50)
    h = torch.from_numpy(rng.random(n).astype(np.float32))
    pos = torch.from_numpy(rng.integers(-1, window + 5, n).astype(np.int32))
    if not mapped:
        return bins, g, h, pos, None, window
    left = rng.random(window // 2) < 0.5
    slots = np.arange(window // 2, dtype=np.int32)
    node_map = np.stack([np.where(left, slots, -1), np.where(left, -1, slots)], 1)
    return bins, g, h, pos, torch.from_numpy(node_map.reshape(-1)), window // 2


@pytest.mark.parametrize("dtype", [np.uint8, np.int32])
@pytest.mark.parametrize("n,m,n_bins,window,mapped", [
    (3000, 13, 64, 16, True), (3000, 13, 64, 16, False), (1, 1, 1, 2, True),
    (5000, 7, 256, 600, True), (777, 40, 255, 4, False),
    (4000, 2, 4, 30000, True),  # a node_map too long to stage in shared memory
])
def test_window_histogram_kernel_matches_plain(dev, dtype, n, m, n_bins, window, mapped):
    rng = np.random.default_rng(n + m + window)
    bins, g, h, pos, node_map, n_nodes = _window_inputs(rng, n, m, n_bins, window, mapped,
                                                        dtype)
    want = ref.build_histogram(bins, g, h, pos, n_nodes, n_bins, node_map)
    cuda_map = None if node_map is None else node_map.to(dev)
    before = k_hist.launches_window
    got = k_hist.build_histogram(bins.to(dev), g.to(dev), h.to(dev), pos.to(dev), n_nodes,
                                 n_bins, cuda_map)
    assert k_hist.launches_window == before + 1
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    again = k_hist.build_histogram(bins.to(dev), g.to(dev), h.to(dev), pos.to(dev), n_nodes,
                                   n_bins, cuda_map)
    assert torch.equal(got, again)


@pytest.mark.parametrize("n,m,n_bins", [(20000, 30, 255), (999, 5, 16)])
def test_window_histogram_kernel_equals_node_kernel_bitwise(dev, n, m, n_bins):
    """Kernel 4 with a node_map gives the bits of kernel 1 given the
    equivalent global build nodes: the same rows match, so the fixed-point
    scale and every integer sum are the same."""
    rng = np.random.default_rng(n)
    offset, window = 127, 128
    bins, g, h, level, node_map, n_build = _window_inputs(
        rng, n, m, n_bins, window, True, np.uint8
    )
    glob = torch.where(level >= 0, level + offset, -1)
    build_nodes = torch.zeros(n_build, dtype=torch.int32)
    for j, s in enumerate(node_map.tolist()):
        if s >= 0:
            build_nodes[s] = offset + j
    args = [t.to(dev) for t in (bins, g, h)]
    got4 = k_hist.build_histogram(*args, level.to(dev), n_build, n_bins, node_map.to(dev))
    got1 = k_hist.build_histogram_nodes(*args, glob.to(dev), build_nodes.to(dev), n_bins)
    assert torch.equal(got4, got1)


def test_window_histogram_kernel_empty_and_bad_arguments(dev):
    bins = torch.zeros((4, 3), dtype=torch.uint8, device=dev)
    ones = torch.ones(4, device=dev)
    pos = torch.zeros(4, dtype=torch.int32, device=dev)
    out = k_hist.build_histogram(bins, ones, ones, pos, 2, 8,
                                 torch.zeros(0, dtype=torch.int32, device=dev))
    assert out.shape == (2, 3, 8, 2) and not out.any()
    with pytest.raises(TypeError, match="dtype"):
        k_hist.build_histogram(bins, ones, ones, pos, 2, 8,
                               torch.zeros(2, dtype=torch.int64, device=dev))
    with pytest.raises(ValueError, match="is on cpu"):
        k_hist.build_histogram(bins, ones, ones, pos, 2, 8, torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA tensors"):
        k_hist.build_histogram(bins.cpu(), ones.cpu(), ones.cpu(), pos.cpu(), 2, 8)


@pytest.mark.parametrize("dtype", [np.uint8, np.int32])
def test_partition_kernel_matches_plain(dev, dtype):
    rng = np.random.default_rng(1)
    n, m, n_nodes = 4099, 11, 31
    bins = _bins(rng, n, m, 32, dtype)
    pos = torch.from_numpy(rng.integers(-1, 15, n).astype(np.int32))
    tree = (
        torch.from_numpy(rng.integers(0, m, n_nodes).astype(np.int32)),
        torch.from_numpy(rng.integers(0, 32, n_nodes).astype(np.int32)),
        torch.from_numpy(rng.random(n_nodes) < 0.5),
        torch.from_numpy(rng.random(n_nodes) < 0.3),
    )
    got = k_part.partition_rows(bins.to(dev), pos.to(dev), *(t.to(dev) for t in tree))
    assert torch.equal(got.cpu(), ref.partition_rows(bins, pos, *tree))


@pytest.mark.parametrize("dtype", [np.uint8, np.int32])
def test_forest_kernel_matches_plain_bitwise(dev, dtype):
    rng = np.random.default_rng(2)
    n, m, n_trees, depth = 2500, 9, 6, 5
    n_total = 2 ** (depth + 1) - 1
    bins = _bins(rng, n, m, 32, dtype)
    leaf = rng.random((n_trees, n_total)) < 0.3
    leaf[:, 2**depth - 1:] = True
    forest = (
        torch.from_numpy(rng.integers(0, m, (n_trees, n_total)).astype(np.int32)),
        torch.from_numpy(rng.integers(0, 32, (n_trees, n_total)).astype(np.int32)),
        torch.from_numpy(rng.random((n_trees, n_total)) < 0.5),
        torch.from_numpy(leaf),
        torch.from_numpy(rng.normal(size=(n_trees, n_total)).astype(np.float32)),
    )
    margin_in = torch.from_numpy(rng.normal(size=n).astype(np.float32))
    got = k_forest.predict_forest(
        bins.to(dev), *(t.to(dev) for t in forest), depth, margin_in.to(dev)
    )
    assert torch.equal(got.cpu(), ref.predict_forest_bins(bins, *forest, depth, margin_in))


def test_wrappers_reject_bad_arguments(dev):
    bins = torch.zeros((4, 2), dtype=torch.uint8, device=dev)
    pos = torch.zeros(4, dtype=torch.int32, device=dev)
    nodes = torch.zeros(1, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError, match="dtype"):
        k_hist.build_histogram_nodes(bins, torch.zeros(4, device=dev).double(),
                                     torch.zeros(4, device=dev), pos, nodes, 8)
    with pytest.raises(ValueError, match="shape"):
        k_hist.build_histogram_nodes(bins, torch.zeros(3, device=dev),
                                     torch.zeros(4, device=dev), pos, nodes, 8)
    with pytest.raises(ValueError, match="contiguous"):
        k_part.partition_rows(
            torch.zeros((2, 4), dtype=torch.uint8, device=dev).t(), pos,
            *(torch.zeros(3, dtype=t, device=dev) for t in (torch.int32, torch.int32)),
            *(torch.zeros(3, dtype=torch.bool, device=dev) for _ in range(2)),
        )


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n,m,max_bin", [(5000, 37, 256), (1, 1, 2), (3001, 70, 16)])
def test_bin_kernel_matches_plain_and_host(dev, dtype, n, m, max_bin):
    rng = np.random.default_rng(n + m)
    X = rng.normal(size=(n, m)).astype(dtype)
    X[rng.random((n, m)) < 0.05] = np.nan
    cuts = sketch_dense(X, max_bin)
    # values on the edges, just around them (f64: between adjacent f32
    # numbers), and the specials
    edges = cuts.values.astype(np.float64)
    pick = rng.integers(0, len(edges), n * m // 4)
    nudge = rng.choice([-1e-12, 0.0, 1e-12], pick.size)
    flat = X.reshape(-1)
    flat[rng.choice(n * m, pick.size, replace=False)] = (edges[pick] * (1 + nudge)).astype(dtype)
    flat[:: max(1, flat.size // 7)] = np.array([np.inf, -np.inf, -0.0, 0.0], dtype)[
        np.arange(len(flat[:: max(1, flat.size // 7)])) % 4]
    binner = Binner(cuts, dev)
    x = torch.from_numpy(X).to(dev)
    got = k_bin.bin_values(x, binner.edges, binner.n_bins)
    want = ref.bin_values(x.cpu(), binner.edges.cpu(), binner.n_bins.cpu())
    assert got.dtype == torch.uint8
    assert torch.equal(got.cpu(), want)
    np.testing.assert_array_equal(got.cpu().numpy(), bin_batch(X, cuts))
    np.testing.assert_array_equal(binner.to_host(X), bin_batch(X, cuts))


def test_bin_kernel_rejects_bad_arguments(dev):
    x = torch.zeros((4, 2), device=dev)
    edges = torch.zeros((2, 3), device=dev)
    nb = torch.ones(2, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError, match="dtype"):
        k_bin.bin_values(x.half(), edges, nb)
    with pytest.raises(ValueError, match="shape"):
        k_bin.bin_values(x, edges[:1], nb)
    with pytest.raises(ValueError, match="CUDA"):
        k_bin.bin_values(x.cpu(), edges, nb)
