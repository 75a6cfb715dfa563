"""The fixed-point plain histograms against the reference on the CPU.

`repro_torch.kernels.ref.build_histogram_nodes_fixed` and
`build_histogram_fixed` compute what the CUDA histogram kernels compute, in
their arithmetic: g and h scaled to int64 on a power-of-two grid, summed
exactly, each sum converted to f32 once. On the card the kernels must equal
them bit for bit (`tests/test_torch_cuda.py`, `chip_smoke.py`). Here they
are held against the reference's jnp histograms and the port's f32 plain
versions on the same numpy inputs, at rtol = atol = 1e-5 (those sum f32 in
row order, so their last bits differ), and against themselves with the rows
permuted, bit for bit (integer sums have no order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ref

TOL = dict(rtol=1e-5, atol=1e-5)
MISSING = 255


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(seed, n, m, n_bins, n_nodes, dtype):
    """Bins with missing cells and one all-missing column, gradients of
    both signs, positions with pad rows (-1)."""
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, n_bins, (n, m))
    bins[rng.random((n, m)) < 0.05] = MISSING
    bins[:, m // 2] = MISSING
    g = (rng.normal(size=n) * 3).astype(np.float32)
    h = rng.random(n).astype(np.float32)
    pos = rng.integers(0, n_nodes, n).astype(np.int32)
    pos[rng.random(n) < 0.2] = -1
    return bins.astype(dtype), g, h, pos


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _jax(bins, g, h, pos, *rest):
    return (jnp.asarray(bins.astype(np.int32)), jnp.asarray(g), jnp.asarray(h),
            jnp.asarray(pos), *(jnp.asarray(r) for r in rest))


@pytest.mark.parametrize("dtype", [np.uint8, np.int32])
@pytest.mark.parametrize("n_bins", [1, 32, 255, 256])
def test_fixed_node_histogram_matches_reference(n_bins, dtype):
    n, m, n_nodes = 700, 6, 9
    bins, g, h, pos = _inputs(n_bins, n, m, n_bins, n_nodes, dtype)
    # node 8 has rows, node 12 none: an empty slot between two full ones
    nodes = np.array([2, 12, 5, 8], dtype=np.int32)
    got = ref.build_histogram_nodes_fixed(*_t(bins, g, h, pos, nodes), n_bins)
    assert got.dtype == torch.float32 and got.shape == (4, m, n_bins, 2)
    want = np.asarray(jref.build_histogram_nodes(*_jax(bins, g, h, pos, nodes), n_bins))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    f32 = ref.build_histogram_nodes(*_t(bins, g, h, pos, nodes), n_bins)
    torch.testing.assert_close(got, f32, **TOL)
    assert not got[1].any() and not got[:, m // 2].any()


@pytest.mark.parametrize("dtype", [np.uint8, np.int32])
@pytest.mark.parametrize("mapped", [True, False])
def test_fixed_window_histogram_matches_reference(mapped, dtype):
    n, m, n_bins, window = 900, 5, 32, 8
    bins, g, h, pos = _inputs(7, n, m, n_bins, window + 3, dtype)  # some rows past the window
    node_map = np.array([0, -1, -1, 1, 2, -1, -1, 3], dtype=np.int32) if mapped else None
    n_nodes = 4 if mapped else window
    args = _t(bins, g, h, pos)
    tmap = None if node_map is None else torch.from_numpy(node_map)
    got = ref.build_histogram_fixed(*args, n_nodes, n_bins, tmap)
    jmap = None if node_map is None else jnp.asarray(node_map)
    want = np.asarray(jref.build_histogram(*_jax(bins, g, h, pos), n_nodes, n_bins,
                                           node_map=jmap))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    torch.testing.assert_close(got, ref.build_histogram(*args, n_nodes, n_bins, tmap), **TOL)


def test_fixed_window_equals_fixed_nodes_on_equivalent_build_nodes():
    """Kernel 4's and kernel 1's plain versions give the same bits when the
    same rows match: the scale depends only on the matched rows."""
    bins, g, h, level = _inputs(3, 1000, 7, 64, 8, np.uint8)
    node_map = np.array([-1, 0, 1, -1, -1, 2, 3, -1], dtype=np.int32)
    offset = 7
    glob = np.where(level >= 0, level + offset, -1).astype(np.int32)
    nodes = np.array([offset + 1, offset + 2, offset + 5, offset + 6], dtype=np.int32)
    a = ref.build_histogram_fixed(*_t(bins, g, h, level), 4, 64, torch.from_numpy(node_map))
    b = ref.build_histogram_nodes_fixed(*_t(bins, g, h, glob, nodes), 64)
    assert torch.equal(a, b)


def test_fixed_one_slot_holding_every_row():
    n, m, n_bins = 5000, 4, 255
    bins, g, h, _ = _inputs(11, n, m, n_bins, 1, np.uint8)
    pos = np.full(n, 3, dtype=np.int32)
    nodes = np.array([3], dtype=np.int32)
    got = ref.build_histogram_nodes_fixed(*_t(bins, g, h, pos, nodes), n_bins)
    want = np.asarray(jref.build_histogram_nodes(*_jax(bins, g, h, pos, nodes), n_bins))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # every row lands in slot 0: per feature, the bins sum to the non-missing rows' g
    present = bins != MISSING
    sums = got[0, :, :, 0].sum(dim=1).numpy()
    np.testing.assert_allclose(sums, (g[:, None] * present).sum(axis=0), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("n_bins", [32, 256])
def test_fixed_histogram_is_invariant_to_row_order(n_bins):
    bins, g, h, pos = _inputs(5, 3000, 9, n_bins, 6, np.uint8)
    nodes = torch.tensor([1, 4, 0], dtype=torch.int32)
    perm = np.random.default_rng(1).permutation(len(g))
    a = ref.build_histogram_nodes_fixed(*_t(bins, g, h, pos), nodes, n_bins)
    b = ref.build_histogram_nodes_fixed(*_t(bins[perm], g[perm], h[perm], pos[perm]), nodes,
                                        n_bins)
    assert torch.equal(a, b)


def test_fixed_histogram_of_no_rows_is_zero():
    bins = torch.zeros((0, 3), dtype=torch.uint8)
    empty_f, empty_i = torch.zeros(0), torch.zeros(0, dtype=torch.int32)
    out = ref.build_histogram_nodes_fixed(bins, empty_f, empty_f, empty_i,
                                          torch.tensor([0, 1], dtype=torch.int32), 8)
    assert out.shape == (2, 3, 8, 2) and not out.any()
    bins, g, h, pos = _t(*_inputs(2, 50, 3, 8, 4, np.uint8))
    out = ref.build_histogram_fixed(bins, g, h, torch.full_like(pos, -1), 4, 8)
    assert not out.any()
