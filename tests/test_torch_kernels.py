"""The port's kernel layer against the reference on the CPU.

The plain PyTorch versions in `repro_torch.kernels.ref` (what a CPU tensor
runs through `repro_torch.kernels.ops`) are held against the reference's
jnp versions and against its Pallas kernels in interpret mode, on the same
numpy inputs. Tolerances: partition and forest traversal are integer /
pure-add and must be equal bit for bit; histograms sum f32 in another order,
so they are allclose(rtol=1e-5, atol=1e-5). The CUDA kernels themselves run
only on the card (`tests/test_torch_cuda.py`, marked ``cuda``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.forest import predict_forest as forest_pl
from repro.kernels.histogram import build_histogram_nodes as hist_pl
from repro.kernels.partition import partition_rows as part_pl
from repro_torch.kernels import forest as k_forest
from repro_torch.kernels import histogram as k_hist
from repro_torch.kernels import ops, ref
from repro_torch.kernels import partition as k_part

MISSING = 255


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _hist_inputs(n, m, n_bins, n_nodes, seed, bin_dtype):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, n_bins, (n, m)).astype(bin_dtype)
    bins[rng.random((n, m)) < 0.05] = MISSING
    g = rng.normal(size=n).astype(np.float32)
    h = rng.random(n).astype(np.float32)
    pos = rng.integers(0, n_nodes, n).astype(np.int32)
    pos[rng.random(n) < 0.2] = -1
    return bins, g, h, pos


HIST_SWEEP = [
    # (n_rows, m, n_bins, n_build) — off-tile sizes on purpose
    (64, 4, 16, 1),
    (257, 3, 32, 2),
    (513, 13, 32, 4),
    (300, 8, 8, 3),
]


@pytest.mark.parametrize("bin_dtype", [np.uint8, np.int32])
@pytest.mark.parametrize("n,m,n_bins,n_build", HIST_SWEEP)
def test_histogram_plain_matches_reference(n, m, n_bins, n_build, bin_dtype):
    bins, g, h, pos = _hist_inputs(n, m, n_bins, 2 * n_build + 3, n + m, bin_dtype)
    rng = np.random.default_rng(n)
    nodes = np.sort(rng.choice(2 * n_build + 3, n_build, replace=False)).astype(np.int32)
    got = ops.build_histogram_nodes(_t(bins), _t(g), _t(h), _t(pos), _t(nodes), n_bins).numpy()
    jargs = (jnp.asarray(bins.astype(np.int32)), jnp.asarray(g), jnp.asarray(h),
             jnp.asarray(pos), jnp.asarray(nodes))
    want = np.asarray(jref.build_histogram_nodes(*jargs, n_bins))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    pallas = np.asarray(hist_pl(*jargs, n_bins, interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,m", [(1, 1), (255, 3), (257, 9), (300, 17)])
def test_histogram_pad_rows_contribute_to_no_bin(n, m):
    """The reference's pad-leak case: every row sits at node 1 with bins >= 1,
    so build node 0 and bin 0 must come out exactly zero."""
    n_bins = 8
    rng = np.random.default_rng(n + m)
    bins = rng.integers(1, n_bins, (n, m)).astype(np.uint8)
    g = rng.normal(size=n).astype(np.float32)
    h = (rng.random(n) + 0.1).astype(np.float32)
    pos = np.ones(n, np.int32)
    nodes = np.asarray([0, 1], np.int32)
    got = ops.build_histogram_nodes(_t(bins), _t(g), _t(h), _t(pos), _t(nodes), n_bins).numpy()
    assert got[0].sum() == 0.0
    assert np.abs(got[:, :, 0, :]).sum() == 0.0
    want = np.asarray(hist_pl(
        jnp.asarray(bins.astype(np.int32)), jnp.asarray(g), jnp.asarray(h),
        jnp.asarray(pos), jnp.asarray(nodes), n_bins, interpret=True,
    ))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_row_slots_first_match_and_inactive_rows():
    pos = torch.tensor([-1, 0, 3, 5, 3, 7], dtype=torch.int32)
    nodes = torch.tensor([3, 5, 3], dtype=torch.int32)
    assert ref.row_slots(pos, nodes).tolist() == [-1, -1, 0, 1, 0, -1]
    assert ref.row_slots(pos, nodes[:0]).tolist() == [-1] * 6


PART_SWEEP = [(33, 3, 8, 7), (257, 5, 16, 15), (512, 8, 32, 31)]


@pytest.mark.parametrize("bin_dtype", [np.uint8, np.int32])
@pytest.mark.parametrize("n,m,n_bins,n_nodes", PART_SWEEP)
def test_partition_plain_matches_reference_bitwise(n, m, n_bins, n_nodes, bin_dtype):
    rng = np.random.default_rng(n)
    bins = rng.integers(0, n_bins, (n, m)).astype(bin_dtype)
    bins[rng.random((n, m)) < 0.07] = MISSING
    pos = rng.integers(-1, (n_nodes - 1) // 2, n).astype(np.int32)
    feat = rng.integers(0, m, n_nodes).astype(np.int32)
    sb = rng.integers(0, n_bins, n_nodes).astype(np.int32)
    dl = rng.random(n_nodes) < 0.5
    lf = rng.random(n_nodes) < 0.3
    got = ops.partition_rows(*(_t(a) for a in (bins, pos, feat, sb, dl, lf))).numpy()
    jargs = tuple(jnp.asarray(a) for a in (bins.astype(np.int32), pos, feat, sb, dl, lf))
    np.testing.assert_array_equal(got, np.asarray(jref.partition_rows(*jargs)))
    np.testing.assert_array_equal(got, np.asarray(part_pl(*jargs, interpret=True)))


def _forest(rng, n_trees, depth, m, n_bins):
    n_total = 2 ** (depth + 1) - 1
    feat = rng.integers(0, m, (n_trees, n_total)).astype(np.int32)
    sb = rng.integers(0, n_bins, (n_trees, n_total)).astype(np.int32)
    dl = rng.random((n_trees, n_total)) < 0.5
    leaf = rng.random((n_trees, n_total)) < 0.3
    leaf[:, 2**depth - 1:] = True  # the last level is all leaves
    lv = rng.normal(size=(n_trees, n_total)).astype(np.float32)
    return feat, sb, dl, leaf, lv


@pytest.mark.parametrize("n,m,n_trees,depth", [
    (1, 2, 1, 1), (100, 5, 4, 3), (300, 9, 7, 4),
    # the CUDA kernel's shapes past one chunk of shared memory: a depth-12
    # tree (8,191 nodes), and 33 trees, more than a chunk at the paper width
    (5, 7, 2, 12), (40, 6, 33, 4),
])
def test_forest_plain_matches_reference_bitwise(n, m, n_trees, depth):
    rng = np.random.default_rng(n + depth)
    n_bins = 16
    bins = rng.integers(0, n_bins, (n, m)).astype(np.uint8)
    bins[rng.random((n, m)) < 0.1] = MISSING
    feat, sb, dl, leaf, lv = _forest(rng, n_trees, depth, m, n_bins)
    margin_in = rng.normal(size=n).astype(np.float32)
    lr = 0.3
    got = ops.predict_forest(
        *(_t(a) for a in (bins, feat, sb, dl, leaf, lv)), depth, lr, _t(margin_in)
    ).numpy()
    jbins = jnp.asarray(bins.astype(np.int32))
    jargs = tuple(jnp.asarray(a) for a in (feat, sb, dl, leaf))
    want = np.asarray(jops.predict_forest(
        jbins, *jargs, jnp.asarray(lv), depth, lr, jnp.asarray(margin_in), impl="ref"
    ))
    np.testing.assert_array_equal(got, want)
    scaled = jnp.float32(lr) * jnp.asarray(lv)
    pallas = np.asarray(forest_pl(jbins, *jargs, scaled, depth, jnp.asarray(margin_in),
                                  interpret=True))
    np.testing.assert_array_equal(got, pallas)


def test_predict_bins_known_tree():
    # depth-1 stump: feature 0, split at bin 2, left value -1, right +1
    tree = (
        torch.tensor([0, 0, 0], dtype=torch.int32),
        torch.tensor([2, 0, 0], dtype=torch.int32),
        torch.tensor([True, False, False]),
        torch.tensor([False, True, True]),
        torch.tensor([0.0, -1.0, 1.0]),
    )
    bins = torch.tensor([[0], [2], [3], [MISSING]], dtype=torch.uint8)
    assert ops.predict_bins(bins, *tree, 1).tolist() == [-1.0, -1.0, 1.0, -1.0]


def test_empty_forest_passes_margins_through():
    margin = torch.tensor([0.5, -1.0])
    empty_i = torch.zeros((0, 3), dtype=torch.int32)
    empty_b = torch.zeros((0, 3), dtype=torch.bool)
    out = ops.predict_forest(
        torch.zeros((2, 1), dtype=torch.uint8), empty_i, empty_i, empty_b, empty_b,
        torch.zeros((0, 3)), 1, 0.1, margin,
    )
    assert torch.equal(out, margin)


def test_kernel_wrappers_refuse_cpu_tensors():
    """A wrapper launches its CUDA kernel or raises; it never runs the plain
    version itself (that choice is `ops`', by tensor device)."""
    bins = torch.zeros((4, 2), dtype=torch.uint8)
    pos = torch.zeros(4, dtype=torch.int32)
    i3, b3 = torch.zeros(3, dtype=torch.int32), torch.zeros(3, dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        k_hist.build_histogram_nodes(bins, torch.zeros(4), torch.zeros(4), pos, i3, 8)
    with pytest.raises(ValueError, match="CUDA"):
        k_part.partition_rows(bins, pos, i3, i3, b3, b3)
    with pytest.raises(ValueError, match="CUDA"):
        k_forest.predict_forest(bins, i3[None], i3[None], b3[None], b3[None],
                                torch.zeros((1, 3)), 1, torch.zeros(4))


@pytest.mark.parametrize("n_rows,m,n_slots,n_bins", [
    (1_000_000, 500, 64, 255), (1_000_000, 500, 1, 255), (512, 8, 4, 32),
    (100, 3, 200, 256), (7, 1, 1, 1),
])
def test_histogram_tile_plan_fits_shared_memory(n_rows, m, n_slots, n_bins):
    """The launch plan of both histogram kernels, for uint8 and int32 bins:
    a block's tile and staging buffers fit the card's 227 KB, its threads
    run whole feature groups, the staged words cover a segment at any byte
    offset, the grid fits, and the big-slot accumulator is sized from the
    shapes alone."""
    for bin_bytes in (1, 4):
        p = k_hist.plan_launch(n_rows, m, n_slots, n_bins, bin_bytes)
        tile = p.feat_group * n_bins * 16
        assert p.smem_bytes == tile + p.batch_rows * (40 + 8 * p.stage_words)
        assert p.smem_bytes <= 227 * 1024 and p.batch_rows >= 1
        assert 1 <= p.feat_group <= m and p.n_groups == -(-m // p.feat_group)
        assert (p.n_groups - 1) * p.feat_group < m <= p.n_groups * p.feat_group
        assert p.threads % p.feat_group == 0 and p.feat_group <= p.threads <= 512
        assert 4 * p.stage_words >= 3 + p.feat_group * bin_bytes
        assert p.n_groups <= 65535 and p.items_bound * p.n_groups <= 2**31 - 1
        assert p.items_bound == n_slots + n_rows // p.min_chunk
        assert p.big_bound == min(n_slots, n_rows // p.min_chunk)
        assert p.target_items * p.n_groups >= k_hist.TARGET_WAVES * 132 * k_hist.SCATTER_BLOCKS_PER_SM
        # whatever C the card picks, the work items and big slots stay in their bounds
        for matched in {0, 1, n_rows // 3, n_rows}:
            c = p.chunk_rows(matched)
            assert c >= p.min_chunk and n_slots + matched // c <= p.items_bound
            assert min(n_slots, matched // c) <= p.big_bound
        assert p.acc_values == p.big_bound * m * n_bins * 2
        assert p.ws_ints == 5 + 4 * n_slots + 2 * p.items_bound + 3 * n_rows
