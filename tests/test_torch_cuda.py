"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without a CUDA device (the kernels have no
CPU mode). This file imports neither JAX nor the reference, so it also runs
on a GPU machine without JAX:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Partition (with the next level's counts added into a buffer, also past
the kernel's shared counters and node table), forest (in every part of its
shared-memory plan: trees in chunks, records or rows from global memory,
unaligned rows) and binning must equal the plain versions bit for bit
(binning also equals the host `bin_batch`, for float32 and float64 input,
at edge tables 1 to 1,024 wide);
both histogram kernels equal their fixed-point plain versions
(`ref.build_histogram_nodes_fixed`, `ref.build_histogram_fixed`) bit for bit,
are allclose(rtol=1e-5, atol=1e-5) to their f32 plain versions (which sum
f32 in another order) at small sizes, and equal themselves across runs; the
level-window kernel (kernel 4) equals the node-set kernel (kernel 1) bit for
bit on equivalent inputs, and ``add_into`` equals ``add_`` bit for bit.

The sampled path (Alg. 7): the MVS threshold has the same bits on every
call at 200k and 1M rows; kernels 1 and 2 on a compacted page with its
zero-gradient padding rows (bins 0) against their plain versions, and a
sampled fit on the card against the same fit on the CPU, both handed the
same masks: trees under `assert_forests_equal`, margins within
rtol = atol = 1e-5 off the rows a default-direction tie routes apart, the
staged bytes exact.

Serving: every `predict_margin_dmatrix` mode on the card (resident; chunks
unpinned, pinned under a byte budget in either loop order, all pinned)
equals the resident forest and the same mode on the CPU bit for bit, with
equal ledgers; a `ForestServer` keeps its pins across requests; kernel 3 at
the paged forest's chunk shape, two chunks chained through ``margin_in``,
equals its plain version and the whole forest in one launch; and
`BatchServer`, binning and walking on its worker thread, equals a direct
predict and the plain versions on the CPU.

A second card (skipped on fewer than two): each of the six kernels on
tensors of ``cuda:1`` while the thread's current device is 0, launched from
the main thread and from a fresh `threading.Thread`, equals its plain
version bit for bit and leaves the thread's current device as it was; a
`BatchServer` over a forest on ``cuda:1`` answers as a direct predict.

The sharded trainer: 2 gloo ranks (`torch_shard_ranks.run_cuda`, which
never sets a device: on a machine with several cards rank 1 runs on
``cuda:1`` from a thread whose current device is 0) fit the forest a world
of one fits (under
`assert_forests_equal`: the all-reduce adds two f32 partial histograms), and
a rank whose histogram kernel raises makes both ranks exit non-zero within
the deadline. On four cards (skipped on fewer), 4 ranks one card each, over
NCCL and over gloo, at 200,000 x 500 rows: every rank's forest equal, eval
AUC within 1e-4 of a world of one's and >= 95% of its split nodes.

Compression: the bitpack decode kernel equals its plain version and the page
bit for bit at bits 1-8, at the edges of its row tiles, from payload views
that are not 16-byte aligned, at 8 bits with a missing symbol below 255 and
at the page shapes the paths decode; two decodes are equal and every call is
one launch, whichever path inside the kernel it takes.

The LM models sharded over cards (`torch_lm_shard_ranks.run_cards`, one
card a rank over NCCL; skipped on fewer than four cards): the ten REDUCED
archs in f32 on a 2 x 2 mesh, prefill, 3 greedy decode steps and a train
step against one rank on a card at the gloo test's tolerances;
phi3-mini-3.8b and olmoe-1b-7b at full width and depth, llava-next-34b and
moonshot-v1-16b-a3b at full width and their `FULL_LAYERS` depth, on 2 x 2:
an f32 hold on tempered weights (at `HOLD_LAYERS` for the two cut ones)
against one card's `value_and_grad` (loss and grad norm 1e-5), 3 bf16
steps with finite losses, step 1 within 1e-3 of one card's loss, each
rank's peak within 10% of the dry run's, and phi3's state after step 2
restored onto another four-card mesh bit for bit. Two NCCL ranks on one
card are refused when they ask for a mesh.
"""
import json
import math
import os

import numpy as np
import pytest
import torch

from oracle import assert_forests_equal
from torch_sampled_oracle import patch_sample, tie_routed_rows

import repro_torch.core.booster as booster_mod
from repro_torch.core.booster import GradientBooster
from repro_torch.core.memory import DeviceMemoryModel
from repro_torch.core.ellpack import Binner, EllpackPage, bin_batch, compact
from repro_torch.core.policy import ExecutionPolicy
from repro_torch.core.sampling import SamplingConfig
from repro_torch.data.dmatrix import IterDMatrix
from repro_torch.data.synthetic import make_classification
from repro_torch.core.quantile import HistogramCuts, sketch_dense
from repro_torch.kernels import ellpack_bin as k_bin
from repro_torch.kernels.bitpack import tile_rows
from repro_torch.kernels import forest as k_forest
from repro_torch.kernels import histogram as k_hist
from repro_torch.kernels import partition as k_part
from repro_torch.kernels import ref

pytestmark = pytest.mark.cuda

NODE_BYTES = DeviceMemoryModel().forest_node_bytes  # one staged forest-chunk node


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
    assert torch.equal(got.cpu(), ref.build_histogram_nodes_fixed(*args, n_bins))
    again = k_hist.build_histogram_nodes(*(a.to(dev) for a in args), n_bins)
    assert torch.equal(got, again)


@pytest.mark.parametrize("nodes", [[5, 3, 5, 7], [5, 3, 5, 9000]])
def test_histogram_kernel_node_lookup_table_and_search(dev, nodes):
    """Build nodes spanning fewer ids than the kernel's slot table, and more
    (searched); a repeated node's rows go to its first slot only."""
    rng = np.random.default_rng(7)
    n, m = 4000, 11
    bins = _bins(rng, n, m, 64, np.uint8).to(dev)
    g = torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(dev)
    h = torch.from_numpy(rng.random(n).astype(np.float32)).to(dev)
    pos = torch.from_numpy(rng.choice([-1, 3, 5, 6, 7, 9000], n).astype(np.int32)).to(dev)
    build = torch.tensor(nodes, dtype=torch.int32, device=dev)
    got = k_hist.build_histogram_nodes(bins, g, h, pos, build, 64)
    assert torch.equal(got, ref.build_histogram_nodes_fixed(bins, g, h, pos, build, 64))
    assert got[0].any() and not got[2].any()


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
    assert torch.equal(got.cpu(), ref.build_histogram_fixed(bins, g, h, pos, n_nodes, n_bins,
                                                            node_map))
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


def _level7(dev, n, seed):
    """Level 7 of a depth-8 tree at the paper's width, as `chip_smoke.py`
    gives it to the kernels: uint8 bins of 255 bins with 5% missing, rows
    spread over the 128 level nodes (global ids 127..254), 10% inactive, and
    the smaller child of each of the 64 pairs built."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    bins = torch.randint(0, 255, (n, 500), generator=gen, device=dev, dtype=torch.uint8)
    bins[torch.rand((n, 500), generator=gen, device=dev) < 0.05] = 255
    g = torch.randn(n, generator=gen, device=dev)
    h = torch.rand(n, generator=gen, device=dev)
    level = torch.randint(0, 128, (n,), generator=gen, device=dev, dtype=torch.int32)
    level[torch.rand(n, generator=gen, device=dev) < 0.1] = -1
    left = torch.randint(0, 2, (64,), generator=gen, device=dev).bool()
    return bins, g, h, level, left


@pytest.mark.parametrize("n,kernel", [
    (1_000_000, "nodes"),  # phase 3: all training rows
    (67_108, "nodes"),  # phase 6: one staged 32 MiB page
    (67_108, "window"),  # phase 8: kernel 4 on one page, 5% of rows past the window
])
def test_histogram_kernels_equal_fixed_point_plain_at_path_shapes(dev, n, kernel):
    bins, g, h, level, left = _level7(dev, n, n)
    slots = torch.arange(64, device=dev, dtype=torch.int32)
    if kernel == "nodes":
        pos = torch.where(level >= 0, level + 127, -1)
        nodes = 127 + 2 * slots + (~left).to(torch.int32)
        got = k_hist.build_histogram_nodes(bins, g, h, pos, nodes, 255)
        want = ref.build_histogram_nodes_fixed(bins, g, h, pos, nodes, 255)
    else:
        level[torch.rand(n, device=dev) < 0.05] += 128
        minus = torch.full_like(slots, -1)
        node_map = torch.stack([torch.where(left, slots, minus), torch.where(left, minus, slots)],
                               dim=1).reshape(128)
        got = k_hist.build_histogram(bins, g, h, level, 64, 255, node_map)
        want = ref.build_histogram_fixed(bins, g, h, level, 64, 255, node_map)
    assert torch.equal(got, want)


def _regime(dev, case):
    """(bins, g, h, positions, build_nodes) of one work-list regime of the
    bucketed scatter; C is the most rows one block takes."""
    c = k_hist.MIN_CHUNK_ROWS
    gen = torch.Generator(device=dev).manual_seed(len(case))
    n, m, n_nodes = {
        "one_slot_all_rows": (3 * c + 17, 37, 1),  # every row in one slot: 4 chunks
        "many_small_slots": (40_000, 9, 12_288),  # 12,288 slots of a few rows
        "one_slot_1m_rows": (1_000_000, 500, 1),  # S = 1 at the in-core width
        "chunk_boundary": (2 * c + 1 + 5000, 21, 4),  # slots of exactly C and C + 1 rows
    }[case]
    bins = torch.randint(0, 255, (n, m), generator=gen, device=dev, dtype=torch.uint8)
    bins[torch.rand((n, m), generator=gen, device=dev) < 0.05] = 255
    g = torch.randn(n, generator=gen, device=dev) * 7
    h = torch.rand(n, generator=gen, device=dev)
    if case == "chunk_boundary":
        pos = torch.cat([torch.full((c,), 10), torch.full((c + 1,), 11),
                         torch.randint(12, 14, (5000,), generator=gen, device=dev).cpu()])
        pos = pos[torch.randperm(n)].to(torch.int32).to(dev)
    else:
        pos = torch.randint(0, n_nodes, (n,), generator=gen, device=dev, dtype=torch.int32)
        if case != "one_slot_all_rows":
            pos[torch.rand(n, generator=gen, device=dev) < 0.1] = -1
    nodes = torch.arange(n_nodes, dtype=torch.int32, device=dev) + (10 if n_nodes == 4 else 0)
    return bins, g, h, pos, nodes


@pytest.mark.parametrize("case", [
    "one_slot_all_rows", "many_small_slots", "one_slot_1m_rows", "chunk_boundary",
])
def test_histogram_kernels_equal_fixed_point_plain_in_every_regime(dev, case):
    """Slots of one chunk (one block owns each cell) and of several (global
    int64 atomics into the compact accumulator) give the plain version's bits;
    kernel 4 given the same rows as level-local slots gives kernel 1's."""
    bins, g, h, pos, nodes = _regime(dev, case)
    got = k_hist.build_histogram_nodes(bins, g, h, pos, nodes, 255)
    assert torch.equal(got, ref.build_histogram_nodes_fixed(bins, g, h, pos, nodes, 255))
    if case == "chunk_boundary":
        counts = torch.bincount(pos[pos >= 0].long(), minlength=14)[10:].tolist()
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        plan = k_hist.plan_launch(*bins.shape, 4, 255, 1, n_sm)
        c = plan.chunk_rows(sum(counts))
        assert counts[:2] == [c, c + 1]
    # the exact sums rounded once to f32: within f32 rounding of f64 sums (an
    # f32 running sum over tens of thousands of rows is not, so the f32 plain
    # version is no yardstick at these sizes)
    exact = torch.zeros(got.numel(), dtype=torch.float64, device=dev)
    for cell, rows in ref._hist_cells(bins, ref.row_slots(pos, nodes), 255):
        exact.index_add_(0, cell, g[rows].double())
        exact.index_add_(0, cell + 1, h[rows].double())
    torch.testing.assert_close(got.double().reshape(-1), exact, rtol=1e-6, atol=1e-6)
    local = torch.where(pos >= 0, pos - int(nodes[0]), -1)
    assert torch.equal(k_hist.build_histogram(bins, g, h, local, nodes.shape[0], 255), got)
    assert torch.equal(k_hist.build_histogram_nodes(bins, g, h, pos, nodes, 255), got)


@pytest.mark.parametrize("kernel", ["nodes", "window"])
def test_histogram_kernels_accumulate_pages_like_add(dev, kernel):
    """``add_into`` over 3 pages gives the bits of the page histograms
    summed with ``add_`` in page order, as `ops.build_histogram_paged` sums
    them on the CPU; one page is big enough for the multi-chunk path."""
    gen = torch.Generator(device=dev).manual_seed(3)
    m, n_bins = 30, 64
    sizes = (2 * k_hist.MIN_CHUNK_ROWS + 99, 5000, 777)
    nodes = torch.tensor([3, 5, 6], dtype=torch.int32, device=dev)
    node_map = torch.tensor([-1, 0, -1, 1, 2], dtype=torch.int32, device=dev)
    summed = acc = None
    for i, n in enumerate(sizes):
        bins = torch.randint(0, n_bins, (n, m), generator=gen, device=dev, dtype=torch.uint8)
        g = torch.randn(n, generator=gen, device=dev) * (10 ** i)
        h = torch.rand(n, generator=gen, device=dev)
        if kernel == "nodes":
            pos = torch.randint(2, 7, (n,), generator=gen, device=dev, dtype=torch.int32)
            args = (bins, g, h, pos, nodes, n_bins)
            page = k_hist.build_histogram_nodes(*args)
            acc = k_hist.build_histogram_nodes(*args, add_into=acc)
        else:
            pos = torch.randint(-1, 6, (n,), generator=gen, device=dev, dtype=torch.int32)
            args = (bins, g, h, pos, 3, n_bins, node_map)
            page = k_hist.build_histogram(*args)
            acc = k_hist.build_histogram(*args, add_into=acc)
        summed = page if summed is None else summed.add_(page)
    assert torch.equal(acc, summed)


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


def _forest_planes(rng, n_trees, depth, m, *, p_leaf=0.3, f_range=None, s_range=(0, 32)):
    """Complete-layout planes, the last level all leaves, early leaves with
    probability ``p_leaf`` at every other level (the root included)."""
    n_total = 2 ** (depth + 1) - 1
    leaf = rng.random((n_trees, n_total)) < p_leaf
    leaf[:, 2**depth - 1:] = True
    lo, hi = f_range or (0, m)
    return (
        torch.from_numpy(rng.integers(lo, hi, (n_trees, n_total)).astype(np.int32)),
        torch.from_numpy(rng.integers(*s_range, (n_trees, n_total)).astype(np.int32)),
        torch.from_numpy(rng.random((n_trees, n_total)) < 0.5),
        torch.from_numpy(leaf),
        torch.from_numpy(rng.normal(size=(n_trees, n_total)).astype(np.float32)),
    )


# (n, m, n_trees, depth, max_depth, planes' keywords): each case reaches a
# part of the kernel's shared-memory plan (csrc/forest.cu) in both bin types
FOREST_CASES = {
    "small": (2500, 9, 6, 5, 5, {}),
    # 8,191 nodes: one tree a chunk, two buffers
    "depth12": (700, 30, 5, 12, 12, {}),
    # 70 trees cross chunks of 12 (uint8, rows in shared memory) and of 16
    # (int32, rows in global memory) at the paper width; 1,000 rows end
    # inside a 256-row tile
    "trees_off_chunk": (1000, 500, 70, 8, 8, {"s_range": (0, 255)}),
    "rows_off_tile": (257, 40, 3, 4, 4, {}),
    # 32,767 nodes do not fit in shared memory: records from global memory
    "depth14": (300, 20, 2, 14, 14, {}),
    # rows wider than shared memory beside a tree: bins from global memory
    "wide_rows": (600, 1000, 5, 6, 6, {}),
    "max_depth0": (500, 9, 4, 3, 0, {}),
    "early_leaves": (800, 17, 9, 6, 6, {"p_leaf": 0.5}),
    # features below 0 and at or past m clamp; split bins outside [0, 254]
    "out_of_range": (900, 11, 7, 5, 5, {"f_range": (-11, 22), "s_range": (-20, 300)}),
}


@pytest.mark.parametrize("dtype", [np.uint8, np.int32])
@pytest.mark.parametrize("case", list(FOREST_CASES))
def test_forest_kernel_matches_plain_bitwise(dev, dtype, case):
    n, m, n_trees, depth, max_depth, kw = FOREST_CASES[case]
    rng = np.random.default_rng(2)
    bins = _bins(rng, n, m, 32 if "s_range" not in kw else 255, dtype)
    forest = _forest_planes(rng, n_trees, depth, m, **kw)
    margin_in = torch.from_numpy(rng.normal(size=n).astype(np.float32))
    args = (bins.to(dev), *(t.to(dev) for t in forest), max_depth, margin_in.to(dev))
    got = k_forest.predict_forest(*args)
    assert torch.equal(got.cpu(), ref.predict_forest_bins(bins, *forest, max_depth, margin_in))
    assert torch.equal(got, k_forest.predict_forest(*args))


@pytest.mark.parametrize("offset", [1, 4])
def test_forest_kernel_unaligned_rows(dev, offset):
    # a view whose rows start off a 16-byte boundary: the tile is copied a
    # word (offset 4) or a byte (offset 1) at a time
    rng = np.random.default_rng(offset)
    n, m = 700, 24
    flat = torch.zeros(n * m + offset, dtype=torch.uint8)
    flat[offset:] = _bins(rng, n, m, 32, np.uint8).reshape(-1)
    forest = _forest_planes(rng, 5, 5, m)
    margin_in = torch.from_numpy(rng.normal(size=n).astype(np.float32))
    bins = flat.to(dev)[offset:].view(n, m)
    assert bins.data_ptr() % 16 == offset
    got = k_forest.predict_forest(bins, *(t.to(dev) for t in forest), 5, margin_in.to(dev))
    want = ref.predict_forest_bins(flat[offset:].view(n, m), *forest, 5, margin_in)
    assert torch.equal(got.cpu(), want)


def test_forest_kernel_rejects_what_a_record_cannot_hold(dev):
    planes = tuple(t.to(dev) for t in _forest_planes(np.random.default_rng(0), 2, 3, 4))
    for dtype, limit in k_forest.MAX_FEATURES.items():
        ok = torch.empty((0, limit), dtype=dtype, device=dev)  # zero rows: no bytes
        assert k_forest.predict_forest(ok, *planes, 3, torch.empty(0, device=dev)).shape == (0,)
        wide = torch.empty((0, limit + 1), dtype=dtype, device=dev)
        with pytest.raises(ValueError, match="feature"):
            k_forest.predict_forest(wide, *planes, 3, torch.empty(0, device=dev))
        # a tree of more nodes than the record's child field holds (no trees,
        # so the planes hold no bytes)
        n_nodes = k_forest.MAX_NODES[dtype] + 1
        empty = tuple(torch.zeros((0, n_nodes), dtype=t.dtype, device=dev) for t in planes)
        bins = torch.zeros((4, 2), dtype=dtype, device=dev)
        with pytest.raises(ValueError, match="nodes"):
            k_forest.predict_forest(bins, *empty, 3, torch.zeros(4, device=dev))
    bins = torch.zeros((4, 2), dtype=torch.uint8, device=dev)
    with pytest.raises(TypeError, match="dtype"):
        k_forest.predict_forest(bins, *planes[:4], planes[4].double(), 3,
                                torch.zeros(4, device=dev))
    with pytest.raises(ValueError, match="CUDA tensors"):
        k_forest.predict_forest(bins.cpu(), *(t.cpu() for t in planes), 3, torch.zeros(4))


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


def _level_tree(gen, dev, n, m, depth, n_bins=255):
    """uint8 bins, a complete tree of depth ``depth + 1`` and rows at level
    ``depth`` (5% inactive, 5% frozen at a leaf of the level before), all
    made on the card from ``gen``."""
    n_nodes = 2 ** (depth + 2) - 1
    bins = torch.randint(0, 256, (n, m), generator=gen, device=dev, dtype=torch.int32)
    bins = torch.where(bins < n_bins, bins, 255).to(torch.uint8)
    tree = [
        torch.randint(0, m, (n_nodes,), generator=gen, device=dev, dtype=torch.int32),
        torch.randint(0, n_bins, (n_nodes,), generator=gen, device=dev, dtype=torch.int32),
        torch.rand(n_nodes, generator=gen, device=dev) < 0.5,
        torch.rand(n_nodes, generator=gen, device=dev) < 0.2,
    ]
    lo = 2**depth - 1
    pos = torch.randint(lo, 2 * lo + 1, (n,), generator=gen, device=dev, dtype=torch.int32)
    if depth:
        frozen = torch.rand(n, generator=gen, device=dev) < 0.05
        pos[frozen] = lo - 1
        tree[3][lo - 1] = True
    pos[torch.rand(n, generator=gen, device=dev) < 0.05] = -1
    return bins, pos, tuple(tree)


# the paths' shapes at the next level's window of a depth-8 tree: all
# training rows in core (1M x 500), a staged 32 MiB page (67,108 rows), the
# last page of an elastic shard (65,784 rows); depth 0 (all rows to 2 slots)
@pytest.mark.parametrize("n,depth", [(1_000_000, 6), (67_108, 6), (65_784, 6), (67_108, 0)])
def test_fused_partition_counts_match_plain(dev, n, depth):
    gen = torch.Generator(device=dev).manual_seed(n + depth)
    bins, pos, tree = _level_tree(gen, dev, n, 500, depth)
    window = (2 ** (depth + 1) - 1, 2 ** (depth + 1))
    got_c = torch.zeros(window[1], dtype=torch.int32, device=dev)
    want_c = torch.zeros_like(got_c)
    got = k_part.partition_rows(bins, pos, *tree, window, got_c)
    want = ref.partition_rows(bins, pos, *tree, window, want_c)
    assert torch.equal(got, want)
    assert torch.equal(got_c, want_c) and int(got_c.sum()) > 0
    assert torch.equal(got_c, ref.level_row_counts(want, *window))
    # counts are added into, and the kernel without a window gives the same rows
    again = k_part.partition_rows(bins, pos, *tree, window, got_c)
    assert torch.equal(again, got) and torch.equal(got_c, 2 * want_c)
    assert torch.equal(k_part.partition_rows(bins, pos, *tree), got)


# deep node tables and windows past what a block counts in shared memory
# (2,048 counters): depth 12 has 16,383 nodes and an 8,192-node next level;
# and int32 bins
@pytest.mark.parametrize("depth,offset,count", [
    (12, 8191, 8192), (12, 8191, 2048), (12, 0, 1), (9, 1023, 1024), (10, 2047, 2048),
    (10, 2046, 2049), (4, 31, 32), (4, 10**6, 5),
])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32])
def test_fused_partition_wide_tables_and_windows(dev, depth, offset, count, dtype):
    gen = torch.Generator(device=dev).manual_seed(depth * 7 + count)
    bins, pos, tree = _level_tree(gen, dev, 50_001, 37, depth)
    bins = bins.to(dtype)
    got_c = torch.zeros(count, dtype=torch.int32, device=dev)
    want_c = torch.zeros_like(got_c)
    got = k_part.partition_rows(bins, pos, *tree, (offset, count), got_c)
    want = ref.partition_rows(bins, pos, *tree, (offset, count), want_c)
    assert torch.equal(got, want) and torch.equal(got_c, want_c)
    assert torch.equal(got_c, ref.level_row_counts(want, offset, count))


def test_fused_partition_counts_accumulate_over_pages(dev):
    gen = torch.Generator(device=dev).manual_seed(5)
    bins, pos, tree = _level_tree(gen, dev, 200_000, 500, 6)
    window = (127, 128)
    counts = torch.zeros(128, dtype=torch.int32, device=dev)
    pages = [
        k_part.partition_rows(bins[lo:hi], pos[lo:hi], *tree, window, counts)
        for lo, hi in ((0, 67_108), (67_108, 134_216), (134_216, 200_000))
    ]
    whole = ref.partition_rows(bins, pos, *tree)
    assert torch.equal(torch.cat(pages), whole)
    assert torch.equal(counts, ref.level_row_counts(whole, *window))


def test_fused_partition_rejects_bad_windows(dev):
    bins = torch.zeros((4, 2), dtype=torch.uint8, device=dev)
    pos = torch.zeros(4, dtype=torch.int32, device=dev)
    tree = (torch.zeros(3, dtype=torch.int32, device=dev),
            torch.zeros(3, dtype=torch.int32, device=dev),
            torch.zeros(3, dtype=torch.bool, device=dev),
            torch.zeros(3, dtype=torch.bool, device=dev))
    with pytest.raises(ValueError, match="together"):
        k_part.partition_rows(bins, pos, *tree, (1, 2))
    with pytest.raises(ValueError, match="is on cpu"):
        k_part.partition_rows(bins, pos, *tree, (1, 2), torch.zeros(2, dtype=torch.int32))


def _explicit_cuts(rng, m, width):
    """`HistogramCuts` with a random count of strictly increasing f32 edges
    per feature, 1..width (feature 0 exactly width, so the padded edge table
    is ``width`` wide)."""
    nb = rng.integers(1, width + 1, m)
    nb[0] = width
    values = [
        (np.cumsum(rng.random(k) + 0.01) - 0.3 * k).astype(np.float32) for k in nb
    ]
    ptrs = np.concatenate([[0], np.cumsum(nb)]).astype(np.int32)
    return HistogramCuts(values=np.concatenate(values), ptrs=ptrs,
                         min_vals=np.asarray([v[0] for v in values], np.float32))


def _values_around_edges(rng, cuts, n, dtype):
    """(n, m) values: most spread over the edges' range, a quarter on an edge
    or one step beside it in ``dtype`` (f64: between f32 neighbours), and
    NaN, +-inf, +-0."""
    m = cuts.num_features
    X = (rng.normal(size=(n, m)) * np.maximum(cuts.n_bins_per_feature, 1) * 0.3).astype(dtype)
    flat = X.reshape(-1)
    pick = rng.choice(n * m, n * m // 4, replace=False)
    feat = pick % m
    lo, hi = cuts.ptrs[feat], cuts.ptrs[feat + 1]
    edge = cuts.values[lo + (rng.random(pick.size) * (hi - lo)).astype(np.int64)].astype(dtype)
    side = rng.integers(-1, 2, pick.size)
    flat[pick] = np.where(side < 0, np.nextafter(edge, dtype(-np.inf)),
                          np.where(side > 0, np.nextafter(edge, dtype(np.inf)), edge))
    special = rng.choice(n * m, min(n * m, 64), replace=False)
    flat[special] = np.array([np.nan, np.inf, -np.inf, -0.0, 0.0], dtype)[
        np.arange(special.size) % 5]
    return X


def _check_binning(dev, X, cuts):
    binner = Binner(cuts, dev)
    x = torch.from_numpy(X).to(dev)
    got = k_bin.bin_values(x, binner.edges, binner.n_bins)
    assert torch.equal(got, ref.bin_values(x, binner.edges, binner.n_bins))
    np.testing.assert_array_equal(got.cpu().numpy(), bin_batch(X, cuts))
    return got


# feature tiles of one lane, 31 and 33 features, the paper's width; padded
# edge tables 1 to 1,024 wide; 3,001 rows, a multiple of no tile or stage
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("max_bin", [1, 2, 255, 256, 1024])
@pytest.mark.parametrize("m", [1, 31, 33, 500])
def test_bin_kernel_widths_match_plain_and_host(dev, m, max_bin, dtype):
    rng = np.random.default_rng(m * 2000 + max_bin)
    cuts = _explicit_cuts(rng, m, max_bin)
    assert Binner(cuts, dev).edges.shape == (m, max_bin)
    _check_binning(dev, _values_around_edges(rng, cuts, 3001, dtype), cuts)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_bin_kernel_in_core_shape(dev, dtype):
    """All 1M x 500 rows of the in-core path in one launch, 255-wide edges."""
    rng = np.random.default_rng(11)
    cuts = _explicit_cuts(rng, 500, 255)
    got = _check_binning(dev, _values_around_edges(rng, cuts, 1_000_000, dtype), cuts)
    assert got.shape == (1_000_000, 500)


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


@pytest.mark.parametrize("n", [200_000, 1_000_000])
def test_mvs_threshold_same_bits_every_call(dev, n):
    """μ fixes every MVS weight, so it must not move between two fits: the
    suffix sums behind it (`prefix_sums`) give the same bits on every call
    and agree with f64 sums."""
    from repro_torch.core import sampling

    gen = torch.Generator(device=dev).manual_seed(n)
    g_hat = torch.rand(n, generator=gen, device=dev).square()
    sums = [sampling.prefix_sums(g_hat) for _ in range(30)]
    assert all(torch.equal(s, sums[0]) for s in sums)
    torch.testing.assert_close(sums[0].double(), torch.cumsum(g_hat.double(), 0),
                               rtol=1e-6, atol=0)
    mus = torch.stack([sampling.mvs_threshold(g_hat, 0.1 * n) for _ in range(30)])
    assert torch.equal(mus, mus[:1].expand_as(mus))


def test_kernels_on_a_compacted_page_with_padding_rows(dev):
    """Alg. 7's page: 1,100 sampled rows of five pages gathered by `compact`,
    then zero-gradient padding rows with bins 0 up to a capacity of 2,048;
    every row, padding included, sits in level 3's window or is inactive."""
    rng = np.random.default_rng(41)
    m, n_bins = 30, 64
    host = _bins(rng, 5000, m, n_bins, np.uint8).numpy()
    pages = [EllpackPage(host[lo : lo + 1000], lo) for lo in range(0, 5000, 1000)]
    page, ids = compact(pages, rng.choice(5000, 1100, replace=False))
    capacity = 2048
    bins = np.zeros((capacity, m), np.uint8)
    bins[: len(ids)] = page.bins
    g = np.zeros(capacity, np.float32)
    h = np.zeros(capacity, np.float32)
    g[: len(ids)] = rng.normal(size=len(ids)) * 4
    h[: len(ids)] = rng.random(len(ids))
    pos = rng.integers(7, 15, capacity).astype(np.int32)
    pos[rng.random(capacity) < 0.1] = -1
    bins, g, h, pos = (torch.from_numpy(a).to(dev) for a in (bins, g, h, pos))
    nodes = torch.tensor([7, 10, 12, 13], dtype=torch.int32, device=dev)
    got = k_hist.build_histogram_nodes(bins, g, h, pos, nodes, n_bins)
    assert torch.equal(got, ref.build_histogram_nodes_fixed(bins, g, h, pos, nodes, n_bins))
    torch.testing.assert_close(got, ref.build_histogram_nodes(bins, g, h, pos, nodes, n_bins),
                               rtol=1e-5, atol=1e-5)
    # the partition moves padding rows as real rows (bins 0), and they count
    # in the next level's row counts
    n_nodes = 31
    tree = (
        torch.from_numpy(rng.integers(0, m, n_nodes).astype(np.int32)).to(dev),
        torch.from_numpy(rng.integers(0, n_bins, n_nodes).astype(np.int32)).to(dev),
        torch.from_numpy(rng.random(n_nodes) < 0.5).to(dev),
        torch.from_numpy(rng.random(n_nodes) < 0.2).to(dev),
    )
    got_c, want_c = (torch.zeros(16, dtype=torch.int32, device=dev) for _ in range(2))
    moved = k_part.partition_rows(bins, pos, *tree, (15, 16), got_c)
    assert torch.equal(moved, ref.partition_rows(bins, pos, *tree, (15, 16), want_c))
    assert torch.equal(got_c, want_c) and int(got_c.sum()) > 0


def test_sampled_fit_on_the_card_matches_the_cpu(dev, monkeypatch):
    """20,000 rows at f = 0.1 (capacity 3,072) with masks keeping ~30%: the
    capacity cut, the compaction, the staged page and the margin pass. Depth
    3 keeps ~400 or more sampled rows at a node: with a few dozen, two
    features can split a node's rows into the same two sets, an exact tie
    that the card's and the CPU's f32 sums may break apart."""
    X, y = make_classification(20_000, 12, class_sep=1.2, missing_rate=0.05, seed=31)
    Xe, ye = make_classification(500, 12, class_sep=1.2, missing_rate=0.05, seed=31, batch=1)
    batches = [(X[i : i + 4000], y[i : i + 4000]) for i in range(0, 20_000, 4000)]
    kw = dict(n_estimators=3, max_depth=3, max_bin=64, learning_rate=0.3,
              objective="binary:logistic", sampling=SamplingConfig(method="mvs", f=0.1))
    runs = []
    for where in (dev, torch.device("cpu")):
        masks = patch_sample(monkeypatch, booster_mod, len(X), 0.3,
                             lambda x, g: torch.from_numpy(x).to(g.device))
        b = GradientBooster(device=where, policy=ExecutionPolicy(mode="out_of_core"), **kw)
        b.fit(IterDMatrix(batches, max_bin=64, page_bytes=12 * 4000, device=where),
              eval_set=(Xe, ye))
        runs.append((b, masks))
    (card, masks), (cpu, _) = runs
    assert card.decision_.mode == cpu.decision_.mode == "sampled"
    trees = [type(t)(*(a.cpu() for a in t)) for t in card.trees]
    assert_forests_equal(trees, cpu.trees)
    binner = Binner(cpu.cuts, "cpu")
    xb, eb = binner.to_host(X), binner.to_host(Xe)
    capacity = cpu._sampled_capacity(len(X), kw["sampling"])
    assert capacity == 3072 and min(int(k.sum()) for k in masks) > capacity
    tie_x, tie_e = tie_routed_rows(trees, cpu.trees, masks, capacity, xb, xb, eb)
    assert tie_x.mean() < 0.01 and tie_e.mean() < 0.01
    np.testing.assert_allclose(card.margins_.cpu().numpy()[~tie_x], cpu.margins_.numpy()[~tie_x],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(card.predict_margin(Xe)[~tie_e], cpu.predict_margin(Xe)[~tie_e],
                               rtol=1e-5, atol=1e-5)
    assert card.stats.host_to_device_bytes == cpu.stats.host_to_device_bytes


# ------------------------------------------------------------------ serving
def _served(dev, n_rows=3000, m=24, n_trees=18, depth=5, page_rows=400):
    """A random `PackedForest` (unscaled leaves, lr 0.3) on ``dev`` and a
    paged matrix of ``n_rows`` rows binned with its cuts, on ``dev``."""
    from repro_torch.data.dmatrix import ArrayDMatrix
    from repro_torch.serve import PackedForest

    X, _ = make_classification(n_rows, m, missing_rate=0.05, seed=41)
    dm = ArrayDMatrix(X, max_bin=64, page_bytes=page_rows * m, device=dev)
    planes = _forest_planes(np.random.default_rng(41), n_trees, depth, m, s_range=(0, 64))
    forest = PackedForest(
        *(t.to(dev) for t in planes[:2]), torch.zeros(planes[0].shape, device=dev),
        *(t.to(dev) for t in planes[2:]), max_depth=depth, learning_rate=0.3,
        base_margin=0.25, objective="binary:logistic", cuts=dm.cuts,
    )
    return X, dm, forest


def _on_cpu(forest):
    """The same `PackedForest` with its planes on the CPU, where it predicts
    through the kernels' plain versions."""
    import dataclasses

    return dataclasses.replace(forest, **{
        f.name: getattr(forest, f.name).cpu() for f in dataclasses.fields(forest)
        if isinstance(getattr(forest, f.name), torch.Tensor)
    })


SERVE_MODES = {
    "resident": {},
    "unpinned": dict(trees_per_chunk=4, pin_chunks=False),
    "budget_chunks_outer": dict(trees_per_chunk=4, budget_chunks=2, order="chunks_outer"),
    "budget_pages_outer": dict(trees_per_chunk=4, budget_chunks=2, order="pages_outer"),
    "pin_all": dict(trees_per_chunk=3, pin_chunks=True),
}


@pytest.mark.parametrize("mode", list(SERVE_MODES))
def test_serving_modes_on_the_card_equal_the_resident_forest_and_the_cpu(dev, monkeypatch,
                                                                         mode):
    """Every serving mode on the card: margins equal to the resident forest
    and to the same mode on the CPU bit for bit, the ledgers equal."""
    import dataclasses

    from repro_torch.data.dmatrix import ArrayDMatrix
    from repro_torch.data.pages import TransferStats
    from repro_torch.serve import ServeStats
    from repro_torch.serve import engine

    X, dm, forest = _served(dev)
    cpu_forest = _on_cpu(forest)
    cpu_dm = ArrayDMatrix(X, cuts=dm.cuts, max_bin=64, page_bytes=dm.page_bytes, device="cpu")
    assert dm.n_pages == cpu_dm.n_pages > 4
    kw = dict(SERVE_MODES[mode])
    order = kw.pop("order", None)
    if "budget_chunks" in kw:
        worst = max(nr for _, nr in dm.page_set().page_extents)
        per_chunk = NODE_BYTES * kw["trees_per_chunk"] * forest.n_total
        kw["serve_budget_bytes"] = worst * dm.num_features + kw.pop("budget_chunks") * per_chunk
    if order is not None:
        plan = engine.plan_residency
        monkeypatch.setattr(engine, "plan_residency",
                            lambda *a, **k: dataclasses.replace(plan(*a, **k), order=order))
    resident = forest.predict_margin_bins(torch.from_numpy(dm.single_page_bins()).to(dev))
    runs = []
    for f, d in ((forest, dm), (cpu_forest, cpu_dm)):
        stats, sstats = TransferStats(), ServeStats()
        out = engine.predict_margin_dmatrix(f, d, stats=stats, serve_stats=sstats, **kw)
        runs.append((out, stats.host_to_device_bytes, sstats.chunk_hits, sstats.chunk_misses))
    (card, *card_ledger), (cpu, *cpu_ledger) = runs
    assert torch.equal(torch.from_numpy(card), resident.cpu())
    assert np.array_equal(card, cpu)
    assert card_ledger == cpu_ledger


def test_forest_server_on_the_card_keeps_pins_across_requests(dev):
    from repro_torch.serve import ForestServer, ServeStats

    X, dm, forest = _served(dev)
    resident = forest.predict_margin_bins(torch.from_numpy(dm.single_page_bins()).to(dev))
    sstats = ServeStats()
    per_chunk = NODE_BYTES * 4 * forest.n_total
    worst = max(nr for _, nr in dm.page_set().page_extents)
    server = ForestServer(forest, trees_per_chunk=4, serve_stats=sstats,
                          serve_budget_bytes=worst * dm.num_features + 3 * per_chunk)
    ledgers = []
    for _ in range(2):
        before = (sstats.chunk_hits, sstats.chunk_misses, sstats.h2d_bytes)
        assert torch.equal(torch.from_numpy(server.predict_margin(dm)), resident.cpu())
        ledgers.append([a - b for a, b in zip(
            (sstats.chunk_hits, sstats.chunk_misses, sstats.h2d_bytes), before)])
    assert server.cache.pinned_pages == 3
    (hits_1, misses_1, h2d_1), (hits_2, misses_2, h2d_2) = ledgers
    assert hits_2 >= hits_1 + 3 and misses_2 <= misses_1 - 3 and h2d_2 < h2d_1
    # the resident forest equals the plain versions on the CPU
    assert torch.equal(resident.cpu(), _on_cpu(forest).predict_margin_bins(
        torch.from_numpy(dm.single_page_bins())))
    # raw rows through the chunked server equal the resident forest's and the
    # plain versions' on the CPU
    got = server.predict_margin(X)
    assert np.array_equal(got, forest.predict_margin(X))
    assert np.array_equal(got, _on_cpu(forest).predict_margin(X))


def test_forest_kernel_at_the_chunk_shape_with_a_chained_margin(dev):
    """Kernel 3 at the paged forest's chunk shape (32 trees of depth 8 over
    a 67,108-row page at 500 features): two chained chunks equal the plain
    version chained the same way and the 64 trees in one launch."""
    rng = np.random.default_rng(7)
    n, m = 67_108, 500
    bins = _bins(rng, n, m, 255, np.uint8).to(dev)
    planes = [t.to(dev) for t in _forest_planes(rng, 64, 8, m, p_leaf=0.1, s_range=(0, 255))]
    margin_in = torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(dev)
    out = want = margin_in
    for lo in (0, 32):
        chunk = [p[lo : lo + 32].contiguous() for p in planes]
        out = k_forest.predict_forest(bins, *chunk, 8, out)
        want = ref.predict_forest_bins(bins, *chunk, 8, want)
    assert torch.equal(out, want)
    assert torch.equal(out, k_forest.predict_forest(bins, *planes, 8, margin_in))


@pytest.mark.parametrize("trees_per_chunk", [None, 5])
def test_batch_server_on_the_card_equals_direct_predict(dev, trees_per_chunk):
    """Single raw rows through the micro-batcher: the worker thread bins and
    walks on the card; its answers equal a direct predict on the card and the
    plain versions on the CPU bit for bit."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve import BatchServer, ForestServer, ServeStats

    X, _, forest = _served(dev)
    rows = X[:300]
    want = forest.predict_margin(rows)
    server = ForestServer(forest, trees_per_chunk=trees_per_chunk)
    stats = ServeStats()
    reset_launch_counts()
    with BatchServer(server.predict_margin, max_batch=64, max_delay_ms=2.0,
                     stats=stats) as srv:
        futures = [srv.submit(r) for r in rows]
        got = np.asarray([f.result(timeout=60.0) for f in futures], np.float32)
    counts = launch_counts()
    assert np.array_equal(got, want)
    assert np.array_equal(got, _on_cpu(forest).predict_margin(rows))
    assert stats.requests == 300 and stats.batches >= 5
    assert min(counts["bin_values"], counts["predict_forest"]) >= stats.batches


# ------------------------------------------------ a second card, from any thread
SECOND_CARD_KERNELS = ["build_histogram_nodes", "build_histogram", "partition_rows",
                       "predict_forest", "bin_values", "bitpack_decode"]


@pytest.fixture
def second_card(dev):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    return torch.device("cuda", 1)


def _second_card_case(kernel: str):
    """One kernel's CPU inputs, made from a seed, with its wrapper's call and
    the call of the plain version it equals bit for bit."""
    rng = np.random.default_rng(SECOND_CARD_KERNELS.index(kernel) + 11)
    n, m = 3001, 13
    if kernel == "build_histogram_nodes":
        g = torch.from_numpy(rng.normal(size=n).astype(np.float32) * 50)
        h = torch.from_numpy(rng.random(n).astype(np.float32))
        pos = torch.from_numpy(rng.integers(-1, 9, n).astype(np.int32))
        nodes = torch.tensor([1, 4, 6], dtype=torch.int32)
        return ((_bins(rng, n, m, 64, np.uint8), g, h, pos, nodes),
                lambda *a: k_hist.build_histogram_nodes(*a, 64),
                lambda *a: ref.build_histogram_nodes_fixed(*a, 64))
    if kernel == "build_histogram":
        *args, n_nodes = _window_inputs(rng, n, m, 64, 16, True, np.uint8)
        return (args, lambda *a: k_hist.build_histogram(*a[:4], n_nodes, 64, a[4]),
                lambda *a: ref.build_histogram_fixed(*a[:4], n_nodes, 64, a[4]))
    if kernel == "partition_rows":
        tree = (torch.from_numpy(rng.integers(0, m, 31).astype(np.int32)),
                torch.from_numpy(rng.integers(0, 32, 31).astype(np.int32)),
                torch.from_numpy(rng.random(31) < 0.5), torch.from_numpy(rng.random(31) < 0.3))
        pos = torch.from_numpy(rng.integers(-1, 15, n).astype(np.int32))
        return ((_bins(rng, n, m, 32, np.uint8), pos, *tree), k_part.partition_rows,
                ref.partition_rows)
    if kernel == "predict_forest":
        planes = _forest_planes(rng, 8, 5, m)
        margin = torch.from_numpy(rng.normal(size=n).astype(np.float32))
        return ((_bins(rng, n, m, 32, np.uint8), *planes, margin),
                lambda *a: k_forest.predict_forest(*a[:-1], 5, a[-1]),
                lambda *a: ref.predict_forest_bins(*a[:-1], 5, a[-1]))
    if kernel == "bin_values":
        cuts = _explicit_cuts(rng, 33, 255)
        binner = Binner(cuts, torch.device("cpu"))
        X = torch.from_numpy(_values_around_edges(rng, cuts, n, np.float32))
        return (X, binner.edges, binner.n_bins), k_bin.bin_values, ref.bin_values
    from repro_torch.kernels import bitpack as k_bitpack

    _, payload, meta = _packed_page(rng, 1000, 500, 6, True)
    return ((torch.from_numpy(payload),),
            lambda p: k_bitpack.bitpack_decode(p, 500, 6, meta["missing"]),
            lambda p: ref.bitpack_decode(p, 500, 6, meta["missing"]))


@pytest.mark.parametrize("thread", ["main", "fresh"])
@pytest.mark.parametrize("kernel", SECOND_CARD_KERNELS)
def test_kernel_launches_on_a_second_card(second_card, kernel, thread):
    """Each kernel on tensors of cuda:1 while the calling thread's current
    device is card 0: from the main thread, and from a fresh
    `threading.Thread` (whose current device starts at 0). One launch, the
    result on cuda:1 and bit for bit its plain version's on the CPU, and the
    thread's current device 0 again afterwards."""
    import threading

    from repro_torch.kernels import launch_counts

    args, call, plain = _second_card_case(kernel)
    on_card = [None if a is None else a.to(second_card) for a in args]
    torch.cuda.set_device(0)
    before = launch_counts()[kernel]
    seen = {}

    def launch():
        try:
            seen["device_before"] = torch.cuda.current_device()
            seen["out"] = call(*on_card)
            torch.cuda.synchronize(second_card)
            seen["device_after"] = torch.cuda.current_device()
        except BaseException as err:  # handed to the test's thread
            seen["error"] = err

    if thread == "main":
        launch()
    else:
        worker = threading.Thread(target=launch)
        worker.start()
        worker.join(timeout=120)
        assert not worker.is_alive()
    if "error" in seen:
        raise seen["error"]
    assert seen["device_before"] == seen["device_after"] == 0
    assert torch.cuda.current_device() == 0
    assert launch_counts()[kernel] == before + 1
    out = seen["out"]
    assert out.device == second_card
    assert torch.equal(out.cpu(), plain(*args))


def test_batch_server_on_a_second_card_equals_direct_predict(second_card):
    """A forest and its matrix on cuda:1, served through `BatchServer`, whose
    worker thread starts on card 0: its answers equal a direct predict on
    cuda:1 and the plain versions on the CPU bit for bit."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve import BatchServer, ForestServer, ServeStats

    torch.cuda.set_device(0)
    X, _, forest = _served(second_card)
    assert forest.feature.device == second_card
    rows = X[:300]
    want = forest.predict_margin(rows)
    stats = ServeStats()
    reset_launch_counts()
    with BatchServer(ForestServer(forest).predict_margin, max_batch=64, max_delay_ms=2.0,
                     stats=stats) as srv:
        futures = [srv.submit(r) for r in rows]
        got = np.asarray([f.result(timeout=60.0) for f in futures], np.float32)
    counts = launch_counts()
    assert np.array_equal(got, want)
    assert np.array_equal(got, _on_cpu(forest).predict_margin(rows))
    assert stats.requests == 300 and stats.batches >= 5
    assert min(counts["bin_values"], counts["predict_forest"]) >= stats.batches
    assert torch.cuda.current_device() == 0


# ------------------------------------------------ lossguide and the budgeted store
def test_inflight_spill_then_fetch_is_exact(dev):
    """A fetch issued while the spill's copy may still be in flight waits on
    the copy's event: the bits come back exact for every spilled node, also
    beside a spill abandoned mid-flight."""
    from repro_torch.core.histcache import HistogramStore

    gen = torch.Generator(device=dev).manual_seed(3)
    store = HistogramStore(budget_bytes=0)
    nodes = {k: torch.randn((500, 255, 2), generator=gen, device=dev) for k in range(1, 6)}
    want = {k: v.clone() for k, v in nodes.items()}
    for k, v in nodes.items():
        store.put_node(k, v)  # budget 0: spilled at once, asynchronously
        assert store.tier_of(("N", k)) == "host"
    del nodes
    store.discard_node(5)  # abandoned in flight
    for k in (4, 1, 3, 2):
        got = store._fetch(("N", k), dev)
        assert got.is_cuda and torch.equal(got, want[k]), k
    assert store.transfer_stats.hist_spills == 5 and store.transfer_stats.hist_fetches == 4


@pytest.mark.parametrize("span", [3000, 6000])
def test_batched_pop_build_sets_past_the_id_table(dev, span):
    """Batched lossguide pops at depth 12 give non-contiguous build sets whose
    ids span more than the kernel's 4,096-id table (the search path): kernel
    1 equals its fixed-point plain version; the partition counts the span
    window of the popped children (past 2,048 count slots at 6,000) and the
    listed nodes gathered from it equal `node_row_counts`."""
    from repro_torch.core.histcache import count_span, new_level_counts, node_row_counts
    from repro_torch.core.histcache import take_counts

    rng = np.random.default_rng(span)
    n, m, n_bins = 120_000, 40, 64
    parents = sorted(rng.choice(np.arange(2047, 2047 + span // 2), 8, replace=False).tolist())
    parents[0], parents[-1] = 2047, 2047 + span // 2 - 1
    kids = [2 * p + 1 + c for p in parents for c in (0, 1)]
    bins = _bins(rng, n, m, n_bins, np.uint8).to(dev)
    g = torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(dev)
    h = torch.from_numpy(rng.random(n).astype(np.float32)).to(dev)
    pos = torch.from_numpy(rng.choice(parents + [5, 9000], n).astype(np.int32)).to(dev)
    n_nodes = 2 ** 13 - 1 + span
    tree = (
        torch.from_numpy(rng.integers(0, m, n_nodes).astype(np.int32)).to(dev),
        torch.from_numpy(rng.integers(0, n_bins, n_nodes).astype(np.int32)).to(dev),
        torch.from_numpy(rng.random(n_nodes) < 0.5).to(dev),
        torch.ones(n_nodes, dtype=torch.bool, device=dev),
    )
    tree[3][torch.tensor(parents, device=dev)] = False
    counts = new_level_counts(kids, dev)
    assert counts.shape[0] == count_span(kids)[1] == kids[-1] - kids[0] + 1
    moved = k_part.partition_rows(bins, pos, *tree, count_span(kids), counts)
    assert torch.equal(moved, ref.partition_rows(bins, pos, *tree))
    nodes = torch.tensor(kids, dtype=torch.int32, device=dev)
    assert torch.equal(take_counts(kids, counts), node_row_counts(moved, nodes))
    build = nodes[::2].contiguous()
    assert int(build[-1] - build[0]) >= 4096 or span < 4096
    got = k_hist.build_histogram_nodes(bins, g, h, moved, build, n_bins)
    assert torch.equal(got, ref.build_histogram_nodes_fixed(bins, g, h, moved, build, n_bins))


@pytest.mark.parametrize("max_depth,max_leaves", [(12, 8), (12, 256), (6, 0)])
def test_lossguide_fit_on_the_card_matches_the_cpu_and_kernel_3(dev, max_depth, max_leaves):
    """Lossguide forests on the card, arrays sized by ``effective_max_depth``
    (255 nodes at 8 leaves; 8,191 at depth 12 and 256 leaves): kernel 3
    equals its plain version bit for bit, and a full-budget tree the
    depthwise one. The 8-leaf fit also equals the CPU fit; the deep fits
    reach nodes of a few rows, whose splits and leaves the card's
    fixed-point sums and the CPU's f32 sums tie-break and round apart."""
    X, y = make_classification(20_000, 30, seed=2)
    kw = dict(n_estimators=2, max_depth=max_depth, max_bin=64, objective="binary:logistic",
              grow_policy="lossguide", max_leaves=max_leaves, pop_batch=4)
    card = GradientBooster(device="cuda", **kw).fit(X, y)
    assert card.trees[0].n_total == card.params.tree_params().n_total_nodes
    if max_leaves == 8:
        cpu = GradientBooster(device="cpu", **kw).fit(X, y)
        assert_forests_equal([type(t)(*[a.cpu() for a in t]) for t in card.trees], cpu.trees)
    forest = card.packed_forest()
    bins = forest.quantize(X[:5000])
    scaled = torch.tensor(forest.learning_rate, dtype=torch.float32, device=dev) * forest.leaf_value
    want = ref.predict_forest_bins(bins, forest.feature, forest.split_bin, forest.default_left,
                                   forest.is_leaf, scaled, forest.max_depth,
                                   forest._base(bins.shape[0]))
    assert torch.equal(forest.predict_margin_bins(bins), want)
    if max_leaves == 0:
        dw = GradientBooster(device="cuda", **dict(kw, grow_policy="depthwise")).fit(X, y)
        for a, b in zip(card.trees, dw.trees):
            for f in a._fields:
                assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_budgeted_lossguide_fit_on_the_card_equals_unbudgeted(dev):
    X, y = make_classification(20_000, 30, seed=4)
    kw = dict(n_estimators=2, max_depth=8, max_bin=64, objective="binary:logistic",
              grow_policy="lossguide", max_leaves=32)
    node = 30 * 64 * 2 * 4
    free = GradientBooster(device="cuda", **kw).fit(X, y)
    tight = GradientBooster(device="cuda", policy=ExecutionPolicy(hist_budget_bytes=4 * node),
                            **kw).fit(X, y)
    assert tight.stats.hist_spills > 0 and tight.stats.hist_fetches > 0
    for a, b in zip(tight.trees, free.trees):
        for f in a._fields:
            assert torch.equal(getattr(a, f), getattr(b, f)), f


# ------------------------------------------ repeatability of library ops on the card
def _same_bits(fn, calls: int = 30) -> bool:
    first = fn()
    return all(torch.equal(fn(), first) for _ in range(calls - 1))


@pytest.mark.parametrize("n_nodes", [2, 16, 128])
def test_split_scan_same_bits_every_call(dev, n_nodes):
    """`evaluate_splits` scans each (node, feature) over its bins with
    ``torch.cumsum(hist, dim=2)``: lossguide's frontier order rests on the
    gains it gives, so it must give the same bits on every call."""
    gen = torch.Generator(device=dev).manual_seed(n_nodes)
    hist = torch.randn((n_nodes, 500, 255, 2), generator=gen, device=dev)
    assert _same_bits(lambda: torch.cumsum(hist, dim=2))


@pytest.mark.parametrize("n", [1_000_000])
def test_sampling_sorts_same_bits_every_call(dev, n):
    gen = torch.Generator(device=dev).manual_seed(7)
    g = torch.randn(n, generator=gen, device=dev)
    assert _same_bits(lambda: torch.sort(torch.abs(g)).values)  # GOSS
    assert _same_bits(lambda: torch.sort(g.square()).values)  # MVS


def test_plain_scatters_same_bits_every_call(dev):
    """The plain versions' scatters on the card at a 32 MiB page's shape
    (67,108 rows x 500 features, 64 build nodes): the f32 and fixed-point
    histograms and the partition's row counts. The f32 one adds each cell's
    rows in row order (`ref._index_add_`), so it also equals the CPU's."""
    rng = np.random.default_rng(0)
    n, m, n_bins = 67_108, 500, 255
    bins = _bins(rng, n, m, n_bins, np.uint8).to(dev)
    g = torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(dev)
    h = torch.from_numpy(rng.random(n).astype(np.float32)).to(dev)
    pos = torch.from_numpy(rng.integers(63, 127, n).astype(np.int32)).to(dev)
    nodes = torch.arange(63, 127, dtype=torch.int32, device=dev)
    assert _same_bits(lambda: ref.build_histogram_nodes(bins, g, h, pos, nodes, n_bins))
    assert _same_bits(lambda: ref.build_histogram_nodes_fixed(bins, g, h, pos, nodes, n_bins))
    assert _same_bits(lambda: ref.level_row_counts(pos, 63, 64))
    cpu = [t.cpu() for t in (bins[:4096], g[:4096], h[:4096], pos[:4096], nodes)]
    assert torch.equal(ref.build_histogram_nodes(*cpu, n_bins),
                       ref.build_histogram_nodes(bins[:4096], g[:4096], h[:4096], pos[:4096],
                                                 nodes, n_bins).cpu())


@pytest.mark.parametrize("mode", ["f16", "bf16", "int8"])
def test_spill_quantizer_same_bits_every_call(dev, mode):
    """The histogram spill's narrowing casts and the int8 transport's
    ``amax`` scale give one bit pattern in 30 calls, at a 64-node level of
    the paper's width, and equal the CPU's."""
    from repro_torch.compress import GradQuantizer

    gen = torch.Generator(device=dev).manual_seed(11)
    hist = torch.randn((64, 500, 255, 2), generator=gen, device=dev) * 100.0
    q = GradQuantizer(mode)
    assert _same_bits(lambda: q.quantize(hist)[0])
    if mode == "int8":
        assert _same_bits(lambda: hist.abs().amax())
        assert _same_bits(lambda: q.quantize(hist)[1])
    payload, scale = q.quantize(hist)
    cpu_payload, cpu_scale = q.quantize(hist.cpu())
    assert torch.equal(payload.cpu(), cpu_payload)
    if scale is not None:
        assert torch.equal(scale.cpu(), cpu_scale)
    assert torch.equal(q.dequantize(payload, scale).cpu(), q.dequantize(cpu_payload, cpu_scale))


# ------------------------------------------------- compression (bitpack, transports)
def _packed_page(rng, rows, cols, bits, missing):
    from repro_torch.compress import BitpackCodec

    top = (1 << bits) - 2 if missing else min((1 << bits) - 1, 254)
    page = rng.integers(0, top + 1, size=(rows, cols)).astype(np.uint8)
    page[0, 0] = top
    if missing:
        page[rng.random(page.shape) < 0.1] = 255
        page[min(3, rows - 1)] = 255  # an all-missing row
        page[0, 0] = top
    payload, meta = BitpackCodec().encode(page)
    assert meta["bits"] == bits
    return page, payload, meta


# the kernel's tile edges: R - 1, R and R + 1 rows, and four tiles and a
# ragged one, at 500 symbols a row (R = 32) and 13 (R = 1,248)
BITPACK_EDGES = [
    (rows, cols)
    for cols in (500, 13)
    for rows in (tile_rows(cols) - 1, tile_rows(cols), tile_rows(cols) + 1, 4 * tile_rows(cols) + 3)
]


def _decode_once(dev, payload, cols, bits, missing):
    """The kernel's decode of ``payload`` (a CUDA tensor), checking that
    the call launched it exactly once."""
    from repro_torch.kernels import bitpack as k_bitpack

    before = k_bitpack.launches
    got = k_bitpack.bitpack_decode(payload, cols, bits, missing)
    torch.cuda.synchronize()
    assert k_bitpack.launches == before + 1
    assert got.dtype == torch.uint8 and got.shape == (payload.shape[0], cols)
    return got


@pytest.mark.parametrize("bits", range(1, 9))
@pytest.mark.parametrize("missing", [False, True])
@pytest.mark.parametrize("rows,cols", [(1000, 500), (37, 11), (5, 1), (1, 4099)] + BITPACK_EDGES)
def test_bitpack_decode_kernel_matches_plain(dev, bits, missing, rows, cols):
    """The decode kernel equals its plain version and the page bit for bit
    at every width, rows that do not fill a byte among them, and at the
    edges of its row tiles (the last rows through its direct path)."""
    rng = np.random.default_rng(bits * 100 + rows + cols)
    page, payload, meta = _packed_page(rng, rows, cols, bits, missing)
    got = _decode_once(dev, torch.from_numpy(payload).to(dev), cols, bits, meta["missing"])
    want = ref.bitpack_decode(torch.from_numpy(payload), cols, bits, meta["missing"])
    assert torch.equal(got.cpu(), want)
    assert np.array_equal(want.numpy(), page)


@pytest.mark.parametrize("offset", [1, 3, 8, 15])
@pytest.mark.parametrize(
    "bits,rows,cols",
    [(6, 4 * tile_rows(500) + 3, 500), (8, tile_rows(500) + 1, 500), (3, tile_rows(13) + 1, 13)],
)
def test_bitpack_decode_kernel_from_a_misaligned_view(dev, offset, bits, rows, cols):
    """A payload that is a view ``offset`` bytes into a larger buffer (not
    16-byte aligned, so no tile can be copied in bulk) decodes bit for bit."""
    rng = np.random.default_rng(offset * 10 + bits)
    page, payload, meta = _packed_page(rng, rows, cols, bits, True)
    buf = torch.zeros(payload.size + offset + 16, dtype=torch.uint8, device=dev)
    view = buf[offset : offset + payload.size].view(payload.shape)
    view.copy_(torch.from_numpy(payload).to(dev))
    assert view.data_ptr() % 16 != 0
    got = _decode_once(dev, view, cols, bits, meta["missing"])
    assert np.array_equal(got.cpu().numpy(), page)


def test_bitpack_decode_kernel_remaps_a_missing_symbol_at_8_bits(dev):
    """At 8 bits the decode is a copy; a missing symbol below 255 (real
    symbols up to 253) must still become 255."""
    from repro_torch.compress import BitpackCodec

    rng = np.random.default_rng(8)
    page = rng.integers(0, 254, size=(4 * tile_rows(500) + 3, 500)).astype(np.uint8)
    page[0, 0] = 253
    page[rng.random(page.shape) < 0.1] = 255
    payload, meta = BitpackCodec().encode(page)
    assert (meta["bits"], meta["missing"]) == (8, 254)
    got = _decode_once(dev, torch.from_numpy(payload).to(dev), 500, 8, 254)
    assert np.array_equal(got.cpu().numpy(), page)


def test_bitpack_decode_kernel_is_repeatable_and_launches_once_a_call(dev):
    """Two decodes of one page give the same bytes, and every call is one
    launch whichever of the kernel's paths it takes: whole tiles only,
    tiles and a ragged tail, no whole tile, a misaligned view."""
    rng = np.random.default_rng(9)
    page, payload, meta = _packed_page(rng, 67_108, 500, 6, True)
    p = torch.from_numpy(payload).to(dev)
    first = _decode_once(dev, p, 500, 6, meta["missing"])
    assert torch.equal(first, _decode_once(dev, p, 500, 6, meta["missing"]))
    assert np.array_equal(first.cpu().numpy(), page)
    for rows in (64, 65, 31):
        _decode_once(dev, p[:rows], 500, 6, meta["missing"])
    buf = torch.zeros(payload.size + 16, dtype=torch.uint8, device=dev)
    view = buf[1 : 1 + 65 * 375].view(65, 375).copy_(p[:65])
    assert torch.equal(_decode_once(dev, view, 500, 6, meta["missing"]), first[:65])


def test_bitpack_decode_kernel_at_a_page_shape(dev):
    """One 32 MiB streaming page (67,108 x 500) at 8 bits, and at 6 bits
    with missing values (max_bin 32), and the in-core decode of 200,000 x
    500 at 6 bits."""
    from repro_torch.kernels import bitpack as k_bitpack

    rng = np.random.default_rng(5)
    for rows, bits, missing in ((67_108, 8, False), (67_108, 6, True), (200_000, 6, True)):
        page, payload, meta = _packed_page(rng, rows, 500, bits, missing)
        got = k_bitpack.bitpack_decode(torch.from_numpy(payload).to(dev), 500, bits,
                                       meta["missing"])
        assert np.array_equal(got.cpu().numpy(), page)


def test_bitpack_decode_kernel_rejects_bad_arguments(dev):
    from repro_torch.kernels import bitpack as k_bitpack

    rng = np.random.default_rng(6)
    _, payload, meta = _packed_page(rng, 20, 9, 5, True)
    p = torch.from_numpy(payload).to(dev)
    for call, err in (
        (lambda: k_bitpack.bitpack_decode(p, 9, 9, None), ValueError),  # bits
        (lambda: k_bitpack.bitpack_decode(p, 9, 0, None), ValueError),
        (lambda: k_bitpack.bitpack_decode(p, 10, 5, None), ValueError),  # row stride
        (lambda: k_bitpack.bitpack_decode(p.reshape(-1), 9, 5, None), ValueError),
        (lambda: k_bitpack.bitpack_decode(p.to(torch.int32), 9, 5, None), TypeError),
        (lambda: k_bitpack.bitpack_decode(p[:, :-1], 9, 5, None), ValueError),
        (lambda: k_bitpack.bitpack_decode(p, 9, 5, 32), ValueError),  # missing symbol
        (lambda: k_bitpack.bitpack_decode(
            torch.cat([p, p], 1)[:, : p.shape[1]], 9, 5, None), ValueError),  # strided
    ):
        with pytest.raises(err):
            call()


def test_forest_transport_on_the_card(dev):
    """Forest chunks at an odd node count decode on the card to the CPU's
    fields, and a chunked forest served through the transport equals the
    raw server bit for bit."""
    from repro_torch.compress import ForestPageTransport
    from repro_torch.serve import ForestServer

    X, _, forest = _served(dev)
    assert (3 * forest.n_total) % 2 == 1  # an odd n: leaf_value is unaligned
    page = forest.pack_page(0, 3)
    wire, meta = ForestPageTransport().encode(page)
    got = ForestPageTransport().decode(torch.from_numpy(wire).to(dev), meta)
    want = ForestPageTransport().decode(torch.from_numpy(wire), meta)
    for key, val in want.items():
        assert got[key].is_cuda and torch.equal(got[key].cpu(), val), key
    raw = ForestServer(forest, trees_per_chunk=5).predict_margin(X[:2000])
    packed = ForestServer(forest, trees_per_chunk=5, page_codec="bitpack")
    assert np.array_equal(packed.predict_margin(X[:2000]), raw)
    assert packed.stats.wire_bytes * 24 == packed.stats.logical_bytes * 14


def test_bitpack_stream_and_fits_on_the_card(dev, tmp_path):
    """A bitpack store streams to the card as stored and decodes to the raw
    pages; streaming and in-core fits under bitpack equal the raw fits."""
    from repro_torch.data.dmatrix import PagedDMatrix
    from repro_torch.kernels import bitpack as k_bitpack

    X, y = make_classification(30_000, 40, missing_rate=0.05, seed=9)
    batches = [(X[i : i + 10_000], y[i : i + 10_000]) for i in range(0, 30_000, 10_000)]
    raw_dm = IterDMatrix(batches, max_bin=32, cache_dir=str(tmp_path / "raw"),
                         page_bytes=40 * 4096, device=dev)
    IterDMatrix(batches, max_bin=32, cuts=raw_dm.cuts, cache_dir=str(tmp_path / "bp"),
                page_bytes=40 * 4096, page_codec="bitpack", device=dev)
    bp = PagedDMatrix(str(tmp_path / "bp"))
    want = [p.bins for _, p in raw_dm.page_set().iter_pages()]
    before = k_bitpack.launches
    got = [sp.device.cpu().numpy() for sp in bp.page_set().stream(device=dev, codec="bitpack")]
    assert k_bitpack.launches == before + len(want) and len(want) > 1
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    params = dict(n_estimators=2, max_depth=5, max_bin=32, objective="binary:logistic")
    for mode in ("out_of_core", "in_core"):
        fits = [
            GradientBooster(device=dev, policy=ExecutionPolicy(mode=mode, page_codec=c),
                            **params).fit(PagedDMatrix(str(tmp_path / d)))
            for c, d in (("raw", "raw"), ("bitpack", "bp"))
        ]
        for a, b in zip(fits[0].trees, fits[1].trees):
            assert all(torch.equal(u, v) for u, v in zip(a, b)), mode
        assert fits[1].stats.wire_bytes < 0.8 * fits[1].stats.logical_bytes


# ------------------------------------------------- the sharded trainer (gloo)
def _spawn_ranks(tmp_path, world: int, fail_rank: int, deadline_s: float = 240.0):
    """``world`` gloo ranks on the card running `torch_shard_ranks.run_cuda`;
    returns their exit codes (None for a rank still running at the
    deadline, which is then killed)."""
    import time

    import torch.multiprocessing as mp
    import torch_shard_ranks as ranks

    ctx = mp.start_processes(
        ranks.run_cuda, args=(world, str(tmp_path / "store"), str(tmp_path), fail_rank),
        nprocs=world, join=False, start_method="spawn",
    )
    deadline = time.monotonic() + deadline_s
    for proc in ctx.processes:
        proc.join(timeout=max(0.0, deadline - time.monotonic()))
    codes = [p.exitcode for p in ctx.processes]
    for proc in ctx.processes:
        if proc.is_alive():
            proc.kill()
    return codes


def test_fit_sharded_two_ranks_on_the_card_match_a_world_of_one(dev, tmp_path):
    import torch_shard_ranks as ranks

    from repro_torch.core.booster import BoosterParams
    from repro_torch.distributed import fit_sharded, make_mesh

    X, y = ranks.cuda_fit_inputs()
    one = fit_sharded(make_mesh((1,), ("data",)), X, y, params=BoosterParams(**ranks.CUDA_FIT))
    assert one.trees[0].feature.is_cuda
    assert _spawn_ranks(tmp_path, 2, fail_rank=-1) == [0, 0]
    for r in range(2):
        got = np.load(tmp_path / f"cuda_fit_r{r}.npz")
        forest = [
            type(one.trees[0])(*[torch.from_numpy(got[f"forest_{f}"][i])
                                 for f in one.trees[0]._fields])
            for i in range(len(one.trees))
        ]
        assert_forests_equal(forest, [type(t)(*[a.cpu() for a in t]) for t in one.trees])


def test_fit_sharded_a_failing_rank_fails_the_call(dev, tmp_path):
    codes = _spawn_ranks(tmp_path, 2, fail_rank=1)
    assert None not in codes, f"a rank hung: exit codes {codes}"
    assert all(c != 0 for c in codes), f"exit codes {codes}"
    assert not (tmp_path / "cuda_fit_r0.npz").exists()


@pytest.mark.parametrize("backend", ["nccl", "gloo"])
def test_fit_sharded_one_card_a_rank(dev, tmp_path, backend):
    """4 ranks on 4 cards (skips on fewer), at the paper width: every rank
    returns the same forest, within 1e-4 eval AUC of a world of one's and
    with >= 95% of its split nodes; prints each backend's seconds and
    all-reduce a tree."""
    import time

    import torch.multiprocessing as mp
    import torch_shard_ranks as ranks

    from repro_torch.core.booster import BoosterParams
    from repro_torch.distributed import fit_sharded, make_mesh

    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards")
    ctx = mp.start_processes(
        ranks.run_cards, args=(4, str(tmp_path / "store"), str(tmp_path), backend),
        nprocs=4, join=False, start_method="spawn",
    )
    deadline = time.monotonic() + 400
    for proc in ctx.processes:
        proc.join(timeout=max(0.0, deadline - time.monotonic()))
    codes = [p.exitcode for p in ctx.processes]
    for proc in ctx.processes:
        if proc.is_alive():
            proc.kill()
    assert codes == [0, 0, 0, 0], codes
    X, y = ranks.paper_fit_inputs()
    one = fit_sharded(make_mesh((1,), ("data",)), X, y, params=BoosterParams(**ranks.PAPER_FIT),
                      eval_set=(X[:20_000], y[:20_000]))
    got = [np.load(tmp_path / f"cards_{backend}_r{r}.npz") for r in range(4)]
    for r in range(1, 4):
        for key in got[0].files:
            if key.startswith("forest_") or key == "eval_auc":
                np.testing.assert_array_equal(got[r][key], got[0][key], err_msg=key)
    assert abs(float(got[0]["eval_auc"]) - one.eval_history[-1].value) <= 1e-4
    same = [
        ((got[0]["forest_is_leaf"][i] == t.is_leaf.cpu().numpy())
         & (got[0]["forest_feature"][i] == t.feature.cpu().numpy())
         & (got[0]["forest_split_bin"][i] == t.split_bin.cpu().numpy())).mean()
        for i, t in enumerate(one.trees)
    ]
    assert np.mean(same) >= 0.95, same
    for r in range(4):
        print(f"{backend} rank {r}: {float(got[r]['per_tree_s']):.4f} s a tree, all-reduce "
              f"{float(got[r]['all_reduce_s']):.4f} s and {int(got[r]['all_reduce_bytes'])} B "
              f"a tree; split nodes equal to a world of one's {np.mean(same):.4f}")


# ---------------------------------------------------------------- LM on cards
LM_CARDS = 4
# the four-card mesh, and the one phi3's checkpoint restores onto: the dry
# run's per-device peaks on 2 x 2, 4 x 1 and 1 x 4 tie within 0.1% for both
# archs (PERF.md §6, PR 29), and 2 x 2 is taken on a tie
LM_MESH, LM_OTHER_MESH = (2, 2), (4, 1)
LM_PEAK_RTOL = 0.10  # each rank's peak against the dry run's
LM_F32_LOSS_RTOL = 1e-5  # the f32 hold's loss against one card's
LM_F32_GNORM_RTOL = 1e-5  # and its grad norm
LM_BF16_LOSS_RTOL = 1e-3  # step 1's bf16 loss against one card's
# step 1's bf16 grad norm against one card's: each of the two bf16 runs may
# sit as far from the f32 grad norm of the same weights as one card's does,
# so they are held within twice that distance
LM_BF16_GNORM_GAPS = 2
LM_CARDS_DEADLINE_S = 1000


def _plan() -> dict:
    """For each full-width arch, the dry run of a 4 x 512 bf16 step on
    LM_MESH at its depth (`torch_lm_shard_ranks.dry_run`, one host process
    an arch, started together): its per-device peak, FLOPs and collectives,
    beside the meshes to train on and to restore onto and the depths of the
    steps and of the f32 hold."""
    from concurrent.futures import ThreadPoolExecutor

    import torch_lm_shard_ranks as ranks

    def one(arch):
        layers = ranks.full_config(arch).n_layers
        return ranks.dry_run(arch, LM_MESH, [layers])[layers]

    with ThreadPoolExecutor(len(ranks.FULL_ARCHS)) as pool:
        costs = dict(zip(ranks.FULL_ARCHS, pool.map(one, ranks.FULL_ARCHS)))
    plan = {}
    for arch, cost in costs.items():
        plan[arch] = {"mesh": LM_MESH, "other_mesh": LM_OTHER_MESH, "peak": cost["peak"],
                      "flops": cost["flops"], "collectives": cost["collectives"],
                      "layers": cost["layers"],
                      "hold_layers": ranks.full_config(
                          arch, layers=ranks.HOLD_LAYERS.get(arch)).n_layers}
        print(f"{arch} at {cost['layers']} layers: dry-run peak a device on {LM_MESH}: "
              f"{cost['peak']} B")
    return plan


@pytest.fixture(scope="module")
def lm_four_cards(tmp_path_factory):
    """`torch_lm_shard_ranks.run_cards` on four cards over NCCL, one card a
    rank (skips on fewer): the results directory and the plan."""
    import time

    import torch.multiprocessing as mp
    import torch_lm_shard_ranks as ranks

    if torch.cuda.device_count() < LM_CARDS:
        pytest.skip("needs four cards")
    out = tmp_path_factory.mktemp("lm_cards")
    plan = _plan()
    (out / "plan.json").write_text(json.dumps(plan))
    torch.cuda.empty_cache()  # this process's cached blocks, on rank 0's card
    t0 = time.monotonic()
    ctx = mp.start_processes(
        ranks.run_cards, args=(LM_CARDS, str(out / "store"), str(out), "nccl"),
        nprocs=LM_CARDS, join=False, start_method="spawn",
    )
    for proc in ctx.processes:
        proc.join(timeout=max(0.0, t0 + LM_CARDS_DEADLINE_S - time.monotonic()))
    codes = [p.exitcode for p in ctx.processes]
    for proc in ctx.processes:
        if proc.is_alive():
            proc.kill()
    errors = [f.read_text() for f in sorted(out.glob("cards_error_r*.txt"))]
    assert codes == [0] * LM_CARDS, (codes, errors)
    print(f"four-card ranks: {time.monotonic() - t0:.1f} s")
    return out, plan


@pytest.mark.parametrize("arch", ["llama3.2-1b", "olmoe-1b-7b", "hymba-1.5b", "mamba2-130m",
                                  "smollm-135m", "phi3-mini-3.8b", "minicpm-2b",
                                  "musicgen-large", "moonshot-v1-16b-a3b", "llava-next-34b"])
def test_lm_four_cards_match_one_rank(lm_four_cards, arch):
    """REDUCED f32 on a 2 x 2 mesh of four cards over NCCL: prefill, 3 greedy
    decode steps and a train step held against one rank on a card at the
    gloo test's tolerances; a second run on the mesh printed bit for bit or not."""
    import torch_lm_shard_ranks as ranks

    out, _ = lm_four_cards
    one = torch.device("cuda", 0)
    want = ranks.compute(arch, device=one)
    floor = max(ranks.TOL, ranks.f32_floor(arch, one))
    for rank in range(LM_CARDS):
        got = dict(np.load(out / f"cards_{arch}_r{rank}.npz"))
        dec = ranks.check_against_one_rank(got, want, floor, f"{arch} card {rank}")
        print(f"{arch} card {rank}: loss {float(got['loss'])!r} (one rank "
              f"{float(want['loss'])!r}), decode logits within {dec:.3e}, tokens "
              f"{got['decode_tokens'].T.tolist()}, a second run bit for bit: "
              f"{bool(got['repeat_equal'])}")


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "olmoe-1b-7b", "llava-next-34b",
                                  "moonshot-v1-16b-a3b"])
def test_lm_full_width_trains_on_four_cards(lm_four_cards, arch):
    """Full width over NCCL (llava and moonshot at their FULL_LAYERS depth,
    the others whole): the f32 hold (loss and grad norm within 1e-5 of one
    card's), 3 bf16 steps with finite losses, step 1 within 1e-3 of one
    card's loss, and, where the arch runs whole, its grad norm within
    LM_BF16_GNORM_GAPS of one card's bf16 distance from f32; each rank's
    peak within 10% of the dry run's; prints ms a step, the FLOP bound and
    the NCCL share of a profiled step."""
    import torch_lm_shard_ranks as ranks

    out, plan = lm_four_cards
    bound_ms = plan[arch]["flops"] / ranks.BF16_PEAK_FLOPS * 1e3
    for rank in range(LM_CARDS):
        r = json.loads((out / f"cards_full_{arch}_r{rank}.json").read_text())
        for key, rtol in (("loss", LM_F32_LOSS_RTOL), ("grad_norm", LM_F32_GNORM_RTOL)):
            one, sharded = r[f"f32_one_card_{key}"], r[f"f32_sharded_{key}"]
            assert abs(sharded - one) <= rtol * abs(one), (arch, rank, key, sharded, one)
        assert all(math.isfinite(v) for v in r["losses"] + r["grad_norms"]), r
        first, one = r["losses"][0], r["bf16_one_card_loss"]
        assert abs(first - one) <= LM_BF16_LOSS_RTOL * abs(one), (arch, rank, first, one)
        g1, g_one = r["grad_norms"][0], r["bf16_one_card_grad_norm"]
        g_f32 = r.get("f32_one_card_bf16_weights_grad_norm")  # not for a depth cut
        if g_f32 is not None:
            assert abs(g1 - g_one) <= LM_BF16_GNORM_GAPS * abs(g_one - g_f32), (
                arch, rank, g1, g_one, g_f32)
        assert r["layers"] == plan[arch]["layers"] and r["f32_layers"] == plan[arch][
            "hold_layers"]
        if arch in ranks.HOLD_LAYERS:  # the cut hold's depth keeps its peak
            assert r["f32_one_card_peak_bytes"] <= ranks.HOLD_PEAK_LIMIT, (arch, rank, r)
        peak = max(r["peak_bytes"])
        err = abs(plan[arch]["peak"] - peak) / peak
        assert err <= LM_PEAK_RTOL, (arch, rank, peak, plan[arch]["peak"])
        step_ms = float(np.median(r["step_s"][1:])) * 1e3
        prof = r["profiled"]
        print(f"{arch} card {rank} ({r['device']}), mesh {r['mesh']}: f32 hold "
              f"({r['f32_layers']} layers) loss {r['f32_sharded_loss']!r} vs one card "
              f"{r['f32_one_card_loss']!r}, grad norm {r['f32_sharded_grad_norm']!r} vs "
              f"{r['f32_one_card_grad_norm']!r}, one-card peak {r['f32_one_card_peak_bytes']} B; "
              f"bf16 at {r['layers']} layers: losses "
              f"{r['losses']!r} (one card {one!r}, rel {abs(first - one) / abs(one):.2e}), "
              f"grad norms {r['grad_norms']!r} (one card {g_one!r}; in f32 on the same "
              f"weights {g_f32!r}, loss {r.get('f32_one_card_bf16_weights_loss')!r}); "
              f"step_ms {step_ms:.1f} (median of steps 2-{len(r['step_s'])}, "
              f"{[round(s * 1e3, 1) for s in r['step_s']]}) "
              f"flop_bound_ms {bound_ms:.3f} (dry-run FLOPs a device over 989 TFLOP/s); "
              f"profiled step {prof['wall_ms']:.1f} ms, busy {prof['busy_ms']:.1f} ms, NCCL "
              f"{prof['nccl_ms']:.1f} ms (share {prof['nccl_ms'] / prof['wall_ms']:.3f}); "
              f"peak {peak} B vs dry run {plan[arch]['peak']} B (rel {err:.4f}); set-up peak "
              f"{r['setup_peak_bytes']} B, state {r['state_bytes']} B")


def test_lm_checkpoint_crosses_meshes_on_four_cards(lm_four_cards):
    """phi3-mini-3.8b's state after step 2, saved on its mesh, restores onto
    another four-card mesh with every gathered leaf bit for bit the saved
    one; step 3 there gives a finite loss. Prints the seconds and bytes."""
    import torch_lm_shard_ranks as ranks

    out, plan = lm_four_cards
    arch = ranks.CKPT_ARCH
    for rank in range(LM_CARDS):
        r = json.loads((out / f"cards_full_{arch}_r{rank}.json").read_text())
        assert r["restored_unequal"] == [] and r["restored_at"] == 2, r["restored_unequal"]
        assert r["restored_sharded_leaves"] > 0
        assert math.isfinite(r["restored_step_loss"])
        print(f"{arch} card {rank}: {plan[arch]['mesh']} -> {plan[arch]['other_mesh']}: "
              f"checkpoint {r['ckpt_bytes']} B saved in {r['save_s']:.2f} s, restored in "
              f"{r['restore_s']:.2f} s, {r['restored_sharded_leaves']} leaves sharded; step 3 "
              f"loss there {r['restored_step_loss']!r} (on the first mesh "
              f"{r['losses'][2]!r})")


def test_nccl_ranks_sharing_a_card_raise(dev, tmp_path):
    """Two NCCL ranks on one card: making the mesh raises on both, before
    any NCCL call; neither falls back to sharing the card."""
    import time

    import torch.multiprocessing as mp
    import torch_lm_shard_ranks as ranks

    ctx = mp.start_processes(ranks.run_shared_card, args=(2, str(tmp_path / "store"),
                                                          str(tmp_path)),
                             nprocs=2, join=False, start_method="spawn")
    deadline = time.monotonic() + 120
    for proc in ctx.processes:
        proc.join(timeout=max(0.0, deadline - time.monotonic()))
    codes = [p.exitcode for p in ctx.processes]
    for proc in ctx.processes:
        if proc.is_alive():
            proc.kill()
    assert codes == [0, 0], codes
    for r in range(2):
        msg = (tmp_path / f"shared_r{r}.txt").read_text()
        assert "are on one card" in msg, msg
