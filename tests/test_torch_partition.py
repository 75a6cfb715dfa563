"""The port's fused partition + level counts against the reference on the CPU.

`repro_torch.kernels.ops.partition_rows(..., count_level, counts)` repartitions
the rows and adds the rows per node of the next level's window into
``counts`` in the same pass (on a CPU tensor, the plain version in
`repro_torch.kernels.ref`, which the CUDA kernel equals bit for bit on the
card). Here it is held against the reference's two separate steps: the
positions against `repro.kernels.ref.partition_rows` and its Pallas kernel
(`interpret=True`), the counts against `repro.core.histcache.level_row_counts`
of those positions. Everything is integer, so every comparison is exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.histcache import level_row_counts as j_level_row_counts
from repro.kernels import ref as jref
from repro.kernels.partition import partition_rows as part_pl
from repro_torch.core.histcache import new_level_counts
from repro_torch.kernels import ops

MISSING = 255


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _level_inputs(rng, n, m, depth, bin_dtype, n_bins=32):
    """Bins, a complete tree of depth ``depth + 1`` and rows at level
    ``depth``: 10% inactive (-1), 10% frozen at leaves of shallower levels."""
    n_nodes = 2 ** (depth + 2) - 1
    bins = rng.integers(0, n_bins, (n, m)).astype(bin_dtype)
    bins[rng.random((n, m)) < 0.07] = MISSING
    feat = rng.integers(0, m, n_nodes).astype(np.int32)
    sb = rng.integers(0, n_bins, n_nodes).astype(np.int32)
    dl = rng.random(n_nodes) < 0.5
    lf = rng.random(n_nodes) < 0.2
    lo = 2**depth - 1
    pos = rng.integers(lo, 2 * lo + 1, n).astype(np.int32)
    if depth:
        frozen = rng.random(n) < 0.1
        pos[frozen] = rng.integers(0, lo, int(frozen.sum()))
        lf[pos[frozen]] = True
    pos[rng.random(n) < 0.1] = -1
    return bins, pos, feat, sb, dl, lf


# (depth of the partitioned level, window offset, window count): whole next
# levels, windows of 1, 2, 64 and 4,096 nodes, 65 (the reference counts by
# compare-and-sum up to 64 nodes and by scatter above), a window reaching
# down into the frozen rows of the level before, half a level, and an
# offset no row reaches
WINDOWS = [
    (0, 1, 1), (0, 1, 2), (5, 63, 64), (5, 62, 65), (6, 127, 64), (11, 4095, 4096),
    (3, 100_000, 16),
]


@pytest.mark.parametrize("bin_dtype", [np.uint8, np.int32])
@pytest.mark.parametrize("depth,offset,count", WINDOWS)
def test_fused_partition_counts_match_reference(depth, offset, count, bin_dtype):
    rng = np.random.default_rng(depth * 1000 + count)
    n = 700 if depth > 8 else 2000
    bins, pos, feat, sb, dl, lf = _level_inputs(rng, n, 6, depth, bin_dtype)
    base = rng.integers(0, 50, count).astype(np.int32)  # counts are added into
    counts = _t(base.copy())
    got = ops.partition_rows(*(_t(a) for a in (bins, pos, feat, sb, dl, lf)),
                             (offset, count), counts).numpy()
    jargs = tuple(jnp.asarray(a) for a in (bins.astype(np.int32), pos, feat, sb, dl, lf))
    want = np.asarray(jref.partition_rows(*jargs))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(part_pl(*jargs, interpret=True)))
    want_counts = np.asarray(j_level_row_counts(jnp.asarray(want), offset, count))
    np.testing.assert_array_equal(counts.numpy() - base, want_counts)
    if offset >= 2 ** (depth + 2):  # past every child id: no position reaches it
        assert not want_counts.any()
    else:
        assert want_counts.any()


def test_counts_accumulate_over_pages():
    """One counts buffer passed to every page of a level equals the counts of
    the concatenated positions; each page's positions equal the whole call's."""
    rng = np.random.default_rng(3)
    bins, pos, feat, sb, dl, lf = _level_inputs(rng, 1500, 5, 4, np.uint8)
    tree = tuple(_t(a) for a in (feat, sb, dl, lf))
    window = (31, 32)
    counts = new_level_counts(window, torch.device("cpu"))
    pages = []
    for lo, hi in ((0, 512), (512, 1024), (1024, 1500)):
        pages.append(ops.partition_rows(_t(bins[lo:hi]), _t(pos[lo:hi]), *tree, window, counts))
    whole = ops.partition_rows(_t(bins), _t(pos), *tree)
    assert torch.equal(torch.cat(pages), whole)
    want = np.asarray(j_level_row_counts(jnp.asarray(whole.numpy()), *window))
    np.testing.assert_array_equal(counts.numpy(), want)
    assert counts.sum() == ((whole >= 31) & (whole < 63)).sum()


def test_count_window_arguments_are_checked():
    bins = torch.zeros((4, 2), dtype=torch.uint8)
    pos = torch.zeros(4, dtype=torch.int32)
    tree = (torch.zeros(3, dtype=torch.int32), torch.zeros(3, dtype=torch.int32),
            torch.zeros(3, dtype=torch.bool), torch.zeros(3, dtype=torch.bool))
    with pytest.raises(ValueError, match="together"):
        ops.partition_rows(bins, pos, *tree, (1, 2))
    with pytest.raises(ValueError, match="together"):
        ops.partition_rows(bins, pos, *tree, None, torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="shape"):
        ops.partition_rows(bins, pos, *tree, (1, 2), torch.zeros(3, dtype=torch.int32))
    with pytest.raises(TypeError, match="dtype"):
        ops.partition_rows(bins, pos, *tree, (1, 2), torch.zeros(2, dtype=torch.int64))
    with pytest.raises(ValueError, match="window"):
        ops.partition_rows(bins, pos, *tree, (1, 0), torch.zeros(0, dtype=torch.int32))
    assert new_level_counts(None, "cpu") is None
