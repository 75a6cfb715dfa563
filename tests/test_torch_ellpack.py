"""ELLPACK binning of the port against the reference, on the CPU.

The port bins on the device through `kernels.ops.bin_values`; on the CPU
that is the plain version `kernels.ref.bin_values`, which the CUDA kernel
equals bit for bit on the card (`tests/test_torch_cuda.py`). Here the plain
version must equal, bit for bit, both the reference's plain version
(`repro.kernels.ref.bin_values`, float32: JAX runs without x64) and the
reference's host binning (`repro.core.ellpack.bin_batch`, which the
reference's fit path uses), for float32 and float64 input, and the page
extents and bytes of `create_ellpack_pages` must be the reference's.
Tolerance: none, every comparison is exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.ellpack import bin_batch as j_bin_batch
from repro.core.ellpack import create_ellpack_inmemory as j_inmemory
from repro.core.ellpack import create_ellpack_pages as j_pages
from repro.kernels import ref as j_ref
from repro_torch.core.ellpack import (
    Binner,
    bin_batch,
    create_ellpack_inmemory,
    create_ellpack_pages,
    rows_per_page,
)
from repro_torch.core.quantile import sketch_dense
from repro_torch.kernels import ops
from repro_torch.kernels import ref

CPU = torch.device("cpu")


def _raw(rng, n, m, dtype, missing=0.05):
    X = rng.normal(size=(n, m)).astype(dtype)
    X[rng.random((n, m)) < missing] = np.nan
    return X


def _plant_edges_and_specials(rng, X, cuts):
    """Values equal to edges, values between adjacent float32 numbers
    around an edge (for float64 input), and +-inf, -0.0, 0.0."""
    flat = X.reshape(-1)
    edges = cuts.values[np.isfinite(cuts.values)].astype(np.float64)
    k = flat.size // 4
    at = rng.choice(flat.size, k, replace=False)
    base = edges[rng.integers(0, len(edges), k)]
    if X.dtype == np.float64:
        # half an f32 ulp below/above the edge, or on it
        ulp = np.spacing(base.astype(np.float32)).astype(np.float64)
        flat[at] = base + rng.choice([-0.5, 0.0, 0.5], k) * ulp
    else:
        flat[at] = base.astype(np.float32)
    specials = np.array([np.inf, -np.inf, -0.0, 0.0], X.dtype)
    sel = rng.choice(flat.size, 8, replace=False)
    flat[sel] = specials[np.arange(8) % 4]
    return X


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n,m,max_bin", [(400, 37, 256), (257, 70, 16), (33, 2, 2), (90, 5, 64)])
def test_plain_bin_values_equals_reference_host_binning(dtype, n, m, max_bin):
    rng = np.random.default_rng(n * m + max_bin)
    X = _raw(rng, n, m, dtype)
    X[:, 0] = np.nan  # an all-missing feature: its only edge is +inf
    cuts = sketch_dense(X, max_bin)
    assert cuts.feature_edges(0).tolist() == [np.inf]
    X = _plant_edges_and_specials(rng, X, cuts)
    binner = Binner(cuts, CPU)
    got = ref.bin_values(torch.from_numpy(X), binner.edges, binner.n_bins)
    assert got.dtype == torch.uint8
    want = j_bin_batch(X, cuts)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(bin_batch(X, cuts), want)
    np.testing.assert_array_equal(ops.bin_values(torch.from_numpy(X), binner.edges,
                                                 binner.n_bins).numpy(), want)


def test_float64_input_is_compared_in_float64():
    """A value half an f32 ulp above an edge bins above it (as numpy's
    float64 searchsorted does); cast to float32 first it would land on it."""
    X = np.array([[0.0], [1.0], [2.0], [3.0]], np.float64)
    cuts = sketch_dense(X, 8)
    e = np.float64(cuts.values[1])
    above = e + 0.5 * np.spacing(np.float32(e))
    assert np.float32(above) == np.float32(e)
    Q = np.array([[e], [above]], np.float64)
    binner = Binner(cuts, CPU)
    got = binner.to_host(Q)
    np.testing.assert_array_equal(got, j_bin_batch(Q, cuts))
    assert got[1, 0] == got[0, 0] + 1
    np.testing.assert_array_equal(
        binner.to_host(Q.astype(np.float32)), j_bin_batch(Q.astype(np.float32), cuts)
    )


@pytest.mark.parametrize("n,m,max_bin", [(300, 13, 32), (64, 40, 255)])
def test_plain_bin_values_equals_reference_plain_version(n, m, max_bin):
    rng = np.random.default_rng(7 + m)
    X = _raw(rng, n, m, np.float32)
    cuts = sketch_dense(X, max_bin)
    X = _plant_edges_and_specials(rng, X, cuts)
    width = cuts.max_n_bins
    padded, nb = cuts.padded_edges(width), cuts.n_bins_per_feature
    want = np.asarray(j_ref.bin_values(jnp.asarray(X), jnp.asarray(padded), jnp.asarray(nb)))
    got = ref.bin_values(torch.from_numpy(X), torch.from_numpy(padded), torch.from_numpy(nb))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int64, np.float16])
def test_binner_chunks_by_page_rows(dtype):
    """Raw rows cross in chunks of one page's rows; the result is the
    reference's host binning whatever the input type."""
    rng = np.random.default_rng(3)
    X = (rng.normal(size=(250, 9)) * 20).astype(dtype)
    cuts = sketch_dense(X.astype(np.float64), 32)
    binner = Binner(cuts, CPU, page_bytes=9 * 40)
    assert binner.chunk_rows == rows_per_page(9, 9 * 40) == 40
    want = j_bin_batch(X, cuts)
    np.testing.assert_array_equal(binner.to_host(X), want)
    dev = binner.to_device(X)
    assert dev.dtype == torch.uint8 and dev.device == CPU
    np.testing.assert_array_equal(dev.numpy(), want)


@pytest.mark.parametrize("batch_rows,page_bytes", [(100, 8 * 64), (37, 8 * 64), (500, 8 * 1000),
                                                   (64, 8 * 64)])
def test_create_ellpack_pages_matches_reference_extents(batch_rows, page_bytes):
    rng = np.random.default_rng(batch_rows)
    X = _raw(rng, 500, 8, np.float32)
    cuts = sketch_dense(X, 32)
    batches = [X[i : i + batch_rows] for i in range(0, 500, batch_rows)]
    got = list(create_ellpack_pages(iter(batches), cuts, page_bytes, device=CPU))
    want = list(j_pages(iter(batches), cuts, page_bytes))
    assert [(p.row_offset, p.n_rows, p.nbytes) for p in got] == [
        (p.row_offset, p.n_rows, p.nbytes) for p in want
    ]
    for a, b in zip(got, want):
        assert a.bins.dtype == np.uint8
        np.testing.assert_array_equal(a.bins, b.bins)


def test_create_ellpack_inmemory_matches_reference():
    rng = np.random.default_rng(5)
    X = _raw(rng, 300, 6, np.float32, missing=0.1)
    got, want = create_ellpack_inmemory(X, 64, device=CPU), j_inmemory(X, 64)
    for f in ("values", "ptrs", "min_vals"):
        np.testing.assert_array_equal(getattr(got.cuts, f), getattr(want.cuts, f))
    np.testing.assert_array_equal(got.single_page().bins, want.single_page().bins)
    assert got.n_rows == want.n_rows == 300


def test_binning_needs_cuda_unless_cpu_is_asked(monkeypatch):
    X = np.zeros((4, 2), np.float32)
    cuts = sketch_dense(X, 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from repro_torch.data.dmatrix import ArrayDMatrix

    with pytest.raises(RuntimeError, match="device='cpu'"):
        ArrayDMatrix(X, np.zeros(4), cuts=cuts)
