"""DMatrix: the data surface for every training mode (paper §1 claim).

Counterpart of `repro.data.dmatrix`. The user hands `GradientBooster.fit`
one DMatrix-shaped object and the `ExecutionPolicy` decides how it trains:

  `ArrayDMatrix`   in-memory ndarrays, quantised whole (Alg. 2+4); can still
                   re-page itself for out-of-core passes, so one matrix
                   serves every mode with the same bins;
  `IterDMatrix`    XGBoost `DataIter`-style batch source: two passes over
                   the batches — the incremental quantile sketch on the host
                   (Alg. 3), then quantisation on the device into
                   fixed-budget ELLPACK pages (Alg. 5), copied back as uint8
                   and spilled to a `PageStore` (disk) or kept in host RAM;
  `PagedDMatrix`   reopens an on-disk page cache written by either
                   package's `IterDMatrix` without touching raw data.

Binning runs on the DMatrix's ``device`` ("cuda" unless the caller passes
"cpu"), through the CUDA binning kernel for a CUDA device; the bins it keeps
are host uint8 pages, equal bit for bit to the reference's. `PageSet`, the
external ELLPACK view every streaming consumer iterates, lives here too.
Pages stay uint8 on the device: the kernels read uint8 (the reference
widens them to int32).
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Iterable, Iterator

import numpy as np
import torch

from repro_torch.core.ellpack import (
    DEFAULT_PAGE_BYTES,
    EllpackMatrix,
    EllpackPage,
    create_ellpack_inmemory,
    create_ellpack_pages,
    rows_per_page,
)
from repro_torch.core.quantile import HistogramCuts, QuantileSketch
from repro_torch.compress import EncodedPage, make_transport
from repro_torch.data.pages import PageStore, TransferStats
from repro_torch.pipeline import DevicePageCache, PageStream

_META_FILE = "dmatrix.npz"


def _resolve(device) -> torch.device:
    from repro_torch.core.booster import resolve_device

    return resolve_device(device)


def _bins_to_host_array(page: EllpackPage) -> np.ndarray | EncodedPage:
    """The host array a page stages: its uint8 bins, or the payload as its
    codec stored it (an `EncodedPage`, which the stream's transport of the
    same codec stages without a host decode)."""
    if isinstance(page.bins, EncodedPage):
        return page.bins
    return np.ascontiguousarray(page.bins)


@dataclasses.dataclass
class PageSet:
    """The external ELLPACK matrix: pages either on disk or in host RAM."""

    store: PageStore | None
    host_pages: list[EllpackPage] | None
    row_offsets: list[int]
    n_rows: int
    num_features: int
    stats: TransferStats

    @property
    def n_pages(self) -> int:
        return len(self.row_offsets)

    @property
    def page_extents(self) -> list[tuple[int, int]]:
        """(row_offset, n_rows) per page, derivable without touching the disk."""
        ends = list(self.row_offsets[1:]) + [self.n_rows]
        return [(ro, end - ro) for ro, end in zip(self.row_offsets, ends)]

    def stream(
        self,
        device: str | torch.device = "cuda",
        prefetch_depth: int = 2,
        staging_depth: int = 2,
        cache: DevicePageCache | None = None,
        retry=None,
        codec: str | None = None,
        cache_tag: str = "page",
        stats: TransferStats | None = None,
        indices: Iterable[int] | None = None,
    ) -> PageStream:
        """One pass of the pipeline engine over every page onto ``device``, or
        over the pages ``indices`` only (each keeps its global index, so
        per-page state keyed by it stays valid: the page-skipping passes of
        lossguide builds).

        ``retry`` is the prefetcher's `RetryPolicy` (None = its defaults).
        ``codec`` names a `repro_torch.compress` page codec: a device-
        decodable one (``"bitpack"``) stages the packed wire payload and the
        bitpack decode kernel expands it on the device (pages the store
        wrote with that codec stage as stored, with no host decode);
        anything else stages uncompressed. ``cache_tag`` namespaces this matrix's
        pages inside a shared ``cache``, which one serving cache that
        outlives a matrix needs (colliding keys would return another
        matrix's rows). ``stats`` redirects the pass's ledger entries
        (default: the page set's own `TransferStats`), so that the serving
        engine books row pages and forest chunks in one ledger.
        """
        common = dict(
            to_array=_bins_to_host_array,
            device=device,
            stats=stats if stats is not None else self.stats,
            prefetch_depth=prefetch_depth,
            staging_depth=staging_depth,
            cache=cache,
            cache_tag=cache_tag,
            retry=retry,
            transport=make_transport(codec),
        )
        if self.host_pages is not None:
            return PageStream.from_host_pages(self.host_pages, indices=indices, **common)

        def wrap(idx: int, arrays: dict) -> EllpackPage:
            return EllpackPage(bins=arrays["bins"], row_offset=self.row_offsets[idx])

        return PageStream.from_store(self.store, wrap, indices=indices, **common)

    def iter_pages(self, prefetch_depth: int = 2) -> Iterator[tuple[int, EllpackPage]]:
        """Host-side pass (no device staging); disk pages go through the prefetcher."""
        yield from self.stream(device="cpu", prefetch_depth=prefetch_depth).iter_host()

    def stage(
        self,
        page: EllpackPage,
        device: str | torch.device = "cuda",
        codec: str | None = None,
    ) -> torch.Tensor:
        """Host -> device copy of one page ("CopyToGPU"), booked in the page
        set's `TransferStats`; a device-decodable ``codec`` sends the packed
        payload and decodes it on ``device``."""
        transport = make_transport(codec)
        arr = _bins_to_host_array(page)
        t0 = time.perf_counter()
        if transport is not None:
            wire, wire_meta = transport.encode(arr)
            out = transport.decode(torch.from_numpy(wire).to(device), wire_meta)
            wire_nbytes = wire.nbytes
        else:
            out = torch.from_numpy(arr).to(device)
            wire_nbytes = arr.nbytes
        dt = time.perf_counter() - t0
        self.stats.host_to_device_bytes += wire_nbytes
        self.stats.logical_bytes += arr.nbytes
        self.stats.wire_bytes += wire_nbytes
        # a lone synchronous copy overlaps nothing: book equal stage and wall
        # time so it cannot inflate overlap_ratio
        self.stats.stream_stage_seconds += dt
        self.stats.stream_wall_seconds += dt
        return out


class DMatrix:
    """Quantised training data (host side) with one surface for every mode.

    Concrete sources own their `HistogramCuts`, labels and paging; because
    the cuts belong to the matrix, the same DMatrix trains with the same
    bins in every mode.
    """

    cuts: HistogramCuts
    labels: np.ndarray | None
    stats: TransferStats
    page_bytes: int
    n_bins: int

    @property
    def n_rows(self) -> int:
        raise NotImplementedError

    @property
    def num_features(self) -> int:
        return self.cuts.num_features

    @property
    def n_pages(self) -> int:
        return self.page_set().n_pages

    def estimated_device_bytes(self) -> int:
        """Bytes of the quantised matrix staged whole (dense uint8 ELLPACK)."""
        return self.n_rows * self.num_features

    def page_set(self) -> PageSet:
        """The paged (external-memory) view of this matrix."""
        raise NotImplementedError

    def single_page_bins(self) -> np.ndarray:
        """The whole quantised matrix as one (n_rows, m) uint8 array."""
        raise NotImplementedError

    def require_labels(self) -> np.ndarray:
        if self.labels is None:
            raise ValueError(
                f"{type(self).__name__} has no labels; construct it with y "
                "(or a batch source yielding (X, y)) before calling fit"
            )
        return self.labels


class ArrayDMatrix(DMatrix):
    """In-memory ndarrays quantised whole (Alg. 2+4) on ``device``, pageable
    on demand: `page_set()` re-pages the bins into `page_bytes` host chunks,
    so a forced out-of-core run over the same object streams the same bins."""

    def __init__(
        self,
        X: np.ndarray,
        y: np.ndarray | None = None,
        *,
        max_bin: int = 256,
        cuts: HistogramCuts | None = None,
        page_bytes: int = DEFAULT_PAGE_BYTES,
        stats: TransferStats | None = None,
        device: str | torch.device = "cuda",
    ):
        X = np.asarray(X)
        if X.ndim != 2:
            raise ValueError(f"X must be 2-D (n_rows, num_features); got shape {X.shape}")
        self.n_bins = min(max_bin, 255)
        self._ell: EllpackMatrix = create_ellpack_inmemory(
            X, max_bin=self.n_bins, cuts=cuts, device=_resolve(device), page_bytes=page_bytes
        )
        self.cuts = self._ell.cuts
        self.labels = None if y is None else np.asarray(y, np.float32)
        if self.labels is not None and self.labels.shape[0] != X.shape[0]:
            raise ValueError(f"len(y)={self.labels.shape[0]} != n_rows={X.shape[0]}")
        self.page_bytes = page_bytes
        self.stats = stats if stats is not None else TransferStats()
        self._page_set: PageSet | None = None

    @property
    def n_rows(self) -> int:
        return self._ell.n_rows

    def single_page_bins(self) -> np.ndarray:
        return self._ell.single_page().bins

    def page_set(self) -> PageSet:
        if self._page_set is None:
            bins = self.single_page_bins()
            rpp = rows_per_page(self.num_features, self.page_bytes)
            pages = [
                EllpackPage(np.ascontiguousarray(bins[lo : lo + rpp]), lo)
                for lo in range(0, max(self.n_rows, 1), rpp)
            ]
            self._page_set = PageSet(
                store=None,
                host_pages=pages,
                row_offsets=[p.row_offset for p in pages],
                n_rows=self.n_rows,
                num_features=self.num_features,
                stats=self.stats,
            )
        return self._page_set


def _as_batch_callback(source: Any) -> Callable[[], Iterable[tuple]]:
    """Normalise a batch source to a re-invocable zero-arg callback: a
    zero-arg callable returning (X, y) batches, an object with
    `iter_batches()`, or a list/tuple of (X, y) pairs. One-shot generators
    are rejected: quantisation needs two passes (sketch, then binning)."""
    if callable(source):
        return source
    if hasattr(source, "iter_batches"):
        return source.iter_batches
    if isinstance(source, (list, tuple)):
        return lambda: iter(source)
    raise TypeError(
        "IterDMatrix needs a re-iterable batch source: a zero-arg callable "
        "returning (X, y) batches, an object with iter_batches(), or a list of "
        f"(X, y) pairs — got {type(source).__name__} (one-shot generators "
        "cannot be re-wound for the second quantisation pass)"
    )


class IterDMatrix(DMatrix):
    """Batch source quantised incrementally and spilled to pages.

    Two passes over the batches (the callback is re-invoked per pass, so it
    must be re-iterable): first the incremental quantile sketch + label
    gather on the host (Alg. 3), then quantisation on ``device`` into
    ~``page_bytes`` uint8 ELLPACK pages (Alg. 5), copied back and written
    through a `PageStore` when ``cache_dir`` is given (disk spill, reopenable
    later via either package's `PagedDMatrix`) or kept as host-RAM pages.
    ``page_codec`` names a lossless `repro_torch.compress` codec applied to
    each page blob on disk (recorded per page in the manifest, so the cache
    reopens with either package's reader); ``compress`` zstd-frames the
    blobs when `zstandard` is installed.
    """

    def __init__(
        self,
        source: Any,
        *,
        max_bin: int = 256,
        cuts: HistogramCuts | None = None,
        cache_dir: str | None = None,
        page_bytes: int = DEFAULT_PAGE_BYTES,
        compress: bool = False,
        page_codec: str = "raw",
        stats: TransferStats | None = None,
        device: str | torch.device = "cuda",
    ):
        batches = _as_batch_callback(source)
        device = _resolve(device)
        self.n_bins = min(max_bin, 255)
        self.page_bytes = page_bytes
        self.cache_dir = cache_dir
        self.stats = stats if stats is not None else TransferStats()
        store = None
        if cache_dir is not None:
            store = PageStore(cache_dir, compress=compress, stats=self.stats, codec=page_codec)

        # pass 1 (Alg. 3): incremental sketch + labels, raw data never
        # resident; explicit cuts pin the quantisation and skip the sketch,
        # but labels/row counts still need the pass
        sketch: QuantileSketch | None = None
        saw_batch = False
        labels: list[np.ndarray] = []
        n_rows = 0
        for X_batch, y_batch in batches():
            X_batch = np.asarray(X_batch)
            saw_batch = True
            if cuts is None:
                if sketch is None:
                    sketch = QuantileSketch(X_batch.shape[1], max_bin=self.n_bins)
                sketch.update(X_batch)
            n_rows += X_batch.shape[0]
            if y_batch is not None:
                labels.append(np.asarray(y_batch, np.float32))
        if not saw_batch:
            raise ValueError("IterDMatrix source yielded no batches")
        self.cuts = cuts if cuts is not None else sketch.finalize()
        self.labels = np.concatenate(labels) if labels else None
        self._n_rows = n_rows

        # pass 2 (Alg. 5): quantise on the device into fixed-budget pages
        host_pages: list[EllpackPage] | None = None if store is not None else []
        row_offsets: list[int] = []
        for page in create_ellpack_pages(
            (np.asarray(X) for X, _ in batches()), self.cuts, page_bytes, device=device
        ):
            row_offsets.append(page.row_offset)
            if store is not None:
                store.write_page(
                    {"bins": page.bins},
                    {"row_offset": page.row_offset, "n_rows": page.n_rows},
                )
            else:
                host_pages.append(page)
        self._page_set = PageSet(
            store=store,
            host_pages=host_pages,
            row_offsets=row_offsets,
            n_rows=n_rows,
            num_features=self.cuts.num_features,
            stats=self.stats,
        )
        if store is not None:
            self._write_meta(cache_dir)

    def _write_meta(self, cache_dir: str) -> None:
        """Sidecar so `PagedDMatrix(cache_dir)` reopens without the source."""
        np.savez_compressed(
            os.path.join(cache_dir, _META_FILE),
            cut_values=self.cuts.values,
            cut_ptrs=self.cuts.ptrs,
            cut_min_vals=self.cuts.min_vals,
            labels=self.labels if self.labels is not None else np.zeros(0, np.float32),
            has_labels=np.asarray(self.labels is not None),
            n_rows=np.asarray(self._n_rows),
            n_bins=np.asarray(self.n_bins),
        )

    @property
    def n_rows(self) -> int:
        return self._n_rows

    def page_set(self) -> PageSet:
        return self._page_set

    def single_page_bins(self) -> np.ndarray:
        chunks = [np.asarray(p.bins) for _, p in self._page_set.iter_pages()]
        if not chunks:
            return np.zeros((0, self.num_features), np.uint8)
        return np.concatenate(chunks, axis=0)


class PagedDMatrix(DMatrix):
    """An existing on-disk ELLPACK page cache as a DMatrix.

    Reopens a `PageStore` directory (written by either package's
    `IterDMatrix(cache_dir=...)`, whose ``dmatrix.npz`` sidecar carries
    cuts/labels/row counts); stores written without the sidecar need
    explicit ``cuts``/``labels``, and row counts come from the manifest.
    """

    def __init__(
        self,
        cache_dir: str,
        *,
        cuts: HistogramCuts | None = None,
        labels: np.ndarray | None = None,
        stats: TransferStats | None = None,
        page_bytes: int = DEFAULT_PAGE_BYTES,
    ):
        self.stats = stats if stats is not None else TransferStats()
        self.page_bytes = page_bytes
        store = PageStore(cache_dir, stats=self.stats)
        if store.n_pages == 0:
            raise ValueError(f"no pages found in {cache_dir!r}")
        meta_path = os.path.join(cache_dir, _META_FILE)
        n_rows = n_bins = None
        if os.path.exists(meta_path):
            data = np.load(meta_path)
            if cuts is None:
                cuts = HistogramCuts(
                    values=data["cut_values"],
                    ptrs=data["cut_ptrs"],
                    min_vals=data["cut_min_vals"],
                )
            if labels is None and bool(data["has_labels"]):
                labels = data["labels"]
            n_rows = int(data["n_rows"])
            n_bins = int(data["n_bins"])
        if cuts is None:
            raise ValueError(
                f"{cache_dir!r} has no {_META_FILE} sidecar; pass cuts= (and "
                "labels=) explicitly to reopen a bare page store"
            )
        self.cuts = cuts
        self.labels = None if labels is None else np.asarray(labels, np.float32)
        self.n_bins = n_bins if n_bins is not None else max(int(cuts.max_n_bins), 1)

        row_offsets = [int(store.page_meta(i)["row_offset"]) for i in range(store.n_pages)]
        if n_rows is None:
            last = store.page_meta(store.n_pages - 1)
            last_rows = last.get("n_rows")
            if last_rows is None:  # legacy store: one read recovers the count
                last_rows = store.read_page(store.n_pages - 1)["bins"].shape[0]
            n_rows = row_offsets[-1] + int(last_rows)
        self._page_set = PageSet(
            store=store,
            host_pages=None,
            row_offsets=row_offsets,
            n_rows=n_rows,
            num_features=self.cuts.num_features,
            stats=self.stats,
        )

    @property
    def n_rows(self) -> int:
        return self._page_set.n_rows

    def page_set(self) -> PageSet:
        return self._page_set

    def single_page_bins(self) -> np.ndarray:
        chunks = [np.asarray(p.bins) for _, p in self._page_set.iter_pages()]
        return np.concatenate(chunks, axis=0)


def as_dmatrix(
    data: Any,
    y: np.ndarray | None = None,
    *,
    max_bin: int = 256,
    cuts: HistogramCuts | None = None,
    page_bytes: int = DEFAULT_PAGE_BYTES,
    stats: TransferStats | None = None,
    device: str | torch.device = "cuda",
) -> DMatrix:
    """Coerce what the user handed `fit` into a DMatrix, binning on
    ``device``: a DMatrix is itself; an ndarray (+ y) or an ``(X, y)`` pair
    becomes an `ArrayDMatrix`; a batch source (iter_batches / callable /
    list of pairs) becomes an `IterDMatrix` with host-RAM pages."""
    if isinstance(data, DMatrix):
        if y is not None:
            raise ValueError("pass labels when constructing the DMatrix, not to fit()")
        return data
    kw = dict(max_bin=max_bin, cuts=cuts, page_bytes=page_bytes, stats=stats, device=device)
    if isinstance(data, np.ndarray) or (
        hasattr(data, "__array__") and not hasattr(data, "iter_batches") and not callable(data)
    ):
        return ArrayDMatrix(data, y, **kw)
    if isinstance(data, tuple) and len(data) == 2 and y is None:
        return ArrayDMatrix(data[0], data[1], **kw)
    return IterDMatrix(data, **kw)
