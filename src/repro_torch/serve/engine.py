"""Out-of-core forest serving: stream rows, stream trees, never OOM.

Counterpart of `repro.serve.engine`. Two independent axes can exceed the
device budget at prediction time, and both page through the same
`repro_torch.pipeline.PageStream` engine training uses:

  rows    a `PagedDMatrix` (or any DMatrix) streams its uint8 ELLPACK pages
          with prefetch and double-buffered staging onto the forest's
          device; each page gets one fused whole-forest launch (the CUDA
          forest kernel on the card) and its margins land in a host array;
  trees   a forest larger than the device budget is split into tree-chunks
          (`PackedForest.pack_page`: one f32 ndarray a chunk, the page shape
          PageStream stages); chunks apply in ascending tree order with each
          row page's margin chained chunk to chunk through
          ``ops.predict_forest(..., margin_in)``, so the partial sums add in
          exactly the in-core forest's order: bit for bit.

Shared-budget residency
-----------------------
Without residency the paged-forest transfer bill is chunks x pages: every
chunk pass re-streams every row page. One `DevicePageCache` governs both
sides under a single byte budget (`DeviceMemoryModel.serve_residency_budget`):

  pin tier   a prefix of forest tree-chunks is staged once and pinned —
             never evicted, not even by row-page pressure. Every pinned
             chunk shares one row-page pass with the other pins, deleting
             one full row-page re-stream from the chunks x pages bill;
  LRU tier   row pages and the non-resident chunk remainder compete for
             what the pins left.

The remainder still streams, with the loop order chosen to minimise modeled
h2d bytes: "chunks outer" costs F + max(R,1)*D (pinned chunks and the first
streamed chunk share one data pass; R-1 more passes follow), "pages outer"
costs D + F_pin + P*F_rem (rows once, remainder chunks once a page). Both
orders apply chunks in ascending tree order per row, so residency only ever
skips transfers and every mode stays bit for bit the resident forest.

Every `PageStream` pass on the card ends with a synchronise, so a cached
chunk or page (allocated on an earlier pass's copy stream, returned by a hit
with no ready event) is always complete before a later pass reads it. In
"pages outer" a forest pass nests inside each row page; the row page stays
referenced (and `record_stream`-ed on the compute stream) until its last
chunk's launch has been queued.

Page codecs (`repro_torch.compress`) ride both axes: ``page_codec`` stages
row pages through the codec's transport (``"bitpack"`` copies packed pages
and the bitpack decode kernel expands them), and any non-raw codec sends
forest tree-chunks through `ForestPageTransport` (14 wire bytes a node
against 24, decoded on the device). Both are lossless, so every mode stays
bit for bit.

`ForestServer` bundles a packed forest with this machinery (and a persistent
residency cache, so pins survive across requests) behind
``predict``/``predict_margin``; `GradientBooster.predict` delegates here for
DMatrix inputs. There is no ``impl`` switch: the forest's device picks the
CUDA kernels or their plain versions.
"""
from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch

from repro_torch.compress import ForestPageTransport, get_codec
from repro_torch.core import objectives as obj_lib
from repro_torch.core.memory import DeviceMemoryModel
from repro_torch.data.pages import TransferStats
from repro_torch.kernels import ops
from repro_torch.pipeline import DevicePageCache, PageStream
from repro_torch.serve.batcher import ServeStats
from repro_torch.serve.forest import PackedForest

_ROWS_TAG_COUNTER = itertools.count()


def _rows_tag(dm) -> str:
    """A cache-key namespace unique to this matrix object for its lifetime.

    The serving residency cache outlives any one request; two matrices both
    cached under the default ``("page", idx)`` keys would alias and return
    the wrong rows. The tag rides on the matrix itself (not ``id()``, which
    the allocator recycles), so repeat requests over the same matrix hit."""
    tag = getattr(dm, "_residency_rows_tag", None)
    if tag is None:
        tag = f"rows/{next(_ROWS_TAG_COUNTER)}"
        dm._residency_rows_tag = tag
    return tag


def _chunk_extents(forest: PackedForest, trees_per_chunk: int) -> list[tuple[int, int]]:
    return [
        (lo, min(lo + trees_per_chunk, forest.n_trees))
        for lo in range(0, forest.n_trees, trees_per_chunk)
    ]


def chunk_bytes(forest: PackedForest, trees_per_chunk: int) -> list[int]:
    """Staged bytes of each tree-chunk page: `pack_page`'s planes, the byte
    model's `DeviceMemoryModel.forest_node_bytes` a node."""
    node = DeviceMemoryModel().forest_node_bytes
    return [
        node * (hi - lo) * forest.n_total
        for lo, hi in _chunk_extents(forest, trees_per_chunk)
    ]


def _forest_stream(
    forest: PackedForest,
    trees_per_chunk: int,
    stats: TransferStats,
    staging_depth: int = 2,
    transport: ForestPageTransport | None = None,
    cache: DevicePageCache | None = None,
    pin: bool = False,
    indices=None,
) -> PageStream:
    """The forest's tree-chunks as a PageStream onto the forest's device
    (host RAM pages, double-buffered staging: chunk k+1's copy overlaps
    chunk k's traversal).

    Chunks pack lazily (`pack_page` runs per fetch), and a chunk whose key is
    pinned in ``cache`` skips the host pack entirely — pinned entries can
    never be evicted, so the staged lookup is guaranteed to hit. The cache
    tag carries the chunk size (``forest/<k>``): chunk geometry is part of a
    chunk's identity, so differently-sized passes can never alias. With a
    `ForestPageTransport`, each staged chunk crosses as a 14-byte/node wire
    payload and decodes to the unpacked field dict on the device.
    """
    extents = _chunk_extents(forest, trees_per_chunk)
    tag = f"forest/{trees_per_chunk}"

    def fetch(idx: int):
        if cache is not None and cache.is_pinned((tag, idx)):
            return None  # guaranteed staged hit: the pack cost is skippable
        lo, hi = extents[idx]
        return forest.pack_page(lo, hi)

    return PageStream(
        fetch,
        indices if indices is not None else range(len(extents)),
        device=forest.device, stats=stats, cache_tag=tag, cache_pin=pin,
        staging_depth=staging_depth, cache=cache, transport=transport,
    )


def _forest_transport(page_codec: str | None) -> ForestPageTransport | None:
    """The forest wire packer when any non-raw page codec is active: the
    paged forest's chunks ride the same compression policy as row pages."""
    if page_codec is None or get_codec(page_codec).name == "raw":
        return None
    return ForestPageTransport()


def _chunk_arrays(fp_device) -> dict:
    """Unpacked per-field device tensors of one staged forest chunk: already
    a dict when a transport decoded it on the device."""
    if isinstance(fp_device, dict):
        return fp_device
    return PackedForest.unpack_page(fp_device)


def resolve_trees_per_chunk(
    forest: PackedForest,
    batch_rows: int,
    model: DeviceMemoryModel | None,
    trees_per_chunk: int | None,
) -> int | None:
    """How many trees fit per launch — None means the whole forest does.

    An explicit ``trees_per_chunk`` wins (0/None-model means never page);
    otherwise the byte model decides, mirroring how `ExecutionPolicy` picks
    the training mode from the same `DeviceMemoryModel`. ``batch_rows`` is
    whatever `DeviceMemoryModel.serve_batch_rows` resolved — the measured
    launch shape when a serving history exists, else the worst-case page.
    """
    if trees_per_chunk is not None:
        return trees_per_chunk if trees_per_chunk < forest.n_trees else None
    if model is None:
        return None
    depth = forest.max_depth
    resident = model.max_trees_resident(batch_rows, max_depth=depth)
    if resident >= forest.n_trees:
        return None
    if resident < 1:
        raise ValueError(
            f"serving byte model fits no tree at all: batch_rows={batch_rows} "
            f"rows leave {model.hbm_bytes} bytes short of one depth-{depth} "
            "tree; shrink the batch or raise the budget"
        )
    return resident


# --------------------------------------------------------- residency planning
@dataclasses.dataclass(frozen=True)
class ResidencyPlan:
    """One paged-forest pass's residency decisions (pure byte-model output).

    ``n_pinned`` chunks form the pinned prefix; ``order`` is the loop nesting
    that minimises modeled h2d bytes for the remainder. ``bytes_chunks_outer``
    /``bytes_pages_outer`` keep the model's arithmetic inspectable, and
    ``baseline_bytes`` is the unpinned chunks x pages bill."""

    n_chunks: int
    n_pinned: int
    order: str  # "chunks_outer" | "pages_outer"
    bytes_chunks_outer: int
    bytes_pages_outer: int
    baseline_bytes: int  # the unpinned chunks x pages bill (F + C*D)


def plan_residency(
    chunk_bytes: list[int],
    data_bytes: int,
    n_pages: int,
    max_bytes: int | None,
    reserve_bytes: int = 0,
    pin: bool = True,
) -> ResidencyPlan:
    """Size the pinned prefix and pick the loop order from modeled bytes.

    ``chunk_bytes`` are the staged bytes of each forest chunk page,
    ``data_bytes`` the wire bytes of one full row-page pass. Pins fill the
    byte budget minus ``reserve_bytes`` (kept free so the LRU tier can still
    hold at least one row page); ``max_bytes=None`` pins everything.
    """
    n_chunks = len(chunk_bytes)
    n_pin = 0
    if pin:
        if max_bytes is None:
            n_pin = n_chunks
        else:
            avail = max_bytes - reserve_bytes
            cum = 0
            for cb in chunk_bytes:
                if cum + cb > avail:
                    break
                cum += cb
                n_pin += 1
    F = sum(chunk_bytes)
    F_pin = sum(chunk_bytes[:n_pin])
    F_rem = F - F_pin
    R = n_chunks - n_pin
    # chunks outer: the pinned prefix (plus the first streamed chunk, if any)
    # shares ONE row-page pass; each further remainder chunk re-streams the
    # rows — every pinned chunk deletes one full data pass from the bill
    bytes_a = F + max(R, 1) * data_bytes
    # pages outer: rows stream once, pins stage once, the remainder re-stages
    # per page
    bytes_b = data_bytes + F_pin + n_pages * F_rem
    order = "chunks_outer" if bytes_a <= bytes_b else "pages_outer"
    return ResidencyPlan(
        n_chunks=n_chunks, n_pinned=n_pin, order=order,
        bytes_chunks_outer=bytes_a, bytes_pages_outer=bytes_b,
        baseline_bytes=F + n_chunks * data_bytes,
    )


def _pin_prologue(forest, chunk, n_pin, stats, transport, cache) -> None:
    """Stage chunks [0, n_pin) into the cache's pinned tier (all-hit when a
    previous request already pinned them)."""
    if n_pin <= 0:
        return
    for _ in _forest_stream(
        forest, chunk, stats, staging_depth=1, transport=transport, cache=cache,
        pin=True, indices=range(n_pin),
    ):
        pass


def _apply_chunk(forest: PackedForest, arrays: dict, bins, margin):
    """``margin`` plus the chunk's trees, one forest launch."""
    return ops.predict_forest(
        bins, arrays["feature"], arrays["split_bin"], arrays["default_left"],
        arrays["is_leaf"], arrays["leaf_value"], forest.max_depth,
        forest.learning_rate, margin,
    )


def predict_margin_dmatrix(
    forest: PackedForest,
    dm,
    *,
    model: DeviceMemoryModel | None = None,
    trees_per_chunk: int | None = None,
    prefetch_depth: int = 2,
    staging_depth: int = 2,
    stats: TransferStats | None = None,
    page_codec: str | None = None,
    cache: DevicePageCache | None = None,
    pin_chunks: bool | None = None,
    serve_budget_bytes: int | None = None,
    serve_stats: ServeStats | None = None,
) -> np.ndarray:
    """Margins for every row of a DMatrix, streaming pages (and tree-chunks)
    onto the forest's device.

    Bit for bit the fused forest over `single_page_bins()`: row pages
    partition the batch (per-row work is independent) and tree-chunks chain
    their partial margins in ascending tree order — residency only skips
    transfers, never reorders accumulation. ``page_codec`` (a
    `repro_torch.compress` codec) shrinks row-page and forest-chunk
    transfers; the codecs are lossless.

    ``cache``/``pin_chunks``/``serve_budget_bytes`` activate the shared-budget
    residency layer (see the module docstring); ``pin_chunks=None`` means
    "pin when a budget is known" and ``False`` forces the legacy re-streaming
    path. ``serve_stats`` receives the residency ledger (chunk hits/misses,
    h2d bytes per request) and supplies the measured launch shape that
    `DeviceMemoryModel.serve_batch_rows` sizes chunks with.
    """
    pages = dm.page_set()
    stats = stats if stats is not None else pages.stats
    margins = np.full(pages.n_rows, forest.base_margin, np.float32)
    if pages.n_rows == 0:
        return margins
    dev = forest.device
    extents = pages.page_extents
    worst_rows = max(nr for _, nr in extents)
    measured = serve_stats.max_launch_rows if serve_stats is not None else None
    if model is not None:
        batch_rows = model.serve_batch_rows(worst_rows, measured)
    else:
        batch_rows = measured or worst_rows
    chunk = resolve_trees_per_chunk(forest, batch_rows, model, trees_per_chunk)

    residency = pin_chunks is not False and (
        cache is not None or serve_budget_bytes is not None
        or model is not None or pin_chunks is True
    )
    h2d0 = stats.host_to_device_bytes
    if residency and cache is None:
        budget = serve_budget_bytes
        if budget is None and model is not None:
            budget = model.serve_residency_budget(batch_rows)
        n_chunks = len(_chunk_extents(forest, chunk)) if chunk else 0
        cache = DevicePageCache(max_pages=max(8, n_chunks + 2), max_bytes=budget)

    def data_stream() -> PageStream:
        kw = {}
        if residency and cache is not None:
            kw = dict(cache=cache, cache_tag=_rows_tag(dm))
        return pages.stream(
            device=dev, prefetch_depth=prefetch_depth, staging_depth=staging_depth,
            codec=page_codec, stats=stats, **kw,
        )

    def margin_in(ro: int, nr: int) -> torch.Tensor:
        return torch.from_numpy(margins[ro : ro + nr]).to(dev)

    def store(ro: int, nr: int, margin: torch.Tensor) -> None:
        margins[ro : ro + nr] = margin.cpu().numpy()

    if chunk is None:
        for sp in data_stream():
            ro, nr = sp.host.row_offset, sp.host.n_rows
            store(ro, nr, forest.predict_margin_bins(sp.device, margin_in=margin_in(ro, nr)))
        if serve_stats is not None:
            serve_stats.record_residency(0, 0, stats.host_to_device_bytes - h2d0)
        return margins

    transport = _forest_transport(page_codec)
    if not residency:
        # legacy bill: chunks outermost, every chunk pass re-streams every row
        # page — transfer bill = chunks x pages, ledgered in TransferStats
        n_staged = 0
        for fp in _forest_stream(
            forest, chunk, stats, staging_depth=staging_depth, transport=transport
        ):
            arrays = _chunk_arrays(fp.device)
            n_staged += 1
            for sp in data_stream():
                ro, nr = sp.host.row_offset, sp.host.n_rows
                store(ro, nr, _apply_chunk(forest, arrays, sp.device, margin_in(ro, nr)))
        if serve_stats is not None:
            serve_stats.record_residency(0, n_staged, stats.host_to_device_bytes - h2d0)
        return margins

    # ---- shared-budget residency path ----
    m = dm.num_features
    data_bytes = sum(nr * m for _, nr in extents)  # uint8 wire per full pass
    h_pre, m_pre = cache.tag_counts("forest")
    plan = plan_residency(
        chunk_bytes(forest, chunk), data_bytes, pages.n_pages, cache.max_bytes,
        reserve_bytes=worst_rows * m, pin=pin_chunks is not False,
    )
    _pin_prologue(forest, chunk, plan.n_pinned, stats, transport, cache)

    if plan.order == "chunks_outer":
        # the pinned prefix plus the first streamed chunk share one row-page
        # pass; each later remainder chunk gets its own pass
        remainder = plan.n_chunks - plan.n_pinned
        first = list(range(plan.n_pinned + (1 if remainder else 0)))
        groups = [first] if first else []
        groups += [[i] for i in range(len(first), plan.n_chunks)]
        for group in groups:
            resident: dict[int, dict] = {}
            for fp in _forest_stream(
                forest, chunk, stats, staging_depth=staging_depth,
                transport=transport, cache=cache, indices=group,
            ):
                resident[fp.index] = _chunk_arrays(fp.device)
            for sp in data_stream():
                ro, nr = sp.host.row_offset, sp.host.n_rows
                margin = margin_in(ro, nr)
                for i in group:  # ascending chunk index == tree order
                    margin = _apply_chunk(forest, resident[i], sp.device, margin)
                store(ro, nr, margin)
    else:  # pages_outer: rows stream once, chunks re-resolve per page
        fstream = _forest_stream(
            forest, chunk, stats, staging_depth=staging_depth,
            transport=transport, cache=cache,
        )
        for sp in data_stream():
            ro, nr = sp.host.row_offset, sp.host.n_rows
            margin = margin_in(ro, nr)
            for fp in fstream:  # fresh pass per page, ascending tree order
                margin = _apply_chunk(forest, _chunk_arrays(fp.device), sp.device, margin)
            store(ro, nr, margin)

    if serve_stats is not None:
        h_post, m_post = cache.tag_counts("forest")
        serve_stats.record_residency(
            h_post - h_pre, m_post - m_pre, stats.host_to_device_bytes - h2d0
        )
    return margins


class ForestServer:
    """A packed forest plus its serving policy, behind one predict surface.

    Accepts a fitted `GradientBooster` or a ready `PackedForest`; it serves
    on the forest's device (the booster's, "cuda" unless it was loaded with
    ``device="cpu"``). ``model`` (a `DeviceMemoryModel`) turns on
    byte-budgeted forest paging exactly as `ExecutionPolicy` budgets
    training; ``trees_per_chunk`` forces a chunk size. The server owns a
    persistent shared-budget `DevicePageCache` (``serve_budget_bytes`` or the
    model's `serve_residency_budget`): pinned tree-chunks stay on the device
    across requests, so steady-state traffic pays only the non-resident
    remainder. ``pin_chunks=False`` forces the legacy re-streaming path;
    ``serve_stats`` (shareable with a `BatchServer`) receives the residency
    ledger and supplies measured launch shapes for chunk sizing. All
    transfer traffic lands on ``self.stats``; ``page_codec`` compresses it
    as in `predict_margin_dmatrix`.
    """

    def __init__(
        self,
        forest_or_booster,
        *,
        model: DeviceMemoryModel | None = None,
        trees_per_chunk: int | None = None,
        stats: TransferStats | None = None,
        page_codec: str | None = None,
        pin_chunks: bool | None = None,
        serve_budget_bytes: int | None = None,
        serve_stats: ServeStats | None = None,
    ):
        self.forest = (
            forest_or_booster
            if isinstance(forest_or_booster, PackedForest)
            else PackedForest.from_booster(forest_or_booster)
        )
        self.model = model
        self.trees_per_chunk = trees_per_chunk
        self.stats = stats if stats is not None else TransferStats()
        self.page_codec = page_codec
        self.pin_chunks = pin_chunks
        self.serve_budget_bytes = serve_budget_bytes
        self.serve_stats = serve_stats
        self.cache: DevicePageCache | None = None
        self.objective = obj_lib.get_objective(self.forest.objective)

    # ----------------------------------------------------------- residency
    def _residency_active(self) -> bool:
        return self.pin_chunks is not False and (
            self.serve_budget_bytes is not None or self.model is not None
            or self.pin_chunks is True
        )

    def _ensure_cache(self, batch_rows: int) -> DevicePageCache | None:
        """The persistent residency cache (created on first use; its byte
        budget is fixed at creation so pins stay stable across requests)."""
        if not self._residency_active():
            return None
        if self.cache is None:
            budget = self.serve_budget_bytes
            if budget is None and self.model is not None:
                budget = self.model.serve_residency_budget(batch_rows)
            self.cache = DevicePageCache(
                max_pages=max(8, 2 * (self.forest.n_trees + 1)), max_bytes=budget
            )
        return self.cache

    def residency(self) -> dict:
        """The residency ledger: pin tier occupancy, chunk-cache hit rate,
        and total h2d traffic — printable next to `ServeStats`."""
        if self.cache is None:
            return {}
        hits, misses = self.cache.tag_counts("forest")
        return {
            "pinned_chunks": self.cache.pinned_pages,
            "pinned_mib": round(self.cache.pinned_bytes / 2**20, 2),
            "chunk_hits": hits,
            "chunk_misses": misses,
            "chunk_hit_rate": round(hits / (hits + misses), 3) if hits + misses else 0.0,
            "h2d_mib": round(self.stats.host_to_device_bytes / 2**20, 2),
        }

    def _measured_rows(self) -> int | None:
        return self.serve_stats.max_launch_rows if self.serve_stats is not None else None

    # ----------------------------------------------------------- prediction
    def predict_margin(self, data) -> np.ndarray:
        """Margins for raw feature rows (ndarray) or any DMatrix."""
        if hasattr(data, "page_set"):  # DMatrix: stream its pages
            extents = data.page_set().page_extents
            worst = max((nr for _, nr in extents), default=0) or 1
            rows = (
                self.model.serve_batch_rows(worst, self._measured_rows())
                if self.model is not None else worst
            )
            return predict_margin_dmatrix(
                self.forest, data, model=self.model,
                trees_per_chunk=self.trees_per_chunk,
                stats=self.stats, page_codec=self.page_codec,
                cache=self._ensure_cache(rows),
                pin_chunks=self.pin_chunks,
                serve_budget_bytes=self.serve_budget_bytes,
                serve_stats=self.serve_stats,
            )
        X = np.asarray(data)
        forest = self.forest
        if self.model is not None:
            batch_rows = self.model.serve_batch_rows(X.shape[0], self._measured_rows())
        else:
            batch_rows = X.shape[0]
        chunk = resolve_trees_per_chunk(
            forest, batch_rows, self.model, self.trees_per_chunk
        )
        if chunk is None:
            return forest.predict_margin(X)
        if forest.cuts is None:
            raise ValueError("PackedForest has no cuts; predict from bins instead")
        h2d0 = self.stats.host_to_device_bytes
        transport = _forest_transport(self.page_codec)
        cache = self._ensure_cache(batch_rows)
        h_pre, m_pre = cache.tag_counts("forest") if cache is not None else (0, 0)
        if cache is not None:
            # no row pages compete on this path: data_bytes=0 makes the order
            # moot, the plan only sizes the pinned prefix
            plan = plan_residency(
                chunk_bytes(forest, chunk), 0, 1, cache.max_bytes,
                pin=self.pin_chunks is not False,
            )
            _pin_prologue(forest, chunk, plan.n_pinned, self.stats, transport, cache)
        bins = forest.quantize(X)
        margin = torch.full((X.shape[0],), forest.base_margin, dtype=torch.float32,
                            device=forest.device)
        for fp in _forest_stream(
            forest, chunk, self.stats, transport=transport, cache=cache
        ):
            margin = _apply_chunk(forest, _chunk_arrays(fp.device), bins, margin)
        if self.serve_stats is not None:
            h_post, m_post = (
                cache.tag_counts("forest") if cache is not None else (0, 0)
            )
            self.serve_stats.record_residency(
                h_post - h_pre, m_post - m_pre,
                self.stats.host_to_device_bytes - h2d0,
            )
        return margin.cpu().numpy()

    def predict(self, data, output_margin: bool = False) -> np.ndarray:
        margin = self.predict_margin(data)
        if output_margin:
            return margin
        return self.objective.transform(torch.from_numpy(margin)).numpy()
