"""`PageStream`: the async page-streaming engine (paper §2.3 / §3.2).

Counterpart of `repro.pipeline.stream`. One engine owns the whole disk ->
host -> device pipeline that the paper's out-of-core argument rests on:

  disk -> host    the threaded `Prefetcher` keeps `prefetch_depth` page loads
                  in flight ahead of the consumer (§2.3's multi-threaded
                  pre-fetcher, with retries for transient I/O faults);
  host -> device  on a CUDA device, a ring of `staging_depth` pinned host
                  buffers feeds ``non_blocking`` copies on a side CUDA
                  stream, so the copy of page k+1 runs while the compute
                  stream works on page k; the compute stream waits on the
                  page's copy event before its kernels. On the CPU, staging
                  is a plain copy;
  device          an optional `DevicePageCache` LRU skips the host->device
                  copy for pages still resident from a previous pass.

With a ``transport`` (`repro_torch.compress.PageTransport`, or the forest
wire packer) only the wire payload is staged: the host encodes it (a page
its store wrote with the transport's codec passes as stored), the copy
moves the payload, and on the card the decode runs on the compute stream
right after the consumer's wait on the copy's event, so the ring's overlap
is kept; the consumer sees the decoded page. On the CPU it decodes at once.
The ledger books both sides: ``logical_bytes`` the decoded page,
``wire_bytes`` and ``host_to_device_bytes`` the payload, and a cached page
is charged its payload's size.

Allocator and buffer hazards, and what is done about them:

  * a pinned buffer is refilled only after the event of the copy that last
    read it has completed (host-side wait on that event);
  * a device page is allocated on the side stream and read on the compute
    stream, so it is `record_stream`-ed on the compute stream: the caching
    allocator does not hand its memory out again until the compute stream's
    work on it has run.

Every boundary crossing is booked in a `TransferStats`: bytes per edge plus
the overlap ledger. On a CUDA device, stage and compute seconds are device
times from CUDA events (the copy on the side stream; the page's decode and
the consumer's kernels on the compute stream, up to the consumer's return),
and each pass ends with a synchronise so its wall time covers the device
work it launched. Fetch seconds are host clock in the prefetcher thread.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Any, Callable, Iterable, Iterator, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.data.pages import GLOBAL_STATS, PageStore, Prefetcher, TransferStats
from repro_torch.fault.retry import RetryPolicy
from repro_torch.pipeline.cache import DevicePageCache


class StreamedPage(NamedTuple):
    """One page as it leaves the pipeline: host view + staged device tensor."""

    index: int
    host: Any  # whatever the fetch callable produced (e.g. an EllpackPage)
    device: torch.Tensor


def _default_to_array(page: Any) -> np.ndarray:
    return np.asarray(page)


class _CudaStager:
    """One pass's host -> device staging on a CUDA device: a ring of pinned
    buffers, a side copy stream, and the CUDA events the ledger reads."""

    def __init__(self, device: torch.device, depth: int):
        self.compute = torch.cuda.current_stream(device)
        self.copy = torch.cuda.Stream(device)
        self.device = device
        self.buffers: list[torch.Tensor | None] = [None] * depth
        self.copied: list[torch.cuda.Event | None] = [None] * depth
        self.slot = 0
        self.host_seconds = 0.0
        self.copy_spans: list[tuple[torch.cuda.Event, torch.cuda.Event]] = []
        self.compute_spans: list[tuple[torch.cuda.Event, torch.cuda.Event]] = []
        self._open: torch.cuda.Event | None = None

    @staticmethod
    def _event() -> torch.cuda.Event:
        return torch.cuda.Event(enable_timing=True)

    def stage(self, arr: np.ndarray) -> tuple[torch.Tensor, torch.cuda.Event]:
        """Start the copy of ``arr``; returns (device tensor, its ready event)."""
        i = self.slot
        self.slot = (i + 1) % len(self.buffers)
        if self.copied[i] is not None:
            self.copied[i].synchronize()  # the last copy out of this buffer is done
        src = torch.from_numpy(np.ascontiguousarray(arr))
        flat = src.reshape(-1).view(torch.uint8)
        nbytes = flat.numel()
        if self.buffers[i] is None or self.buffers[i].numel() < nbytes:
            self.buffers[i] = torch.empty(max(nbytes, 1), dtype=torch.uint8, pin_memory=True)
        t0 = time.perf_counter()
        pinned = self.buffers[i][:nbytes]
        pinned.copy_(flat)
        self.host_seconds += time.perf_counter() - t0
        start, done = self._event(), self._event()
        with torch.cuda.stream(self.copy):
            start.record(self.copy)
            dev = torch.empty(nbytes, dtype=torch.uint8, device=self.device)
            dev.copy_(pinned, non_blocking=True)
            done.record(self.copy)
        self.copied[i] = done
        self.copy_spans.append((start, done))
        return dev.view(src.dtype).reshape(src.shape), done

    def begin(self, page, ready: torch.cuda.Event | None) -> None:
        """Before the decode and the consumer's kernels on ``page``: order
        them after its copy. ``page`` is the staged tensor (a cached page
        may be a decoded forest chunk's dict, made on the compute stream)."""
        if ready is not None:
            self.compute.wait_event(ready)
        if isinstance(page, torch.Tensor):
            page.record_stream(self.compute)
        self._open = self._event()
        self._open.record(self.compute)

    def end(self) -> None:
        done = self._event()
        done.record(self.compute)
        self.compute_spans.append((self._open, done))

    def finish(self, stats: TransferStats) -> None:
        """Wait for the pass's device work and book its event times."""
        self.copy.synchronize()
        self.compute.synchronize()
        stats.stream_stage_seconds += self.host_seconds + sum(
            a.elapsed_time(b) for a, b in self.copy_spans
        ) / 1e3
        stats.stream_compute_seconds += sum(
            a.elapsed_time(b) for a, b in self.compute_spans
        ) / 1e3


class PageStream:
    """Double-buffered streaming of pages from a source to one device.

    Parameters
    ----------
    fetch : idx -> host page. Disk-backed sources should do their read here;
        it runs in a background thread when ``threaded=True``.
    indices : iteration order (one pass = one full iteration of ``indices``).
    to_array : host page -> np.ndarray staged to the device. Defaults to
        ``np.asarray``.
    device : where pages are staged ("cpu" stages a plain copy; a CUDA
        device must be available, nothing falls back to the host).
    threaded : run ``fetch`` in the §2.3 prefetcher thread (True for disk,
        False for pages already in host RAM).
    prefetch_depth / staging_depth : fetches / device copies kept in flight;
        ``staging_depth`` is also the number of pinned host buffers.
    cache : optional `DevicePageCache`, keyed ``(cache_tag, index)``; hits
        skip the host->device copy.
    cache_tag : namespace of the cache keys, so that distinct streams over
        the same indices (a matrix's row pages, a forest's tree-chunks) do
        not collide in one cache.
    cache_pin : stage into the cache's pinned (never-evicted) tier: the
        serving tier's pin prologue stages forest tree-chunks this way, so
        that row-page pressure on the shared byte budget cannot displace
        them. Entries the pin budget refuses land in the plain LRU tier.
        ``fetch`` may return None for a key it knows is pinned: the cache
        hit comes first and the host page is never read.
    stats : `TransferStats` sink (defaults to the module-global one).
    retry : `RetryPolicy` for the threaded prefetcher's transient-fault
        retries (None = the policy's defaults).
    transport : optional `repro_torch.compress.PageTransport` (or the forest
        wire packer): ``to_array``'s output is encoded on the host, only the
        wire payload is staged, and the device copy is decoded on the
        device; the consumer sees the logical page (see the module
        docstring).

    A `PageStream` is re-iterable: each ``iter()`` is an independent pass.
    """

    def __init__(
        self,
        fetch: Callable[[int], Any],
        indices: Iterable[int],
        *,
        to_array: Callable[[Any], np.ndarray] | None = None,
        device: str | torch.device = "cuda",
        threaded: bool = False,
        prefetch_depth: int = 2,
        staging_depth: int = 2,
        cache: DevicePageCache | None = None,
        cache_tag: str = "page",
        cache_pin: bool = False,
        stats: TransferStats | None = None,
        retry: RetryPolicy | None = None,
        transport: Any | None = None,
    ):
        self._fetch = fetch
        self._indices = list(indices)
        self._to_array = to_array or _default_to_array
        self.device = torch.device(device)
        self._threaded = threaded
        self.prefetch_depth = max(1, prefetch_depth)
        self.staging_depth = max(1, staging_depth)
        self.cache = cache
        self.cache_tag = cache_tag
        self.cache_pin = cache_pin
        self.stats = stats or GLOBAL_STATS
        self.retry = retry
        self.transport = transport

    # ------------------------------------------------------------ constructors
    @classmethod
    def from_host_pages(
        cls, pages: Sequence[Any], indices: Iterable[int] | None = None, **kw
    ) -> "PageStream":
        """Stream pages already resident in host RAM (no prefetch thread);
        ``indices`` restricts the pass to a subset, each page keeping its
        global index."""
        kw.setdefault("threaded", False)
        return cls(pages.__getitem__, indices if indices is not None else range(len(pages)), **kw)

    @classmethod
    def from_store(
        cls,
        store: PageStore,
        wrap: Callable[[int, dict], Any] | None = None,
        indices: Iterable[int] | None = None,
        **kw,
    ) -> "PageStream":
        """Stream a disk `PageStore`; ``wrap(idx, arrays)`` builds the host
        page; ``indices`` restricts the pass as in `from_host_pages`. With a
        ``transport``, the members its codec wrote are read undecoded and
        staged as stored."""
        transport = kw.get("transport")
        keep = transport.name if transport is not None else None

        def fetch(idx: int) -> Any:
            arrays = store.read_page(idx, keep=keep)
            return wrap(idx, arrays) if wrap is not None else arrays

        kw.setdefault("threaded", True)
        kw.setdefault("stats", store.stats)
        return cls(fetch, indices if indices is not None else range(store.n_pages), **kw)

    # --------------------------------------------------------------- host pass
    def _source(self) -> Iterator[tuple[int, Any]]:
        """Raw fetched pages, no ledger entries beyond fetch time itself."""
        timed = self._timed_fetch
        if self._threaded:
            yield from Prefetcher(
                timed,
                self._indices,
                depth=self.prefetch_depth,
                retry=self.retry,
                stats=self.stats,
            )
        else:
            for idx in self._indices:
                yield idx, timed(idx)

    def iter_host(self) -> Iterator[tuple[int, Any]]:
        """One pass over host pages with prefetch but *no* device staging,
        keeping the same wall/compute ledger as a device pass."""
        stats = self.stats
        t_wall0 = time.perf_counter()
        try:
            for idx, page in self._source():
                t_yield = time.perf_counter()
                yield idx, page
                stats.stream_compute_seconds += time.perf_counter() - t_yield
        finally:
            stats.stream_wall_seconds += time.perf_counter() - t_wall0

    def _timed_fetch(self, idx: int) -> Any:
        t0 = time.perf_counter()
        page = self._fetch(idx)
        self.stats.stream_fetch_seconds += time.perf_counter() - t0
        return page

    # -------------------------------------------------------------- device pass
    def _stage(self, idx: int, host: Any, stager: _CudaStager | None):
        """(StreamedPage, ready event or None, pending decode or None) for
        one fetched page; the pending decode (wire meta, cache key, wire
        bytes) is left for `_decode` after the consumer's wait on the copy."""
        key = (self.cache_tag, idx)
        if self.cache is not None:
            entry = self.cache.lookup(key)
            if entry is not None:
                dev, nbytes = entry
                self.stats.cache_hits += 1
                self.stats.cache_hit_bytes += nbytes  # host bytes the hit saved
                return StreamedPage(idx, host, dev), None, None
            self.stats.cache_misses += 1
        arr = self._to_array(host)
        wire, wire_meta = arr, None
        if self.transport is not None:
            t0 = time.perf_counter()
            wire, wire_meta = self.transport.encode(arr)
            self.stats.stream_stage_seconds += time.perf_counter() - t0
        ready = None
        if stager is not None:
            dev, ready = stager.stage(wire)
        else:
            t0 = time.perf_counter()
            dev = torch.from_numpy(np.array(wire, copy=True))
            self.stats.stream_stage_seconds += time.perf_counter() - t0
        self.stats.host_to_device_bytes += wire.nbytes
        self.stats.logical_bytes += arr.nbytes
        self.stats.wire_bytes += wire.nbytes
        page = StreamedPage(idx, host, dev)
        if self.transport is None:
            if self.cache is not None:
                self.cache.put(key, dev, wire.nbytes, pinned=self.cache_pin)
            return page, ready, None
        pending = (wire_meta, key, wire.nbytes)
        if stager is None:
            return self._decode(page, pending), None, None
        return page, ready, pending

    def _decode(self, page: StreamedPage, pending: tuple) -> StreamedPage:
        """Decode a staged wire payload on its device, and cache the decoded
        page charged with its wire bytes."""
        wire_meta, key, wire_nbytes = pending
        dev = self.transport.decode(page.device, wire_meta)
        if self.cache is not None:
            self.cache.put(key, dev, wire_nbytes, pinned=self.cache_pin)
        return page._replace(device=dev)

    def __iter__(self) -> Iterator[StreamedPage]:
        stats = self.stats
        t_wall0 = time.perf_counter()
        stager = (
            _CudaStager(self.device, self.staging_depth) if self.device.type == "cuda" else None
        )
        source = self._source()
        inflight: deque = deque()
        exhausted = False
        try:
            while True:
                # keep `staging_depth` copies in flight ahead of compute: the
                # copy of page k+1 starts before page k is yielded, so the
                # copy engine overlaps the consumer's kernels on page k
                while not exhausted and len(inflight) < self.staging_depth:
                    try:
                        idx, host = next(source)
                    except StopIteration:
                        exhausted = True
                        break
                    inflight.append(self._stage(idx, host, stager))
                if not inflight:
                    return
                page, ready, pending = inflight.popleft()
                if stager is not None:
                    stager.begin(page.device, ready)
                    if pending is not None:
                        page = self._decode(page, pending)
                    yield page
                    stager.end()
                else:
                    t_yield = time.perf_counter()
                    yield page
                    stats.stream_compute_seconds += time.perf_counter() - t_yield
        finally:
            if stager is not None:
                stager.finish(stats)
            stats.stream_wall_seconds += time.perf_counter() - t_wall0
