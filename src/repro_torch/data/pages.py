"""External page store, threaded prefetcher and transfer ledger.

Counterpart of `repro.data.pages` (paper §2.3 / §3.2 substrate).
`PageStore` persists ELLPACK pages (and their metadata) to disk in the
reference's format, so a page cache written by either package opens in the
other: each blob is ``RAW0`` plus an ``np.savez`` archive (``ZST0`` plus a
zstd frame of it with ``compress=True`` when the `zstandard` module is
installed), written to a tmp file, fsynced and renamed into place, and
``manifest.json`` (replaced the same way, after the blob) records each
page's size and CRC32. A crash mid-write leaves the torn page out of the
manifest; `read_page` checks the CRC and raises `PageCorruptError` naming
the page instead of decoding garbage.

Pages optionally pass through a lossless `repro_torch.compress` codec
(``codec="bitpack"``/``"delta-rle"``/chains): only uint8 members are coded,
and the codec name and meta are recorded per page in the manifest, so mixed
and legacy (pre-codec) caches decode correctly. A garbled payload or stale
meta surfaces as `PageDecodeError` (a `PageCorruptError`, never retried)
naming the codec and page, through the ``page_store.decode`` fault site.
``read_page(idx, keep=name)`` leaves the members a ``name`` codec wrote
undecoded (`repro_torch.compress.EncodedPage`): a stream whose transport
uses that codec stages them as stored.

`Prefetcher` is the §2.3 multi-threaded pre-fetcher: it loads pages k+1 ..
k+depth in a background thread while page k is consumed, retrying transient
read faults under a `repro_torch.fault.RetryPolicy`. Store and prefetcher
fire `repro_torch.fault.inject` sites so chaos tests can plant
deterministic I/O failures. `TransferStats` counts the bytes that cross each
boundary and the streaming overlap ledger.
"""
from __future__ import annotations

import dataclasses
import io
import json
import os
import queue
import threading
import time
import zlib
from typing import Callable, Iterable, Iterator

import numpy as np

from repro_torch.compress import EncodedPage, get_codec
from repro_torch.fault import inject as fault_inject
from repro_torch.fault.retry import RetryPolicy

try:
    import zstandard as _zstd
except ImportError:  # optional, as in the reference: blobs are then RAW0
    _zstd = None


@dataclasses.dataclass
class TransferStats:
    disk_read_bytes: int = 0
    disk_write_bytes: int = 0
    host_to_device_bytes: int = 0
    device_to_host_bytes: int = 0
    page_loads: int = 0
    load_seconds: float = 0.0
    # --- streaming-overlap accounting (filled by repro_torch.pipeline.PageStream) ---
    # fetch/stage/compute are attributed where the work happens, so their sum
    # is the *serial* cost of a pass; wall is what actually elapsed. Overlap
    # hides serial work, so wall < serial when the pipeline is doing its job.
    # On a CUDA device stage and compute are device times read from CUDA
    # events (the copy on the side stream; the page's kernels on the compute
    # stream), and each pass ends with a synchronise, so wall covers the
    # device work it launched. On the CPU they are host clock times.
    stream_fetch_seconds: float = 0.0  # source fetch (disk/host) time
    stream_stage_seconds: float = 0.0  # pinned-buffer fill + host->device copy
    stream_compute_seconds: float = 0.0  # the consumer's work on each page
    stream_wall_seconds: float = 0.0  # end-to-end elapsed across passes
    cache_hits: int = 0  # device-page cache hits (transfers skipped)
    cache_hit_bytes: int = 0  # host->device bytes those hits saved
    # stages that consulted a DevicePageCache and found nothing resident; only
    # counted when a cache is attached, so cache_hit_rate reads 0/0 (not a
    # fake 0%) on cacheless streams
    cache_misses: int = 0
    # pages never fetched/staged because a per-node lossguide pass proved no
    # row of theirs sits in the popped node's window (see build_tree_paged)
    pages_skipped: int = 0
    # --- tiered histogram store ledger (filled by core.histcache.HistogramStore) ---
    # cold node/level histograms evicted from the device budget land in host
    # buffers (spill) and are staged back through PageStream when a plan
    # needs them again (fetch); fetch bytes are *also* counted in
    # host_to_device_bytes because the fetch goes through the same staging path
    hist_spill_bytes: int = 0
    hist_fetch_bytes: int = 0
    hist_spills: int = 0
    hist_fetches: int = 0
    # --- compression ledger (filled everywhere pages/histograms stage) ---
    # logical_bytes is what the device consumes after decode; wire_bytes is
    # what actually crossed host->device. With page_codec="raw" they are
    # equal; a codec's win is exactly logical_bytes - wire_bytes. Disk-side
    # savings show up in disk_read/write_bytes instead (the blob shrinks).
    logical_bytes: int = 0
    wire_bytes: int = 0
    # --- retry ledger (filled by repro_torch.fault.RetryPolicy.call) ---
    # io_retries counts re-attempts that a transient fault cost (page
    # reads); io_giveups counts operations that exhausted their attempt
    # budget and surfaced the error
    io_retries: int = 0
    io_giveups: int = 0

    @property
    def cache_hit_rate(self) -> float:
        """Device-cache hit fraction of cached stages (0..1); 0.0 when no
        cache-backed stage ran. Sits next to overlap_ratio in benchmark
        records so residency wins are ledgered, not just byte counts."""
        total = self.cache_hits + self.cache_misses
        return self.cache_hits / total if total else 0.0

    @property
    def wire_ratio(self) -> float:
        """wire/logical staged bytes (1.0 = uncompressed, lower = better)."""
        return self.wire_bytes / self.logical_bytes if self.logical_bytes > 0 else 1.0

    @property
    def stream_serial_seconds(self) -> float:
        """What the streamed passes would cost with zero overlap."""
        return self.stream_fetch_seconds + self.stream_stage_seconds + self.stream_compute_seconds

    @property
    def overlap_saved_seconds(self) -> float:
        return max(0.0, self.stream_serial_seconds - self.stream_wall_seconds)

    @property
    def overlap_ratio(self) -> float:
        """Fraction of serial transfer+compute time hidden by pipelining (0..1)."""
        serial = self.stream_serial_seconds
        return self.overlap_saved_seconds / serial if serial > 0 else 0.0

    def reset(self) -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, f.default)


GLOBAL_STATS = TransferStats()


def _encode(arrays: dict[str, np.ndarray], compress: bool = False) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    raw = buf.getvalue()
    if compress and _zstd is not None:
        return b"ZST0" + _zstd.ZstdCompressor(level=1).compress(raw)
    return b"RAW0" + raw


def _decode(blob: bytes) -> dict[str, np.ndarray]:
    tag, body = blob[:4], blob[4:]
    if tag == b"ZST0":
        if _zstd is None:
            raise RuntimeError("zstd page but zstandard not installed")
        body = _zstd.ZstdDecompressor().decompress(body)
    data = np.load(io.BytesIO(body))
    return {k: data[k] for k in data.files}


class PageCorruptError(OSError):
    """A page blob failed its manifest CRC32 check (torn write / bit rot).

    Raised by `PageStore.read_page` instead of decoding garbage; names the
    page index and file so the operator knows exactly what to rebuild.
    """

    def __init__(self, idx: int, path: str, expected: int, actual: int):
        self.idx = idx
        self.path = path
        super().__init__(
            f"page {idx} is corrupt: CRC32 mismatch on {path} "
            f"(manifest {expected:#010x}, on disk {actual:#010x}). The page "
            f"cache is damaged — rebuild it from the raw source (IterDMatrix)."
        )


class PageDecodeError(PageCorruptError):
    """A page blob passed CRC but failed codec decode (truncated/garbled
    payload, stale codec meta). Deterministic damage like a CRC mismatch —
    never retried — naming the codec and page index."""

    def __init__(self, idx: int, path: str, codec: str, cause: Exception):
        self.idx = idx
        self.path = path
        self.codec = codec
        OSError.__init__(
            self,
            f"page {idx} failed {codec!r} decode on {path}: {cause!r}. The "
            f"compressed payload is damaged — rebuild the page cache from "
            f"the raw source (IterDMatrix).",
        )


def _atomic_write(path: str, data: bytes) -> None:
    """Write bytes durably: tmp file in the same dir, fsync, `os.replace`.

    A crash at any point leaves either the old file or the new file — never a
    half-written one trusted by a later reopen.
    """
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as fh:
        fh.write(data)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


def fsync_dir(path: str) -> None:
    """Best-effort directory fsync so a rename itself survives power loss."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # pragma: no cover - platform without dir-open support
        return
    try:
        os.fsync(fd)
    except OSError:  # pragma: no cover
        pass
    finally:
        os.close(fd)


class PageStore:
    """Directory of numbered pages; thread-safe reads, durable writes.

    Every blob and the manifest land via `_atomic_write`; each manifest entry
    records the blob's CRC32, verified on `read_page`. A crash between blob
    and manifest writes leaves the new page invisible (the manifest still
    describes a fully consistent store). ``codec`` codes the uint8 members
    of the pages this store writes; ``compress`` zstd-frames each blob when
    `zstandard` is installed. Reads decode with each entry's own codec.
    """

    def __init__(
        self,
        root: str,
        compress: bool = False,
        stats: TransferStats | None = None,
        codec: str = "raw",
    ):
        self.root = root
        self.compress = compress
        self.stats = stats or GLOBAL_STATS
        self.codec = get_codec(codec)
        os.makedirs(root, exist_ok=True)
        self._meta: dict = {"pages": []}
        self._meta_path = os.path.join(root, "manifest.json")
        if os.path.exists(self._meta_path):
            with open(self._meta_path) as fh:
                self._meta = json.load(fh)

    @property
    def n_pages(self) -> int:
        return len(self._meta["pages"])

    def _path(self, idx: int) -> str:
        return os.path.join(self.root, f"page_{idx:06d}.bin")

    def write_page(self, arrays: dict[str, np.ndarray], meta: dict | None = None) -> int:
        idx = self.n_pages
        fault_inject.fire("page_store.write_page", index=idx)
        codec_meta: dict = {}
        if self.codec.name != "raw":
            # only uint8 payloads (ELLPACK bin pages) go through the codec;
            # labels and float sidecars pass through verbatim
            coded = {}
            for key, arr in arrays.items():
                if isinstance(arr, np.ndarray) and arr.dtype == np.uint8:
                    coded[key], codec_meta[key] = self.codec.encode(arr)
                else:
                    coded[key] = arr
            arrays = coded
        blob = _encode(arrays, self.compress)
        _atomic_write(self._path(idx), blob)
        self.stats.disk_write_bytes += len(blob)
        entry = {
            "idx": idx, "bytes": len(blob), "crc32": zlib.crc32(blob), "codec": self.codec.name
        }
        if codec_meta:
            entry["codec_meta"] = codec_meta
        entry.update(meta or {})
        self._meta["pages"].append(entry)
        # manifest last: a crash before this point leaves the fresh blob
        # unreferenced, never a referenced-but-torn page
        _atomic_write(self._meta_path, json.dumps(self._meta).encode())
        fsync_dir(self.root)
        return idx

    def read_page(self, idx: int, keep: str | None = None) -> dict[str, np.ndarray]:
        """The page's arrays, each coded member decoded with the codec its
        manifest entry names; with ``keep``, the members that codec wrote are
        returned undecoded as `EncodedPage`s, after a check of their
        geometry against their meta."""
        fault_inject.fire("page_store.read_page", index=idx)
        t0 = time.perf_counter()
        with open(self._path(idx), "rb") as fh:
            blob = fh.read()
        entry = self._meta["pages"][idx] if idx < len(self._meta["pages"]) else {}
        want = entry.get("crc32")  # pre-durability manifests have no CRC
        if want is not None:
            got = zlib.crc32(blob)
            if got != want:
                raise PageCorruptError(idx, self._path(idx), want, got)
        # decode with the codec the *entry* was written with: legacy
        # (pre-codec) manifests have no "codec" field and decode as raw
        codec_name = entry.get("codec", "raw")
        try:
            fault_inject.fire("page_store.decode", index=idx, codec=codec_name)
            out = _decode(blob)
            codec_meta = entry.get("codec_meta") or {}
            if codec_meta:
                codec = get_codec(codec_name)
                for key, cmeta in codec_meta.items():
                    if keep is not None and codec.name == keep:
                        codec.validate(out[key], cmeta)
                        out[key] = EncodedPage(out[key], cmeta, codec)
                    else:
                        out[key] = codec.decode(out[key], cmeta)
        except PageCorruptError:
            raise
        except Exception as err:
            raise PageDecodeError(idx, self._path(idx), codec_name, err) from err
        self.stats.disk_read_bytes += len(blob)
        self.stats.page_loads += 1
        self.stats.load_seconds += time.perf_counter() - t0
        return out

    def page_meta(self, idx: int) -> dict:
        return self._meta["pages"][idx]


class Prefetcher:
    """Background-thread page loader (the §2.3 multi-threaded pre-fetcher).

    Wraps any `load(idx)` callable; yields pages in order while keeping up to
    `depth` loads in flight ahead of the consumer. Failed loads are retried
    with exponential backoff + jitter under a `RetryPolicy` (``retry``,
    default ``RetryPolicy()``: 3 attempts) before surfacing. Re-attempts land in ``stats.io_retries``, exhausted
    budgets in ``stats.io_giveups``. `PageCorruptError` is never retried: a
    failed checksum is deterministic damage, not a transient fault.
    """

    def __init__(
        self,
        load: Callable[[int], dict],
        indices: Iterable[int],
        depth: int = 2,
        retry: RetryPolicy | None = None,
        stats: TransferStats | None = None,
    ):
        self._load = load
        self._indices = list(indices)
        self._queue: "queue.Queue[tuple[int, object]]" = queue.Queue(maxsize=depth)
        self._retry = retry if retry is not None else RetryPolicy()
        self._stats = stats
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        for idx in self._indices:
            try:
                page = self._retry.call(
                    lambda idx=idx: self._load(idx),
                    retryable=(Exception,),
                    nonretryable=(PageCorruptError,),
                    stats=self._stats,
                    describe=f"page {idx} load",
                )
            except Exception as e:
                self._queue.put((idx, e))
                continue
            self._queue.put((idx, page))
        self._queue.put((-1, None))

    def __iter__(self) -> Iterator[tuple[int, dict]]:
        while True:
            idx, item = self._queue.get()
            if idx == -1:
                return
            if isinstance(item, PageCorruptError):
                raise item  # already the actionable error; don't bury it
            if isinstance(item, Exception):
                raise RuntimeError(f"page {idx} failed to load after retries") from item
            yield idx, item
