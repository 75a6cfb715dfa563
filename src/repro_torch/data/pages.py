"""Transfer ledger and durable-directory helper for the port.

Counterpart of the part of `repro.data.pages` that the in-core slice uses:
`TransferStats`, the byte/seconds ledger every staging path books into, and
`fsync_dir`, which checkpoints use to make a rename durable. `PageStore` and
`Prefetcher` (the on-disk page cache and its threaded reader) arrive with the
out-of-core slice.
"""
from __future__ import annotations

import dataclasses
import os


@dataclasses.dataclass
class TransferStats:
    disk_read_bytes: int = 0
    disk_write_bytes: int = 0
    host_to_device_bytes: int = 0
    device_to_host_bytes: int = 0
    page_loads: int = 0
    load_seconds: float = 0.0
    # --- streaming-overlap accounting (filled by the out-of-core PageStream) ---
    # fetch/stage/compute are attributed where the work happens (fetch in the
    # prefetcher thread, stage + compute in the consumer thread), so their sum
    # is the *serial* cost of a pass; wall is what actually elapsed. Overlap
    # hides serial work, so wall < serial when the pipeline is doing its job.
    stream_fetch_seconds: float = 0.0  # source fetch (disk/host) time
    stream_stage_seconds: float = 0.0  # host->device put time
    stream_compute_seconds: float = 0.0  # consumer time between pages
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
    # what actually crossed host->device. Raw pages (the only kind the port
    # stages yet) make them equal; a codec's win is exactly logical_bytes -
    # wire_bytes. Disk-side savings show up in disk_read/write_bytes instead.
    logical_bytes: int = 0
    wire_bytes: int = 0

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
