"""The port's page store, prefetcher, device cache and page stream against
the reference, on the CPU.

A page cache written by either package opens in the other (same manifest,
CRC32 and blob bytes); damage raises `PageCorruptError` without a retry;
transient faults planted by a seeded `FaultPlan` are retried exactly as the
reference retries them; `DevicePageCache` follows the reference's LRU and
pinning decisions op for op; a `PageStream` is re-iterable and books the
reference's bytes. Every comparison is exact.
"""
import collections
import json
import os

import numpy as np
import pytest
import torch

from repro.data import pages as j_pages
from repro.fault import inject as j_inject
from repro.fault.retry import RetryPolicy as JRetry
from repro.pipeline import DevicePageCache as JCache
from repro.pipeline import PageStream as JStream
from repro_torch.data.pages import (
    PageCorruptError,
    PageDecodeError,
    PageStore,
    Prefetcher,
    TransferStats,
)
from repro_torch.fault import FaultPlan, FaultSpec, injected
from repro_torch.fault.retry import RetryPolicy
from repro_torch.pipeline import DevicePageCache, PageStream

CPU = torch.device("cpu")


def _pages(n=4, rows=(30, 30, 30, 7), m=5):
    rng = np.random.default_rng(0)
    return [rng.integers(0, 255, (rows[i], m)).astype(np.uint8) for i in range(n)]


def _write(store, pages):
    for i, b in enumerate(pages):
        store.write_page({"bins": b}, {"row_offset": 30 * i, "n_rows": b.shape[0]})


def test_page_store_format_is_the_reference_format(tmp_path):
    pages = _pages()
    _write(PageStore(str(tmp_path / "port"), stats=TransferStats()), pages)
    _write(j_pages.PageStore(str(tmp_path / "ref"), stats=j_pages.TransferStats()), pages)
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "ref"))
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "ref" / name).read_bytes()
    manifest = json.loads((tmp_path / "port" / "manifest.json").read_text())
    assert [e["codec"] for e in manifest["pages"]] == ["raw"] * 4


def test_page_store_round_trips_across_packages(tmp_path):
    pages = _pages()
    _write(PageStore(str(tmp_path / "a"), stats=TransferStats()), pages)
    _write(j_pages.PageStore(str(tmp_path / "b"), stats=j_pages.TransferStats()), pages)
    ref_reads_port = j_pages.PageStore(str(tmp_path / "a"), stats=j_pages.TransferStats())
    port_reads_ref = PageStore(str(tmp_path / "b"), stats=TransferStats())
    for i, want in enumerate(pages):
        np.testing.assert_array_equal(ref_reads_port.read_page(i)["bins"], want)
        np.testing.assert_array_equal(port_reads_ref.read_page(i)["bins"], want)
        assert port_reads_ref.page_meta(i) == ref_reads_port.page_meta(i)


def test_crc_failure_raises_without_retry(tmp_path):
    stats = TransferStats()
    store = PageStore(str(tmp_path), stats=stats)
    _write(store, _pages())
    with open(tmp_path / "page_000002.bin", "r+b") as fh:
        fh.seek(60)
        fh.write(b"\xff\x00\xff")
    reads = collections.Counter()

    def load(idx):
        reads[idx] += 1
        return store.read_page(idx)

    with pytest.raises(PageCorruptError, match="page 2 is corrupt"):
        list(Prefetcher(load, range(4), retry=RetryPolicy(base_delay=0.0), stats=stats))
    assert reads[2] == 1  # deterministic damage is not re-read
    assert stats.io_retries == 0 and stats.io_giveups == 0


def test_decode_failure_is_a_page_decode_error(tmp_path):
    store = PageStore(str(tmp_path), stats=TransferStats())
    _write(store, _pages())
    plan = FaultPlan.of(FaultSpec(site="page_store.decode", at=2, exc="ValueError"))
    with injected(plan):
        store.read_page(0)
        with pytest.raises(PageDecodeError, match="page 1 failed 'raw' decode"):
            store.read_page(1)


@pytest.mark.parametrize("at,count,attempts", [(2, 2, 3), (1, 1, 2), (3, 1, 4)])
def test_prefetcher_retries_like_the_reference(tmp_path, at, count, attempts):
    pages = _pages()
    _write(PageStore(str(tmp_path / "p"), stats=TransferStats()), pages)
    _write(j_pages.PageStore(str(tmp_path / "j"), stats=j_pages.TransferStats()), pages)
    spec = dict(site="page_store.read_page", at=at, count=count, exc="OSError")
    stats, jstats = TransferStats(), j_pages.TransferStats()
    store = PageStore(str(tmp_path / "p"), stats=stats)
    jstore = j_pages.PageStore(str(tmp_path / "j"), stats=jstats)
    with injected(FaultPlan.of(FaultSpec(**spec), seed=7)) as inj:
        got = list(Prefetcher(store.read_page, range(4), depth=2,
                              retry=RetryPolicy(max_attempts=attempts, base_delay=0.0),
                              stats=stats))
    with j_inject.injected(j_inject.FaultPlan.of(j_inject.FaultSpec(**spec), seed=7)) as jinj:
        want = list(j_pages.Prefetcher(jstore.read_page, range(4), depth=2,
                                       retry=JRetry(max_attempts=attempts, base_delay=0.0),
                                       stats=jstats))
    assert [i for i, _ in got] == [i for i, _ in want] == [0, 1, 2, 3]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a["bins"], b["bins"])
    assert (stats.io_retries, stats.io_giveups) == (jstats.io_retries, jstats.io_giveups)
    assert stats.io_retries == count
    assert [(s, n) for s, n, _ in inj.fired] == [(s, n) for s, n, _ in jinj.fired]


def test_prefetcher_gives_up_after_its_attempt_budget(tmp_path):
    stats = TransferStats()
    store = PageStore(str(tmp_path), stats=stats)
    _write(store, _pages())
    plan = FaultPlan.of(FaultSpec(site="page_store.read_page", at=2, count=-1))
    with injected(plan), pytest.raises(RuntimeError, match="page 1 failed to load"):
        list(Prefetcher(store.read_page, range(4), retry=RetryPolicy(max_attempts=2,
                                                                     base_delay=0.0),
                        stats=stats))
    assert stats.io_giveups >= 1


def test_unported_codecs_raise(tmp_path):
    """A cache the reference wrote compressed opens and reads the
    reference's arrays: the bitpack, delta-rle and chained codecs, in zstd
    blobs too."""
    for name, compress in (("bitpack", False), ("delta-rle", True), ("bitpack+delta-rle", True)):
        root = str(tmp_path / name.replace("+", "_"))
        store = j_pages.PageStore(root, stats=j_pages.TransferStats(), codec=name,
                                  compress=compress)
        store.write_page({"bins": _pages()[0] % 16, "labels": np.arange(30, dtype=np.float32)},
                         {"row_offset": 0, "n_rows": 30})
        port = PageStore(root)
        assert port.n_pages == 1 and port.page_meta(0)["codec"] == name
        got, want = port.read_page(0), store.read_page(0)
        assert got.keys() == want.keys()
        for key in want:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])


def _cache_ops(seed, n_ops=300):
    rng = np.random.default_rng(seed)
    for _ in range(n_ops):
        op = rng.choice(["put", "put", "lookup", "pin", "unpin", "contains", "put_pinned"])
        key = ("page" if rng.random() < 0.7 else "forest/8", int(rng.integers(0, 12)))
        yield op, key, int(rng.integers(1, 400))


@pytest.mark.parametrize("max_pages,max_bytes,seed", [(4, None, 0), (3, 900, 1), (8, 1500, 2)])
def test_device_page_cache_follows_the_reference(max_pages, max_bytes, seed):
    port, ref = DevicePageCache(max_pages, max_bytes), JCache(max_pages, max_bytes)
    for op, key, nbytes in _cache_ops(seed):
        if op in ("put", "put_pinned"):
            value = f"v{key}{nbytes}"
            assert port.put(key, value, nbytes, op == "put_pinned") == ref.put(
                key, value, nbytes, op == "put_pinned")
        elif op == "lookup":
            assert port.lookup(key) == ref.lookup(key)
        else:
            assert getattr(port, op)(key) == getattr(ref, op)(key)
        state = lambda c: (c.n_pages, c.nbytes, c.pinned_pages, c.pinned_bytes, c.hits,
                           c.misses, c.oversize_puts, c.hit_rate, c.tag_counts("forest"),
                           sorted(k for k in c._entries))
        assert state(port) == state(ref)
    port.clear()
    assert (port.n_pages, port.hits, port.misses) == (0, 0, 0)


def test_page_stream_is_reiterable_and_books_the_reference_bytes(tmp_path):
    pages = _pages()
    _write(PageStore(str(tmp_path), stats=TransferStats()), pages)
    stats, jstats = TransferStats(), j_pages.TransferStats()
    store = PageStore(str(tmp_path), stats=stats)
    jstore = j_pages.PageStore(str(tmp_path), stats=jstats)
    cache, jcache = DevicePageCache(2), JCache(2)
    unwrap = lambda i, a: a["bins"]  # noqa: E731
    stream = PageStream.from_store(store, unwrap, device=CPU, cache=cache, staging_depth=2)
    jstream = JStream.from_store(jstore, unwrap, cache=jcache, staging_depth=2)
    for _ in range(2):
        got = [(sp.index, sp.device) for sp in stream]
        want = [(sp.index, np.asarray(sp.device)) for sp in jstream]
        assert [i for i, _ in got] == [i for i, _ in want] == [0, 1, 2, 3]
        for (_, a), (_, b) in zip(got, want):
            assert a.dtype == torch.uint8 and a.device == CPU
            np.testing.assert_array_equal(a.numpy(), b)
    for field in ("host_to_device_bytes", "logical_bytes", "wire_bytes", "disk_read_bytes",
                  "page_loads", "cache_hits", "cache_misses", "cache_hit_bytes"):
        assert getattr(stats, field) == getattr(jstats, field), field
    assert stats.host_to_device_bytes == 2 * sum(p.nbytes for p in pages) - stats.cache_hit_bytes
    assert stats.stream_wall_seconds > 0 and stats.stream_fetch_seconds > 0


def test_page_stream_from_host_pages_keeps_global_indices():
    pages = _pages()
    assert [sp.index for sp in PageStream.from_host_pages(pages, device=CPU)] == [0, 1, 2, 3]
    stats = TransferStats()
    stream = PageStream(pages.__getitem__, [3, 1], device=CPU, stats=stats)
    got = [(sp.index, sp.device) for sp in stream]
    assert [i for i, _ in got] == [3, 1]
    np.testing.assert_array_equal(got[0][1].numpy(), pages[3])
    assert stats.host_to_device_bytes == pages[3].nbytes + pages[1].nbytes
    # staged tensors are copies: the host page can be reused
    got[1][1][0, 0] = 0
    assert pages[1][0, 0] == _pages()[1][0, 0]
