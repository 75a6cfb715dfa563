"""The port's page codecs and quantized gradient transport against the
reference (`repro.compress`), on the CPU.

Host codecs must give the reference's payload and meta byte for byte, and
decode what the reference wrote; the plain bitpack decode (what a CPU tensor
runs, and what the CUDA kernel is held against) equals the reference's
``device_decode`` and both packages' host decodes, at the CUDA kernel's
tile edges and from a payload view that is not 16-byte aligned; `ForestPageTransport` equals the reference's at odd and
even node counts and on its raw fallback; `GradQuantizer` is bitwise the
reference's in every mode. A page cache written by either package under any
codec (zstd framed too) reads in the other, and a stream over a bitpack
store stages the stored payload as it is. Fits and predictions under a
lossless codec equal the raw ones bit for bit; the reference's fits are held
with `assert_trees_equal`. The lossy spill transports are held by the
reference's own bounds.
"""
import json

import numpy as np
import pytest
import torch
from oracle import assert_forests_equal

from repro import compress as jc
from repro.core.booster import BoosterParams as JParams
from repro.core.booster import GradientBooster as JBooster
from repro.core.histcache import HistogramStore as JStore
from repro.core.policy import ExecutionPolicy as JPolicy
from repro.data import pages as j_pages
from repro.data.dmatrix import IterDMatrix as JIterDMatrix
from repro.data.dmatrix import PagedDMatrix as JPagedDMatrix
from repro.serve import ForestServer as JForestServer
from repro_torch import compress as tc
from repro_torch.core.booster import BoosterParams, GradientBooster
from repro_torch.core.histcache import HistogramStore
from repro_torch.core.objectives import auc
from repro_torch.core.policy import ExecutionPolicy
from repro_torch.data import pages as t_pages
from repro_torch.data.dmatrix import ArrayDMatrix, IterDMatrix, PagedDMatrix
from repro_torch.data.pages import PageCorruptError, PageDecodeError, PageStore, TransferStats
from repro_torch.data.synthetic import make_classification
from repro_torch.fault import FaultSpec, injected
from repro_torch.kernels import bitpack as k_bitpack
from repro_torch.kernels import ref
from repro_torch.serve import ForestServer

CPU = torch.device("cpu")
CODECS = ["raw", "bitpack", "delta-rle", "bitpack+delta-rle"]
M = 12
PAGE_BYTES = M * 160  # 160-row pages: 5 pages of 720 rows
PARAMS = dict(n_estimators=3, max_depth=3, max_bin=32, learning_rate=0.3,
              objective="binary:logistic")
FIELDS = ("feature", "split_bin", "split_value", "default_left", "is_leaf", "leaf_value")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _pages():
    """uint8 pages covering the codec edge cases (the reference's grid)."""
    rng = np.random.default_rng(0)
    sorted_page = np.sort(rng.integers(0, 16, size=(64, 8)).astype(np.uint8), axis=None)
    with_missing = rng.integers(0, 64, size=(33, 7)).astype(np.uint8)
    with_missing[rng.random(with_missing.shape) < 0.2] = 255
    one_missing_row = rng.integers(0, 5, size=(9, 3)).astype(np.uint8)
    one_missing_row[4] = 255
    return [
        rng.integers(0, 32, size=(50, 4)).astype(np.uint8),
        rng.integers(0, 64, size=(128, 28)).astype(np.uint8),
        with_missing,
        sorted_page.reshape(64, 8),
        np.full((10, 3), 255, dtype=np.uint8),  # all missing
        one_missing_row,
        np.zeros((0, 4), dtype=np.uint8),  # empty page
        np.arange(256, dtype=np.uint8).reshape(1, 256),  # full alphabet
        rng.integers(0, 2, size=(17,)).astype(np.uint8),  # 1-D, binary
        rng.integers(0, 7, size=(3, 2, 5)).astype(np.uint8),  # 3-D
    ]


def _page_at_bits(bits: int, missing: bool, rows: int = 37, cols: int = 11, seed: int = 0):
    """A page whose bitpack width is exactly ``bits``; ``cols * bits`` does
    not fill whole bytes for odd widths."""
    rng = np.random.default_rng(seed + bits)
    # the largest real symbol; the missing symbol takes top + 1, and 255
    # is MISSING_BIN itself
    top = (1 << bits) - 2 if missing else min((1 << bits) - 1, 254)
    page = rng.integers(0, top + 1, size=(rows, cols)).astype(np.uint8)
    page[0, 0] = top
    if missing:
        page[rng.random(page.shape) < 0.1] = 255
        page[3] = 255  # one all-missing row
        page[0, 0] = top
    return page


# ------------------------------------------------------------------ codec layer
@pytest.mark.parametrize("name", CODECS)
def test_encode_is_the_reference_encode(name):
    for page in _pages():
        got, meta = tc.get_codec(name).encode(page)
        want, jmeta = jc.get_codec(name).encode(page)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        assert json.dumps(meta) == json.dumps(jmeta)  # manifests are shared


@pytest.mark.parametrize("name", CODECS)
def test_decode_reads_the_reference_payloads(name):
    for page in _pages():
        payload, meta = jc.get_codec(name).encode(page)
        meta = json.loads(json.dumps(meta))  # as a manifest hands it back
        got = tc.get_codec(name).decode(payload, meta)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, jc.get_codec(name).decode(payload, meta))
        np.testing.assert_array_equal(got, page)


# the CUDA kernel's tile edges (`tests/test_torch_cuda.py` holds it there):
# R - 1, R, R + 1 and 4R + 3 rows at 500 symbols a row and at 13
BITPACK_EDGES = [
    (rows, cols)
    for cols in (500, 13)
    for rows in (k_bitpack.tile_rows(cols) - 1, k_bitpack.tile_rows(cols),
                 k_bitpack.tile_rows(cols) + 1, 4 * k_bitpack.tile_rows(cols) + 3)
]


def _check_plain_decode(page, payload, meta):
    """The plain decode of ``payload`` (a CPU tensor) equals the reference's
    jnp ``device_decode``, both packages' host decodes and the page."""
    want = np.asarray(jc.BitpackCodec().device_decode(np.asarray(payload), meta)).astype(np.uint8)
    got = ref.bitpack_decode(payload, page.shape[1], meta["bits"], meta["missing"])
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tc.BitpackCodec().decode(payload.numpy(), meta), want)
    np.testing.assert_array_equal(jc.BitpackCodec().decode(payload.numpy(), meta), want)
    dev = tc.BitpackCodec().device_decode(payload, meta)
    np.testing.assert_array_equal(dev.numpy(), page)


@pytest.mark.parametrize("bits", range(1, 9))
@pytest.mark.parametrize("missing", [False, True])
@pytest.mark.parametrize("rows,cols", [(37, 11)] + BITPACK_EDGES)
def test_plain_bitpack_decode_is_the_reference_device_decode(bits, missing, rows, cols):
    page = _page_at_bits(bits, missing, rows=rows, cols=cols)
    payload, meta = jc.BitpackCodec().encode(page)
    assert meta["bits"] == bits and (meta["missing"] is not None) == missing
    _check_plain_decode(page, torch.from_numpy(payload), meta)


@pytest.mark.parametrize("offset", [1, 3, 8, 15])
@pytest.mark.parametrize("bits,rows,cols", [(6, 131, 500), (3, 1249, 13)])
def test_plain_bitpack_decode_reads_a_view_into_a_buffer(offset, bits, rows, cols):
    """A payload that is a view ``offset`` bytes into a larger buffer (what
    the kernel cannot copy in bulk) decodes as the reference decodes it."""
    page = _page_at_bits(bits, True, rows=rows, cols=cols, seed=offset)
    payload, meta = jc.BitpackCodec().encode(page)
    buf = torch.zeros(payload.size + offset + 16, dtype=torch.uint8)
    view = buf[offset : offset + payload.size].view(payload.shape)
    view.copy_(torch.from_numpy(payload))
    assert view.data_ptr() % 16 != 0 and view.is_contiguous()
    _check_plain_decode(page, view, meta)


def test_plain_bitpack_decode_bounds_its_chunks(monkeypatch):
    """Rows decode in chunks: a chunk of a few rows gives the same bytes."""
    page = _page_at_bits(5, True, rows=301, cols=23)
    payload, meta = tc.BitpackCodec().encode(page)
    whole = ref.bitpack_decode(torch.from_numpy(payload), 23, 5, meta["missing"])
    monkeypatch.setattr(ref, "_BITPACK_CHUNK_SYMS", 50)
    chunked = ref.bitpack_decode(torch.from_numpy(payload), 23, 5, meta["missing"])
    assert torch.equal(whole, chunked) and np.array_equal(whole.numpy(), page)


def test_the_kernel_wrapper_takes_cuda_tensors_only():
    payload, meta = tc.BitpackCodec().encode(_page_at_bits(3, False))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        k_bitpack.bitpack_decode(torch.from_numpy(payload), 11, 3, None)


def test_bitpack_adapts_bits_and_rejects_stale_meta():
    rng = np.random.default_rng(1)
    full64 = rng.integers(0, 64, size=(256, 16)).astype(np.uint8)
    full64[0, 0] = 63
    payload, meta = tc.BitpackCodec().encode(full64)
    assert meta["bits"] == 6 and meta["missing"] is None
    assert payload.nbytes / full64.nbytes == 0.75
    # the port checks the payload's geometry against its meta (the
    # reference raises on the first and last of these, and decodes the
    # middle one to other symbols)
    for bad in (dict(meta, bits=9), dict(meta, bits=3), dict(meta, shape=[255, 16])):
        with pytest.raises(ValueError):
            tc.BitpackCodec().decode(payload, bad)
    for bad in (dict(meta, bits=9), dict(meta, shape=[255, 16])):
        with pytest.raises(ValueError):
            jc.BitpackCodec().decode(payload, bad)


def test_encoded_page_decodes_rows_on_their_own():
    page = _page_at_bits(7, True, rows=40, cols=9)
    payload, meta = tc.BitpackCodec().encode(page)
    enc = tc.EncodedPage(payload, meta, tc.get_codec("bitpack"))
    assert enc.shape == page.shape and enc.nbytes == page.nbytes
    np.testing.assert_array_equal(np.asarray(enc), page)
    rows = np.asarray([0, 3, 3, 17, 39])
    np.testing.assert_array_equal(enc[rows], page[rows])
    np.testing.assert_array_equal(enc[5:9], page[5:9])


def test_registry_chains_transports_and_model_bits():
    assert tc.available_codecs() == jc.available_codecs()
    assert tc.get_codec(None).name == "raw"
    chain = tc.get_codec("bitpack+delta-rle")
    assert [c.name for c in chain.codecs] == ["bitpack", "delta-rle"]
    with pytest.raises(ValueError, match="unknown page codec") as err:
        tc.get_codec("gzip")
    with pytest.raises(ValueError) as jerr:
        jc.get_codec("gzip")
    assert str(err.value) == str(jerr.value)
    for name in (None, "raw", "delta-rle", "bitpack+delta-rle", "bitpack"):
        assert (tc.make_transport(name) is None) == (jc.make_transport(name) is None)
    with pytest.raises(ValueError, match="cannot decode on device"):
        tc.PageTransport(tc.DeltaRLECodec())
    for name in ("raw", "delta-rle", "bitpack", "bitpack+delta-rle"):
        for n_bins in (1, 2, 16, 31, 32, 63, 64, 255):
            assert tc.model_bits(name, n_bins) == jc.model_bits(name, n_bins)
    assert tc.__all__ == jc.__all__


def _forest_page(n_trees: int, depth: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n_nodes = 2 ** (depth + 1) - 1
    page = np.stack([
        rng.integers(0, 500, (n_trees, n_nodes)),
        rng.integers(0, 255, (n_trees, n_nodes)),
        rng.normal(size=(n_trees, n_nodes)),
        rng.integers(0, 2, (n_trees, n_nodes)),
        rng.integers(0, 2, (n_trees, n_nodes)),
        rng.normal(size=(n_trees, n_nodes)),
    ]).astype(np.float32)
    return page


@pytest.mark.parametrize("n_trees,depth", [(3, 2), (4, 2), (1, 0), (5, 3), (2, 4)])
def test_forest_transport_is_the_reference_at_odd_and_even_n(n_trees, depth):
    from repro.serve.forest import PackedForest as JPackedForest
    from repro_torch.serve.forest import PackedForest

    page = _forest_page(n_trees, depth, seed=n_trees * 10 + depth)
    wire, meta = tc.ForestPageTransport().encode(page)
    jwire, jmeta = jc.ForestPageTransport().encode(page)
    np.testing.assert_array_equal(wire, jwire)
    assert meta == jmeta and meta["mode"] == "packed"
    assert wire.nbytes * 24 == page.nbytes * 14
    # decode from a payload at an odd storage offset too: each segment is
    # copied to an aligned tensor before its bitcast
    shifted = torch.from_numpy(np.concatenate([[7], wire]).astype(np.uint8))[1:]
    want = jc.ForestPageTransport().decode(jwire, jmeta)
    plain = PackedForest.unpack_page(torch.from_numpy(page))
    jplain = JPackedForest.unpack_page(page)
    for dev in (torch.from_numpy(wire), shifted):
        got = tc.ForestPageTransport().decode(dev, meta)
        for key in FIELDS:
            assert got[key].dtype == plain[key].dtype and got[key].is_contiguous()
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
            np.testing.assert_array_equal(got[key].numpy(), plain[key].numpy())
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(jplain[key]))


def test_forest_transport_raw_fallback():
    page = _forest_page(3, 1, seed=5)
    page[0, 1, 2] = 40_000.0  # a node id past int16
    wire, meta = tc.ForestPageTransport().encode(page)
    jwire, jmeta = jc.ForestPageTransport().encode(page)
    assert meta == jmeta and meta["mode"] == "raw"
    np.testing.assert_array_equal(wire, jwire)
    got = tc.ForestPageTransport().decode(torch.from_numpy(wire), meta)
    want = jc.ForestPageTransport().decode(jwire, jmeta)
    for key in FIELDS:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))


# -------------------------------------------------------------- grad quantizer
@pytest.mark.parametrize("mode", ["raw", "f16", "bf16", "int8"])
def test_grad_quantizer_is_the_reference_bit_for_bit(mode):
    rng = np.random.default_rng(3)
    vals = (rng.normal(size=(4, 9, 16, 2)) * 37.0).astype(np.float32)
    vals[0, 0, 0] = [0.5, -1.5]  # halves: round half to even
    q, jq = tc.GradQuantizer(mode), jc.GradQuantizer(mode)
    payload, scale = q.quantize(torch.from_numpy(vals))
    jpayload, jscale = jq.quantize(vals)
    assert (scale is None) == (jscale is None) == (mode != "int8")
    if mode == "bf16":  # numpy has no bf16: compare the bit patterns
        got_bits = payload.view(torch.int16).numpy()
        want_bits = np.asarray(jpayload).view(np.int16)
        np.testing.assert_array_equal(got_bits, want_bits)
    else:
        assert payload.numpy().dtype == np.asarray(jpayload).dtype
        np.testing.assert_array_equal(payload.numpy(), np.asarray(jpayload))
    if scale is not None:
        assert scale.dtype == torch.float32 and scale.dim() == 0
        assert np.float32(scale.item()).tobytes() == np.asarray(jscale).tobytes()
    back = q.dequantize(payload, scale)
    jback = np.asarray(jq.dequantize(jpayload, jscale))
    assert back.dtype == torch.float32
    np.testing.assert_array_equal(back.numpy().view(np.int32), jback.view(np.int32))


def test_grad_quantizer_psum_guard_and_names():
    assert tc.GRAD_TRANSPORTS == jc.GRAD_TRANSPORTS
    assert tc.PSUM_TRANSPORTS == jc.PSUM_TRANSPORTS
    raw = tc.GradQuantizer.resolve(None)
    assert raw.is_raw and raw is tc.GradQuantizer.resolve(raw)
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(3, 5)).astype(np.float32))
    with pytest.raises(ValueError, match="int8") as err:
        tc.GradQuantizer("int8").psum_cast(x)
    with pytest.raises(ValueError) as jerr:
        jc.GradQuantizer("int8").psum_cast(x.numpy())
    assert str(err.value) == str(jerr.value)
    for mode in ("raw", "f16", "bf16"):
        q, jq = tc.GradQuantizer(mode), jc.GradQuantizer(mode)
        got = q.psum_restore(q.psum_cast(x)).numpy()
        want = np.asarray(jq.psum_restore(jq.psum_cast(x.numpy())))
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="grad transport"):
        tc.GradQuantizer("fp4")


# ------------------------------------------------------------------- page store
@pytest.fixture(scope="module")
def data():
    X, y = make_classification(720, M, class_sep=1.2, missing_rate=0.05, seed=31)
    Xe, ye = make_classification(240, M, class_sep=1.2, missing_rate=0.05, seed=31, batch=1)
    batches = [(X[i : i + 200], y[i : i + 200]) for i in range(0, 720, 200)]
    return X, y, Xe, ye, batches


STORES = [("bitpack", False), ("delta-rle", False), ("raw", True), ("bitpack", True)]


@pytest.mark.parametrize("codec,compress", STORES)
def test_caches_read_across_packages(codec, compress, data, tmp_path):
    """A cache the reference wrote under a codec (zstd framed or not) reads
    in the port's `PagedDMatrix`, and the reverse; manifests match."""
    X, y, _, _, batches = data
    jroot, troot = str(tmp_path / "ref"), str(tmp_path / "port")
    jdm = JIterDMatrix(batches, max_bin=32, cache_dir=jroot, page_bytes=PAGE_BYTES,
                       page_codec=codec, compress=compress)
    IterDMatrix(batches, max_bin=32, cuts=jdm.cuts, cache_dir=troot, page_bytes=PAGE_BYTES,
                page_codec=codec, compress=compress, device="cpu")
    for root in (jroot, troot):
        want = JPagedDMatrix(root).single_page_bins()
        got = PagedDMatrix(root).single_page_bins()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, jdm.single_page_bins())
    jman, tman = (json.load(open(f"{r}/manifest.json")) for r in (jroot, troot))
    assert jman == tman  # same blobs, CRCs, codecs and codec metas
    tag = open(f"{troot}/page_000000.bin", "rb").read(4)
    assert tag == (b"ZST0" if compress else b"RAW0")


def test_zstd_blob_without_the_module_is_a_decode_error(data, tmp_path, monkeypatch):
    _, _, _, _, batches = data
    root = str(tmp_path / "z")
    IterDMatrix(batches, max_bin=32, cache_dir=root, page_bytes=PAGE_BYTES, compress=True,
                device="cpu")
    monkeypatch.setattr(t_pages, "_zstd", None)
    with pytest.raises(PageDecodeError, match="zstandard not installed"):
        PageStore(root).read_page(0)
    monkeypatch.undo()
    monkeypatch.setattr(t_pages, "_zstd", None)  # written without the module: RAW0
    PageStore(str(tmp_path / "w"), compress=True).write_page({"bins": _pages()[0]})
    assert open(f"{tmp_path}/w/page_000000.bin", "rb").read(4) == b"RAW0"


def test_stored_bitpack_payload_stages_as_stored(data, tmp_path, monkeypatch):
    """Every page of a bitpack store re-encodes to its stored payload and
    meta; a bitpack stream stages the stored payload without a host decode
    or encode, and books the reference's bytes."""
    _, _, _, _, batches = data
    root = str(tmp_path / "bp")
    jdm = JIterDMatrix(batches, max_bin=32, cache_dir=root, page_bytes=PAGE_BYTES,
                       page_codec="bitpack")
    store = PageStore(root)
    codec = tc.get_codec("bitpack")
    for idx in range(store.n_pages):
        enc = store.read_page(idx, keep="bitpack")["bins"]
        assert isinstance(enc, tc.EncodedPage)
        payload, meta = codec.encode(np.asarray(enc))
        np.testing.assert_array_equal(payload, enc.payload)
        assert json.dumps(meta) == json.dumps(enc.meta)

    dm = PagedDMatrix(root)
    want = [p.bins for _, p in dm.page_set().iter_pages()]

    def refuse(*a, **k):
        raise AssertionError("a stored bitpack page was decoded or re-encoded on the host")

    monkeypatch.setattr(tc.BitpackCodec, "encode", refuse)
    monkeypatch.setattr(tc.BitpackCodec, "decode", refuse)
    stats = TransferStats()
    got = [sp.device for sp in dm.page_set().stream(device="cpu", codec="bitpack", stats=stats)]
    monkeypatch.undo()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.uint8 and np.array_equal(g.numpy(), w)
    jstats = j_pages.TransferStats()
    for _ in jdm.page_set().stream(codec="bitpack", stats=jstats):
        pass
    for f in ("host_to_device_bytes", "logical_bytes", "wire_bytes", "page_loads",
              "disk_read_bytes"):
        assert getattr(stats, f) == getattr(jstats, f), f
    assert stats.wire_bytes < stats.logical_bytes


def test_decode_damage_is_a_page_decode_error(data, tmp_path):
    _, _, _, _, batches = data
    root = str(tmp_path / "bp")
    dm = IterDMatrix(batches, max_bin=32, cache_dir=root, page_bytes=PAGE_BYTES,
                     page_codec="bitpack", device="cpu")
    ps = dm.page_set()
    with injected([FaultSpec(site="page_store.decode", at=2)]) as inj:
        with pytest.raises(PageDecodeError, match=r"page 1 failed 'bitpack' decode"):
            for _ in ps.stream(device="cpu", codec="bitpack"):
                pass
        assert [(site, n) for site, n, _ in inj.fired] == [("page_store.decode", 2)]
    assert ps.stats.io_retries == 0 and ps.stats.io_giveups == 0
    store = PageStore(root)
    store._meta["pages"][0]["codec_meta"]["bins"]["bits"] += 3  # stale meta
    for keep in (None, "bitpack"):
        with pytest.raises(PageDecodeError, match="'bitpack'"):
            store.read_page(0, keep=keep)
    assert issubclass(PageDecodeError, PageCorruptError)


# ------------------------------------------------------------- fits and serving
@pytest.fixture(scope="module")
def ref_cache(data, tmp_path_factory):
    """The reference's raw page cache, whose cuts every fit below shares."""
    _, _, _, _, batches = data
    root = str(tmp_path_factory.mktemp("compress") / "raw")
    JIterDMatrix(batches, max_bin=32, cache_dir=root, page_bytes=PAGE_BYTES)
    return root


def _same_trees(a, b) -> bool:
    return len(a) == len(b) and all(
        torch.equal(getattr(s, f), getattr(t, f)) for s, t in zip(a, b) for f in FIELDS
    )


@pytest.mark.parametrize("codec", ["bitpack", "delta-rle", "bitpack+delta-rle"])
def test_out_of_core_fits_under_each_codec(codec, data, ref_cache, tmp_path):
    """Streaming fits over a store written under each codec, or staging
    through it, grow the raw fit's trees bit for bit, and the reference's
    trees on the same store."""
    _, _, Xe, ye, batches = data
    cuts = PagedDMatrix(ref_cache).cuts
    root = str(tmp_path / "pages")
    IterDMatrix(batches, max_bin=32, cuts=cuts, cache_dir=root, page_bytes=PAGE_BYTES,
                page_codec=codec, device="cpu")
    raw = GradientBooster(device="cpu", policy=ExecutionPolicy(mode="out_of_core"), **PARAMS)
    raw.fit(PagedDMatrix(ref_cache), eval_set=(Xe, ye))
    policy = ExecutionPolicy(mode="out_of_core", page_codec=codec)
    port = GradientBooster(device="cpu", policy=policy, **PARAMS)
    port.fit(PagedDMatrix(root), eval_set=(Xe, ye))
    assert _same_trees(port.trees, raw.trees)
    assert [r.value for r in port.eval_history] == [r.value for r in raw.eval_history]
    jpolicy = JPolicy(mode="out_of_core", page_codec=codec)
    jb = JBooster(JParams(**PARAMS), policy=jpolicy).fit(JPagedDMatrix(root))
    assert_forests_equal(port.trees, jb.trees)
    for f in ("host_to_device_bytes", "logical_bytes", "wire_bytes"):
        assert getattr(port.stats, f) == getattr(jb.stats, f), f
    if tc.make_transport(codec) is not None:
        assert port.stats.wire_bytes < 0.8 * port.stats.logical_bytes
    else:
        assert port.stats.wire_bytes == port.stats.logical_bytes > 0
    np.testing.assert_array_equal(port.predict_margin(PagedDMatrix(root)),
                                  raw.predict_margin(PagedDMatrix(ref_cache)))


@pytest.mark.parametrize("mode", ["in_core", "sampled"])
def test_in_core_and_sampled_fits_stage_through_bitpack(mode, data, ref_cache):
    """In core the matrix and on the sampled path the compacted page cross
    packed, and the trees are the raw fit's bit for bit."""
    _, _, Xe, ye, _ = data
    kw = dict(PARAMS)
    if mode == "sampled":
        from repro_torch.core.sampling import SamplingConfig

        kw["sampling"] = SamplingConfig(method="mvs", f=0.5)
    fits = {}
    for codec in ("raw", "bitpack"):
        policy = ExecutionPolicy(mode="in_core" if mode == "in_core" else "out_of_core",
                                 page_codec=codec)
        fits[codec] = GradientBooster(device="cpu", policy=policy, **kw).fit(
            PagedDMatrix(ref_cache), eval_set=(Xe, ye))
    assert fits["bitpack"].decision_.mode == fits["raw"].decision_.mode == mode
    assert _same_trees(fits["bitpack"].trees, fits["raw"].trees)
    st = fits["bitpack"].stats
    assert 0 < st.wire_bytes < st.logical_bytes == fits["raw"].stats.logical_bytes
    assert st.host_to_device_bytes < fits["raw"].stats.host_to_device_bytes


def test_policy_bits_and_decisions_are_the_reference(data, ref_cache):
    dm, jdm = PagedDMatrix(ref_cache), JPagedDMatrix(ref_cache)
    params, jparams = BoosterParams(**PARAMS), JParams(**PARAMS)
    for codec in ("raw", "bitpack", "delta-rle", "bitpack+delta-rle"):
        model = ExecutionPolicy(page_codec=codec).memory_model(dm, params)
        jmodel = JPolicy(page_codec=codec).memory_model(jdm, jparams)
        assert model.page_codec_bits == jmodel.page_codec_bits
        assert model.page_codec_bits == (6 if codec == "bitpack" else 8)
        need_core, need_stream = model.in_core_bytes(dm.n_rows), model.out_of_core_bytes(dm.n_rows)
        for budget in (need_stream - 1, need_stream, need_core - 1, need_core, 2 * need_core):
            kw = dict(page_codec=codec, memory_budget_bytes=budget)
            try:
                got = ExecutionPolicy(**kw).decide(dm, params)
            except ValueError as err:
                with pytest.raises(ValueError) as jerr:
                    JPolicy(**kw).decide(jdm, jparams)
                assert str(err) == str(jerr.value)
                continue
            want = JPolicy(**kw).decide(jdm, jparams)
            assert (got.mode, got.sampling_f, got.reason) == (
                want.mode, want.sampling_f, want.reason)
    for bad in (dict(page_codec="gzip"), dict(grad_transport="fp4")):
        with pytest.raises(ValueError) as err:
            ExecutionPolicy(**bad)
        with pytest.raises(ValueError) as jerr:
            JPolicy(**bad)
        assert str(err.value) == str(jerr.value)
    ExecutionPolicy(grad_transport="int8")  # fine for the spill


@pytest.mark.parametrize("mode,divisor", [("raw", 1), ("f16", 2), ("bf16", 2), ("int8", 4)])
def test_hist_store_spill_fetch_wire(mode, divisor):
    """The store's quantized spill ledger and values, the reference's."""
    import jax.numpy as jnp

    rng = np.random.default_rng(7)
    vals = rng.normal(size=(6, 16, 2)).astype(np.float32)
    ts, jts = TransferStats(), j_pages.TransferStats()
    store = HistogramStore(transfer_stats=ts, grad_transport=mode)
    jstore = JStore(transfer_stats=jts, grad_transport=mode)
    key = ("tree", 0, 0)
    store._put(key, torch.from_numpy(vals), "level", 0.0)
    jstore._put(key, jnp.asarray(vals), "level", 0.0)
    store._spill(key)
    jstore._spill(key)
    assert store.tier_of(key) == jstore.tier_of(key) == "host"
    assert ts.hist_spill_bytes == ts.device_to_host_bytes == vals.nbytes // divisor
    out = store._fetch(key, CPU)
    jout = np.asarray(jstore._fetch(key))
    assert out.dtype == torch.float32 and store.tier_of(key) == "device"
    np.testing.assert_array_equal(out.numpy().view(np.int32), jout.view(np.int32))
    for f in ("hist_spills", "hist_fetches", "hist_spill_bytes", "hist_fetch_bytes",
              "device_to_host_bytes", "host_to_device_bytes", "logical_bytes", "wire_bytes"):
        assert getattr(ts, f) == getattr(jts, f), f
    assert ts.logical_bytes == vals.nbytes and ts.wire_bytes == vals.nbytes // divisor
    if mode == "raw":
        np.testing.assert_array_equal(out.numpy(), vals)
    else:
        assert np.abs(out.numpy() - vals).max() <= np.abs(vals).max() / 100


def test_booster_spill_transport_end_to_end():
    """The policy knob reaches the store: f16, bf16 and int8 spills move a
    half, a half and a quarter of the raw run's bytes, and the model stays
    within the reference's bound (eval AUC within 0.02 of raw)."""
    rng = np.random.default_rng(8)
    X = rng.normal(size=(500, 6)).astype(np.float32)
    y = (X[:, 0] + rng.normal(scale=0.2, size=500) > 0).astype(np.float32)
    params = dict(n_estimators=3, max_depth=8, max_bin=16, objective="binary:logistic",
                  seed=0, grow_policy="lossguide", max_leaves=32)
    kw = dict(mode="in_core", hist_budget_bytes=2048, hist_retained_levels=2)
    fits = {
        mode: GradientBooster(device="cpu", policy=ExecutionPolicy(**kw, grad_transport=mode),
                              **params).fit(X, y)
        for mode in ("raw", "f16", "bf16", "int8")
    }
    jraw = JBooster(JParams(**params), policy=JPolicy(**kw)).fit(X, y)
    raw = fits["raw"]
    assert raw.stats.hist_spills == jraw.stats.hist_spills > 0
    assert raw.stats.hist_spill_bytes == jraw.stats.hist_spill_bytes
    raw_auc = auc(y, raw.predict(X))
    for mode, divisor in (("f16", 2), ("bf16", 2), ("int8", 4)):
        b = fits[mode]
        assert b.hist_cache.quantizer.mode == mode
        assert b.stats.hist_spills > 0
        assert b.stats.hist_spill_bytes * divisor == (
            b.stats.hist_spills * raw.stats.hist_spill_bytes // raw.stats.hist_spills)
        assert auc(y, b.predict(X)) > raw_auc - 0.02
    again = GradientBooster(device="cpu", policy=ExecutionPolicy(**kw, grad_transport="int8"),
                            **params).fit(X, y)
    assert _same_trees(again.trees, fits["int8"].trees)


def test_serving_page_codec_bit_exact_and_thinner(data, ref_cache):
    X, _, _, _, _ = data
    b = GradientBooster(device="cpu", policy=ExecutionPolicy(mode="in_core"), **PARAMS)
    b.fit(PagedDMatrix(ref_cache))
    jb = JBooster(JParams(**PARAMS), policy=JPolicy(mode="in_core")).fit(JPagedDMatrix(ref_cache))
    dm, jdm = PagedDMatrix(ref_cache), JPagedDMatrix(ref_cache)
    raw = ForestServer(b, trees_per_chunk=2)
    packed = ForestServer(b, trees_per_chunk=2, page_codec="bitpack")
    jpacked = JForestServer(jb, trees_per_chunk=2, page_codec="bitpack")
    got = packed.predict_margin(dm)
    np.testing.assert_array_equal(got, raw.predict_margin(dm))
    np.testing.assert_allclose(got, jpacked.predict_margin(jdm), rtol=1e-5, atol=1e-5)
    assert packed.stats.wire_bytes < packed.stats.logical_bytes
    for f in ("host_to_device_bytes", "logical_bytes", "wire_bytes"):
        assert getattr(packed.stats, f) == getattr(jpacked.stats, f), f
    # the ndarray path pages the forest through the same transport
    np.testing.assert_array_equal(packed.predict_margin(X), raw.predict_margin(X))
    # the booster's own predict of a DMatrix takes its policy's codec
    b.policy = ExecutionPolicy(mode="in_core", page_codec="bitpack")
    np.testing.assert_array_equal(b.predict_margin(dm), raw.predict_margin(dm))


def test_array_dmatrix_pages_stream_through_bitpack(data):
    """Host-RAM pages (no store) are encoded at each stage, as in the
    reference, and decode to the same bins."""
    X, y, _, _, _ = data
    dm = ArrayDMatrix(X, y, max_bin=32, page_bytes=PAGE_BYTES, device="cpu")
    pages = [sp.device for sp in dm.page_set().stream(device="cpu", codec="bitpack")]
    np.testing.assert_array_equal(torch.cat(pages).numpy(), dm.single_page_bins())
    assert dm.stats.wire_bytes < dm.stats.logical_bytes == dm.single_page_bins().nbytes
