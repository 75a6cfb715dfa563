"""Lossless page codecs for ELLPACK bin pages and packed forest chunks.

Counterpart of `repro.compress.codecs`. Host encoding is numpy and gives the
reference's payload and meta byte for byte, so a page cache written by
either package decodes in the other:

- ``RawCodec``      -- identity passthrough; the default.
- ``BitpackCodec``  -- packs uint8 bin symbols to the minimal bit width
                       (``ceil(log2(n_symbols))`` per page, adaptively), the
                       XGBoost ELLPACK trick (arxiv 1806.11248). Device-
                       decodable: the packed bytes cross to the card and the
                       bitpack decode kernel (``kernels/csrc/bitpack.cu``)
                       expands them to uint8 bins (MISSING -> 255). The
                       reference expands to int32 with jnp ops; the port's
                       pipeline stages uint8 pages, so its decode does too.
- ``DeltaRLECodec`` -- mod-256 delta + run-length coding for sorted or sparse
                       pages. Host-only: its win is disk bytes.
- ``CodecChain``    -- composition, e.g. ``"bitpack+delta-rle"``.

Bitpack packs and unpacks eight symbols at a time as one little-endian
64-bit word of ``8 * bits`` bits (eight symbols fill exactly ``bits``
bytes), rows in chunks, so host temporaries stay a few words a symbol
whatever the page size. Rows are padded to whole bytes independently, so
a packed page's rows decode on their own (`EncodedPage.__getitem__`).

`EncodedPage` is a page payload as its codec stored it, not yet decoded: a
`repro_torch.data.pages.PageStore` read for a stream whose transport uses
the page's own codec returns the payload this way, and the stream stages it
as it is, with no host decode and re-encode.

All codecs here are lossless: ``decode(encode(arr)) == arr`` exactly, for
any uint8 array including the MISSING_BIN (255) sentinel.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

__all__ = [
    "PageCodec",
    "RawCodec",
    "BitpackCodec",
    "DeltaRLECodec",
    "CodecChain",
    "EncodedPage",
    "register_codec",
    "get_codec",
    "available_codecs",
    "PageTransport",
    "ForestPageTransport",
    "make_transport",
    "model_bits",
]

Meta = Dict[str, object]

# symbols per chunk of the host pack / unpack: bounds its (rows, groups)
# uint64 temporaries to a few tens of MB whatever the page size
_HOST_CHUNK_SYMBOLS = 1 << 22


class PageCodec:
    """A lossless transform on a uint8 page payload.

    ``encode`` returns ``(payload, meta)`` where ``payload`` is a numpy array
    (what hits disk / the wire) and ``meta`` is a small JSON-serializable
    dict recorded in the page manifest. ``decode`` inverts it exactly on the
    host. Codecs with ``device_decodable=True`` also implement
    :meth:`device_decode`, which expands the *staged* payload on its device,
    and :meth:`validate`, the cheap geometry check a stored payload passes
    before it is staged undecoded.
    """

    name: str = "abstract"
    device_decodable: bool = False

    def encode(self, arr: np.ndarray) -> Tuple[np.ndarray, Meta]:
        raise NotImplementedError

    def decode(self, payload: np.ndarray, meta: Meta) -> np.ndarray:
        raise NotImplementedError

    def device_decode(self, dev: torch.Tensor, meta: Meta) -> torch.Tensor:
        raise NotImplementedError(f"codec {self.name!r} is not device-decodable")

    def validate(self, payload: np.ndarray, meta: Meta) -> None:
        raise NotImplementedError(f"codec {self.name!r} is not device-decodable")


class RawCodec(PageCodec):
    """Identity codec: the uncompressed behaviour, bit for bit."""

    name = "raw"

    def encode(self, arr: np.ndarray) -> Tuple[np.ndarray, Meta]:
        return arr, {}

    def decode(self, payload: np.ndarray, meta: Meta) -> np.ndarray:
        return payload


def _row_chunk(row_syms: int) -> int:
    return max(1, _HOST_CHUNK_SYMBOLS // max(row_syms, 1))


def _pack_rows(a2: np.ndarray, bits: int) -> np.ndarray:
    """(rows, n) uint8 symbols below ``2**bits`` -> (rows, ceil(n*bits/8))
    uint8, each row little-endian from bit 0 and zero-padded to whole bytes
    (``np.packbits(..., bitorder="little")`` of the low ``bits`` bit planes)."""
    rows, n = a2.shape
    row_bytes = (n * bits + 7) // 8
    groups = -(-n // 8)
    out = np.empty((rows, row_bytes), np.uint8)
    for lo in range(0, rows, _row_chunk(n)):
        blk = a2[lo : lo + _row_chunk(n)]
        padded = np.zeros((blk.shape[0], groups * 8), np.uint64)
        padded[:, :n] = blk
        sym = padded.reshape(blk.shape[0], groups, 8)
        word = np.zeros((blk.shape[0], groups), np.uint64)
        for k in range(8):
            word |= sym[:, :, k] << np.uint64(k * bits)
        packed = word.astype("<u8").view(np.uint8).reshape(blk.shape[0], groups, 8)
        out[lo : lo + blk.shape[0]] = packed[:, :, :bits].reshape(blk.shape[0], -1)[:, :row_bytes]
    return out


def _unpack_rows(payload: np.ndarray, row_syms: int, bits: int) -> np.ndarray:
    """Inverse of `_pack_rows`: (rows, ceil(row_syms*bits/8)) -> (rows,
    row_syms) uint8."""
    rows, row_bytes = payload.shape
    groups = -(-row_syms // 8)
    mask = np.uint64((1 << bits) - 1)
    out = np.empty((rows, row_syms), np.uint8)
    for lo in range(0, rows, _row_chunk(row_syms)):
        blk = payload[lo : lo + _row_chunk(row_syms)]
        wide = np.zeros((blk.shape[0], groups * bits), np.uint8)
        wide[:, :row_bytes] = blk
        padded = np.zeros((blk.shape[0], groups, 8), np.uint8)
        padded[:, :, :bits] = wide.reshape(blk.shape[0], groups, bits)
        word = padded.view("<u8").reshape(blk.shape[0], groups)
        sym = np.empty((blk.shape[0], groups, 8), np.uint8)
        for k in range(8):
            sym[:, :, k] = (word >> np.uint64(k * bits)) & mask
        out[lo : lo + blk.shape[0]] = sym.reshape(blk.shape[0], -1)[:, :row_syms]
    return out


class BitpackCodec(PageCodec):
    """Pack uint8 symbols to the minimal per-page bit width.

    The bit width adapts to the symbols actually present: MISSING_BIN (255)
    is remapped to ``max_real_symbol + 1`` before packing, so a 64-bin page
    with no missing values packs at 6 bits/symbol (0.75x) instead of the 8
    bits a fixed-255 alphabet would force. Packing is row-wise (each row
    padded to whole bytes independently) so a packed page can still be
    row-sharded, and its rows decoded on their own.
    """

    name = "bitpack"
    device_decodable = True
    _MISSING = 255

    def encode(self, arr: np.ndarray) -> Tuple[np.ndarray, Meta]:
        arr = np.ascontiguousarray(arr, dtype=np.uint8)
        shape = list(arr.shape)
        if arr.ndim >= 2:
            a2 = arr.reshape(shape[0], int(np.prod(shape[1:])))
        else:
            a2 = arr.reshape(1, arr.size)
        missing_mask = a2 == self._MISSING
        has_missing = bool(missing_mask.any())
        max_real = int(np.where(missing_mask, 0, a2).max(initial=0))
        missing_sym: Optional[int] = None
        if has_missing:
            missing_sym = max_real + 1
            a2 = np.where(missing_mask, np.uint8(missing_sym), a2)
        max_sym = missing_sym if has_missing else max_real
        bits = max(1, int(max_sym).bit_length())
        meta: Meta = {"shape": shape, "bits": bits, "missing": missing_sym}
        if a2.size == 0:
            return np.zeros((a2.shape[0], 0), dtype=np.uint8), meta
        return _pack_rows(a2, bits), meta

    @staticmethod
    def geometry(meta: Meta) -> Tuple[List[int], int, int, int, Optional[int]]:
        """(shape, rows, row_syms, bits, missing) of a packed page's meta;
        raises ValueError on a meta no payload can decode under."""
        shape = [int(s) for s in meta["shape"]]
        bits = int(meta["bits"])
        missing = meta.get("missing")
        if not 1 <= bits <= 8:
            raise ValueError(f"bitpack meta has bits={bits}; a uint8 symbol packs to 1-8 bits")
        if missing is not None and not 0 <= int(missing) < (1 << bits):
            raise ValueError(f"bitpack meta's missing symbol {missing} does not fit {bits} bits")
        rows = shape[0] if len(shape) >= 2 else 1
        row_syms = int(np.prod(shape[1:])) if len(shape) >= 2 else int(shape[0])
        return shape, rows, row_syms, bits, None if missing is None else int(missing)

    def validate(self, payload: np.ndarray, meta: Meta) -> None:
        """Raise ValueError unless ``payload`` holds ``rows`` rows of
        ``ceil(row_syms * bits / 8)`` bytes under ``meta``."""
        _, rows, row_syms, bits, _ = self.geometry(meta)
        want = rows * ((row_syms * bits + 7) // 8) if rows * row_syms else 0
        if payload.dtype != np.uint8 or payload.size != want:
            raise ValueError(
                f"bitpack payload of {payload.size} {payload.dtype} bytes does not match its "
                f"meta ({rows} rows x {row_syms} symbols at {bits} bits: {want} bytes)"
            )

    def decode(self, payload: np.ndarray, meta: Meta) -> np.ndarray:
        shape, rows, row_syms, bits, missing = self.geometry(meta)
        if rows * row_syms == 0:
            return np.zeros(shape, dtype=np.uint8)
        self.validate(np.asarray(payload), meta)
        payload = np.ascontiguousarray(payload, dtype=np.uint8).reshape(rows, -1)
        syms = _unpack_rows(payload, row_syms, bits)
        if missing is not None:
            syms[syms == np.uint8(missing)] = np.uint8(self._MISSING)
        return syms.reshape(shape)

    def device_decode(self, dev: torch.Tensor, meta: Meta) -> torch.Tensor:
        """Expand a staged packed payload to uint8 bins on its device (the
        bitpack decode kernel for a CUDA tensor, its plain version on the
        CPU)."""
        from repro_torch.kernels import ops

        shape, rows, row_syms, bits, missing = self.geometry(meta)
        if rows * row_syms == 0:
            return torch.zeros(shape, dtype=torch.uint8, device=dev.device)
        syms = ops.bitpack_decode(dev.reshape(rows, -1), row_syms, bits, missing)
        return syms.reshape(shape)


class DeltaRLECodec(PageCodec):
    """Mod-256 delta + run-length coding for sorted / sparse pages.

    The flat C-order symbol stream is delta-coded (first symbol kept, then
    successive differences mod 256) and run-length encoded as interleaved
    ``(value, run_length<=255)`` uint8 pairs; runs longer than 255 split.
    Host-only: its win is disk bytes.
    """

    name = "delta-rle"

    def encode(self, arr: np.ndarray) -> Tuple[np.ndarray, Meta]:
        arr = np.ascontiguousarray(arr, dtype=np.uint8)
        shape = list(arr.shape)
        flat = arr.reshape(-1)
        if flat.size == 0:
            return np.zeros(0, dtype=np.uint8), {"shape": shape}
        delta = np.empty_like(flat)
        delta[0] = flat[0]
        np.subtract(flat[1:], flat[:-1], out=delta[1:])  # uint8 wraps mod 256
        change = np.flatnonzero(delta[1:] != delta[:-1]) + 1
        starts = np.concatenate(([0], change))
        lengths = np.diff(np.concatenate((starts, [delta.size])))
        values = delta[starts]
        # split runs longer than 255
        reps = ((lengths + 254) // 255).astype(np.int64)
        out_vals = np.repeat(values, reps)
        out_lens = np.full(int(reps.sum()), 255, dtype=np.uint8)
        last = np.cumsum(reps) - 1
        out_lens[last] = (lengths - (reps - 1) * 255).astype(np.uint8)
        payload = np.empty(out_vals.size * 2, dtype=np.uint8)
        payload[0::2] = out_vals
        payload[1::2] = out_lens
        return payload, {"shape": shape}

    def decode(self, payload: np.ndarray, meta: Meta) -> np.ndarray:
        shape = [int(s) for s in meta["shape"]]
        payload = np.ascontiguousarray(payload, dtype=np.uint8)
        if payload.size == 0:
            return np.zeros(shape, dtype=np.uint8)
        values = payload[0::2]
        lengths = payload[1::2].astype(np.int64)
        delta = np.repeat(values, lengths)
        # cumsum in uint64 then truncate back to uint8 == mod-256 prefix sum
        flat = np.cumsum(delta, dtype=np.uint64).astype(np.uint8)
        return flat.reshape(shape)


class CodecChain(PageCodec):
    """Apply codecs in sequence, e.g. ``bitpack`` then ``delta-rle``."""

    device_decodable = False

    def __init__(self, codecs: Sequence[PageCodec]):
        if not codecs:
            raise ValueError("CodecChain needs at least one codec")
        self.codecs = list(codecs)
        self.name = "+".join(c.name for c in self.codecs)

    def encode(self, arr: np.ndarray) -> Tuple[np.ndarray, Meta]:
        payload = arr
        steps: List[Meta] = []
        for codec in self.codecs:
            payload, meta = codec.encode(payload)
            steps.append(meta)
        return payload, {"steps": steps}

    def decode(self, payload: np.ndarray, meta: Meta) -> np.ndarray:
        steps = meta["steps"]
        for codec, step in zip(reversed(self.codecs), reversed(list(steps))):
            payload = codec.decode(payload, step)
        return payload


_REGISTRY: Dict[str, PageCodec] = {}


def register_codec(codec: PageCodec) -> PageCodec:
    """Register a codec instance under its ``name`` for lookup by string."""
    _REGISTRY[codec.name] = codec
    return codec


register_codec(RawCodec())
register_codec(BitpackCodec())
register_codec(DeltaRLECodec())


def available_codecs() -> List[str]:
    return sorted(_REGISTRY)


def get_codec(codec: Union[str, PageCodec, None]) -> PageCodec:
    """Resolve a codec name (``"raw"``, ``"bitpack"``, ``"a+b"`` chains, or
    an already-constructed :class:`PageCodec`) to a codec instance."""
    if codec is None:
        return _REGISTRY["raw"]
    if isinstance(codec, PageCodec):
        return codec
    name = str(codec)
    if name in _REGISTRY:
        return _REGISTRY[name]
    if "+" in name:
        return CodecChain([get_codec(part) for part in name.split("+")])
    raise ValueError(
        f"unknown page codec {name!r}; available: {', '.join(available_codecs())}"
        " (compose with '+', e.g. 'bitpack+delta-rle')"
    )


@dataclasses.dataclass
class EncodedPage:
    """A uint8 page as its codec stored it: ``payload`` and ``meta`` as in
    the manifest, decoded only when the host asks for symbols.

    ``shape`` and ``nbytes`` are the decoded page's; a transport
    of the same codec stages ``payload`` as it is. ``np.asarray`` decodes the
    whole page; indexing rows of a bitpack page decodes those rows alone
    (its rows are packed independently)."""

    payload: np.ndarray
    meta: Meta
    codec: PageCodec

    @property
    def shape(self) -> tuple:
        return tuple(int(s) for s in self.meta["shape"])

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape))

    def __array__(self, dtype=None, copy=None) -> np.ndarray:
        out = self.codec.decode(self.payload, self.meta)
        return out if dtype is None else out.astype(dtype)

    def __getitem__(self, rows) -> np.ndarray:
        if isinstance(self.codec, BitpackCodec) and len(self.shape) == 2:
            part = np.ascontiguousarray(self.payload.reshape(self.shape[0], -1)[rows])
            if part.ndim == 2:
                meta = dict(self.meta, shape=[part.shape[0], self.shape[1]])
                return self.codec.decode(part, meta)
        return np.asarray(self)[rows]


class PageTransport:
    """Host -> device transport for a device-decodable codec.

    ``encode`` runs on the host and returns the wire payload plus meta (an
    `EncodedPage` of the same codec passes as it is); ``decode`` runs after
    staging and expands the device copy of the wire payload back to uint8
    bins. Only the wire payload crosses to the device.
    """

    def __init__(self, codec: PageCodec):
        if not codec.device_decodable:
            raise ValueError(f"codec {codec.name!r} cannot decode on device")
        self.codec = codec
        self.name = codec.name

    def encode(self, arr) -> Tuple[np.ndarray, Meta]:
        if isinstance(arr, EncodedPage):
            if arr.codec.name == self.name:
                return arr.payload, arr.meta
            arr = np.asarray(arr)
        return self.codec.encode(arr)

    def decode(self, dev: torch.Tensor, meta: Meta) -> torch.Tensor:
        return self.codec.device_decode(dev, meta)


def make_transport(codec: Union[str, PageCodec, None]) -> Optional[PageTransport]:
    """A :class:`PageTransport` for the staging path, or ``None``.

    ``None``/``"raw"`` and host-only codecs (delta-rle, chains) return
    ``None``: pages then stage uncompressed. Host-only codecs still shrink
    disk bytes via `repro_torch.data.pages.PageStore`; only device-decodable
    codecs shrink host-to-device bytes too.
    """
    if codec is None:
        return None
    resolved = get_codec(codec)
    if not resolved.device_decodable:
        return None
    return PageTransport(resolved)


def model_bits(codec: Union[str, PageCodec, None], n_bins: int) -> int:
    """Device-wire bits per bin symbol for the memory model.

    The model plans capacity before seeing data, so it uses the worst case
    for the configured alphabet: ``ceil(log2(n_bins + 1))`` (the ``+1``
    reserves the missing symbol). Codecs that do not stage a device
    transport (raw, host-only codecs, chains) model at 8 bits.
    """
    if make_transport(codec) is None:
        return 8
    return max(1, int(max(1, int(n_bins))).bit_length())


class ForestPageTransport:
    """Wire packing for paged-forest chunks served out of core.

    A packed forest page is a ``(6, n_trees, n_nodes)`` f32 stack of the
    per-node fields; on the wire each node costs 24 bytes. Tree node ids
    (feature, split_bin) fit int16 and the two flags fit uint8, so the wire
    layout [feature i16 | split_bin i16 | split_value f32 | default_left u8 |
    is_leaf u8 | leaf_value f32] is 14 bytes a node (0.583x) and decodes on
    the device with bitcasts, losslessly: the f32 planes cross verbatim and
    the int planes are exact. Node ids of 32,767 or more fall back to the
    verbatim f32 page (``mode="raw"``).

    The segments start at byte offsets ``0, 2n, 4n, 8n, 9n, 10n`` of the
    staged payload (``n = n_trees * n_nodes``); ``leaf_value`` at ``10n`` is
    4-byte aligned only for even ``n``, and every complete-heap tree has an
    odd node count. So each segment is copied into a fresh (aligned) tensor
    before it is reinterpreted.
    """

    name = "forest-pack"

    def encode(self, page: np.ndarray) -> Tuple[np.ndarray, Meta]:
        page = np.ascontiguousarray(page, dtype=np.float32)
        _, n_trees, n_nodes = page.shape
        feature, split_bin, split_value, default_left, is_leaf, leaf_value = page
        if max(np.abs(feature).max(initial=0), np.abs(split_bin).max(initial=0)) >= 32767:
            wire = np.frombuffer(page.tobytes(), dtype=np.uint8).copy()
            return wire, {"mode": "raw", "shape": [6, int(n_trees), int(n_nodes)]}
        wire = np.frombuffer(
            b"".join(
                (
                    feature.astype("<i2").tobytes(),
                    split_bin.astype("<i2").tobytes(),
                    split_value.astype("<f4").tobytes(),
                    (default_left > 0.5).astype(np.uint8).tobytes(),
                    (is_leaf > 0.5).astype(np.uint8).tobytes(),
                    leaf_value.astype("<f4").tobytes(),
                )
            ),
            dtype=np.uint8,
        ).copy()
        return wire, {"mode": "packed", "shape": [6, int(n_trees), int(n_nodes)]}

    def decode(self, dev: torch.Tensor, meta: Meta) -> Dict[str, torch.Tensor]:
        """The chunk's unpacked fields on the payload's device, in the dtypes
        `PackedForest.unpack_page` gives."""
        from repro_torch.serve.forest import PackedForest

        _, n_trees, n_nodes = (int(s) for s in meta["shape"])
        n = n_trees * n_nodes
        dev = dev.reshape(-1)
        if meta["mode"] == "raw":
            page = dev.clone().view(torch.float32).reshape(6, n_trees, n_nodes)
            return PackedForest.unpack_page(page)
        offsets = np.cumsum([0, 2 * n, 2 * n, 4 * n, n, n, 4 * n]).tolist()

        def seg(i: int, dtype: torch.dtype) -> torch.Tensor:
            raw = dev[offsets[i] : offsets[i + 1]].clone()  # aligned copy
            return raw.view(dtype).reshape(n_trees, n_nodes)

        return {
            "feature": seg(0, torch.int16).to(torch.int32),
            "split_bin": seg(1, torch.int16).to(torch.int32),
            "split_value": seg(2, torch.float32),
            "default_left": seg(3, torch.uint8) > 0,
            "is_leaf": seg(4, torch.uint8) > 0,
            "leaf_value": seg(5, torch.float32),
        }
