"""Bitpack page decode: wrapper of ``csrc/bitpack.cu``.

Expands a staged bitpack payload (`repro_torch.compress.BitpackCodec`) to
uint8 bins on the card. It replaces no Pallas kernel: the reference decodes
with jnp ops (`repro.compress.codecs.BitpackCodec.device_decode`), whose
bit-plane temporaries are 32 bytes a symbol at 8 bits. Integer-exact. Plain
version: `repro_torch.kernels.ref.bitpack_decode`.

The kernel stages whole tiles of `tile_rows` rows through shared memory;
the rows after the last whole tile, and pages it cannot stage (a payload
view that is not 16-byte aligned, fewer rows than a tile, a tile too large
for shared memory), take its direct path in the same launch. `tile_rows`
is here so that tests can aim at the tile edges.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import launch_target, require, require_cuda

launches = 0

TILE_OUT_BYTES = 16384  # decoded bytes a staged tile aims at


def tile_rows(row_syms: int) -> int:
    """Rows of one staged tile at ``row_syms`` symbols a row: a multiple of
    16 (so that a tile's packed and decoded bytes are each a multiple of 16
    long at any width), about `TILE_OUT_BYTES` decoded."""
    return max(16, TILE_OUT_BYTES // max(row_syms, 1) // 16 * 16)


def bitpack_decode(
    payload: torch.Tensor,  # (rows, ceil(row_syms * bits / 8)) uint8
    row_syms: int,
    bits: int,
    missing: int | None,
) -> torch.Tensor:
    """(rows, row_syms) uint8 symbols of a row-wise packed payload; the
    packed ``missing`` symbol (None: the page has none) becomes 255."""
    global launches
    require_cuda(payload, "bitpack_decode")
    dev = payload.device
    if payload.dim() != 2:
        raise ValueError(f"payload must be (rows, row_bytes); got shape {tuple(payload.shape)}")
    rows, row_bytes = payload.shape
    if not 1 <= bits <= 8:
        raise ValueError(f"bits must be in [1, 8]; got {bits}")
    if row_syms < 0 or row_bytes != (row_syms * bits + 7) // 8:
        raise ValueError(
            f"payload rows hold {row_bytes} bytes; {row_syms} symbols at {bits} bits "
            f"pack to {(row_syms * bits + 7) // 8}"
        )
    if missing is not None and not 0 <= missing < (1 << bits):
        raise ValueError(f"missing symbol {missing} does not fit {bits} bits")
    require(payload, "payload", (torch.uint8,), (rows, row_bytes), dev)
    out = torch.empty((rows, row_syms), dtype=torch.uint8, device=dev)
    if rows * row_syms == 0:
        return out
    err = _build.library("bitpack")(
        payload.data_ptr(), rows, row_syms, row_bytes, bits,
        -1 if missing is None else int(missing), tile_rows(row_syms), out.data_ptr(),
        *launch_target(dev),
    )
    _build.check(err, "bitpack_decode", dev)
    launches += 1
    return out
