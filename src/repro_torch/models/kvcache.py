"""KV caches for serving: contiguous, ring (sliding window), and PAGED.

Counterpart of `repro.models.kvcache`. The paged cache is the paper's
ELLPACK-page idea applied to serving memory: KV lives in fixed-size pages
addressed through a page table, so long and ragged sequences don't need
contiguous device memory, and allocation granularity is one page.

The reference's caches are values: each write returns a new cache. The
port writes into the cache's tensors in place and returns a cache over the
same tensors, so a decode step does not copy the whole cache. Token counts
the writes need are Python ints on the host. Where the reference's
``dynamic_update_slice`` clamps a start past the end (and so silently
overwrites the last slots), the port raises: a write past ``max_len`` (or
past a paged pool) is an error here. Under a mesh (`repro_torch.sharding`)
the caches are DTensors split over batch and head_dim, and every write and
page gather runs on the local shards.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.sharding.rules import P as SpecP
from repro_torch.sharding.rules import assign, constrain, placements, spec_of

Tensor = torch.Tensor


class KVCache(NamedTuple):
    """Contiguous cache, layer-stacked: k/v (L, B, max_len, KH, hd)."""

    k: Tensor
    v: Tensor
    length: int  # tokens already cached (uniform batch)

    @classmethod
    def init(cls, n_layers, batch, max_len, n_kv, head_dim, dtype=torch.bfloat16, *,
             device: torch.device):
        shape = (n_layers, batch, max_len, n_kv, head_dim)
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device), 0)

    def update_layer(self, layer_k: Tensor, layer_v: Tensor, layer_idx: int) -> "KVCache":
        """Write (B, S_new, KH, hd) at [layer_idx, :, length:length+S_new], in place."""
        end = self.length + layer_k.shape[1]
        if end > self.k.shape[2]:
            raise ValueError(f"KV cache write of positions {self.length}..{end - 1} past its "
                             f"max_len {self.k.shape[2]}")
        at = (layer_idx, slice(None), slice(self.length, end))
        assign(self.k, at, layer_k.to(self.k.dtype))
        assign(self.v, at, layer_v.to(self.v.dtype))
        return self

    def advanced(self, n: int) -> "KVCache":
        return KVCache(self.k, self.v, self.length + n)


class RingKVCache(NamedTuple):
    """Sliding-window ring buffer: k/v (L, B, window, KH, hd)."""

    k: Tensor
    v: Tensor
    length: int  # absolute position count

    @classmethod
    def init(cls, n_layers, batch, window, n_kv, head_dim, dtype=torch.bfloat16, *,
             device: torch.device):
        shape = (n_layers, batch, window, n_kv, head_dim)
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device), 0)

    @property
    def window(self) -> int:
        return self.k.shape[2]

    def write_token(self, layer_k: Tensor, layer_v: Tensor, layer_idx: int) -> "RingKVCache":
        """Write one token (B, 1, KH, hd) at slot length % window, in place."""
        slot = self.length % self.window
        self.k[layer_idx, :, slot : slot + 1] = layer_k.to(self.k.dtype)
        self.v[layer_idx, :, slot : slot + 1] = layer_v.to(self.v.dtype)
        return self

    def relative_positions(self) -> Tensor:
        """Absolute position held in each ring slot (for RoPE/masking)."""
        w = self.window
        slots = torch.arange(w, device=self.k.device)
        cur = self.length % w
        age = (cur - slots - 1) % w  # age of slot content (0 = newest)
        return self.length - 1 - age  # may be negative for never-written slots


class PagedKVCache(NamedTuple):
    """Paged cache with PER-SEQUENCE page pools.

    k/v pages: (L, B, pool_pages, page, KH, hd); page_table (B, max_pages)
    holds indices into that sequence's own pool, so every gather and
    scatter is a batched op over B (the reference keeps per-sequence pools
    so that they shard over the data axes; cross-sequence page sharing is
    traded away, per-sequence indirection, non-contiguity and slack pages
    remain). ``max_length`` mirrors ``lengths.max()`` on the host, so that a
    write past the pages the table addresses raises without a device read.
    """

    k_pages: Tensor
    v_pages: Tensor
    page_table: Tensor  # (B, max_pages) int32 page ids within the seq pool
    lengths: Tensor  # (B,) int32 tokens cached per sequence
    max_length: int

    @classmethod
    def init(
        cls, n_layers, batch, max_len, n_kv, head_dim,
        page_size: int = 256, dtype=torch.bfloat16, slack_pages: int = 0, *,
        device: torch.device,
    ):
        max_pages = -(-max_len // page_size)
        pool = max_pages + slack_pages
        shape = (n_layers, batch, pool, page_size, n_kv, head_dim)
        table = torch.arange(max_pages, dtype=torch.int32, device=device)[None].repeat(batch, 1)
        return cls(
            torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device), table,
            torch.zeros((batch,), dtype=torch.int32, device=device), 0,
        )

    @property
    def page_size(self) -> int:
        return self.k_pages.shape[3]

    def gather_layer(self, layer_idx: int) -> tuple[Tensor, Tensor]:
        """Materialize (B, max_pages*page, KH, hd) views for one layer."""
        if isinstance(self.k_pages, DTensor):
            mesh = self.k_pages.device_mesh
            pl = placements(self._token_spec(), mesh)
            return tuple(DTensor.from_local(t, mesh, pl, run_check=False)
                         for t in self._local().gather_layer(layer_idx))
        kl = self.k_pages[layer_idx]  # (B, pool, page, KH, hd)
        vl = self.v_pages[layer_idx]
        B, MP = self.page_table.shape
        rows = torch.arange(B, device=kl.device)[:, None]
        table = self.page_table.long()
        k = kl[rows, table]  # (B, MP, page, KH, hd)
        v = vl[rows, table]
        P = self.page_size
        KH, hd = kl.shape[-2], kl.shape[-1]
        return k.reshape(B, MP * P, KH, hd), v.reshape(B, MP * P, KH, hd)

    def write_token(self, layer_k: Tensor, layer_v: Tensor, layer_idx: int) -> "PagedKVCache":
        """Write one token (B, 1, KH, hd) at each sequence's current position, in place."""
        if isinstance(self.k_pages, DTensor):
            spec = self._token_spec()
            self._local().write_token(constrain(layer_k, spec).to_local(),
                                      constrain(layer_v, spec).to_local(), layer_idx)
            return self
        P = self.page_size
        if self.max_length >= self.page_table.shape[1] * P:
            raise ValueError(f"paged KV cache write at position {self.max_length} past its "
                             f"{self.page_table.shape[1]} pages of {P}")
        pos = self.lengths.long()  # (B,)
        page_slot = pos // P
        offset = pos % P
        page_ids = torch.gather(self.page_table, 1, page_slot[:, None])[:, 0].long()
        rows = torch.arange(pos.shape[0], device=pos.device)
        self.k_pages[layer_idx, rows, page_ids, offset] = layer_k[:, 0].to(self.k_pages.dtype)
        self.v_pages[layer_idx, rows, page_ids, offset] = layer_v[:, 0].to(self.v_pages.dtype)
        return self

    def _token_spec(self) -> SpecP:
        """The layout of a (B, ., KH, hd) slice of the sharded pages."""
        spec = spec_of(self.k_pages)  # (L, B, pool, page, KH, hd)
        if any(spec[i] for i in (0, 2, 3, 4)) or spec_of(self.page_table)[1]:
            raise NotImplementedError(f"paged cache sharded as {spec}: only batch and "
                                      "head_dim may be split")
        return SpecP(spec[1], None, None, spec[5])

    def _local(self) -> "PagedKVCache":
        """This rank's shard of a sharded cache, over the same storage: the
        pages, the page table and the lengths are split alike over batch,
        so each rank's rows address its own pools."""
        return PagedKVCache(self.k_pages.to_local(), self.v_pages.to_local(),
                            self.page_table.to_local(), self.lengths.to_local(),
                            self.max_length)

    def advanced(self, n: int = 1) -> "PagedKVCache":
        return PagedKVCache(self.k_pages, self.v_pages, self.page_table, self.lengths + n,
                            self.max_length + n)
