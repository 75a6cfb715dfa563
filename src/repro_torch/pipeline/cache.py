"""Device residency manager: LRU pages plus a pinned tier, one byte budget.

Counterpart of `repro.pipeline.cache`, a copy: the logic holds whatever
values it is given (here device tensors) and never touches them.

Out-of-core passes revisit the same immutable pages — Alg. 6 re-streams every
page per tree level, the Alg. 7 fast path re-streams them once per iteration
for the margin update, and the serving tier re-streams forest tree-chunks for
every row-page pass. When a page's device copy is still resident from the
previous pass, the host->device transfer can be skipped entirely.
`DevicePageCache` is that residency set: an LRU keyed by (tag, index), bounded
by page count and optionally by bytes.

Two tiers share the byte budget:

  unpinned   plain LRU entries; capacity pressure (page count or bytes)
             evicts the least recently used first;
  pinned     entries promoted with `pin` (or inserted with ``pinned=True``)
             are never evicted — the serving tier pins hot forest tree-chunks
             here so row-page pressure cannot push them out. Pinned bytes
             still count against ``max_bytes``, so eviction pressure on one
             side of the budget is visible to the other: pinning shrinks the
             room the LRU tier has, and the LRU tier can never displace a pin.

Pages are immutable after preprocessing (quantized ELLPACK bins, packed
forest chunks), so there is no invalidation protocol — eviction is purely
capacity-driven. With ``max_bytes=None`` and no pins the cache degenerates to
the original page-count LRU bit-for-bit.

Hit/miss counters are kept both globally and per key tag (the first element
of tuple keys, e.g. ``"forest/8"`` vs ``"page"``), so consumers can report a
chunk-cache hit rate separately from row-page hits; `clear()` resets the
counters along with the entries.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Hashable


def _key_tag(key: Hashable) -> str | None:
    """The namespace of a (tag, index) cache key; None for untagged keys."""
    if isinstance(key, tuple) and len(key) == 2 and isinstance(key[0], str):
        return key[0]
    return None


class DevicePageCache:
    """Bounded two-tier residency set keyed by a hashable page identity."""

    def __init__(self, max_pages: int = 8, max_bytes: int | None = None):
        if max_pages <= 0:
            raise ValueError(f"max_pages must be positive, got {max_pages}")
        self.max_pages = max_pages
        self.max_bytes = max_bytes
        self._entries: "OrderedDict[Hashable, tuple[Any, int]]" = OrderedDict()
        self._pinned: set[Hashable] = set()
        self._nbytes = 0
        self._pinned_bytes = 0
        self.hits = 0
        self.misses = 0
        # a put whose nbytes exceed the whole byte budget can never stay
        # resident; it is rejected (not inserted-then-evicted) and counted
        self.oversize_puts = 0
        self.hits_by_tag: dict[str, int] = {}
        self.misses_by_tag: dict[str, int] = {}

    @property
    def n_pages(self) -> int:
        return len(self._entries)

    @property
    def nbytes(self) -> int:
        return self._nbytes

    @property
    def pinned_pages(self) -> int:
        return len(self._pinned)

    @property
    def pinned_bytes(self) -> int:
        return self._pinned_bytes

    @property
    def hit_rate(self) -> float:
        """Lookups served from residency (0..1); 0.0 before any lookup."""
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def tag_counts(self, prefix: str) -> tuple[int, int]:
        """(hits, misses) summed over every tag starting with ``prefix`` —
        e.g. ``"forest"`` aggregates all chunk-size-keyed forest tags."""
        h = sum(v for t, v in self.hits_by_tag.items() if t.startswith(prefix))
        m = sum(v for t, v in self.misses_by_tag.items() if t.startswith(prefix))
        return h, m

    # ------------------------------------------------------------------ lookup
    def lookup(self, key: Hashable) -> tuple[Any, int] | None:
        """(value, nbytes as recorded at put time) on a hit, else None."""
        tag = _key_tag(key)
        entry = self._entries.get(key)
        if entry is None:
            self.misses += 1
            if tag is not None:
                self.misses_by_tag[tag] = self.misses_by_tag.get(tag, 0) + 1
            return None
        self._entries.move_to_end(key)
        self.hits += 1
        if tag is not None:
            self.hits_by_tag[tag] = self.hits_by_tag.get(tag, 0) + 1
        return entry

    def get(self, key: Hashable) -> Any | None:
        entry = self.lookup(key)
        return entry[0] if entry is not None else None

    def contains(self, key: Hashable) -> bool:
        """Residency probe with no counter or LRU side effects."""
        return key in self._entries

    def is_pinned(self, key: Hashable) -> bool:
        return key in self._pinned

    # --------------------------------------------------------------- insertion
    def put(self, key: Hashable, value: Any, nbytes: int, pinned: bool = False) -> bool:
        """Insert (or refresh) an entry; True iff it is resident afterwards.

        An entry larger than the whole byte budget is rejected outright and
        counted in ``oversize_puts`` — the old behavior (insert, then evict
        the entry just inserted plus everything else) burned the entire cache
        for a page that could never stay. ``pinned=True`` asks for the pinned
        tier; if the pin budget cannot take it, the entry still lands in the
        LRU tier (pin() reports the refusal separately). A put never demotes
        an existing pin.
        """
        if self.max_bytes is not None and nbytes > self.max_bytes:
            self.oversize_puts += 1
            return self.contains(key)
        old = self._entries.pop(key, None)
        if old is not None:
            self._nbytes -= old[1]
            if key in self._pinned:
                self._pinned.discard(key)
                self._pinned_bytes -= old[1]
                pinned = True  # refreshing a pinned entry keeps it pinned
        self._entries[key] = (value, nbytes)
        self._nbytes += nbytes
        if pinned and self.can_pin(nbytes):
            self._pinned.add(key)
            self._pinned_bytes += nbytes
        self._evict()
        return self.contains(key)

    # ------------------------------------------------------------- pinned tier
    def can_pin(self, nbytes: int) -> bool:
        """Would ``nbytes`` more pinned bytes still fit the byte budget?"""
        if self.max_bytes is None:
            return True
        return self._pinned_bytes + nbytes <= self.max_bytes

    def pin(self, key: Hashable) -> bool:
        """Promote a resident entry to the pinned (never-evicted) tier.

        Refuses (returns False) when the key is absent or when pinning it
        would push pinned bytes past ``max_bytes`` — the pinned tier must
        always fit the budget, since nothing can evict it.
        """
        entry = self._entries.get(key)
        if entry is None:
            return False
        if key in self._pinned:
            return True
        if not self.can_pin(entry[1]):
            return False
        self._pinned.add(key)
        self._pinned_bytes += entry[1]
        return True

    def unpin(self, key: Hashable) -> bool:
        """Demote a pin to the LRU tier (its bytes become evictable)."""
        if key not in self._pinned:
            return False
        self._pinned.discard(key)
        self._pinned_bytes -= self._entries[key][1]
        self._entries.move_to_end(key)  # freshly demoted = most recently used
        self._evict()
        return True

    # ---------------------------------------------------------------- eviction
    def _over_capacity(self) -> bool:
        n_unpinned = len(self._entries) - len(self._pinned)
        if n_unpinned <= 0:
            return False  # only pins left; nothing is evictable
        if n_unpinned > self.max_pages:
            return True
        return self.max_bytes is not None and self._nbytes > self.max_bytes

    def _evict(self) -> None:
        while self._over_capacity():
            for key in self._entries:  # oldest-first, skipping the pinned tier
                if key not in self._pinned:
                    _, nbytes = self._entries.pop(key)
                    self._nbytes -= nbytes
                    break
            else:  # pragma: no cover - guarded by _over_capacity
                break

    def clear(self) -> None:
        """Drop every entry (both tiers) and reset all counters."""
        self._entries.clear()
        self._pinned.clear()
        self._nbytes = 0
        self._pinned_bytes = 0
        self.hits = 0
        self.misses = 0
        self.oversize_puts = 0
        self.hits_by_tag = {}
        self.misses_by_tag = {}
