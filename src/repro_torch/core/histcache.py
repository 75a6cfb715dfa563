"""Tiered histogram store: the subtraction trick, under a device byte budget.

Counterpart of `repro.core.histcache`. Every split partitions a parent's
rows into its two children and histograms add over rows, so ``hist(parent)
== hist(left) + hist(right)``. The builder therefore builds only the smaller
child of each split pair (by exact row counts from the repartition) and
derives the sibling as ``parent - built``, roughly halving the histogram
work.

The retained histograms are a device-memory liability at depth (one node is
``m * n_bins * 2 * 4`` bytes, ~1 MB at 500 x 255), so `HistogramStore` keeps
them in tiers under ``budget_bytes``:

  device tier   hot histograms, ready for subtraction (None = unlimited,
                which is bit for bit the untiered store);
  host tier     cold histograms spilled off the device. A spill is async:
                on a CUDA device the copy to a pinned host buffer runs on a
                side stream that waits on the current one, and the device
                tensor stays referenced (and `record_stream`-ed) until the
                copy's event is waited on, at most two spills deep. A fetch
                of an in-flight spill waits on that event first, so it is
                bit-exact. A fetch stages the buffer back through
                `PageStream` (``cache_tag="hist"``, a private ledger for its
                seconds) and books its bytes in the shared `TransferStats`;
  ancestors     with ``retained_levels=K >= 2``, up to K-1 generations of
                expanded parents stay on the device, so a popped node whose
                histogram was spilled is derived as ``ancestor - siblings``
                along the path, without a transfer.

Each plan resolves the parent, recorded on ``LevelPlan.source``: "build"
(rebuilt from rows), "device", "fetched" (staged back from the host tier) or
"derived" (from an ancestor chain). Depthwise growth holds exactly one level
(older ones are dropped free), so levels leave the device in level order;
best-first growth spills frontier nodes lowest-gain first, and drops retired
ancestors only after every spillable entry has left the device.

  plan(count, counts, dev) / expand(plan, built)
                             one depthwise level: a `LevelPlan` whose
                             ``build_nodes`` are the smaller children (ties
                             build left), then the full level from the
                             compact half and the retained parent level
  put_node, note_gain, discard_node, plan_node(s), expand_node(s)
                             the per-node API of best-first growth: frontier
                             histograms by heap node id, one popped parent
                             (or a sorted batch of them) at a time
  level_row_counts(pos, offset, count), node_row_counts(pos, nodes)
                             rows per node of a window or of a node list,
                             the counts the plans take

A ``grad_transport`` (`repro_torch.compress.GradQuantizer`) narrows what a
spill moves: the histogram is quantized on the device before the copy
(f16/bf16 casts; int8 with a per-array absmax scale that stays on the
device), the pinned host buffer holds the wire dtype, and a fetch
dequantizes to f32 before anything reads the histogram. The ledger books
the wire bytes for spills and fetches and the f32 size as logical bytes.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.compress import GradQuantizer
from repro_torch.data.pages import TransferStats
from repro_torch.fault import inject as fault_inject
from repro_torch.fault.retry import RetryPolicy
from repro_torch.kernels.ref import level_row_counts  # noqa: F401 (re-exported)

Tensor = torch.Tensor

_HOT = float("inf")  # priority of entries whose frontier gain is not known yet
_CPU = torch.device("cpu")


class LevelPlan(NamedTuple):
    """Build/derive split of one node window and how the parent resolved.

    ``node_map[j]`` maps window-local node j to its compacted build slot, or
    -1 when j's histogram is derived (None for a full build, and for batched
    pops, whose windows are not contiguous). ``source`` is "build",
    "device", "fetched" or "derived". ``build_nodes`` are the global ids of
    the build slots, in slot order.
    """

    node_map: Tensor | None  # (count,) int32, or None = build everything
    n_build: int  # number of histogram slots built
    count: int  # nodes in the window
    source: str = "build"
    build_nodes: Tensor | None = None


@dataclasses.dataclass
class HistCacheStats:
    """Build-vs-derive ledger (the root build is not counted).

    Row totals accumulate as device scalars, with no host sync in the level
    loop, and convert to floats only when read."""

    levels: int = 0
    built_nodes: int = 0
    derived_nodes: int = 0
    # parents reconstructed from an ancestor chain instead of a host fetch
    # or a rebuild from rows
    chain_derived_nodes: int = 0
    # per-node plans that fell back to a full rebuild: no tier held the parent
    rebuilt_nodes: int = 0
    _built_rows_acc: Tensor | None = dataclasses.field(default=None, repr=False)
    _total_rows_acc: Tensor | None = dataclasses.field(default=None, repr=False)

    def _add_rows(self, built: Tensor, total: Tensor) -> None:
        # f32, as the reference: int32 would wrap over a long fit
        built = built.to(torch.float32)
        total = total.to(torch.float32)
        if self._built_rows_acc is None:
            self._built_rows_acc, self._total_rows_acc = built, total
        else:
            self._built_rows_acc = self._built_rows_acc + built
            self._total_rows_acc = self._total_rows_acc + total

    @property
    def built_rows(self) -> float:
        """Rows scanned into built node histograms (subtraction mode)."""
        return float(self._built_rows_acc) if self._built_rows_acc is not None else 0.0

    @property
    def total_rows(self) -> float:
        """Rows a full per-node build would have scanned."""
        return float(self._total_rows_acc) if self._total_rows_acc is not None else 0.0

    @property
    def node_rows_ratio(self) -> float:
        """How many times fewer node-rows the subtraction build scans."""
        built = self.built_rows
        return self.total_rows / built if built else 1.0


def node_row_counts(positions: Tensor, nodes: Tensor) -> Tensor:
    """(len(nodes),) int32 rows per global node id in ``nodes`` (any subset,
    any order): the counts of batched pops, whose child windows are not one
    contiguous range."""
    hit = positions.to(torch.int32)[None, :] == nodes.to(torch.int32)[:, None]
    return hit.sum(dim=1).to(torch.int32)


def count_span(count_level) -> tuple[int, int] | None:
    """The ``(offset, count)`` window a partition pass counts rows in: a
    level window as it is, or for a sorted node list (batched pops) the span
    from its first node to its last."""
    if count_level is None or isinstance(count_level, tuple):
        return count_level
    return (count_level[0], count_level[-1] - count_level[0] + 1)


def new_level_counts(count_level, device) -> Tensor | None:
    """Zeroed int32 counts of `count_span` (count_level), for
    `ops.partition_rows` to add into over a pass's pages; None without one."""
    span = count_span(count_level)
    if span is None:
        return None
    return torch.zeros(span[1], dtype=torch.int32, device=device)


def take_counts(count_level, counts: Tensor | None) -> Tensor | None:
    """The counts a plan takes from a pass's span counts: a level window's
    as they are; a node list's gathered from its span, in list order."""
    if counts is None or count_level is None or isinstance(count_level, tuple):
        return counts
    lo = count_level[0]
    idx = torch.tensor([n - lo for n in count_level], dtype=torch.int64, device=counts.device)
    return counts[idx]


def plan_level(count: int, level_counts: Tensor) -> tuple[Tensor, Tensor]:
    """(node_map, build_left) for one level: build the smaller child of each
    sibling pair (ties build left, so every builder agrees)."""
    pairs = count // 2
    build_left = level_counts[0::2] <= level_counts[1::2]
    slots = torch.arange(pairs, dtype=torch.int32, device=level_counts.device)
    minus = torch.full_like(slots, -1)
    node_map = torch.stack(
        [torch.where(build_left, slots, minus), torch.where(build_left, minus, slots)], dim=1
    ).reshape(count)
    return node_map, build_left


def expand_level(parent_hist: Tensor, built: Tensor, build_left: Tensor) -> Tensor:
    """Full level histogram from the compact build half: the built child keeps
    its histogram, the sibling is ``parent - built``."""
    mask = build_left.reshape((-1,) + (1,) * (built.dim() - 1))
    # both children written straight into the level histogram, the derived
    # one computed in place there: no temporary beside it
    full = torch.empty((built.shape[0], 2) + built.shape[1:], dtype=built.dtype, device=built.device)
    torch.sub(parent_hist, built, out=full[:, 1])
    torch.where(mask, built, full[:, 1], out=full[:, 0])
    torch.where(mask, full[:, 1], built, out=full[:, 1])
    return full.reshape((2 * built.shape[0],) + built.shape[1:])


class _Spill(NamedTuple):
    """An async spill whose copy may still be in flight."""

    device: Tensor  # the device tensor, referenced until `done` is waited on
    host: Tensor  # its (pinned, on a CUDA device) host buffer
    done: "torch.cuda.Event | None"


class HistogramStore:
    """Byte-budgeted, tiered retention of histograms, and the build/derive
    planner of the next level or popped node. One instance per booster;
    `reset` runs at the start of every tree and keeps `stats` and
    `transfer_stats`.

    Parameters
    ----------
    enabled : subtraction on/off (off = every plan is a full build).
    budget_bytes : device-tier byte budget. None = unlimited (the untiered
        store, bit for bit); 0 = everything spills and every plan fetches.
    retained_levels : K >= 1, the best-first ancestor-chain depth: up to K-1
        generations of retired parents stay on the device per path.
        Depthwise always retains exactly the parent level.
    transfer_stats : `TransferStats` sink of the spill and fetch bytes (the
        page set's, when the caller shares the ledger).
    retry : `RetryPolicy` of the fetch's staging (None = its defaults).
    grad_transport : wire transport of the spill/fetch round trip
        (`GradQuantizer`): "raw" keeps the f32 path bit for bit; "f16" and
        "bf16" halve and "int8" quarters the bytes a spilled histogram
        moves. Payloads are dequantized to f32 at fetch, before any
        accumulation, so only the stored values narrow, never the order.
    """

    def __init__(
        self,
        enabled: bool = True,
        budget_bytes: int | None = None,
        retained_levels: int = 1,
        transfer_stats: TransferStats | None = None,
        retry: RetryPolicy | None = None,
        grad_transport: str = "raw",
    ):
        if budget_bytes is not None and budget_bytes < 0:
            raise ValueError(f"budget_bytes must be >= 0 or None, got {budget_bytes}")
        if retained_levels < 1:
            raise ValueError(f"retained_levels must be >= 1, got {retained_levels}")
        self.enabled = enabled
        self.budget_bytes = budget_bytes
        self.retained_levels = retained_levels
        self.transfer_stats = transfer_stats if transfer_stats is not None else TransferStats()
        self.retry = retry if retry is not None else RetryPolicy()
        self.quantizer = GradQuantizer.resolve(grad_transport)
        self.stats = HistCacheStats()
        self._device: dict[tuple, Tensor] = {}
        # host tier; a key whose copy is still in flight maps to None here
        # and keeps its `_Spill` in ``_inflight`` until `_host_buffer`
        self._host: dict[tuple, Tensor | None] = {}
        self._inflight: dict[tuple, _Spill] = {}
        self.max_inflight_spills = 2  # the depth PageStream stages with
        self._copy_streams: dict = {}
        self._nbytes: dict[tuple, int] = {}
        # int8 transport: per-key dequantization scale (a 0-d device f32)
        self._qscale: dict[tuple, Tensor | None] = {}
        self._kind: dict[tuple, str] = {}  # "level" | "node" | "ancestor"
        self._priority: dict[tuple, float] = {}  # lower = colder = spills first
        self._stamp: dict[tuple, int] = {}  # insertion order breaks ties
        self._clock = 0
        self._dev_bytes = 0
        self._build_left: Tensor | None = None
        self._node_build_left: Tensor | None = None
        self._batch_modes: list | None = None  # per parent of the last `plan_nodes`

    # ------------------------------------------------------------- tier plumbing
    def reset(self) -> None:
        self._device.clear()
        self._host.clear()
        self._inflight.clear()  # abandoned copies stay safe, as in `_drop`
        self._nbytes.clear()
        self._qscale.clear()
        self._kind.clear()
        self._priority.clear()
        self._stamp.clear()
        self._dev_bytes = 0
        self._build_left = None
        self._node_build_left = None
        self._batch_modes = None

    @property
    def device_bytes(self) -> int:
        """Bytes currently held in the device tier."""
        return self._dev_bytes

    def tier_of(self, key: tuple) -> str | None:
        """"device" | "host" | None: where one entry lives now."""
        if key in self._device:
            return "device"
        if key in self._host:
            return "host"
        return None

    def _put(self, key: tuple, hist: Tensor, kind: str, priority: float) -> None:
        self._drop(key)
        self._device[key] = hist
        self._nbytes[key] = hist.numel() * hist.element_size()
        self._kind[key] = kind
        self._priority[key] = priority
        self._stamp[key] = self._clock
        self._clock += 1
        self._dev_bytes += self._nbytes[key]

    def _drop(self, key: tuple) -> None:
        if key in self._device:
            self._dev_bytes -= self._nbytes[key]
            del self._device[key]
        # an in-flight spill is abandoned: its buffers stay valid until the
        # copy ends (record_stream on the device tensor, the pinned host
        # allocator's event on the buffer), and nothing reads them again
        self._inflight.pop(key, None)
        self._host.pop(key, None)
        self._nbytes.pop(key, None)
        self._qscale.pop(key, None)
        self._kind.pop(key, None)
        self._priority.pop(key, None)
        self._stamp.pop(key, None)

    def _copy_stream(self, device: torch.device):
        if device not in self._copy_streams:
            self._copy_streams[device] = torch.cuda.Stream(device)
        return self._copy_streams[device]

    def _spill(self, key: tuple) -> None:
        """Device -> host, asynchronously. The tier change is booked at once
        (``tier_of`` says "host", the ledger counts the spill, the budget is
        credited); the host buffer is complete only at `_host_buffer`.
        Spill seconds are booked nowhere: the copy runs behind compute. A
        quantizing transport narrows the histogram on the device first, on
        the current stream, so the side stream copies the new wire tensor.
        """
        arr = self._device.pop(key)
        if not self.quantizer.is_raw:
            arr, self._qscale[key] = self.quantizer.quantize(arr)
        if arr.is_cuda:
            side = self._copy_stream(arr.device)
            side.wait_stream(torch.cuda.current_stream(arr.device))
            host = torch.empty(arr.shape, dtype=arr.dtype, pin_memory=True)
            done = torch.cuda.Event()
            with torch.cuda.stream(side):
                host.copy_(arr, non_blocking=True)
                done.record(side)
            arr.record_stream(side)
            spill = _Spill(arr, host, done)
        else:
            spill = _Spill(arr, arr.clone(), None)
        self._inflight[key] = spill
        self._host[key] = None  # logically in the host tier from now on
        self._dev_bytes -= self._nbytes[key]
        nbytes = arr.numel() * arr.element_size()  # wire bytes: the f32 size when raw
        ts = self.transfer_stats
        ts.hist_spills += 1
        ts.hist_spill_bytes += nbytes
        ts.device_to_host_bytes += nbytes
        while len(self._inflight) > self.max_inflight_spills:
            self._complete_spill(next(iter(self._inflight)))

    def _complete_spill(self, key: tuple) -> None:
        """Completion barrier of one in-flight spill: wait on its copy's
        event, then let the device tensor go."""
        spill = self._inflight.pop(key, None)
        if spill is None:
            return
        if spill.done is not None:
            spill.done.synchronize()
        if key in self._host:
            self._host[key] = spill.host

    def _host_buffer(self, key: tuple) -> Tensor:
        """The host buffer of ``key``, completing its spill first if the copy
        is still in flight: what keeps a fetch of an in-flight spill exact."""
        self._complete_spill(key)
        return self._host[key]

    def _fetch(self, key: tuple, device: torch.device) -> Tensor:
        """Host -> device: stage a spilled histogram back through `PageStream`
        (its seconds in a private ledger, which a lone synchronous put would
        only dilute; its bytes in the shared `TransferStats`), retried under
        ``self.retry``; the fault site "hist_store.fetch" fires once a try.
        A quantized payload (staged as its bytes: numpy has no bf16) is
        widened back to f32 before anything reads it."""
        from repro_torch.pipeline.stream import PageStream

        host = self._host_buffer(key)  # popped only after a successful stage

        def _stage() -> Tensor:
            fault_inject.fire("hist_store.fetch")
            stream = PageStream.from_host_pages(
                [host], to_array=lambda t: t.contiguous().view(torch.uint8).numpy(),
                device=device, cache_tag="hist", stats=TransferStats(),
            )
            (page,) = list(stream)
            return page.device.view(host.dtype)

        hist = self.retry.call(_stage, stats=self.transfer_stats, describe="histogram fetch")
        if not self.quantizer.is_raw:
            hist = self.quantizer.dequantize(hist, self._qscale.pop(key, None))
        del self._host[key]
        self._device[key] = hist
        self._dev_bytes += self._nbytes[key]
        nbytes = host.numel() * host.element_size()
        ts = self.transfer_stats
        ts.hist_fetches += 1
        ts.hist_fetch_bytes += nbytes
        ts.host_to_device_bytes += nbytes
        ts.logical_bytes += self._nbytes[key]
        ts.wire_bytes += nbytes
        return hist

    def _coldest(self, keys: list[tuple]) -> tuple:
        return min(keys, key=lambda k: (self._priority[k], self._stamp[k]))

    def _enforce_budget(self) -> None:
        if self.budget_bytes is None:
            return
        while self._dev_bytes > self.budget_bytes:
            # the coldest live entry spills: shallowest level first
            # (depthwise), lowest frontier gain first (best-first),
            # insertion order breaking exact ties
            spillable = [k for k in self._device if self._kind[k] != "ancestor"]
            if spillable:
                self._spill(self._coldest(spillable))
                continue
            # retired ancestors last, dropped rather than spilled: a host-tier
            # ancestor saves no transfer, and they are re-derivable
            if not self._device:
                return
            self._drop(self._coldest(list(self._device)))

    # ------------------------------------------------------- depthwise (levels)
    def plan(self, count: int, level_counts: Tensor | None, device: torch.device) -> LevelPlan:
        depth = count.bit_length() - 1  # count == 2**depth in the heap layout
        parent_key = ("L", depth - 1)
        subtract = (
            self.enabled
            and count > 1
            and level_counts is not None
            and self.tier_of(parent_key) is not None
        )
        if not subtract:
            self._build_left = None
            return LevelPlan(
                node_map=None, n_build=count, count=count, source="build",
                build_nodes=torch.arange(count, dtype=torch.int32, device=device) + (count - 1),
            )
        if parent_key in self._device:
            source = "device"
        else:
            # staged back now, before the histogram pass that precedes expand
            self._fetch(parent_key, device)
            source = "fetched"
        node_map, build_left = plan_level(count, level_counts)
        pairs = count // 2
        build_nodes = (
            (count - 1)
            + 2 * torch.arange(pairs, dtype=torch.int32, device=device)
            + (~build_left).to(torch.int32)
        )
        self._build_left = build_left
        self.stats.levels += 1
        self.stats.built_nodes += pairs
        self.stats.derived_nodes += count - pairs
        self.stats._add_rows(
            torch.minimum(level_counts[0::2], level_counts[1::2]).sum(), level_counts.sum()
        )
        return LevelPlan(
            node_map=node_map, n_build=pairs, count=count, source=source,
            build_nodes=build_nodes,
        )

    def expand(self, plan: LevelPlan, built: Tensor) -> Tensor:
        """Compact build histogram -> full (count, m, n_bins, 2) level
        histogram; retained as the next level's parent, within the budget."""
        depth = plan.count.bit_length() - 1
        if plan.node_map is None:
            full = built
        else:
            full = expand_level(self._device[("L", depth - 1)], built, self._build_left)
        if self.enabled:
            self._put(("L", depth), full, kind="level", priority=float(depth))
            # depthwise retains exactly one level: nothing reads older ones
            # (``retained_levels`` is the per-node chain knob), so they go free
            for key in [k for k in self._nbytes if k[0] == "L" and k[1] < depth]:
                self._drop(key)
            self._enforce_budget()
        return full

    # ------------------------------------------------- per-node (best-first) API
    def put_node(self, node: int, hist: Tensor) -> None:
        """Retain one frontier node's (m, n_bins, 2) histogram."""
        if self.enabled:
            self._put(("N", node), hist, kind="node", priority=_HOT)
            self._enforce_budget()

    def note_gain(self, node: int, gain: float) -> None:
        """Record a frontier node's split gain, the spill order: low-gain
        leaves are popped last, if ever, so they go cold first."""
        key = ("N", node)
        if key in self._priority:
            self._priority[key] = float(gain)

    def discard_node(self, node: int) -> None:
        """Drop a node that left the frontier (became a permanent leaf)."""
        self._drop(("N", node))

    def _derive_from_chain(self, node: int) -> Tensor | None:
        """hist(node) from the nearest retired ancestor minus the siblings on
        the path held on the device, subtracted one by one in path order (at
        most ``retained_levels - 1`` generations up); None if the chain
        breaks."""
        if self.retained_levels < 2:
            return None
        sibs: list[Tensor] = []
        cur = node
        for _ in range(self.retained_levels - 1):
            if cur == 0:
                return None
            parent = (cur - 1) // 2
            sibling = cur + 1 if cur % 2 == 1 else cur - 1
            sib_hist = self._device.get(("N", sibling))
            if sib_hist is None:
                return None
            sibs.append(sib_hist)
            anc = self._device.get(("N", parent))
            if anc is not None:
                for s in sibs:
                    anc = anc - s
                return anc
            cur = parent
        return None

    def _resolve(self, parent: int, device: torch.device) -> str | None:
        """Bring the popped parent's histogram to the device tier: "device",
        "derived" (ancestor chain), "fetched" (host tier), or None when
        nothing holds it."""
        key = ("N", parent)
        if key in self._device:
            return "device"
        chain = self._derive_from_chain(parent)
        if chain is not None:
            self._put(key, chain, kind="node", priority=self._priority.get(key, _HOT))
            self.stats.chain_derived_nodes += 1
            return "derived"
        if key in self._host:
            self._fetch(key, device)
            return "fetched"
        return None

    def plan_node(
        self, parent: int, child_counts: Tensor | None, device: torch.device | None = None
    ) -> LevelPlan:
        """Build/derive plan of the popped ``parent``'s 2-node child window.

        The parent resolves device -> ancestor chain -> host fetch; then only
        the smaller child (ties build left) takes the one kernel slot and the
        sibling is derived in `expand_node`. Unresolved, both children are
        rebuilt from rows. Everything stays on the device: no host sync."""
        if device is None:
            device = child_counts.device if child_counts is not None else _CPU
        children = torch.arange(2, dtype=torch.int32, device=device) + (2 * parent + 1)
        source = (
            self._resolve(parent, device)
            if self.enabled and child_counts is not None
            else "build"
        )
        if source is None:
            self.stats.rebuilt_nodes += 1
            source = "build"
        if source == "build":
            self._node_build_left = None
            return LevelPlan(node_map=None, n_build=2, count=2, source="build",
                             build_nodes=children)
        node_map, build_left = plan_level(2, child_counts)
        self._node_build_left = build_left
        self.stats.levels += 1
        self.stats.built_nodes += 1
        self.stats.derived_nodes += 1
        self.stats._add_rows(torch.minimum(child_counts[0], child_counts[1]), child_counts.sum())
        return LevelPlan(
            node_map=node_map, n_build=1, count=2, source=source,
            build_nodes=children[0:1] + (~build_left).to(torch.int32),
        )

    def _store_pair(self, parent: int, left: Tensor, right: Tensor) -> None:
        """Store a popped parent's two children as frontier nodes, and retire
        (``retained_levels >= 2``) or drop the parent. Each child is stored
        as a tensor of its own, so that a spill frees its bytes."""
        key = ("N", parent)
        self._put(("N", 2 * parent + 1), _own(left), kind="node", priority=_HOT)
        self._put(("N", 2 * parent + 2), _own(right), kind="node", priority=_HOT)
        if self.retained_levels > 1 and key in self._device:
            # retired: its depth orders ancestor drops, and its descendants'
            # chains may reach it without a transfer
            self._kind[key] = "ancestor"
            self._priority[key] = float((parent + 1).bit_length() - 1)
            self._inflight.pop(key, None)
            self._host.pop(key, None)
            # prune path ancestors the bounded chain can no longer reach
            cur, steps = parent, 0
            while cur > 0:
                cur = (cur - 1) // 2
                steps += 1
                akey = ("N", cur)
                if steps >= self.retained_levels - 1 and self._kind.get(akey) == "ancestor":
                    self._drop(akey)
        else:
            self._drop(key)
        self._enforce_budget()

    def _children(self, parent: int, built: Tensor, build_left: bool | Tensor) -> tuple:
        """(left, right) of a resolved parent from its built child: the
        sibling is ``parent - built``, the elementwise math of
        `expand_level`."""
        derived = self._device[("N", parent)] - built
        if isinstance(build_left, bool):
            return (built, derived) if build_left else (derived, built)
        return (torch.where(build_left, built, derived), torch.where(build_left, derived, built))

    def expand_node(self, parent: int, plan: LevelPlan, built: Tensor) -> Tensor:
        """Compact build -> full (2, m, n_bins, 2) child histograms; both are
        stored as frontier nodes and the parent is retired or dropped."""
        if plan.node_map is None:
            left, right = built[0], built[1]
        else:
            left, right = self._children(parent, built[0], self._node_build_left)
        if self.enabled:
            self._store_pair(parent, left, right)
        return torch.stack([left, right])

    # ----------------------------------------------- batched pops (best-first)
    def plan_nodes(
        self, parents: list[int], child_counts: Tensor | None, device: torch.device | None = None
    ) -> LevelPlan:
        """Batched `plan_node`: one plan for several popped parents (sorted
        ascending), so that all their children ride one histogram pass.

        ``child_counts`` is ``(2 * len(parents),)`` in [left_0, right_0,
        left_1, ...] order. Each parent resolves as in `plan_node`; a
        resolved one adds its smaller child to the build set (ties build
        left), an unresolved one both children. ``build_nodes`` is the
        (possibly non-contiguous) union in parent order; ``node_map`` is
        None. The counts are read to the host once a batch."""
        if device is None:
            device = child_counts.device if child_counts is not None else _CPU
        k = len(parents)
        count = 2 * k
        if not (self.enabled and child_counts is not None):
            self._batch_modes = [("full", None)] * k
            nodes = [2 * p + 1 + c for p in parents for c in (0, 1)]
            return LevelPlan(
                node_map=None, n_build=count, count=count, source="build",
                build_nodes=torch.tensor(nodes, dtype=torch.int32, device=device),
            )
        counts = child_counts.cpu().tolist()
        modes: list[tuple[str, bool | None]] = []
        nodes: list[int] = []
        sources: set[str] = set()
        built_rows = total_rows = 0.0
        for i, parent in enumerate(parents):
            source = self._resolve(parent, device)
            left_n, right_n = counts[2 * i], counts[2 * i + 1]
            if source is not None:
                sources.add(source)
                build_left = left_n <= right_n
                modes.append(("sub", build_left))
                nodes.append(2 * parent + 1 + (0 if build_left else 1))
                self.stats.levels += 1
                self.stats.built_nodes += 1
                self.stats.derived_nodes += 1
                built_rows += min(left_n, right_n)
                total_rows += left_n + right_n
            else:
                modes.append(("full", None))
                nodes.extend((2 * parent + 1, 2 * parent + 2))
                self.stats.rebuilt_nodes += 1
                sources.add("build")
        self._batch_modes = modes
        if total_rows:
            self.stats._add_rows(
                torch.tensor(built_rows, device=device), torch.tensor(total_rows, device=device)
            )
        # one label for the batch: the most expensive resolution names it
        source = next(
            (s for s in ("fetched", "derived", "build", "device") if s in sources), "device"
        )
        return LevelPlan(
            node_map=None, n_build=len(nodes), count=count, source=source,
            build_nodes=torch.tensor(nodes, dtype=torch.int32, device=device),
        )

    def expand_nodes(self, parents: list[int], plan: LevelPlan, built: Tensor) -> Tensor:
        """Batched `expand_node`: every popped parent's child pair from the
        fused build, stored and retired as the per-node path does. Returns
        ``(2 * len(parents), m, n_bins, 2)`` in [left_0, right_0, ...]
        order."""
        modes = self._batch_modes
        self._batch_modes = None
        pairs: list[tuple[Tensor, Tensor]] = []
        slot = 0
        # every pair is derived before any is stored: storing enforces the
        # budget, which could spill a later parent mid-batch
        for parent, (mode, build_left) in zip(parents, modes):
            if mode == "full":
                pairs.append((built[slot], built[slot + 1]))
                slot += 2
            else:
                pairs.append(self._children(parent, built[slot], build_left))
                slot += 1
        if self.enabled:
            for parent, (left, right) in zip(parents, pairs):
                self._store_pair(parent, left, right)
        return torch.stack([t for pair in pairs for t in pair])


def _own(t: Tensor) -> Tensor:
    """``t``, or a copy of it when it is a view into a larger tensor (whose
    bytes a spill of the view would not free)."""
    if t.untyped_storage().nbytes() == t.numel() * t.element_size():
        return t
    return t.clone()


class HistogramCache(HistogramStore):
    """The unlimited single-tier store under its older name:
    ``HistogramCache(enabled=...)`` is the untiered subtraction cache."""
