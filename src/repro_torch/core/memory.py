"""Device-memory model for the three training modes (paper Table 1 analogue).

Counterpart of `repro.core.memory`, a copy. Table 1 ("maximum rows before
OOM on a 16 GiB device") is an explicit byte model of each mode's device
working set. The default device stays the paper's 16 GiB so that
`ExecutionPolicy` decides exactly as the reference does;
``memory_budget_bytes`` sets another. It mirrors the paper's accounting:

  in-core       whole ELLPACK matrix + per-row training state + histograms
  out-of-core   double-buffered page + per-row training state + histograms
  ooc+sampling  double-buffered page + compacted (f·n)-row ELLPACK
                + per-row state for sampled rows only + histograms

and, for serving (`repro_torch.serve`), a packed forest beside one launch's
batch of rows, which sizes the paged forest's tree-chunks and the shared
residency budget.

The histogram term is depth-honest: the paper's fixed ``2^(d-1)`` snapshot
ignores both the compact build half that coexists during sibling expansion
and the ancestor levels the subtraction cache retains — exactly the bytes
that OOM deep trees. `histogram_bytes(depth, retained_levels)` models the
peak working set of `core.histcache.HistogramStore`, and ``hist_budget_bytes``
caps the *retained* (spillable) share at the store's device budget, so
`ExecutionPolicy` decisions stay honest when spilling is enabled.
"""
from __future__ import annotations

import dataclasses

GiB = 1024**3


@dataclasses.dataclass(frozen=True)
class DeviceMemoryModel:
    hbm_bytes: int = 16 * GiB  # paper: V100 16 GiB
    num_features: int = 500  # paper §4.1 synthetic dataset
    max_bin: int = 256
    max_depth: int = 8
    page_bytes: int = 32 * 1024 * 1024
    # per-row device state: gradient pair (8) + position (4) + cached pred (4)
    row_state_bytes: int = 16
    # HistogramStore ancestor-chain depth (K >= 1; shapes lossguide demand —
    # depthwise always retains exactly the parent level)
    hist_retained_levels: int = 1
    # device budget of the HistogramStore; None = everything stays device-
    # resident, otherwise retained histograms past the budget spill to host
    hist_budget_bytes: int | None = None
    # lossguide leaf budget; 0 = depthwise (whole-level histograms)
    max_leaves: int = 0
    # bits per ELLPACK bin symbol on the wire / resident (repro_torch.compress):
    # 8 = raw uint8 pages, ceil(log2(n_bins+1)) when a device-decodable
    # page codec ("bitpack") packs them (`compress.model_bits`). The model is
    # the reference's: it counts the matrix packed on the device, though both
    # packages hold decoded symbols after the decode (ROADMAP queue 3)
    page_codec_bits: int = 8

    @property
    def hist_node_bytes(self) -> int:
        """One node histogram: m x n_bins x (g, h) f32."""
        return self.num_features * self.max_bin * 2 * 4

    def histogram_bytes(self, depth: int | None = None, retained_levels: int | None = None) -> int:
        """Peak device bytes of per-node histograms while building level
        ``depth`` (default: the deepest level) with ``retained_levels``
        retained ancestor levels.

        Depthwise (``retained_levels >= 1``): the peak sits inside
        `expand_level`, where the retained parent level, the compact build
        half, and the full level being assembled coexist —
        ``2^(d-1) + 2^(d-1) + 2^d = 2^(d+1)`` node histograms; the store
        drops older levels outright (no whole-level derivation chain reads
        them), so K beyond 1 adds nothing here. ``retained_levels=0`` models
        the subtraction-free full build (just the level). Lossguide
        (``max_leaves > 0``): a 4-node working window (parent + built slot +
        the 2 expanded children) plus the spillable frontier cache of up to
        ``max_leaves`` histograms and K-1 retired ancestors.
        """
        d = (self.max_depth - 1) if depth is None else depth
        k = self.hist_retained_levels if retained_levels is None else retained_levels
        if self.max_leaves:
            working = 4
            retained = (min(self.max_leaves, 2 ** max(d, 0)) + max(k - 1, 0)) if k else 0
        elif d == 0 or k < 1:
            working, retained = 2**d, 0
        else:
            working = 2**d + 2 ** (d - 1)
            retained = 2 ** (d - 1)
        return (working + retained) * self.hist_node_bytes

    @property
    def hist_bytes(self) -> int:
        """Device share of the histogram working set after the store budget.

        Only lossguide's frontier cache is cappable: the depthwise parent
        level is device-resident through plan/build/expand even when the
        budget spills it between passes, so the depthwise peak is
        budget-invariant."""
        demand = self.histogram_bytes()
        if self.hist_budget_bytes is None or not self.max_leaves:
            return demand
        working = self.histogram_bytes(retained_levels=0)
        return working + min(demand - working, self.hist_budget_bytes)

    @property
    def fixed_bytes(self) -> int:
        cuts = self.num_features * self.max_bin * 4
        return self.hist_bytes + cuts

    def matrix_device_bytes(self, logical_bytes: int) -> int:
        """Device/wire bytes of ``logical_bytes`` of uint8 bin symbols under
        the configured codec (identity at the default 8 bits/symbol)."""
        return (logical_bytes * self.page_codec_bits + 7) // 8

    def ellpack_bytes(self, n_rows: int) -> int:
        # uint8 bins, packed to page_codec_bits per symbol on device
        return self.matrix_device_bytes(n_rows * self.num_features)

    @property
    def page_wire_bytes(self) -> int:
        """One streamed page's device/PCIe footprint (packed under the codec)."""
        return self.matrix_device_bytes(self.page_bytes)

    def in_core_bytes(self, n_rows: int) -> int:
        return self.fixed_bytes + self.ellpack_bytes(n_rows) + n_rows * (
            self.row_state_bytes + 8  # + margins & labels resident
        )

    def out_of_core_bytes(self, n_rows: int) -> int:
        return (
            self.fixed_bytes
            + 2 * self.page_wire_bytes  # double-buffered page streaming
            + n_rows * self.row_state_bytes
        )

    def sampled_bytes(self, n_rows: int, f: float) -> int:
        kept = int(n_rows * f)
        return (
            self.fixed_bytes
            + 2 * self.page_wire_bytes
            + self.ellpack_bytes(kept)  # compacted page (Alg. 7)
            + kept * self.row_state_bytes
        )

    # ----- serving working set (repro_torch.serve) -----
    @property
    def forest_node_bytes(self) -> int:
        """One packed forest node in device staging layout: 6 f32/int32
        planes (feature, split_bin, split_value, default_left, is_leaf,
        leaf_value — `serve.forest._PAGE_FIELDS`)."""
        return 6 * 4

    def packed_forest_bytes(self, n_trees: int, max_depth: int | None = None) -> int:
        """Device bytes of a `PackedForest` of ``n_trees`` complete-layout
        trees (the serving analogue of the matrix term)."""
        d = self.max_depth if max_depth is None else max_depth
        return n_trees * (2 ** (d + 1) - 1) * self.forest_node_bytes

    def serve_batch_bytes(self, batch_rows: int) -> int:
        """Per-launch row-side working set: the staged bins page counted as
        int32 (4 bytes a bin) + running margins, the reference's arithmetic.

        Conservative for the port, which stages and walks uint8 bins (1 byte
        a bin): it is kept so that chunk sizes and residency plans equal the
        reference's."""
        return batch_rows * (4 * self.num_features + 4)

    def serve_bytes(self, batch_rows: int, n_trees: int, max_depth: int | None = None) -> int:
        """One serving launch's device working set: forest + batch."""
        return self.packed_forest_bytes(n_trees, max_depth) + self.serve_batch_bytes(batch_rows)

    def serve_batch_rows(
        self, worst_case_rows: int, measured_rows: int | None = None
    ) -> int:
        """The batch-rows term that sizes serving tree-chunks: the measured
        launch shape of a `ServeStats` history (batches padded to
        ``max_batch`` rows) when there is one, else the worst-case row page
        of the matrix being predicted."""
        if measured_rows is not None and measured_rows > 0:
            return measured_rows
        return worst_case_rows

    def serve_residency_budget(self, batch_rows: int) -> int:
        """Device bytes left for the shared row-page/forest-chunk residency
        cache once one ``batch_rows`` launch working set is carved out —
        the default ``max_bytes`` of the serving `DevicePageCache`."""
        return max(0, self.hbm_bytes - self.serve_batch_bytes(batch_rows))

    def max_trees_resident(self, batch_rows: int, max_depth: int | None = None) -> int:
        """Most trees that fit on the device next to one ``batch_rows`` page:
        the paged forest's chunk size (`repro_torch.serve.engine`); forests
        beyond it stream tree-chunks through `PageStream`."""
        d = self.max_depth if max_depth is None else max_depth
        per_tree = (2 ** (d + 1) - 1) * self.forest_node_bytes
        budget = self.hbm_bytes - self.serve_batch_bytes(batch_rows)
        return max(0, budget // per_tree)

    # ----- closed-form max rows per mode (Table 1) -----
    # integer bit math (x8) keeps the closed forms exact for fractional
    # per-row matrix bytes; at the default 8 bits/symbol every formula
    # reduces to the pre-codec integer result
    def max_rows_in_core(self) -> int:
        per_row_bits = self.num_features * self.page_codec_bits + (self.row_state_bytes + 8) * 8
        return max(0, (self.hbm_bytes - self.fixed_bytes) * 8 // per_row_bits)

    def max_rows_out_of_core(self) -> int:
        per_row = self.row_state_bytes
        budget = self.hbm_bytes - self.fixed_bytes - 2 * self.page_wire_bytes
        return max(0, budget // per_row)

    def max_rows_sampled(self, f: float) -> int:
        per_row_bits = f * (self.num_features * self.page_codec_bits + self.row_state_bytes * 8)
        budget = self.hbm_bytes - self.fixed_bytes - 2 * self.page_wire_bytes
        return max(0, int(budget * 8 / per_row_bits))
