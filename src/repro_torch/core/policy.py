"""ExecutionPolicy: memory-budget-driven training-mode selection (paper §3.4).

Counterpart of `repro.core.policy`. The decision procedure is the
reference's, unchanged, and `GradientBooster.fit` trains each of its three
decisions. The policy also carries the streaming knobs (prefetch and staging depths,
per-node page skipping, device page cache, checkpoint cadence), the page
codec and histogram spill transport (`repro_torch.compress`), and the I/O
retry policy, which the histogram store's fetch shares.

The paper's decision procedure, as a config object: given a `DMatrix` and the
booster hyperparameters, consult the Table-1 byte model (`DeviceMemoryModel`)
and pick how the data trains on the device —

  in_core       the whole quantized matrix + per-row state + histograms fit
                in the budget: stage once, train with zero paging;
  out_of_core   per-row state + double-buffered pages fit: stream every page
                through `PageStream` per tree level (Alg. 6);
  sampled       even streaming's per-row state is too large (or the user
                asked for gradient-based sampling): pick the largest sampling
                fraction f whose compacted page fits and run Alg. 7.

``mode="auto"`` runs the procedure; forcing a mode skips it (the byte model is
still evaluated so the decision can report it). Forcing ``out_of_core`` while
the booster's `SamplingConfig` requests sampling promotes to the Alg. 7 fast
path, mirroring how the external trainer always behaved.

The policy also carries the knobs of the tiered histogram store
(``hist_budget_bytes`` / ``hist_retained_levels`` — see
`core.histcache.HistogramStore`): how training executes, not a model
hyperparameter (`BoosterParams`) or a data property (`DMatrix`). The byte
model folds the histogram knobs in, so ``mode="auto"`` stays honest for deep trees: retained
levels raise the device demand, a histogram budget caps it (spilling the
rest to host).
"""
from __future__ import annotations

import dataclasses

from repro_torch.compress import GradQuantizer, get_codec, model_bits
from repro_torch.core.memory import DeviceMemoryModel
from repro_torch.fault.retry import RetryPolicy

MODES = ("auto", "in_core", "out_of_core", "sampled")


@dataclasses.dataclass(frozen=True)
class ExecutionDecision:
    """What the policy picked for one fit(): mode, sampling fraction, and the
    byte model + human-readable reason behind the choice."""

    mode: str  # in_core | out_of_core | sampled
    sampling_f: float | None = None
    model: DeviceMemoryModel | None = None
    reason: str = ""


def sampling_requested(sampling) -> bool:
    """Does this `SamplingConfig` actually ask for gradient-based sampling?
    Shared by the decision procedure and the external engine so the two can
    never disagree about which path a config selects."""
    return sampling.method != "none" and (
        sampling.method == "goss" or sampling.f < 1.0
    )


def _requested_fraction(sampling) -> float:
    if sampling.method == "goss":
        return sampling.goss_a + sampling.goss_b
    return sampling.f


@dataclasses.dataclass(frozen=True)
class ExecutionPolicy:
    mode: str = "auto"  # auto | in_core | out_of_core | sampled
    # device budget the auto decision is made against; None = the byte
    # model's default device (paper: 16 GiB V100)
    memory_budget_bytes: int | None = None
    # candidate sampling fractions for auto-selected sampling, tried largest
    # first (the paper sweeps f in {0.5, 0.3, 0.1})
    sampling_fractions: tuple[float, ...] = (0.5, 0.3, 0.1)
    # device budget of the tiered HistogramStore: None keeps every retained
    # histogram device-resident; a byte cap spills cold levels / frontier
    # nodes to host buffers, staged back through PageStream on demand
    # (0 = everything spills). Threaded into the store by GradientBooster and
    # into the byte model here.
    hist_budget_bytes: int | None = None
    # lossguide ancestor-chain depth (K >= 1): up to K-1 retired ancestors
    # per path stay device-resident for transfer-free multi-level derivation.
    # Depthwise always retains exactly the parent level.
    hist_retained_levels: int = 1
    # streaming-engine knobs (see repro_torch.pipeline.PageStream)
    prefetch_depth: int = 2
    staging_depth: int = 2
    # lossguide out of core: a pop's repartition and histogram passes skip
    # the pages with no row in the popped nodes (no fetch, no staging);
    # counted in TransferStats.pages_skipped
    page_skipping: bool = True
    # device page cache of the external engines: None = auto (every page
    # on the sampled path when there are at most 8; none on the streaming
    # path, whose LRU scans would evict every page right before its reuse);
    # a count caches that many pages; 0 disables
    device_cache_pages: int | None = None
    # checkpoint cadence for external-mode training (None = no checkpoints)
    checkpoint_every: int | None = None
    checkpoint_dir: str | None = None
    # lossless page codec of every host->device staging path
    # (repro_torch.compress): "raw" = uint8 pages bit for bit; "bitpack"
    # stages ceil(log2(n_symbols))-bit packed payloads, expanded on the
    # device by the bitpack decode kernel, and shrinks the byte model's
    # matrix/page terms. The trained forest is identical either way.
    page_codec: str = "raw"
    # wire transport of the HistogramStore's spill/fetch (GradQuantizer):
    # "raw" (f32, bit for bit), "f16"/"bf16" (half the spill bytes) or
    # "int8" (per-array absmax scale, a quarter). Payloads are dequantized
    # to f32 before any accumulation.
    grad_transport: str = "raw"
    # transient-I/O retry/backoff of the page prefetcher; attempts/aborts
    # are accounted in TransferStats.io_retries / io_giveups
    retry: RetryPolicy = RetryPolicy()

    def __post_init__(self) -> None:
        if self.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}; got {self.mode!r}")
        if self.memory_budget_bytes is not None and self.memory_budget_bytes <= 0:
            raise ValueError("memory_budget_bytes must be positive")
        if not self.sampling_fractions or any(
            not (0.0 < f <= 1.0) for f in self.sampling_fractions
        ):
            raise ValueError("sampling_fractions must be fractions in (0, 1]")
        if self.hist_budget_bytes is not None and self.hist_budget_bytes < 0:
            raise ValueError("hist_budget_bytes must be >= 0 or None")
        if self.hist_retained_levels < 1:
            raise ValueError("hist_retained_levels must be >= 1")
        # an unknown codec or transport fails at construction, not mid-fit
        get_codec(self.page_codec)
        GradQuantizer.resolve(self.grad_transport)

    # ------------------------------------------------------------- byte model
    def memory_model(self, dm, params) -> DeviceMemoryModel:
        """Table-1 byte model instantiated for this data + hyperparameters."""
        kw = {}
        if self.memory_budget_bytes is not None:
            kw["hbm_bytes"] = self.memory_budget_bytes
        max_leaves = (
            params.max_leaves
            if getattr(params, "grow_policy", "depthwise") == "lossguide"
            else 0
        )
        return DeviceMemoryModel(
            num_features=dm.num_features,
            max_bin=max(dm.n_bins, 1),
            max_depth=params.max_depth,
            page_bytes=dm.page_bytes,
            hist_retained_levels=self.hist_retained_levels,
            hist_budget_bytes=self.hist_budget_bytes,
            max_leaves=max_leaves,
            page_codec_bits=model_bits(self.page_codec, max(dm.n_bins, 1)),
            **kw,
        )

    # --------------------------------------------------------------- decision
    def decide(self, dm, params) -> ExecutionDecision:
        """The paper's mode decision for one fit() call."""
        model = self.memory_model(dm, params)
        requested = sampling_requested(params.sampling)
        f_req = _requested_fraction(params.sampling)

        if self.mode == "in_core":
            return ExecutionDecision("in_core", None, model, "forced in_core")
        if self.mode == "out_of_core":
            if requested:
                return ExecutionDecision(
                    "sampled", f_req, model,
                    "forced out_of_core with sampling configured -> Alg. 7 "
                    "compacted-page fast path",
                )
            return ExecutionDecision("out_of_core", None, model, "forced out_of_core")
        if self.mode == "sampled":
            f = f_req if requested else self._largest_fitting_fraction(dm, model)
            if f is None:
                # nothing fits even sampled; the mode is forced, so take the
                # least memory-hungry fraction rather than the largest
                f = min(self.sampling_fractions)
            return ExecutionDecision("sampled", f, model, "forced sampled")

        # mode == "auto": the decision procedure proper.
        # Resolve-time validation first: the fixed working set — dominated by
        # the histogram demand of max_depth/max_leaves — must fit the budget
        # in *some* mode before any row is staged. Forced modes skip this
        # (their documented contract is "skip the procedure").
        if model.fixed_bytes > model.hbm_bytes:
            leaves = f"/max_leaves={model.max_leaves}" if model.max_leaves else ""
            remedy = (
                "Set ExecutionPolicy(hist_budget_bytes=...) to spill retained "
                "histograms to host"
                if model.max_leaves
                else "Use grow_policy='lossguide' with max_leaves (plus "
                "ExecutionPolicy(hist_budget_bytes=...)) to bound and spill "
                "the histogram working set"
            )
            raise ValueError(
                f"memory budget {model.hbm_bytes} bytes does not fit the fixed "
                f"device working set ({model.fixed_bytes} bytes): histograms "
                f"alone need {model.hist_bytes} bytes at "
                f"max_depth={model.max_depth}{leaves} with "
                f"{model.hist_retained_levels} retained level(s). "
                f"{remedy}, or lower max_depth/max_bin"
            )
        n = dm.n_rows
        in_core_bytes = (
            model.fixed_bytes
            + model.matrix_device_bytes(dm.estimated_device_bytes())
            + n * (model.row_state_bytes + 8)
        )
        if in_core_bytes <= model.hbm_bytes:
            return ExecutionDecision(
                "in_core", None, model,
                f"fits in core ({in_core_bytes} <= {model.hbm_bytes} bytes)",
            )
        # does the histogram working set tip the in-core decision? (deep trees:
        # the matrix alone would fit, the retained histograms do not)
        hist_tip = ""
        if in_core_bytes - model.hist_bytes <= model.hbm_bytes:
            hint = (
                "hist_budget_bytes can spill it"
                if model.max_leaves
                else "lossguide growth (max_leaves) with hist_budget_bytes "
                "can shrink it"
            )
            hist_tip = (
                f"; histogram working set {model.hist_bytes} bytes "
                f"(max_depth={model.max_depth}, {model.hist_retained_levels} "
                f"retained level(s)) tips in-core over budget — {hint}"
            )
        if n <= model.max_rows_out_of_core():
            if requested:
                return ExecutionDecision(
                    "sampled", f_req, model,
                    f"exceeds in-core budget ({n} > {model.max_rows_in_core()} "
                    f"rows) and sampling configured -> Alg. 7{hist_tip}",
                )
            return ExecutionDecision(
                "out_of_core", None, model,
                f"exceeds in-core budget ({n} > {model.max_rows_in_core()} rows), "
                f"streaming state fits ({n} <= {model.max_rows_out_of_core()})"
                f"{hist_tip}",
            )
        # even streaming per-row state busts the budget: sampling shrinks it
        if requested and n <= model.max_rows_sampled(f_req):
            return ExecutionDecision(
                "sampled", f_req, model,
                f"exceeds streaming budget ({n} > {model.max_rows_out_of_core()} "
                f"rows); configured f={f_req} fits",
            )
        f = self._largest_fitting_fraction(dm, model)
        if f is None:
            raise ValueError(
                f"{n} rows x {dm.num_features} features does not fit the "
                f"{model.hbm_bytes}-byte budget in any mode (max sampled rows at "
                f"f={min(self.sampling_fractions)}: "
                f"{model.max_rows_sampled(min(self.sampling_fractions))}); raise "
                "memory_budget_bytes or add smaller sampling_fractions"
            )
        return ExecutionDecision(
            "sampled", f, model,
            f"exceeds streaming budget ({n} > {model.max_rows_out_of_core()} "
            f"rows); largest fitting sampling fraction f={f}",
        )

    def _largest_fitting_fraction(self, dm, model: DeviceMemoryModel) -> float | None:
        for f in sorted(self.sampling_fractions, reverse=True):
            if dm.n_rows <= model.max_rows_sampled(f):
                return f
        return None
