"""GradientBooster: the estimator surface of the port.

Counterpart of `repro.core.booster`. ``fit`` takes raw ``(X, y)`` arrays, a
batch source or a DMatrix (`ArrayDMatrix`, `IterDMatrix`, `PagedDMatrix`);
the `ExecutionPolicy` decides the mode with the reference's Table-1 byte
model, and the decision lands on ``decision_``:

  in_core      the whole uint8 ELLPACK matrix is staged to the device once,
               and every tree level runs the CUDA histogram and partition
               kernels (Alg. 1 per round);
  out_of_core  the pages stream through `PageStream` (disk -> pinned host ->
               device), one pass per tree level for the histogram and one
               for the repartition (Alg. 6); the margins are updated from
               the final row positions, without another pass;
  sampled      gradient-based sampling (`core.sampling`: SGB, GOSS, MVS)
               picks rows each round; one host pass over the pages gathers
               them into one compacted page, staged once, and the tree is
               built on it in core; one staged pass per tree then updates
               the margins (Alg. 7).

In core, sampling multiplies the gradients by ``where(keep, weight, 0)``,
as the reference does. Each round draws from a `torch.Generator` on the
booster's device seeded from ``(params.seed, iteration)``, so a resumed fit
draws the masks the uninterrupted fit drew.

``predict`` bins raw rows on the device (the CUDA binning kernel) and goes
through `PackedForest` and the CUDA forest kernel; a DMatrix streams its
ELLPACK pages through the serving tier (`repro_torch.serve`), one forest
launch a page.

``resume(checkpoint, data)`` reloads a forest and replays its margins page
by page, and ``fit(data, start_iteration=len(trees))`` boosts on from it:
the single-process crash/resume path, and the recovery primitive of the
elastic trainer (`repro_torch.distributed`).

Everything runs on the CUDA device unless the caller passes
``device="cpu"``, which runs the plain PyTorch versions of the kernels on the
host; asking for CUDA where there is none raises. Every engine grows
depthwise or best-first (``grow_policy="lossguide"``, `core.tree`), and the
policy's ``hist_budget_bytes`` bounds the device tier of the histogram store
(`core.histcache`), whose spills and fetches land in ``stats``; the
policy's ``grad_transport`` narrows them, and its ``page_codec``
(`repro_torch.compress`) is threaded through every staging path: a
device-decodable codec
(``"bitpack"``) copies packed pages and decodes them on the device, with
the same bins and so the same trees.

Checkpoints use the reference's format (``model.npz``, ``booster.json``,
``manifest.json`` with CRC32), so a forest saved by `repro` loads here and
predicts the same margins, and the reverse.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import time
import zlib
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import objectives as obj_lib
from repro_torch.core.ellpack import Binner, EllpackPage
from repro_torch.core.histcache import HistogramStore
from repro_torch.core.policy import ExecutionDecision, ExecutionPolicy, sampling_requested
from repro_torch.core.quantile import HistogramCuts
from repro_torch.core.sampling import SamplingConfig, sample
from repro_torch.core.split import SplitParams
from repro_torch.core.tree import (
    TreeArrays,
    TreeBuildResult,
    TreeParams,
    grow_tree,
    predict_tree_bins,
)
from repro_torch.data.pages import TransferStats, fsync_dir

Tensor = torch.Tensor


def resolve_device(device: str | torch.device) -> torch.device:
    """The device an entry point runs on; raise rather than fall back."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' was requested but torch.cuda.is_available() is False; "
                "pass device='cpu' to run the plain PyTorch versions on the host"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    return dev


class CheckpointCorruptError(RuntimeError):
    """A checkpoint failed its manifest validation; names the damaged file
    and, when one survives, the last-good checkpoint (``<path>.prev``)."""

    def __init__(self, path: str, bad_file: str, reason: str, last_good: str | None):
        self.path = path
        self.bad_file = bad_file
        self.last_good = last_good
        hint = (
            f"last-good checkpoint: {last_good!r} — resume from it"
            if last_good
            else "no intact previous checkpoint found"
        )
        super().__init__(
            f"checkpoint {path!r} is corrupt: {bad_file} {reason}. {hint}."
        )


@dataclasses.dataclass
class BoosterParams:
    """Model hyperparameters, with the reference's fields so its checkpoints
    load. ``kernel_impl`` is read for format compatibility and has no effect:
    the device of the data picks kernel or plain version. ``max_leaves`` (0 =
    up to the complete tree of ``max_depth``) and ``pop_batch`` (frontier
    leaves popped per histogram pass) only matter for best-first growth,
    ``grow_policy="lossguide"``."""

    n_estimators: int = 100
    learning_rate: float = 0.3
    max_depth: int = 6
    reg_lambda: float = 1.0
    gamma: float = 0.0
    min_child_weight: float = 1.0
    max_bin: int = 256
    objective: str = "reg:squarederror"
    sampling: SamplingConfig = dataclasses.field(default_factory=SamplingConfig)
    base_score: float | None = None
    seed: int = 0
    kernel_impl: str = "auto"
    early_stopping_rounds: int | None = None
    hist_subtraction: bool = True
    grow_policy: str = "depthwise"
    max_leaves: int = 0
    pop_batch: int = 1

    def __post_init__(self) -> None:
        if self.n_estimators < 1:
            raise ValueError(f"n_estimators must be >= 1; got {self.n_estimators}")
        if self.max_depth < 1:
            raise ValueError(f"max_depth must be >= 1; got {self.max_depth}")
        if self.learning_rate <= 0.0:
            raise ValueError(f"learning_rate must be > 0; got {self.learning_rate}")
        if self.max_bin < 2:
            raise ValueError(f"max_bin must be >= 2; got {self.max_bin}")
        if self.grow_policy not in ("depthwise", "lossguide"):
            raise ValueError(
                f"grow_policy must be 'depthwise' or 'lossguide'; got {self.grow_policy!r}"
            )
        if self.max_leaves < 0:
            raise ValueError(f"max_leaves must be >= 0; got {self.max_leaves}")
        if self.pop_batch < 1:
            raise ValueError(f"pop_batch must be >= 1; got {self.pop_batch}")
        if self.early_stopping_rounds is not None and self.early_stopping_rounds < 1:
            raise ValueError(
                f"early_stopping_rounds must be >= 1 or None; got {self.early_stopping_rounds}"
            )

    def tree_params(self) -> TreeParams:
        return TreeParams(
            max_depth=self.max_depth,
            split=SplitParams(
                reg_lambda=self.reg_lambda,
                gamma=self.gamma,
                min_child_weight=self.min_child_weight,
            ),
            hist_subtraction=self.hist_subtraction,
            grow_policy=self.grow_policy,
            max_leaves=self.max_leaves,
            pop_batch=self.pop_batch,
        )


def bin_valid_from_cuts(cuts: HistogramCuts, n_bins: int, device: torch.device) -> Tensor:
    """(m, n_bins) bool: True at each feature's real bins."""
    nbf = torch.as_tensor(cuts.n_bins_per_feature, dtype=torch.int64)
    mask = torch.arange(n_bins)[None, :] < nbf[:, None]
    return mask.to(device)


@dataclasses.dataclass
class EvalRecord:
    iteration: int
    metric: str
    value: float
    elapsed_s: float


class GradientBooster:
    """XGBoost-like estimator over the port's tree builders (in-core,
    out-of-core streaming and sampled)."""

    def __init__(
        self,
        params: BoosterParams | None = None,
        *,
        policy: ExecutionPolicy | None = None,
        device: str | torch.device = "cuda",
        **kwargs,
    ):
        if params is None:
            params = BoosterParams(**kwargs)
        elif kwargs:
            params = dataclasses.replace(params, **kwargs)
        self.device = resolve_device(device)
        self.params = params
        self.policy = policy if policy is not None else ExecutionPolicy()
        self.objective = obj_lib.get_objective(params.objective)
        self.trees: list[TreeArrays] = []
        self.cuts: HistogramCuts | None = None
        self.base_margin_: float = 0.0
        self.eval_history: list[EvalRecord] = []
        self.decision_: ExecutionDecision | None = None
        self.stats: TransferStats | None = None
        self.hist_cache = self._make_hist_store()
        self._packed_forest = None
        # out-of-core state (filled when the decision streams pages)
        self.pages = None  # PageSet of the last external fit
        self.margins_: Tensor | None = None  # (n_rows,) f32 on the device
        self._device_cache = None

    def _make_hist_store(self, transfer_stats: TransferStats | None = None) -> HistogramStore:
        """A histogram store with this booster's policy knobs; ``transfer_stats``
        shares its spill and fetch ledger (the fit's, or the page set's)."""
        return HistogramStore(
            enabled=self.params.hist_subtraction,
            budget_bytes=self.policy.hist_budget_bytes,
            retained_levels=self.policy.hist_retained_levels,
            transfer_stats=transfer_stats,
            retry=self.policy.retry,
            grad_transport=self.policy.grad_transport,
        )

    # ------------------------------------------------------------------ fit
    def fit(
        self,
        data,
        y: np.ndarray | None = None,
        *,
        eval_set: tuple[np.ndarray, np.ndarray] | None = None,
        eval_metric: str = "auto",
        verbose: bool = False,
        cuts: HistogramCuts | None = None,
        start_iteration: int = 0,
    ) -> "GradientBooster":
        """Train on raw arrays, a batch source or a DMatrix; the policy's
        decision lands on ``self.decision_``. ``start_iteration`` resumes
        boosting from the trees held (see `resume`): it must equal their
        count, and rounds ``start_iteration .. n_estimators - 1`` follow."""
        from repro_torch.data.dmatrix import as_dmatrix

        p = self.params
        if start_iteration and len(self.trees) != start_iteration:
            raise ValueError(
                f"start_iteration={start_iteration} but the booster holds "
                f"{len(self.trees)} trees; resume with start_iteration == len(trees)"
            )
        self._packed_forest = None
        dm = as_dmatrix(data, y, max_bin=p.max_bin, cuts=cuts, device=self.device)
        decision = self.policy.decide(dm, p)
        self.decision_ = decision
        self.cuts = dm.cuts
        if decision.mode == "in_core":
            return self._fit_in_core(dm, eval_set, eval_metric, verbose, start_iteration)
        return self._fit_external(dm, decision, eval_set, eval_metric, verbose, start_iteration)

    def _round_generator(self, iteration: int) -> torch.Generator:
        """The sampling draws of one boosting round: a generator on the
        booster's device seeded from (seed, iteration), so the draws depend
        on nothing a resume loses. The two are mixed by a `SeedSequence`:
        the CPU generator keeps only the seed's low 32 bits."""
        mixed = np.random.SeedSequence([self.params.seed % (1 << 64), iteration])
        seed = int(mixed.generate_state(1, np.uint64)[0])
        return torch.Generator(device=self.device).manual_seed(seed)

    def _eval_state(self, eval_set, cuts: HistogramCuts):
        """(device bins, labels, margins replaying the held trees) of the eval
        set, or Nones; the rows are binned on the device."""
        if eval_set is None:
            return None, None, None
        p = self.params
        eval_bins = Binner(cuts, self.device).to_device(eval_set[0])
        eval_labels = np.asarray(eval_set[1], dtype=np.float32)
        eval_margin = torch.full(
            (eval_labels.shape[0],), self.base_margin_, dtype=torch.float32, device=self.device
        )
        for tree in self.trees:
            eval_margin = eval_margin + p.learning_rate * predict_tree_bins(
                tree, eval_bins, p.max_depth
            )
        return eval_bins, eval_labels, eval_margin

    def _boost(
        self, boost_round, eval_set, cuts, eval_metric, verbose, start_iteration
    ) -> None:
        """The boosting loop shared by the engines: per round ``it`` from
        ``start_iteration`` on, a tree from ``boost_round(it)`` (which also
        updates the training margins), then the checkpoint cadence, eval and
        early stopping."""
        p, pol = self.params, self.policy
        eval_bins, eval_labels, eval_margin = self._eval_state(eval_set, cuts)
        metric_name = self._metric_name(eval_metric)
        t0 = time.perf_counter()
        best_metric, best_iter = None, -1
        for it in range(start_iteration, p.n_estimators):
            tree = boost_round(it)
            self.trees.append(tree)
            if pol.checkpoint_every and pol.checkpoint_dir and (it + 1) % pol.checkpoint_every == 0:
                self.save(pol.checkpoint_dir)
            if eval_bins is None:
                continue
            pred = predict_tree_bins(tree, eval_bins, p.max_depth)
            eval_margin = eval_margin + p.learning_rate * pred
            val = self._eval(metric_name, eval_labels, eval_margin)
            self.eval_history.append(EvalRecord(it, metric_name, val, time.perf_counter() - t0))
            if verbose:
                print(f"[{it}] {metric_name}={val:.6f}")
            better = (
                best_metric is None
                or (metric_name in ("auc", "accuracy") and val > best_metric)
                or (metric_name not in ("auc", "accuracy") and val < best_metric)
            )
            if better:
                best_metric, best_iter = val, it
            elif p.early_stopping_rounds and it - best_iter >= p.early_stopping_rounds:
                break
        self.best_iteration_ = best_iter if best_iter >= 0 else len(self.trees) - 1

    def _fit_in_core(
        self, dm, eval_set, eval_metric, verbose, start_iteration
    ) -> "GradientBooster":
        p, dev = self.params, self.device
        tp = p.tree_params()
        if start_iteration == 0:
            # a fresh ledger for this fit, which the store's spills share
            self.stats = TransferStats()
            self.hist_cache = self._make_hist_store(self.stats)
        else:
            # a resumed fit keeps its store and ledger, as the reference does
            if self.stats is None:
                self.stats = TransferStats()
            self.hist_cache.transfer_stats = self.stats
        labels = dm.require_labels()
        n_bins = dm.n_bins
        bin_valid = bin_valid_from_cuts(dm.cuts, n_bins, dev)
        bins = self._stage_in_core(np.ascontiguousarray(dm.single_page_bins()))
        labels_t = torch.from_numpy(labels).to(dev)

        if start_iteration == 0:
            self.base_margin_ = (
                p.base_score if p.base_score is not None else self.objective.base_margin(labels)
            )
        margin = torch.full((labels.shape[0],), self.base_margin_, dtype=torch.float32, device=dev)
        # a refit boosts on from the trees already held, as the reference does
        for tree in self.trees:
            margin = margin + p.learning_rate * predict_tree_bins(tree, bins, p.max_depth)

        def boost_round(it: int) -> TreeArrays:
            nonlocal margin
            g, h = self.objective.grad_hess(margin, labels_t)
            keep, w = sample(self._round_generator(it), g, h, p.sampling)
            scale = torch.where(keep, w, 0.0)
            res = grow_tree(
                bins, g * scale, h * scale, n_bins, bin_valid, tp,
                cut_values=dm.cuts.values, cut_ptrs=dm.cuts.ptrs,
                hist_cache=self.hist_cache,
            )
            # eager multiply then add, as the reference (no fused FMA)
            margin = margin + p.learning_rate * res.tree.leaf_value[res.positions.to(torch.int64)]
            return res.tree

        self._boost(boost_round, eval_set, dm.cuts, eval_metric, verbose, start_iteration)
        return self

    def _stage_in_core(self, host_bins: np.ndarray) -> Tensor:
        """Stage the whole uint8 matrix (the kernels read uint8), through the
        policy's page codec when it is device-decodable: only the packed
        payload is copied, and the bitpack decode kernel expands it to the
        same bins on the device."""
        from repro_torch.compress import make_transport

        transport = make_transport(self.policy.page_codec)
        if transport is None:
            bins = torch.from_numpy(host_bins).to(self.device)
            wire_nbytes = host_bins.nbytes
        else:
            wire, wire_meta = transport.encode(host_bins)
            bins = transport.decode(torch.from_numpy(wire).to(self.device), wire_meta)
            wire_nbytes = wire.nbytes
        self.stats.logical_bytes += host_bins.nbytes
        self.stats.wire_bytes += wire_nbytes
        self.stats.host_to_device_bytes += wire_nbytes
        return bins

    # ----------------------------------------------- Alg. 6 (streaming path)
    def _stream(self, indices=None):
        """One `PageStream` pass over the last external fit's page set, or
        over the pages ``indices`` of it."""
        return self.pages.stream(
            device=self.device,
            indices=indices,
            prefetch_depth=self.policy.prefetch_depth,
            staging_depth=self.policy.staging_depth,
            cache=self._device_cache,
            retry=self.policy.retry,
            codec=self.policy.page_codec,
        )

    def _fit_external(
        self, dm, decision, eval_set, eval_metric, verbose, start_iteration
    ) -> "GradientBooster":
        from repro_torch.pipeline import DevicePageCache

        p, dev = self.params, self.device
        tp = p.tree_params()
        labels = dm.require_labels()
        pages = dm.page_set()
        self.pages = pages
        self.stats = pages.stats
        if start_iteration == 0:
            self.hist_cache = self._make_hist_store(pages.stats)
        else:
            self.hist_cache.transfer_stats = pages.stats
        n_bins = dm.n_bins
        bin_valid = bin_valid_from_cuts(dm.cuts, n_bins, dev)
        labels_t = torch.from_numpy(labels).to(dev)
        if self.margins_ is None:
            # a refit of the same data boosts on from the held margins, as
            # the reference's external engine does
            self.base_margin_ = (
                p.base_score if p.base_score is not None else self.objective.base_margin(labels)
            )
            self.margins_ = torch.full(
                (pages.n_rows,), self.base_margin_, dtype=torch.float32, device=dev
            )
        use_sampling = decision.mode == "sampled"
        sampling_cfg = p.sampling
        if use_sampling and not sampling_requested(p.sampling):
            # policy-chosen fraction: the paper's MVS default at the largest
            # f whose compacted page fits the budget
            sampling_cfg = SamplingConfig(method="mvs", f=decision.sampling_f or 0.5)
        cache_pages = self.policy.device_cache_pages
        if cache_pages is None:
            # auto: cache only when the whole page set fits (a sequential LRU
            # scan over more pages than capacity evicts every page right
            # before its reuse), and only on the sampled path, whose margin
            # pass revisits each page once a tree
            cache_pages = pages.n_pages if (use_sampling and pages.n_pages <= 8) else 0
        self._device_cache = DevicePageCache(cache_pages) if cache_pages > 0 else None

        def boost_round(it: int) -> TreeArrays:
            g, h = self.objective.grad_hess(self.margins_, labels_t)
            if use_sampling:
                res = self._build_tree_sampled(
                    self._round_generator(it), g, h, n_bins, bin_valid, tp, dm.cuts,
                    sampling_cfg,
                )
            else:
                res = self._build_tree_streaming(g, h, n_bins, bin_valid, tp, dm.cuts)
            self._update_margins(res, tp)
            return res.tree

        self._boost(boost_round, eval_set, dm.cuts, eval_metric, verbose, start_iteration)
        return self

    # -------------------------------------------------- Alg. 7 (sampled path)
    def _sampled_capacity(self, n_rows: int, sampling_cfg: SamplingConfig) -> int:
        """Rows of the compacted page: the expected kept rows with a margin
        for the spread of Bernoulli sampling, rounded up to 1024 (the
        reference's static shape)."""
        f = sampling_cfg.f if sampling_cfg.method != "goss" else (
            sampling_cfg.goss_a + sampling_cfg.goss_b
        )
        cap = int(n_rows * min(1.0, f * 1.25)) + 256
        return min(n_rows, -(-cap // 1024) * 1024)

    def _build_tree_sampled(
        self, generator, g, h, n_bins, bin_valid, tp, cuts, sampling_cfg
    ) -> TreeBuildResult:
        """One tree on the compacted page of this round's sampled rows."""
        keep, w = sample(generator, g, h, sampling_cfg)
        capacity = self._sampled_capacity(self.pages.n_rows, sampling_cfg)
        # kept rows in row order; past the capacity (the extreme tail) the
        # last ones are dropped
        sel = torch.nonzero(keep).squeeze(1)[:capacity]
        n_sel = sel.shape[0]
        # zero-gradient padding rows up to the capacity: they reach the
        # histograms with g = h = 0 and count in the row counts
        g_c = torch.zeros(capacity, dtype=torch.float32, device=g.device)
        h_c = torch.zeros_like(g_c)
        g_c[:n_sel] = (g * w)[sel]
        h_c[:n_sel] = (h * w)[sel]

        # Compact: gather the sampled rows of every page (one host pass, the
        # prefetcher overlapping disk reads; nothing staged), padding rows
        # with bins 0
        sel_np = sel.cpu().numpy()
        bins_np = np.zeros((capacity, self.pages.num_features), np.uint8)
        for _, page in self._stream().iter_host():
            lo = np.searchsorted(sel_np, page.row_offset, side="left")
            hi = np.searchsorted(sel_np, page.row_offset + page.n_rows, side="left")
            if hi > lo:
                bins_np[lo:hi] = page.bins[sel_np[lo:hi] - page.row_offset]
        bins_c = self.pages.stage(EllpackPage(bins_np, 0), self.device,
                                  codec=self.policy.page_codec)
        res = grow_tree(
            bins_c, g_c, h_c, n_bins, bin_valid, tp,
            cut_values=cuts.values, cut_ptrs=cuts.ptrs, hist_cache=self.hist_cache,
        )
        # positions only cover the sampled rows: the margin update streams
        return TreeBuildResult(tree=res.tree, positions=None)

    # ----------------------------------------------- Alg. 6 (streaming path)
    def _build_tree_streaming(self, g, h, n_bins, bin_valid, tp, cuts) -> TreeBuildResult:
        from repro_torch.core.outofcore import build_tree_paged

        extents = self.pages.page_extents
        tree, positions = build_tree_paged(
            self._stream, extents, g, h, n_bins, bin_valid, tp,
            cuts.values, cuts.ptrs, hist_cache=self.hist_cache,
            page_skipping=self.policy.page_skipping,
        )
        # final positions point at leaves: the margin update needs no pass
        pos = torch.cat([positions[i] for i in range(len(extents))])
        return TreeBuildResult(tree=tree, positions=pos)

    def _update_margins(self, res: TreeBuildResult, tp) -> None:
        """Add the tree's learning-rate-scaled leaves to the training margins,
        an eager multiply then an add, as the reference (no fused FMA): from
        the final positions of a streamed tree, else by one staged pass of
        the pages."""
        lr = self.params.learning_rate
        if res.positions is not None:
            leaf = res.tree.leaf_value[res.positions.to(torch.int64)]
            self.margins_ = self.margins_ + lr * leaf
            return
        for sp in self._stream():
            pred = predict_tree_bins(res.tree, sp.device, tp.max_depth)
            ro, nr = sp.host.row_offset, sp.host.n_rows
            self.margins_[ro : ro + nr] += lr * pred

    def _metric_name(self, eval_metric: str) -> str:
        if eval_metric != "auto":
            return eval_metric
        return "auc" if self.objective.name == "binary:logistic" else "rmse"

    def _eval(self, metric: str, labels: np.ndarray, margin: Tensor) -> float:
        preds = self.objective.transform(margin).cpu().numpy()
        return obj_lib.METRICS[metric](labels, preds)

    # -------------------------------------------------------------- predict
    def packed_forest(self, iteration_range: tuple[int, int] | None = None):
        """The serving view of this forest (`repro_torch.serve.PackedForest`),
        cached per forest length; an explicit ``iteration_range`` packs fresh."""
        from repro_torch.serve.forest import PackedForest

        if iteration_range is not None:
            return PackedForest.from_booster(self, iteration_range)
        if self._packed_forest is None or self._packed_forest.n_trees != len(self.trees):
            self._packed_forest = PackedForest.from_booster(self)
        return self._packed_forest

    def predict_margin(self, X, iteration_range: tuple[int, int] | None = None) -> np.ndarray:
        """Margins through the fused serving tier, mirroring ``fit``: raw rows
        are binned on the device and predicted in one whole-forest launch; a
        DMatrix streams its ELLPACK pages (`predict_margin_dmatrix`). Both
        equal `PackedForest.predict_margin_per_tree` bit for bit."""
        if self.cuts is None:
            raise ValueError("booster is not fitted")
        forest = self.packed_forest(iteration_range)
        if hasattr(X, "page_set"):  # DMatrix: the streaming serving path
            from repro_torch.serve.engine import predict_margin_dmatrix

            return predict_margin_dmatrix(forest, X, page_codec=self.policy.page_codec)
        return forest.predict_margin_bins(forest.quantize(X)).cpu().numpy()

    def predict(self, X, output_margin: bool = False) -> np.ndarray:
        """Predictions for raw feature rows or any DMatrix (mirrors ``fit``)."""
        margin = self.predict_margin(X)
        if output_margin:
            return margin
        return self.objective.transform(torch.from_numpy(margin)).numpy()

    # ----------------------------------------------------------- checkpoint
    def save(self, path: str) -> None:
        """Checkpoint the forest and quantisation state in the reference's
        format, atomically: written to a temp sibling, fsynced, renamed into
        place; the previous checkpoint survives as ``<path>.prev``."""
        if self.cuts is None:
            raise ValueError("booster is not fitted")
        arrays = {}
        if self.trees:
            arrays = {
                f: torch.stack([getattr(t, f) for t in self.trees]).cpu().numpy()
                for f in TreeArrays._fields
            }
        meta = dataclasses.asdict(self.params)
        meta["sampling"] = dataclasses.asdict(self.params.sampling)
        meta["base_margin_"] = self.base_margin_
        meta["n_trees"] = len(self.trees)

        parent = os.path.dirname(os.path.abspath(path)) or "."
        os.makedirs(parent, exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        try:
            np.savez_compressed(
                os.path.join(tmp, "model.npz"),
                cut_values=self.cuts.values,
                cut_ptrs=self.cuts.ptrs,
                cut_min_vals=self.cuts.min_vals,
                # the reference's layout of its sampling key, PRNGKey(seed)
                # (threefry: [0, seed]); the port seeds each round's draws
                # from (seed, iteration) and keeps no other RNG state
                rng=np.asarray([0, self.params.seed & 0xFFFFFFFF], np.uint32),
                **{f"tree_{k}": v for k, v in arrays.items()},
            )
            with open(os.path.join(tmp, "booster.json"), "w") as fh:
                json.dump(meta, fh, indent=2)
            manifest = {"format": 1, "files": {}}
            for name in ("model.npz", "booster.json"):
                with open(os.path.join(tmp, name), "rb") as fh:
                    blob = fh.read()
                manifest["files"][name] = {"crc32": zlib.crc32(blob), "bytes": len(blob)}
            with open(os.path.join(tmp, "manifest.json"), "w") as fh:
                json.dump(manifest, fh, indent=2)
            for name in ("model.npz", "booster.json", "manifest.json"):
                with open(os.path.join(tmp, name), "rb") as fh:
                    os.fsync(fh.fileno())
            fsync_dir(tmp)
            prev = f"{path}.prev"
            rotated = False
            if os.path.isdir(path):
                shutil.rmtree(prev, ignore_errors=True)
                os.replace(path, prev)
                rotated = True
            try:
                os.replace(tmp, path)
            except BaseException:
                if rotated:
                    os.replace(prev, path)
                raise
            fsync_dir(parent)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise

    @staticmethod
    def _checkpoint_damage(path: str) -> tuple[str, str] | None:
        """(bad_file, reason) if the checkpoint fails validation, else None.
        Checkpoints without a manifest validate on file presence only."""
        manifest_path = os.path.join(path, "manifest.json")
        if not os.path.isdir(path):
            return (path, "does not exist")
        files: dict[str, dict] = {}
        if os.path.exists(manifest_path):
            try:
                with open(manifest_path) as fh:
                    files = json.load(fh)["files"]
            except (OSError, ValueError, KeyError) as err:
                return ("manifest.json", f"is unreadable ({err})")
        for name in ("booster.json", "model.npz"):
            fp = os.path.join(path, name)
            if not os.path.exists(fp):
                return (name, "is missing")
            want = files.get(name, {}).get("crc32")
            if want is None:
                continue
            with open(fp, "rb") as fh:
                got = zlib.crc32(fh.read())
            if got != want:
                return (
                    name,
                    f"failed its CRC32 check (manifest {want:#010x}, on disk {got:#010x})",
                )
        return None

    @classmethod
    def verify_checkpoint(cls, path: str) -> None:
        """Raise `CheckpointCorruptError` if ``path`` fails validation."""
        damage = cls._checkpoint_damage(path)
        if damage is None:
            return
        prev = f"{path}.prev"
        last_good = prev if cls._checkpoint_damage(prev) is None else None
        raise CheckpointCorruptError(path, damage[0], damage[1], last_good)

    @classmethod
    def last_good_checkpoint(cls, path: str) -> str | None:
        """The newest intact checkpoint among ``path`` and ``path.prev``."""
        for cand in (path, f"{path}.prev"):
            if cls._checkpoint_damage(cand) is None:
                return cand
        return None

    @classmethod
    def load(cls, path: str, device: str | torch.device = "cuda") -> "GradientBooster":
        """Read a checkpoint written by this package's or the reference's
        ``save``, after its CRC check, onto ``device``."""
        cls.verify_checkpoint(path)
        with open(os.path.join(path, "booster.json")) as fh:
            meta = json.load(fh)
        base_margin = meta.pop("base_margin_")
        n_trees = meta.pop("n_trees")
        sampling = SamplingConfig(**meta.pop("sampling"))
        params = BoosterParams(sampling=sampling, **meta)
        data = np.load(os.path.join(path, "model.npz"))
        trees = [
            {f: data[f"tree_{f}"][i] for f in TreeArrays._fields} for i in range(n_trees)
        ]
        return cls.from_numpy_state(
            params, trees, data["cut_values"], data["cut_ptrs"], float(base_margin),
            cut_min_vals=data["cut_min_vals"], device=device,
        )

    @classmethod
    def from_numpy_state(
        cls,
        params: BoosterParams,
        trees: Sequence,
        cuts_values: np.ndarray,
        cuts_ptrs: np.ndarray,
        base_margin: float,
        *,
        cut_min_vals: np.ndarray | None = None,
        device: str | torch.device = "cuda",
    ) -> "GradientBooster":
        """A fitted booster from numpy state: ``trees`` holds one entry per
        tree with the six `TreeArrays` fields, as a mapping or as attributes
        (a reference `TreeArrays` works as it is). Predicts what the source
        forest predicts."""
        self = cls(params, device=device)
        n_features = len(cuts_ptrs) - 1
        self.cuts = HistogramCuts(
            values=np.asarray(cuts_values, np.float32),
            ptrs=np.asarray(cuts_ptrs, np.int32),
            min_vals=(
                np.zeros(n_features, np.float32)
                if cut_min_vals is None
                else np.asarray(cut_min_vals, np.float32)
            ),
        )
        self.base_margin_ = float(base_margin)
        dtypes = {
            "feature": np.int32, "split_bin": np.int32, "split_value": np.float32,
            "default_left": np.bool_, "is_leaf": np.bool_, "leaf_value": np.float32,
        }

        def field(tree, name: str) -> Tensor:
            value = tree[name] if isinstance(tree, dict) else getattr(tree, name)
            arr = np.array(value, dtype=dtypes[name])  # a writable copy
            return torch.from_numpy(arr).to(self.device)

        self.trees = [
            TreeArrays(*[field(t, f) for f in TreeArrays._fields]) for t in trees
        ]
        return self

    @classmethod
    def resume(
        cls,
        checkpoint_path: str,
        data,
        *,
        policy: ExecutionPolicy | None = None,
        device: str | torch.device = "cuda",
    ) -> "GradientBooster":
        """Restart out-of-core training from a checkpoint of either package.

        Reloads the forest and cuts, rebuilds the margins by streaming the
        data's pages (a `PagedDMatrix` over the original page cache needs no
        raw data) and returns a booster ready for ``fit(data,
        start_iteration=len(trees))``. The checkpoint's cuts are
        authoritative: raw data is binned with them, and a DMatrix must
        carry bit-identical cuts, or this raises. The margins replay the
        reference's arithmetic exactly (numpy f32, ``margins[page] += lr *
        pred`` tree by tree), so they equal the incremental ones bit for bit.
        """
        from repro_torch.data.dmatrix import DMatrix, as_dmatrix

        base = cls.load(checkpoint_path, device=device)
        self = cls(
            base.params, policy=policy or ExecutionPolicy(mode="out_of_core"), device=device
        )
        self.trees = base.trees
        self.base_margin_ = base.base_margin_
        if isinstance(data, DMatrix):
            dm = data
            if not (
                np.array_equal(dm.cuts.values, base.cuts.values)
                and np.array_equal(dm.cuts.ptrs, base.cuts.ptrs)
            ):
                raise ValueError(
                    "DMatrix quantization differs from the checkpoint's cuts; its pages "
                    "were binned with other thresholds than the restored trees split on. "
                    "Reopen the original page cache (PagedDMatrix) or pass the raw data."
                )
        else:
            dm = as_dmatrix(data, max_bin=base.params.max_bin, cuts=base.cuts, device=device)
        self.cuts = base.cuts
        self.pages = dm.page_set()
        self.stats = self.pages.stats
        margins = np.full(self.pages.n_rows, self.base_margin_, np.float32)
        lr, md = self.params.learning_rate, self.params.max_depth
        for tree in self.trees:
            for sp in self._stream():
                pred = predict_tree_bins(tree, sp.device, md).cpu().numpy()
                sl = slice(sp.host.row_offset, sp.host.row_offset + sp.host.n_rows)
                margins[sl] += lr * pred
        self.margins_ = torch.from_numpy(margins).to(self.device)
        return self
