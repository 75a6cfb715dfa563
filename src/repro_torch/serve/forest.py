"""PackedForest: a fitted forest flattened for one-launch batched prediction.

Counterpart of `repro.serve.forest`. The booster keeps trees as a list of
per-tree `TreeArrays`; `PackedForest` stacks them into (T, n_total) tensors
on the device once and predicts the whole forest per launch through
`kernels.ops.predict_forest` (the CUDA forest kernel for CUDA tensors).

Accumulation is in tree order over a leaf table pre-scaled by the learning
rate, so packed prediction equals the per-tree loop
(`predict_margin_per_tree`) bit for bit.

`chunk(lo, hi)` splits the forest into tree ranges for the paged forest
(forests larger than the device budget; see `repro_torch.serve.engine`), and
`pack_page`/`unpack_page` flatten a chunk into the one-ndarray page that
`repro_torch.pipeline.PageStream` stages, and back on the device.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core.quantile import HistogramCuts
from repro_torch.core.tree import TreeArrays
from repro_torch.kernels import ops

Tensor = torch.Tensor

# pack_page row layout: one f32 plane per tree-array field, in this order
_PAGE_FIELDS = ("feature", "split_bin", "split_value", "default_left", "is_leaf", "leaf_value")


@dataclasses.dataclass(frozen=True)
class PackedForest:
    """Flat-array forest: every field is (n_trees, n_total), on one device."""

    feature: Tensor  # (T, n_total) int32
    split_bin: Tensor  # (T, n_total) int32
    split_value: Tensor  # (T, n_total) f32 raw thresholds
    default_left: Tensor  # (T, n_total) bool
    is_leaf: Tensor  # (T, n_total) bool
    leaf_value: Tensor  # (T, n_total) f32
    max_depth: int
    learning_rate: float
    base_margin: float
    objective: str = "reg:squarederror"
    cuts: HistogramCuts | None = None

    @classmethod
    def from_booster(
        cls, booster, iteration_range: tuple[int, int] | None = None
    ) -> "PackedForest":
        """Pack a fitted `GradientBooster` (anything with ``trees``,
        ``params``, ``cuts``, ``base_margin_``) for serving."""
        if not booster.trees:
            raise ValueError("booster has no trees; fit before packing")
        lo, hi = iteration_range or (0, len(booster.trees))
        trees = booster.trees[lo:hi]
        first = booster.trees[0]
        stacked = {
            f: (
                torch.stack([getattr(t, f) for t in trees])
                if trees
                else getattr(first, f).new_zeros((0, first.n_total))
            )
            for f in TreeArrays._fields
        }
        return cls(
            max_depth=booster.params.max_depth,
            learning_rate=booster.params.learning_rate,
            base_margin=float(booster.base_margin_),
            objective=booster.params.objective,
            cuts=booster.cuts,
            **stacked,
        )

    @property
    def n_trees(self) -> int:
        return self.feature.shape[0]

    @property
    def n_total(self) -> int:
        return self.feature.shape[1]

    @property
    def device(self) -> torch.device:
        return self.feature.device

    @property
    def nbytes(self) -> int:
        """Device bytes of the packed planes (int32/f32 words, bool bytes)."""
        return sum(
            getattr(self, f).numel() * getattr(self, f).element_size() for f in _PAGE_FIELDS
        )

    def _base(self, n_rows: int) -> Tensor:
        return torch.full((n_rows,), self.base_margin, dtype=torch.float32, device=self.device)

    def predict_margin_bins(self, bins: Tensor, margin_in: Tensor | None = None) -> Tensor:
        """Fused whole-forest margins over quantised rows (one launch)."""
        if margin_in is None:
            margin_in = self._base(bins.shape[0])
        return ops.predict_forest(
            bins, self.feature, self.split_bin, self.default_left, self.is_leaf,
            self.leaf_value, self.max_depth, self.learning_rate, margin_in,
        )

    @functools.cached_property
    def _binner(self):
        """The cuts as device tables, made once a forest, not once a request."""
        from repro_torch.core.ellpack import Binner

        return Binner(self.cuts, self.device)

    def quantize(self, X: np.ndarray) -> Tensor:
        """Raw feature rows -> uint8 bins, binned on the forest's device (the
        CUDA binning kernel there), in chunks of one page's rows."""
        if self.cuts is None:
            raise ValueError("PackedForest has no cuts; predict from bins instead")
        return self._binner.to_device(X)

    def predict_margin(self, X: np.ndarray) -> np.ndarray:
        """Raw-feature front door: quantise with the forest's cuts, then fuse."""
        return self.predict_margin_bins(self.quantize(X)).cpu().numpy()

    def predict_margin_per_tree(self, bins: Tensor) -> Tensor:
        """The per-tree reference loop the fused kernel must match bit for
        bit: the same eager leaf pre-scale, then one pure f32 add per tree."""
        margin = self._base(bins.shape[0])
        scaled_leaf = (
            torch.tensor(self.learning_rate, dtype=torch.float32, device=self.device)
            * self.leaf_value
        )
        for t in range(self.n_trees):
            margin = margin + ops.predict_bins(
                bins, self.feature[t], self.split_bin[t], self.default_left[t],
                self.is_leaf[t], scaled_leaf[t], self.max_depth,
            )
        return margin

    # ------------------------------------------------- paged-forest chunking
    def chunk(self, lo: int, hi: int) -> "PackedForest":
        """Trees [lo, hi) as a self-contained chunk (same metadata)."""
        sliced = {f: getattr(self, f)[lo:hi] for f in _PAGE_FIELDS}
        return dataclasses.replace(self, **sliced)

    @functools.cached_property
    def _host_planes(self) -> np.ndarray:
        """The whole forest as one (6, T, n_total) f32 host array, copied
        from the device once: the source every chunk page is cut from."""
        return np.stack(
            [getattr(self, f).cpu().numpy().astype(np.float32) for f in _PAGE_FIELDS]
        )

    def pack_page(self, lo: int, hi: int) -> np.ndarray:
        """Trees [lo, hi) as ONE (6, hi-lo, n_total) f32 host array, the
        single-ndarray page shape `PageStream` stages. Feature ids below
        2**24, bins up to 255 and bools are exact in f32, so `unpack_page`
        round-trips bit for bit."""
        return np.ascontiguousarray(self._host_planes[:, lo:hi])

    @staticmethod
    def unpack_page(page: Tensor) -> dict[str, Tensor]:
        """Inverse of `pack_page` on the page's device: contiguous planes in
        the dtypes the forest kernel's wrapper requires."""
        return {
            "feature": page[0].to(torch.int32).contiguous(),
            "split_bin": page[1].to(torch.int32).contiguous(),
            "split_value": page[2].contiguous(),
            "default_left": (page[3] > 0.5).contiguous(),
            "is_leaf": (page[4] > 0.5).contiguous(),
            "leaf_value": page[5].contiguous(),
        }
