"""Core of the port: quantisation, objectives, splits, histogram store, tree
builders (in-core and over streamed pages), byte model, execution policy and
the `GradientBooster` estimator. Re-exports the names of `repro.core`."""
from repro_torch.core.booster import BoosterParams, GradientBooster, train_in_core
from repro_torch.core.ellpack import (
    DEFAULT_PAGE_BYTES,
    MISSING_BIN,
    EllpackMatrix,
    EllpackPage,
    bin_batch,
    compact,
    create_ellpack_inmemory,
    create_ellpack_pages,
)
from repro_torch.core.histcache import HistCacheStats, HistogramCache, HistogramStore, LevelPlan
from repro_torch.core.memory import DeviceMemoryModel
from repro_torch.core.objectives import LOGISTIC, SQUARED_ERROR, get_objective
from repro_torch.core.outofcore import ExternalGradientBooster, build_tree_paged
from repro_torch.core.policy import ExecutionDecision, ExecutionPolicy
from repro_torch.core.quantile import HistogramCuts, QuantileSketch, sketch_dense
from repro_torch.core.sampling import SamplingConfig, estimate_mvs_lambda, mvs_threshold, sample
from repro_torch.core.split import SplitParams, evaluate_splits, leaf_weight
from repro_torch.core.tree import (
    TreeArrays,
    TreeParams,
    grow_tree,
    grow_tree_generic,
    grow_tree_lossguide_generic,
    predict_forest_raw,
    predict_tree_bins,
    predict_tree_raw,
    stack_trees,
    tree_growth_driver,
)

__all__ = [
    "BoosterParams",
    "GradientBooster",
    "train_in_core",
    "ExternalGradientBooster",
    "DEFAULT_PAGE_BYTES",
    "MISSING_BIN",
    "EllpackMatrix",
    "EllpackPage",
    "bin_batch",
    "compact",
    "create_ellpack_inmemory",
    "create_ellpack_pages",
    "DeviceMemoryModel",
    "ExecutionDecision",
    "ExecutionPolicy",
    "build_tree_paged",
    "HistCacheStats",
    "HistogramCache",
    "HistogramStore",
    "LevelPlan",
    "LOGISTIC",
    "SQUARED_ERROR",
    "get_objective",
    "HistogramCuts",
    "QuantileSketch",
    "sketch_dense",
    "SamplingConfig",
    "estimate_mvs_lambda",
    "mvs_threshold",
    "sample",
    "SplitParams",
    "evaluate_splits",
    "leaf_weight",
    "TreeArrays",
    "TreeParams",
    "grow_tree",
    "grow_tree_generic",
    "grow_tree_lossguide_generic",
    "tree_growth_driver",
    "predict_forest_raw",
    "predict_tree_bins",
    "predict_tree_raw",
    "stack_trees",
]
