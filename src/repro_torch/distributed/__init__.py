"""Elastic data-parallel training over subprocess workers.

Counterpart of the elastic half of `repro.distributed`. The sharded builder
(`gbdt_shard.py`: `DistConfig`, `grow_tree_distributed*`, `fit_sharded`),
which needs an all-reduce across several cards, is not ported yet.
"""
from repro_torch.distributed.elastic import (
    ElasticConfig,
    ElasticError,
    ElasticTrainer,
    WorkerFailure,
    prepare_shards,
)

__all__ = [
    "ElasticConfig",
    "ElasticError",
    "ElasticTrainer",
    "WorkerFailure",
    "prepare_shards",
]
