"""Distributed training: the sharded builder and the elastic trainer.

Counterpart of `repro.distributed`. `gbdt_shard` is the paper's §2.2
histogram all-reduce over `torch.distributed`, SPMD, one process per shard
of a `make_mesh` mesh (`DistConfig`, `grow_tree_distributed*`,
`make_gbdt_step_fn`, `fit_sharded`); `elastic` is the fault-tolerant
coordinator/worker trainer over subprocess workers.
"""
from repro_torch.distributed.elastic import (
    ElasticConfig,
    ElasticError,
    ElasticTrainer,
    WorkerFailure,
    prepare_shards,
)
from repro_torch.distributed.gbdt_shard import (
    CollectiveStats,
    DistConfig,
    Mesh,
    check_feature_parallel_lossguide,
    distributed_train_step,
    fit_sharded,
    grow_tree_distributed,
    grow_tree_distributed_paged,
    make_gbdt_step_fn,
    make_mesh,
    sharded_page_put,
)

__all__ = [
    "CollectiveStats",
    "DistConfig",
    "ElasticConfig",
    "ElasticError",
    "ElasticTrainer",
    "Mesh",
    "WorkerFailure",
    "check_feature_parallel_lossguide",
    "distributed_train_step",
    "fit_sharded",
    "grow_tree_distributed",
    "grow_tree_distributed_paged",
    "make_gbdt_step_fn",
    "make_mesh",
    "prepare_shards",
    "sharded_page_put",
]
