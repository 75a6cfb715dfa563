"""Configurations of the port: the paper's own GBDT workload (`xgb_paper`)
and the assigned LM architectures, one module each, found by ``--arch``
name through `registry`, and the dry run's input shapes (`shapes`).
Counterpart of `repro.configs`."""
from repro_torch.configs.registry import ALL_ARCHS, LM_ARCHS, get_config, get_module
from repro_torch.configs.shapes import SHAPES, ShapeSpec, applicable, input_specs

__all__ = [
    "ALL_ARCHS",
    "LM_ARCHS",
    "get_config",
    "get_module",
    "SHAPES",
    "ShapeSpec",
    "applicable",
    "input_specs",
]
