"""Configurations of the port: the paper's own GBDT workload (`xgb_paper`)
and the assigned LM architectures, one module each, found by ``--arch``
name through `registry` (counterpart of `repro.configs`; `shapes` is not
ported yet)."""
from repro_torch.configs.registry import ALL_ARCHS, LM_ARCHS, get_config, get_module

__all__ = ["ALL_ARCHS", "LM_ARCHS", "get_config", "get_module"]
