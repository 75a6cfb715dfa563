"""--arch registry: every assigned architecture + the paper's own GBDT config.

Counterpart of `repro.configs.registry`: the same archs, each mapped to its
port module `repro_torch.configs.<module>`.
"""
from __future__ import annotations

import importlib

_ARCH_MODULES = {
    "llava-next-34b": "repro_torch.configs.llava_next_34b",
    "moonshot-v1-16b-a3b": "repro_torch.configs.moonshot_v1_16b_a3b",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "phi3-mini-3.8b": "repro_torch.configs.phi3_mini_3_8b",
    "smollm-135m": "repro_torch.configs.smollm_135m",
    "minicpm-2b": "repro_torch.configs.minicpm_2b",
    "llama3.2-1b": "repro_torch.configs.llama3_2_1b",
    "mamba2-130m": "repro_torch.configs.mamba2_130m",
    "musicgen-large": "repro_torch.configs.musicgen_large",
    "hymba-1.5b": "repro_torch.configs.hymba_1_5b",
    "xgb-paper": "repro_torch.configs.xgb_paper",
}

LM_ARCHS = [a for a in _ARCH_MODULES if a != "xgb-paper"]
ALL_ARCHS = list(_ARCH_MODULES)


def get_config(arch: str, reduced: bool = False):
    if arch not in _ARCH_MODULES:
        raise ValueError(f"unknown arch {arch!r}; known: {ALL_ARCHS}")
    mod = importlib.import_module(_ARCH_MODULES[arch])
    return mod.REDUCED if reduced else mod.CONFIG


def get_module(arch: str):
    return importlib.import_module(_ARCH_MODULES[arch])
