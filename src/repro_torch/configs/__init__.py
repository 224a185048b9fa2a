"""Architecture registry: the ten assigned configs + the paper's workload."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import SHAPES, ShapeSpec, applicable, get_shape

_MODULES: Dict[str, str] = {
    "recurrentgemma-9b": "repro_torch.configs.recurrentgemma_9b",
    "qwen3-moe-235b-a22b": "repro_torch.configs.qwen3_moe_235b_a22b",
    "deepseek-moe-16b": "repro_torch.configs.deepseek_moe_16b",
    "command-r-35b": "repro_torch.configs.command_r_35b",
    "h2o-danube-1.8b": "repro_torch.configs.h2o_danube_1_8b",
    "qwen2-1.5b": "repro_torch.configs.qwen2_1_5b",
    "gemma2-9b": "repro_torch.configs.gemma2_9b",
    "internvl2-1b": "repro_torch.configs.internvl2_1b",
    "whisper-large-v3": "repro_torch.configs.whisper_large_v3",
    "mamba2-2.7b": "repro_torch.configs.mamba2_2_7b",
}


def list_archs() -> List[str]:
    return sorted(_MODULES)


def get_arch(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {list_archs()}")
    return importlib.import_module(_MODULES[name]).CONFIG


def get_smoke(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {list_archs()}")
    return importlib.import_module(_MODULES[name]).smoke_config()


__all__ = [
    "ArchConfig", "SHAPES", "ShapeSpec", "applicable", "get_shape",
    "list_archs", "get_arch", "get_smoke",
]
