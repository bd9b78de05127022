"""Architecture config registry: ``get_config("<arch-id>")`` (port of
``repro.configs``: the same ten dimension tables, copied as data), and
``dwt53.py``, the paper's own signal configs."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (  # noqa: F401
    SHAPE_SUITE,
    ArchConfig,
    ShapeCell,
    cell_applicable,
    reduced,
    shape_cell,
)

_ARCH_MODULES: Dict[str, str] = {
    "granite-34b": "granite_34b",
    "granite-3-8b": "granite_3_8b",
    "stablelm-1.6b": "stablelm_1_6b",
    "nemotron-4-340b": "nemotron_4_340b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe_42b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b",
    "rwkv6-7b": "rwkv6_7b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "musicgen-medium": "musicgen_medium",
    "internvl2-26b": "internvl2_26b",
}

ARCH_IDS: List[str] = list(_ARCH_MODULES)


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch_id]}")
    return mod.CONFIG
