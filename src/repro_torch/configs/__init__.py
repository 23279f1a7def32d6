"""Architecture config registry.

``get_config(arch_id)`` returns the full production :class:`ModelConfig`;
``get_config(arch_id, reduced=True)`` returns the smoke-test variant.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (  # noqa: F401 (re-export)
    INPUT_SHAPES, FrontendConfig, GroupedPattern, InputShape, LayerSpec,
    MLAConfig, MambaConfig, ModelConfig, MoEConfig, RWKV6Config,
    group_pattern,
)

# arch id -> module name under repro_torch.configs (the port serves the
# pure-GQA dense decoder; other families are later roadmap items)
_ARCH_MODULES: Dict[str, str] = {
    "llama-3.1-8b": "llama3_1_8b",
}

ALL_ARCHS: List[str] = list(_ARCH_MODULES)

_cache: Dict[str, ModelConfig] = {}


def get_config(arch: str, *, reduced: bool = False) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ALL_ARCHS}")
    if arch not in _cache:
        mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")
        _cache[arch] = mod.CONFIG
    cfg = _cache[arch]
    return cfg.reduced() if reduced else cfg
