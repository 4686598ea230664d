"""Architecture registry: --arch <id> resolution + smoke variants (own
copy of ``repro.configs.registry``)."""
from __future__ import annotations

import importlib

from .base import SHAPES, ModelConfig, shape_applicable

ARCHS = (
    "granite-moe-3b-a800m",
    "moonshot-v1-16b-a3b",
    "zamba2-1.2b",
    "qwen2-vl-2b",
    "deepseek-67b",
    "gemma3-27b",
    "gemma3-12b",
    "deepseek-7b",
    "rwkv6-1.6b",
    "musicgen-large",
)

_MODULES = {a: a.replace("-", "_").replace(".", "_") for a in ARCHS}


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; have {list(ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke(arch: str) -> ModelConfig:
    return _module(arch).smoke()


def all_cells():
    """All 40 (arch, shape) cells with applicability flags."""
    out = []
    for a in ARCHS:
        cfg = get_config(a)
        for s in SHAPES.values():
            ok, why = shape_applicable(cfg, s)
            out.append((a, s.name, ok, why))
    return out
