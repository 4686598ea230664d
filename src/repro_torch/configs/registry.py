"""Architecture registry of the port: the archs it can run so far."""
from __future__ import annotations

import importlib

from .base import ModelConfig

ARCHS = ("deepseek-7b", "zamba2-1.2b", "rwkv6-1.6b", "granite-moe-3b-a800m",
         "moonshot-v1-16b-a3b", "deepseek-67b", "qwen2-vl-2b",
         "musicgen-large", "gemma3-12b", "gemma3-27b")

_MODULES = {a: a.replace("-", "_").replace(".", "_") for a in ARCHS}


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"arch {arch!r} is not ported yet; have {list(ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke(arch: str) -> ModelConfig:
    return _module(arch).smoke()
