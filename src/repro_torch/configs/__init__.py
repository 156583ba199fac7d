"""Architecture registry of the port.

`get_config(name)` returns the full published config, `get_smoke(name)`
a reduced same-family config for CPU tests. Every architecture of the
reference's registry is here, in its order.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (  # noqa: F401
    ModelConfig, ParallelConfig, ShapeConfig, SHAPES, TrainConfig)

ARCHS: List[str] = [
    "granite_moe_3b_a800m",
    "deepseek_v2_236b",
    "zamba2_1p2b",
    "qwen2_vl_2b",
    "qwen3_8b",
    "gemma3_1b",
    "granite_3_8b",
    "llama3_405b",
    "mamba2_130m",
    "seamless_m4t_large_v2",
]

# CLI ids (dashes) -> module names
_ALIASES: Dict[str, str] = {
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "zamba2-1.2b": "zamba2_1p2b",
    "qwen2-vl-2b": "qwen2_vl_2b",
    "qwen3-8b": "qwen3_8b",
    "gemma3-1b": "gemma3_1b",
    "granite-3-8b": "granite_3_8b",
    "llama3-405b": "llama3_405b",
    "mamba2-130m": "mamba2_130m",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
}


def _module(name: str):
    mod_name = _ALIASES.get(name, name)
    if mod_name not in ARCHS:
        raise ValueError(
            f"unknown architecture {name!r} (known: {sorted(_ALIASES)})")
    return importlib.import_module(f"repro_torch.configs.{mod_name}")


def get_config(name: str, **overrides) -> ModelConfig:
    cfg = _module(name).config()
    return cfg.with_(**overrides) if overrides else cfg


def get_smoke(name: str, **overrides) -> ModelConfig:
    cfg = _module(name).smoke()
    return cfg.with_(**overrides) if overrides else cfg
