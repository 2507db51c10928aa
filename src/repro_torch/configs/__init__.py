"""Architecture registry: the 10 assigned LM configs (pure data, as in the
reference's ``repro.configs``) + the paper's MAGM config (``magm_paper``).

Each module exposes CONFIG (the exact published shape) and SMOKE (a reduced
same-family config for CPU smoke tests).  ``get(name)`` / ``get_smoke(name)``
look them up; ``ARCHS`` lists all ids.
"""

from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import ModelConfig, ShapeConfig, SHAPES, get_shape

ARCHS = (
    "llama_3_2_vision_90b",
    "zamba2_2_7b",
    "yi_9b",
    "qwen3_14b",
    "deepseek_67b",
    "olmo_1b",
    "whisper_base",
    "falcon_mamba_7b",
    "mixtral_8x22b",
    "phi3_5_moe_42b",
)

# aliases matching the assignment spelling
ALIASES: Dict[str, str] = {
    "llama-3.2-vision-90b": "llama_3_2_vision_90b",
    "zamba2-2.7b": "zamba2_2_7b",
    "yi-9b": "yi_9b",
    "qwen3-14b": "qwen3_14b",
    "deepseek-67b": "deepseek_67b",
    "olmo-1b": "olmo_1b",
    "whisper-base": "whisper_base",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "mixtral-8x22b": "mixtral_8x22b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe_42b",
}


def _module(name: str):
    name = ALIASES.get(name, name)
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke(name: str) -> ModelConfig:
    return _module(name).SMOKE


__all__ = [
    "ARCHS",
    "ALIASES",
    "ModelConfig",
    "ShapeConfig",
    "SHAPES",
    "get",
    "get_shape",
    "get_smoke",
]
