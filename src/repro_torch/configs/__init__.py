"""Architecture registry: ``get(name)`` → ModelConfig, ``reduced(name)`` →
the CPU-test-sized config of the same family.

The port carries the configs of all ten architectures: the dense,
local/global, M-RoPE, encoder-only, RG-LRU, xLSTM and expert (MoE)
models, each a copy of the reference's ``CONFIG`` and ``REDUCED``.
"""

from __future__ import annotations

import importlib
from typing import Tuple

from repro_torch.models.config import ModelConfig

ARCH_IDS: Tuple[str, ...] = (
    "smollm-135m",
    "gemma3-4b",
    "llama3.2-3b",
    "chatglm3-6b",
    "deepseek-moe-16b",
    "kimi-k2-1t-a32b",
    "qwen2-vl-72b",
    "hubert-xlarge",
    "xlstm-125m",
    "recurrentgemma-9b",
)

#: Architectures → their module under ``repro_torch.configs``.
_MODULES = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown architecture {name!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get(name: str) -> ModelConfig:
    return _module(name).CONFIG


def reduced(name: str) -> ModelConfig:
    return _module(name).REDUCED
