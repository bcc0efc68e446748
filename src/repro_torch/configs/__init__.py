"""Architecture registry: ``get(name)`` → ModelConfig, ``reduced(name)`` →
the CPU-test-sized config of the same family, ``SHAPES`` → the four
input-shape cells and ``applicable_cells(name)`` → those an architecture
runs.

The port carries the configs of all ten architectures: the dense,
local/global, M-RoPE, encoder-only, RG-LRU, xLSTM and expert (MoE)
models, each a copy of the reference's ``CONFIG`` and ``REDUCED``.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Tuple

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


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown architecture {name!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get(name: str) -> ModelConfig:
    return _module(name).CONFIG


def reduced(name: str) -> ModelConfig:
    return _module(name).REDUCED


def applicable_cells(name: str) -> Tuple[str, ...]:
    """Shape cells this arch runs: every arch trains and prefills; a causal
    one also decodes, and a subquadratic one decodes at 500k too (an
    encoder-only arch has no autoregressive step)."""
    cfg = get(name)
    cells = ["train_4k", "prefill_32k"]
    if cfg.causal:
        cells.append("decode_32k")
        if cfg.subquadratic:
            cells.append("long_500k")
    return tuple(cells)
