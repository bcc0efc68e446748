"""Public wrapper for flash attention, dispatched by the tensors' device.

:func:`flash_attention` takes the reference's layout, ``q (B, Sq, H, dh)``
and ``k``/``v (B, Skv, Hk, dh)``: a CPU tensor runs the plain version
(:func:`.ref.flash_attention_plain`), a CUDA tensor the CUDA kernel
(:func:`.kernel.flash_attention_cuda`), which raises if it cannot launch.

``FAConfig`` keeps the reference's meaning: a block configuration whose
padding never changes the result (pads are masked), with ``WORST_CASE`` the
one that always fits. The CUDA kernel reads ragged lengths in place and
tiles 64 × 64 whatever the config; what a TPU tiling candidate ``(bq, bk)``
should mean on Hopper is decided with the altune port (ROADMAP queue 2).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import flash_attention_plain


@dataclasses.dataclass(frozen=True)
class FAConfig:
    bq: int = 128
    bk: int = 128


#: The JEDEC analogue: the conservative block configuration.
WORST_CASE = FAConfig(bq=128, bk=128)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    config: FAConfig = WORST_CASE) -> torch.Tensor:
    """q: (B, Sq, H, dh); k/v: (B, Skv, Hk, dh). Returns (B, Sq, H, dh)."""
    if config.bq <= 0 or config.bk <= 0:
        raise ValueError(f"block sizes must be positive, got {config}")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    return flash_attention_cuda(q, k, v, causal=causal, window=window)
