"""Public wrapper for flash attention, dispatched by the tensors' device.

:func:`flash_attention` takes the reference's layout, ``q (B, Sq, H, dh)``
and ``k``/``v (B, Skv, Hk, dh)``: a CPU tensor runs the plain version
(:func:`.ref.flash_attention_plain`), a CUDA tensor the CUDA kernel
(:func:`.kernel.flash_attention_cuda`), which raises if it cannot launch.

``FAConfig(bq, bk)`` keeps the reference's name and fields. On a CUDA
tensor it names the query × key tile the CUDA kernel is instantiated for;
the kernel has one, 64 × 64 (:data:`CANDIDATES`, ``kernel.TILES``), which is
also :data:`WORST_CASE`, and any other config raises ``ValueError``. The
kernel reads ragged lengths in place. On a CPU tensor the plain version
runs and, as in the reference, padding never changes the result, so any
positive config is accepted.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.flash_attention import kernel
from repro_torch.kernels.flash_attention.ref import flash_attention_plain

THREADS = 256


@dataclasses.dataclass(frozen=True)
class FAConfig:
    bq: int = 64
    bk: int = 64

    def threads(self, dh: int) -> int:
        return THREADS

    def smem_bytes(self, dh: int) -> int:
        """Shared memory the kernel allocates for this tile: the Q, K and V
        tiles and the P tile, in float32."""
        return 4 * ((self.bq + 2 * self.bk) * dh + self.bq * self.bk)

    def registers(self, dh: int) -> int:
        """A thread's registers for the tile's data, a lower bound: its
        share of the output accumulator and of the score tile."""
        return (self.bq * dh + self.bq * self.bk) // THREADS


#: The card's candidate tiles, one CUDA instantiation each (``kernel.TILES``);
#: the JEDEC analogue is the one there is.
CANDIDATES = tuple(FAConfig(*t) for t in kernel.TILES)
WORST_CASE = CANDIDATES[0]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    config: FAConfig = WORST_CASE) -> torch.Tensor:
    """q: (B, Sq, H, dh); k/v: (B, Skv, Hk, dh). Returns (B, Sq, H, dh)."""
    if config.bq <= 0 or config.bk <= 0:
        raise ValueError(f"block sizes must be positive, got {config}")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if (config.bq, config.bk) not in kernel.TILES:
        raise ValueError(f"tile {(config.bq, config.bk)} is not instantiated; the kernel "
                         f"has {kernel.TILES}")
    return kernel.flash_attention_cuda(q, k, v, causal=causal, window=window)
