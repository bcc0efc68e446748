"""Public wrapper for flash attention, dispatched by the tensors' device.

:func:`flash_attention` takes the reference's layout, ``q (B, Sq, H, dh)``
and ``k``/``v (B, Skv, Hk, dh)``: a CPU tensor runs the plain version
(:func:`.ref.flash_attention_plain`), a CUDA tensor the CUDA kernel
(:func:`.kernel.flash_attention_cuda`), which raises if it cannot launch.

``FAConfig(bq, bk)`` keeps the reference's name and fields. On a CUDA
tensor it names the query × key tile the CUDA kernel is instantiated for:
:data:`CANDIDATES` (``kernel.TILES``) are 64 × 64, 128 × 64 and 64 × 128,
:data:`WORST_CASE` the smallest, 64 × 64, the JEDEC analogue that fits any
``sm_90a`` launch; any other config raises ``ValueError``. The kernel reads
ragged lengths in place. On a CPU tensor the plain version
runs and, as in the reference, padding never changes the result, so any
positive config is accepted.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.flash_attention import kernel
from repro_torch.kernels.flash_attention.ref import flash_attention_plain

#: Scores of a tile each thread owns (``csrc/flash_attention.cu``).
SCORES_PER_THREAD = 32


@dataclasses.dataclass(frozen=True)
class FAConfig:
    bq: int = 64
    bk: int = 64

    def threads(self, dh: int) -> int:
        return self.bq * self.bk // SCORES_PER_THREAD

    def smem_bytes(self, dh: int) -> int:
        """Shared memory the kernel allocates for this tile, all of it
        dynamic: the Q tile, one K and one V tile (single buffers, their
        copies staggered; a K row padded by 16 bytes) and the P tile, in
        float32."""
        return 4 * ((self.bq + 2 * self.bk) * dh + self.bq * self.bk) + 16 * self.bk

    def registers(self, dh: int) -> int:
        """A thread's registers for the tile's data, a lower bound: its
        share of the output accumulator and of the score tile."""
        return (self.bq * dh + self.bq * self.bk) // self.threads(dh)


#: The card's candidate tiles, one CUDA instantiation each (``kernel.TILES``);
#: the JEDEC analogue is the smallest, the first.
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
    return kernel.flash_attention_cuda(q, k, v, causal=causal, window=window,
                                       tile=(config.bq, config.bk))
