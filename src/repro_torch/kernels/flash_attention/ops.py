"""Public wrapper for flash attention, dispatched by the tensors' device.

:func:`flash_attention` takes the reference's layout, ``q (B, Sq, H, dh)``
and ``k``/``v (B, Skv, Hk, dh)``: a CPU tensor runs the plain version
(:func:`.ref.flash_attention_plain`), a CUDA tensor the CUDA kernel
(:func:`.kernel.flash_attention_cuda`), which raises if it cannot launch.

``FAConfig(bq, bk)`` keeps the reference's name and fields. On a CUDA
tensor it names the query × key tile the CUDA kernel is instantiated for at
q's head width: :func:`candidates` (``kernel.tiles(dh)``), the tiles whose
shared memory fits one block. :data:`CANDIDATES` are those of head widths
16 to 128 (64 × 64, 128 × 64 and 64 × 128; also dh 80's and 112's) and
:data:`WORST_CASE` their smallest, 64 × 64. :func:`worst_case` is the
smallest at a given width, the JEDEC analogue that fits every launch there:
64 × 64 up to dh 256, 32 × 64 at dh 320, where 64 × 64 would need 263,168
bytes of shared memory. A config not instantiated at q's width raises
``ValueError``. The kernel reads ragged lengths in place. On a CPU tensor
the plain version runs and, as in the reference, padding never changes the
result, so any positive config is accepted.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.flash_attention import kernel
from repro_torch.kernels.flash_attention.ref import flash_attention_plain

#: Scores of a tile each thread owns (``csrc/flash_attention.cu``'s
#: ``kScores``), and at head widths of 256 and more (``kScoresWide``), where
#: a thread's share of the output accumulator would not fit its registers.
SCORES_PER_THREAD = 32
SCORES_PER_THREAD_WIDE = 16


def scores_per_thread(dh: int) -> int:
    return SCORES_PER_THREAD_WIDE if dh >= 256 else SCORES_PER_THREAD


@dataclasses.dataclass(frozen=True)
class FAConfig:
    bq: int = 64
    bk: int = 64

    def threads(self, dh: int) -> int:
        return self.bq * self.bk // scores_per_thread(dh)

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


#: The card's candidate tiles at head widths up to 128, one CUDA
#: instantiation each (``kernel.TILES``); the JEDEC analogue is the
#: smallest, the first.
CANDIDATES = tuple(FAConfig(*t) for t in kernel.TILES)
WORST_CASE = CANDIDATES[0]


def candidates(dh: int) -> tuple:
    """The tiles instantiated at head width ``dh``, smallest first."""
    return tuple(FAConfig(*t) for t in kernel.tiles(dh))


def worst_case(dh: int) -> FAConfig:
    """The smallest tile instantiated at ``dh`` (:data:`WORST_CASE` at a
    width the kernel does not take: the CPU's plain version accepts any)."""
    return (candidates(dh) or CANDIDATES)[0]


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
