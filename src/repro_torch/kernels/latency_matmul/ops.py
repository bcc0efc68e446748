"""Public wrapper of the latency-tuned matmul, dispatched by device.

``MMConfig(bm, bn, bk)`` keeps the reference's name and fields. On a CUDA
tensor it names the thread-block tile the CUDA kernel is instantiated for:
a block owns a ``bm × bn`` output tile and stages ``bk`` of the contraction
per shared-memory step. :data:`CANDIDATES` is the card's candidate set (one
instantiation each) and :data:`WORST_CASE` its smallest member, the JEDEC
analogue that fits any ``sm_90a`` launch with room to spare; a config that
is not instantiated raises ``ValueError`` on a CUDA tensor. The reference's
TPU tilings (e.g. ``MMConfig(256, 256, 256)``) cannot exist as one block on
an SM; :mod:`repro_torch.core.altune.costmodel` refuses them. On a CPU
tensor the plain version runs and padding never changes the result, so any
positive config is accepted.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.latency_matmul import kernel
from repro_torch.kernels.latency_matmul.ref import matmul_plain

THREADS = 256


@dataclasses.dataclass(frozen=True)
class MMConfig:
    bm: int = 64
    bn: int = 64
    bk: int = 16

    def threads(self) -> int:
        return THREADS

    def smem_bytes(self) -> int:
        """Shared memory the kernel allocates for this tile: two float32
        stages of the x and y slices."""
        return 2 * 4 * (self.bm * self.bk + self.bk * self.bn)

    def registers(self) -> int:
        """A thread's registers for the tile's data, a lower bound: its
        accumulators, its fragments of a k step, its staged next slice."""
        return (self.bm * self.bn + self.bm * self.bk + self.bk * self.bn) // THREADS \
            + (self.bm + self.bn) // 16


#: The card's candidate tiles, one CUDA instantiation each (``kernel.TILES``).
CANDIDATES = tuple(MMConfig(*t) for t in kernel.TILES)
WORST_CASE = CANDIDATES[0]


def matmul(x: torch.Tensor, y: torch.Tensor, config: MMConfig = WORST_CASE) -> torch.Tensor:
    """(m, k) @ (k, n) with a float32 accumulator, in x's dtype; ragged
    shapes are masked in place."""
    if min(config.bm, config.bn, config.bk) <= 0:
        raise ValueError(f"block sizes must be positive, got {config}")
    if x.device.type == "cpu":
        return matmul_plain(x, y)
    return kernel.matmul_cuda(x, y, config.bm, config.bn, config.bk)
