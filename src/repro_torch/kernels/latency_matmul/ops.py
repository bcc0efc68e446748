"""Public wrapper of the latency-tuned matmul, dispatched by device.

``MMConfig(bm, bn, bk)`` keeps the reference's name and fields. On a CUDA
tensor it names the thread-block tile the CUDA kernel is instantiated for:
a block owns a ``bm × bn`` output tile, a thread 8 × 8 or 8 × 16 of it
(:meth:`MMConfig.thread_cols`), and stages ``bk`` of the contraction per
slot of a shared-memory ring. :data:`CANDIDATES` is the card's candidate
set (one instantiation each) and :data:`WORST_CASE` its smallest member,
the JEDEC analogue that fits any ``sm_90a`` launch with room to spare; a
config that is not instantiated raises ``ValueError`` on a CUDA tensor. The
reference's TPU tilings (e.g. ``MMConfig(256, 256, 256)``) cannot exist as
one block on an SM; :mod:`repro_torch.core.altune.costmodel` refuses them.
On a CPU tensor the plain version runs and padding never changes the
result, so any positive config is accepted.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.latency_matmul import kernel
from repro_torch.kernels.latency_matmul.ref import matmul_plain

#: Slices the ring holds at most, floats of padding after a row of x's
#: slice, and the shared memory a block may take with two blocks on an SM
#: (``csrc/latency_matmul.cu``).
MAX_STAGES = 4
PAD_A = 4
TWO_BLOCK_SMEM = 115_712


@dataclasses.dataclass(frozen=True)
class MMConfig:
    bm: int = 64
    bn: int = 64
    bk: int = 16

    def thread_cols(self) -> int:
        """Output columns a thread owns beside its 8 rows: 16 at 128 × 128
        and above (warps of 64 × 64, as cuBLAS's float32 kernels run that
        tile), 8 below (warps of 64 × 32)."""
        return 16 if self.bm * self.bn >= 128 * 128 else 8

    def threads(self) -> int:
        return self.bm * self.bn // (8 * self.thread_cols())

    def stages(self) -> int:
        """Slices the ring holds: four, or as many (two at least) as leave
        room for two blocks an SM."""
        stage = 4 * (self.bm * (self.bk + PAD_A) + self.bk * self.bn)
        return min(MAX_STAGES, max(2, TWO_BLOCK_SMEM // stage))

    def smem_bytes(self) -> int:
        """Shared memory the kernel allocates for this tile, all of it
        dynamic: a ring of float32 slices of x (rows padded by ``PAD_A``) and
        y, in either dtype (bfloat16 is converted on its way in)."""
        return self.stages() * 4 * (self.bm * (self.bk + PAD_A) + self.bk * self.bn)

    def registers(self) -> int:
        """A thread's registers for the tile's data, a lower bound: its
        accumulators and one k step's operands (8 of x, ``thread_cols`` of
        y)."""
        return 9 * self.thread_cols() + 8


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
