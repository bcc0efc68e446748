"""Public wrapper of flash decode, dispatched by device.

``FDConfig(bk)`` keeps the reference's name and field. On a CUDA tensor it
names the tile the CUDA kernel is instantiated for: ``bk`` KV rows a split
(split-K: one block per (batch, KV head, split), then a combine).
:data:`CANDIDATES` is the card's set (one instantiation each) and
:data:`WORST_CASE` its smallest member; a config that is not instantiated
raises ``ValueError`` on a CUDA tensor. The kernel reads GQA KV by group
through strides and masks by ``length`` in place, where the reference
repeats heads, transposes and pads. On a CPU tensor the plain version runs
and any positive config is accepted.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.flash_decode import kernel
from repro_torch.kernels.flash_decode.ref import flash_decode_plain


@dataclasses.dataclass(frozen=True)
class FDConfig:
    bk: int = 256

    @property
    def bq(self) -> int:
        """One query row a head: the cost model reads decode as attention
        with a query tile of 1."""
        return 1

    def threads(self, dh: int) -> int:
        return kernel.THREADS

    def smem_bytes(self, dh: int, itemsize: int = 4) -> int:
        """Shared memory of the split pass, whatever ``bk``: each warp's ring
        of ``STAGES`` steps of ``ROWS`` K and V rows in the operands' dtype
        (``itemsize`` bytes), reused at the end for the warps' float32
        accumulators of every head; each warp's p and rescale; the warps'
        (m, l)."""
        w, g, r = kernel.WARPS, kernel.MAX_GROUP, kernel.ROWS
        ring = w * kernel.STAGES * 2 * r * dh * itemsize
        return max(ring, w * g * dh * 4) + 4 * w * (r * g + g) + 4 * w * 2 * g

    def registers(self, dh: int) -> int:
        """A thread's registers for its data, a lower bound: its 4 columns
        of every head's query and accumulator, its partial scores (``ROWS``
        rows a warp, 128 / dh of them a lane's), and a float4 of K."""
        g = kernel.MAX_GROUP
        return 2 * g * 4 + kernel.ROWS * g * dh // 128 + 4


#: The card's candidate tiles, one CUDA instantiation each (``kernel.TILES``).
CANDIDATES = tuple(FDConfig(bk) for bk in kernel.TILES)
WORST_CASE = CANDIDATES[0]


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, length,
                 config: FDConfig = WORST_CASE) -> torch.Tensor:
    """q: (B, H, dh); k/v cache: (B, L, Hk, dh); ``length``: valid rows (an
    int or a 0-d tensor). Returns (B, H, dh) in q's dtype."""
    if config.bk <= 0:
        raise ValueError(f"block size must be positive, got {config}")
    length = int(length)
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, length)
    return kernel.flash_decode_cuda(q, k, v, length, config.bk)
