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
        return dh

    def smem_bytes(self, dh: int) -> int:
        """Shared memory of the split pass: a 32-row K sub-tile (rows padded
        by 4 floats) and V sub-tile, the group's queries, scores and softmax
        state, in float32, whatever ``bk``."""
        t, g = kernel.SUB_TILE, kernel.MAX_GROUP
        return 4 * (t * (dh + 4) + t * dh + g * dh + g * t + 3 * g)

    def registers(self, dh: int) -> int:
        """A thread's registers for its data, a lower bound: one output
        column of every head of the group, and a float4 of q and of k."""
        return kernel.MAX_GROUP + 8


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
