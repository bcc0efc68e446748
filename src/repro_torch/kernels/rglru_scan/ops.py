"""Public wrapper of the RG-LRU scan, dispatched by device.

``ScanConfig(bd, bs)`` keeps the reference's name and fields. On a CUDA
tensor it names the tile the CUDA kernel is instantiated for: ``bd``
channels (threads) a block, and ``bs`` time steps whose ``a``/``b`` loads a
thread issues ahead of the dependent arithmetic — the memory-level
parallelism knob, since the recurrence leaves only B·D threads.
:data:`CANDIDATES` is the card's set (one instantiation each) and
:data:`WORST_CASE` its smallest member; a config that is not instantiated
raises ``ValueError`` on a CUDA tensor. The kernel masks ragged S and D in
place; the reference pads instead (``a = 1``, ``b = 0``, ``h0 = 0``), which
leaves every real element unchanged. On a CPU tensor the plain version
runs and any positive config is accepted.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.rglru_scan import kernel
from repro_torch.kernels.rglru_scan.ref import rglru_scan_plain


@dataclasses.dataclass(frozen=True)
class ScanConfig:
    bd: int = 64
    bs: int = 4

    def threads(self) -> int:
        return self.bd

    def smem_bytes(self) -> int:
        """The kernel keeps everything in registers."""
        return 0

    def registers(self) -> int:
        """A thread's registers for its data, a lower bound: ``bs`` steps of
        ``a`` and ``b`` in flight and the float32 state."""
        return 2 * self.bs + 1


#: The card's candidate tiles, one CUDA instantiation each (``kernel.TILES``).
CANDIDATES = tuple(ScanConfig(*t) for t in kernel.TILES)
WORST_CASE = CANDIDATES[0]


def rglru_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor,
               config: ScanConfig = WORST_CASE) -> torch.Tensor:
    """a, b: (B, S, D); h0: (B, D). Returns h: (B, S, D) in a.dtype."""
    if config.bd <= 0 or config.bs <= 0:
        raise ValueError(f"block sizes must be positive, got {config}")
    if a.device.type == "cpu":
        return rglru_scan_plain(a, b, h0)
    return kernel.rglru_scan_cuda(a, b, h0, config.bd, config.bs)
