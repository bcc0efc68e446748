"""AL-DRAM in PyTorch with hand-written CUDA kernels for Hopper (sm_90a).

A second package beside :mod:`repro` (the JAX reference, which this package
never imports). It mirrors the reference's layout — ``core/``,
``kernels/<name>/{ref,ops,kernel}.py``, ``launch/`` — and keeps its public
array layouts, so the tests feed both packages the same numpy inputs and
compare like with like.

Device contract: every entry point takes ``device=`` and defaults to
``"cuda"``. A CPU tensor runs the plain PyTorch version of each kernel; a
CUDA tensor launches the CUDA kernel (built from ``csrc/`` at first use)
or raises. Nothing falls back from the card to the CPU.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device a caller asked for; a CUDA request without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path"
        )
    return dev
