"""Plain PyTorch version of the latency-tuned matmul.

The counterpart of the reference's oracle (``src/repro/kernels/latency_matmul/ref.py``):
``(m, k) @ (k, n)`` with a float32 accumulator, the result in x's dtype.
It is what a CPU tensor runs, and what the CUDA kernel is held against; it
is a plain version because the kernel beside it is written by hand.
"""

import torch


def matmul_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(m, k) @ (k, n) in float32, cast to x.dtype."""
    return torch.matmul(x.float(), y.float()).to(x.dtype)
