"""Plain PyTorch version of the RG-LRU scan: h_t = a_t·h_{t−1} + b_t.

The counterpart of the reference's oracle (``src/repro/kernels/rglru_scan/ref.py``)
and of the float32-carry semantics its Pallas kernel implements: the state
is carried in float32 across the whole sequence, ``a_t * h`` and ``+ b_t``
round separately (two torch ops), and each step's state is written in a's
dtype. With float32 operands this is the reference's ``ref.rglru_scan``
bit for bit; with bfloat16 operands the reference's oracle carries the
state in bfloat16 and this one does not.
"""

import torch


def rglru_scan_plain(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """a, b: (B, S, D); h0: (B, D). Returns h: (B, S, D) in a.dtype."""
    out = torch.empty(a.shape, dtype=a.dtype, device=a.device)
    h = h0.float()
    for t in range(a.shape[1]):
        h = a[:, t].float() * h + b[:, t].float()
        out[:, t] = h
    return out
