"""Error-feedback int8 gradient compression.

The port of ``src/repro/optim/compress.py``: each gradient leaf, plus the
quantization error carried from the last step, is quantized to int8 with a
per-tensor scale and dequantized; the new error is kept in bfloat16 as
part of the training state. ``torch.round`` rounds half to even, as
``jnp.round`` does.

:func:`compress_with_feedback` writes the dequantized gradients and the new
error into the trees it is given, leaf by leaf (the reference returns new
trees; in place, a step holds one leaf's temporaries, never a second
gradient tree).
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import torch

from repro_torch.core.charge import div
from repro_torch.tree import leaves, tree_map


def init_error_state(params) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.bfloat16, device=p.device),
                    params)


def _scale(amax: torch.Tensor) -> torch.Tensor:
    return div(torch.clamp_min(amax, 1e-12), 127.0)


def _quantize(g32: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)


def quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8. Returns (q, scale)."""
    g32 = g.to(torch.float32)
    scale = _scale(torch.amax(torch.abs(g32)))
    return _quantize(g32, scale), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_with_feedback(grads, err_state,
                           groups: Optional[Sequence[Sequence[int]]] = None) -> Tuple[Any, Any]:
    """Apply error feedback, quantize and dequantize each leaf: the
    gradients become what the int8 form carries, the error state what it
    lost. Both trees are written in place and returned.

    ``groups``: lists of leaf indices (in ``leaves`` order) quantized with
    one scale, the largest magnitude over all of them — the leaves that
    the reference holds as one tensor (the layers it stacks into a scanned
    group); default each leaf alone."""
    gs, es = list(leaves(grads)), list(leaves(err_state))
    with torch.no_grad():
        for group in groups if groups is not None else [[i] for i in range(len(gs))]:
            corr = [gs[i].to(torch.float32) + es[i].to(torch.float32) for i in group]
            scale = _scale(torch.stack([torch.amax(torch.abs(c)) for c in corr]).amax())
            for i, c in zip(group, corr):
                deq = dequantize(_quantize(c, scale), scale)
                es[i].copy_(c - deq)
                gs[i].copy_(deq)
    return grads, err_state
