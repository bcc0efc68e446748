"""Rotary position embeddings: full, half (ChatGLM 2d), M-RoPE (Qwen2-VL).

All functions take ``positions`` of shape (..., S) (or (3, ..., S) for
M-RoPE's temporal/height/width streams) and rotate the head dimension of
``x`` with shape (..., S, H, D). Computations in float32, cast back. The
float32 order of the reference's ``_angles`` is kept:
``1.0 / theta ** (arange / dim)``, each division rounded once.
"""

from __future__ import annotations

import torch

from repro_torch.core.charge import div
from repro_torch.models.config import ModelConfig


def _rot_half_pairs(x: torch.Tensor) -> torch.Tensor:
    """(…, 2k) → rotate pairs (x1, x2) → (−x2, x1), interleaved convention."""
    x1 = x[..., 0::2]
    x2 = x[..., 1::2]
    return torch.stack([-x2, x1], dim=-1).reshape(x.shape)


def _scalar(x: float, device) -> torch.Tensor:
    """A 0-d float32 tensor made on ``device`` by a fill (a host-to-device
    copy of a Python scalar would wait for the device)."""
    return torch.full((), x, dtype=torch.float32, device=device)


def _angles(positions: torch.Tensor, dim: int, theta: float) -> torch.Tensor:
    """(…, S) → (…, S, dim/2) rotation angles."""
    dev = positions.device
    exponent = div(torch.arange(0, dim, 2, dtype=torch.float32, device=dev),
                   _scalar(float(dim), dev))
    inv_freq = div(1.0, torch.pow(_scalar(theta, dev), exponent))
    return positions.to(torch.float32)[..., None] * inv_freq


def _apply(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """Rotate (…, S, H, D) by per-(…, S) angles (…, S, D/2)."""
    cos = torch.repeat_interleave(torch.cos(ang), 2, dim=-1)[..., None, :]  # (…,S,1,D)
    sin = torch.repeat_interleave(torch.sin(ang), 2, dim=-1)[..., None, :]
    xf = x.to(torch.float32)
    return (xf * cos + _rot_half_pairs(xf) * sin).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig,
               theta: float | None = None) -> torch.Tensor:
    """Dispatch on cfg.rope_variant. x: (B, S, H, D); positions: (B, S) or
    (3, B, S) for mrope."""
    variant = cfg.rope_variant
    th = float(theta if theta is not None else cfg.rope_theta)
    d = x.shape[-1]
    if variant == "none":
        return x
    if variant == "full":
        return _apply(x, _angles(positions, d, th))
    if variant == "half":
        # ChatGLM 2d RoPE: rotate only the first half of the head dim.
        dh = d // 2
        rotated = _apply(x[..., :dh], _angles(positions, dh, th))
        return torch.cat([rotated, x[..., dh:]], dim=-1)
    if variant == "mrope":
        # M-RoPE: the D/2 frequency pairs are split into three sections
        # rotated by temporal / height / width position streams.
        if positions.dim() != x.dim() - 1:
            raise ValueError("mrope needs (3, B, S) positions")
        sec = cfg.mrope_sections
        if sum(sec) != d // 2:
            raise ValueError(f"mrope sections {sec} do not cover d_head {d}")
        pieces, start = [], 0
        for i, s in enumerate(sec):
            pieces.append(_angles(positions[i], d, th)[..., start:start + s])
            start += s
        return _apply(x, torch.cat(pieces, dim=-1))
    raise ValueError(f"unknown rope variant {variant!r}")


def default_positions(cfg: ModelConfig, batch: int, seq: int, offset: int = 0,
                      device=None) -> torch.Tensor:
    """Integer position stream(s) for text input: (B, S) or (3, B, S)."""
    pos = torch.arange(seq, dtype=torch.int32, device=device)[None, :] + offset
    pos = pos.expand(batch, seq)
    if cfg.rope_variant == "mrope":
        return pos[None].expand(3, batch, seq)
    return pos
