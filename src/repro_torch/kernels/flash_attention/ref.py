"""Plain PyTorch versions of flash attention, on the public (B, S, H, dh) layout.

* :func:`naive_attention` is the counterpart of the reference's O(S²) oracle
  (``src/repro/kernels/flash_attention/ref.py``): softmax over the masked
  scores, which spreads a fully masked row evenly over its keys.
* :func:`flash_attention_plain` computes what the Pallas kernel and the CUDA
  kernel compute, in one KV tile: the same masks (causal, window, and keys
  past the end), the same float32 scale, ``p = exp(s - m)`` only where the
  score is not masked, and ``out = acc / max(l, 1e-30)``, so a fully masked
  row gives 0. It has the CUDA kernel wrapper's signature and is what a CPU
  tensor runs.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def repeat_kv(x: torch.Tensor, g: int) -> torch.Tensor:
    """(B, S, Hk, dh) → (B, S, Hk·g, dh): query head h reads KV head h // g."""
    return x.repeat_interleave(g, dim=2) if g > 1 else x


def _mask(sq: int, skv: int, causal: bool, window: int, device,
          q_offset: int = 0) -> torch.Tensor:
    q_pos = torch.arange(sq, device=device) + q_offset
    k_pos = torch.arange(skv, device=device)
    dpos = q_pos[:, None] - k_pos[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        mask &= dpos >= 0
    if window > 0:
        mask &= dpos < window
    return mask


def naive_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    q_offset: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, dh); k/v: (B, Skv, Hk, dh), H = G·Hk. float32 softmax.
    Returns (B, Sq, H, dh) in q's dtype."""
    b, sq, h, dh = q.shape
    skv, hk = k.shape[1], k.shape[2]
    g = h // hk
    kf, vf = repeat_kv(k, g).float(), repeat_kv(v, g).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * (dh ** -0.5)
    s = torch.where(_mask(sq, skv, causal, window, q.device, q_offset), s, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    return torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, window: int = 0) -> torch.Tensor:
    """The flash-attention kernel's function in torch ops on any device.

    q: (B, Sq, H, dh); k/v: (B, Skv, Hk, dh), H = G·Hk. Returns a contiguous
    (B, Sq, H, dh) in q's dtype. The score tile is built in place (one
    (B, H, Sq, Skv) float32 buffer and a mask of the same shape)."""
    b, sq, h, dh = q.shape
    skv, hk = k.shape[1], k.shape[2]
    g = h // hk
    kf, vf = repeat_kv(k, g).float(), repeat_kv(v, g).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf).mul_(dh ** -0.5)
    s.masked_fill_(~_mask(sq, skv, causal, window, q.device), NEG_INF)
    m = s.amax(-1, keepdim=True)
    keep = s > 0.5 * NEG_INF
    p = s.sub_(m).exp_().mul_(keep)
    del keep
    l = p.sum(-1, keepdim=True)
    acc = torch.einsum("bhqk,bkhd->bhqd", p, vf)
    out = acc / torch.clamp_min(l, 1e-30)
    return out.transpose(1, 2).contiguous().to(q.dtype)
