"""Plain PyTorch versions of single-token decode attention over a KV cache.

* :func:`decode_attention` is the counterpart of the reference's oracle
  (``src/repro/kernels/flash_decode/ref.py``): KV already head-repeated,
  softmax over the valid rows, so an empty cache spreads evenly.
* :func:`flash_decode_plain` is the function the Pallas kernel and the CUDA
  kernel compute: GQA KV read by group without a repeat (query head h reads
  KV head h // G), rows at or past ``length`` masked, ``p = 0`` where
  masked, and ``acc / max(l, 1e-30)``, so an empty cache gives 0. It is
  what a CPU tensor runs and what the CUDA kernel is held against.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.ref import NEG_INF, repeat_kv  # noqa: F401


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, length) -> torch.Tensor:
    """q: (B, H, dh); k/v: (B, L, H, dh) (KV already head-repeated);
    ``length``: number of valid cache rows (≤ L). Returns (B, H, dh)."""
    s = torch.einsum("bhd,blhd->bhl", q.float(), k.float()) * (q.shape[-1] ** -0.5)
    idx = torch.arange(k.shape[1], device=q.device)
    s = torch.where((idx < length)[None, None, :], s, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    return torch.einsum("bhl,blhd->bhd", p, v.float()).to(q.dtype)


def flash_decode_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       length: int) -> torch.Tensor:
    """The flash-decode kernel's function in torch ops on any device.

    q: (B, H, dh); k/v: (B, L, Hk, dh), H = G·Hk; ``length``: valid rows.
    Returns a contiguous (B, H, dh) in q's dtype."""
    b, h, dh = q.shape
    n, hk = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, hk, h // hk, dh)
    s = torch.einsum("bkgd,blkd->bkgl", qg, k.float()) * (dh ** -0.5)
    s = s.masked_fill(torch.arange(n, device=q.device) >= length, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(s > 0.5 * NEG_INF, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    acc = torch.einsum("bkgl,blkd->bkgd", p, v.float())
    return (acc / torch.clamp_min(l, 1e-30)).reshape(b, h, dh).to(q.dtype)
