"""Flash attention: the CUDA kernel's wrapper and its plain PyTorch version.

:func:`flash_attention_cuda` launches ``csrc/flash_attention.cu`` on the
public (B, S, H, dh) layout, reading q, k and v through their strides (no
transpose or padding copy); :func:`flash_attention_plain`
(:mod:`.ref`) is the same function in torch ops. Both take float32
``q (B, Sq, H, dh)``, ``k``/``v (B, Skv, Hk, dh)`` with ``H % Hk == 0`` and
return a contiguous ``(B, Sq, H, dh)``.
"""

from __future__ import annotations

import ctypes
import functools

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import flash_attention_plain

__all__ = ["HEAD_DIMS", "TILES", "TILES_BY_DH", "attributes", "flash_attention_cuda",
           "flash_attention_plain", "tiles", "tolerance"]

#: Head widths the CUDA kernel is instantiated for.
HEAD_DIMS = (16, 32, 64, 80, 112, 128, 256, 320)
#: The (bq, bk) query × key tiles it is instantiated for at head widths up to
#: 128, in the order of ``ops.CANDIDATES``; the first is the smallest.
TILES = ((64, 64), (128, 64), (64, 128))
#: The tiles instantiated at each head width (``FA_INSTANCES`` in the
#: source), smallest first: those whose shared memory fits a block
#: (232,448 bytes). Up to dh 128 all of ``TILES`` fit (64 × 128, the
#: largest, needs 178,176 bytes at dh 112, 198,656 at 128); at dh 256 only 64 × 64 fits
#: (214,016 bytes); at dh 320 none of ``TILES`` does (64 × 64 needs
#: 263,168), so it has 32 × 64.
TILES_BY_DH = {16: TILES, 32: TILES, 64: TILES, 80: TILES, 112: TILES, 128: TILES,
               256: ((64, 64),), 320: ((32, 64),)}


def tiles(dh: int) -> Tuple[Tuple[int, int], ...]:
    """The tiles instantiated at head width ``dh`` (none for another width)."""
    return TILES_BY_DH.get(dh, ())


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    lib.flash_attention_launch.argtypes = (
        [ctypes.c_int32] * 2 + [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 3
        + [ctypes.c_int32] * 3 + [ctypes.c_int64] * 9
        + [ctypes.c_int32, ctypes.c_int32, ctypes.c_float, ctypes.c_void_p]
    )
    lib.flash_attention_launch.restype = ctypes.c_int
    return lib


def tolerance(plain: torch.Tensor) -> float:
    """How far the kernel may be from :func:`flash_attention_plain`'s
    ``plain`` result: ``1e-5 * max|plain| + 1e-6`` (float32 sums in another
    order than the plain version's matrix products)."""
    return 1e-5 * float(plain.abs().max()) + 1e-6


def _check(t: torch.Tensor, name: str, device: torch.device) -> None:
    if not t.is_cuda or t.device != device:
        raise ValueError(f"{name} must be a CUDA tensor on {device}, got {t.device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    if t.dim() != 4 or t.stride(3) != 1:
        raise ValueError(f"{name} must be (B, S, heads, dh) with dh contiguous")
    if any(s % 4 for s in t.stride()[:3]) or t.data_ptr() % 16:
        raise ValueError(f"{name}'s rows must be 16-byte aligned for the kernel's float4 loads")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: int = 0,
                         tile: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Launch ``csrc/flash_attention.cu``'s ``tile = (bq, bk)`` instantiation
    at q's head width (``None``: the smallest tile instantiated there) on
    PyTorch's current stream. A tile not instantiated at that width raises
    ``ValueError``. Counts its launches in ``flash_attention_cuda.launches``.

    The kernel has no backward pass (nor has the reference's Pallas kernel),
    and its output, made outside autograd, would have no gradient: while
    grad mode is on and q, k or v requires grad it raises ``RuntimeError``
    instead of returning a detached result."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention_cuda has no backward pass: under autograd its output would "
            "be cut off from q, k and v; run it under torch.no_grad(), or train with "
            "attn_impl='chunked'")
    b, sq, h, dh = q.shape
    if dh not in HEAD_DIMS:
        raise ValueError(f"the CUDA kernel takes dh in {HEAD_DIMS}, got {dh}")
    tile = tiles(dh)[0] if tile is None else tuple(tile)
    if tile not in tiles(dh):
        raise ValueError(f"tile {tile} is not instantiated at dh {dh}; the kernel has "
                         f"{tiles(dh)} there")
    skv, hk = k.shape[1], k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(t, name, q.device)
    if tuple(k.shape) != (b, skv, hk, dh) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k and v must be (B, Skv, Hk, dh) = {(b, skv, hk, dh)}, "
                         f"got {tuple(k.shape)} and {tuple(v.shape)}")
    if hk == 0 or h % hk:
        raise ValueError(f"heads {h} must be a multiple of KV heads {hk}")
    out = torch.empty((b, sq, h, dh), dtype=torch.float32, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_launch(
            *tile, _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
            b, sq, skv, h, hk, dh, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            int(causal), int(window), dh ** -0.5, _build.stream_ptr(q.device),
        )
    _build.check(lib, rc, "flash_attention_launch")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0


def attributes(dh: int, tile: Optional[Tuple[int, int]] = None) -> Dict[str, int]:
    """``cudaFuncGetAttributes`` of the ``(tile, dh)`` instantiation (see
    ``_build.attributes``; ``None``: the smallest tile at ``dh``)."""
    return _build.attributes(_lib(), "flash_attention_attributes",
                             *(tiles(dh)[0] if tile is None else tile), dh)
