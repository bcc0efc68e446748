"""Flash decode: the CUDA kernel's wrapper and its plain version.

:func:`flash_decode_cuda` launches ``csrc/flash_decode.cu`` (a split-K pass
and a combine pass, one call) for one of the instantiated tiles
(:data:`TILES`) on float32 or bfloat16 operands, reading the (B, L, Hk, dh)
cache through its strides (rows on 4-element boundaries: 16-byte copies
where every row is 16-byte aligned, 8-byte copies for other bfloat16 rows);
:func:`flash_decode_plain` (:mod:`.ref`) is the same function in torch ops.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_decode.ref import flash_decode_plain

__all__ = ["HEAD_DIMS", "MAX_GROUP", "TILES", "attributes", "flash_decode_cuda",
           "flash_decode_plain", "n_splits", "tolerance"]

#: The ``bk`` (KV rows a split) the CUDA kernel is instantiated for
#: (``FD_TILES`` in the source), in the order of ``ops.CANDIDATES``.
TILES: Tuple[int, ...] = (256, 512, 1024, 2048, 4096)
#: Head widths the kernel is built for, and the most query heads a KV head.
HEAD_DIMS = (64, 128)
MAX_GROUP = 8
#: The split pass's block (``kWarps`` warps, each its own pipeline), the
#: cache rows a warp step (``kRows``) and a warp's ring depth (``kStages``),
#: as in the source.
WARPS, THREADS, ROWS, STAGES = 4, 128, 4, 4


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_decode")
    lib.flash_decode_launch.argtypes = (
        [ctypes.c_int32] * 3 + [ctypes.c_void_p] * 6 + [ctypes.c_int64]
        + [ctypes.c_int32] * 2 + [ctypes.c_int64, ctypes.c_int32] + [ctypes.c_int64] * 8
        + [ctypes.c_float, ctypes.c_void_p])
    lib.flash_decode_launch.restype = ctypes.c_int
    return lib


def tolerance(plain: torch.Tensor) -> float:
    """How far the kernel may be from :func:`flash_decode_plain`'s result
    ``plain``: ``1e-5 * max|plain| + 1e-6`` in float32 (the splits sum in
    another order than the plain version's products), plus one bfloat16
    rounding step at the largest magnitude, ``2**-7 * max|plain|``, for
    bfloat16 results."""
    top = float(plain.float().abs().max()) if plain.numel() else 0.0
    tol = 1e-5 * top + 1e-6
    if plain.dtype == torch.bfloat16:
        tol += 2.0 ** -7 * top
    return tol


def n_splits(length: int, cache_rows: int, bk: int) -> int:
    """Splits launched: those that hold valid rows, at least one."""
    return max(1, -(-min(length, cache_rows) // bk))


def _check(t: torch.Tensor, name: str, device: torch.device, dtype: torch.dtype,
           dim: int) -> None:
    if not t.is_cuda or t.device != device:
        raise ValueError(f"{name} must be a CUDA tensor on {device}, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != dim or t.stride(-1) != 1:
        raise ValueError(f"{name} must be {dim}-D with a contiguous last dim")


def flash_decode_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, length: int,
                      bk: int) -> torch.Tensor:
    """Launch ``csrc/flash_decode.cu``'s ``bk`` instantiation on PyTorch's
    current stream. Counts its calls in ``flash_decode_cuda.launches``."""
    if bk not in TILES:
        raise ValueError(f"tile bk={bk} is not instantiated; the kernel has {TILES}")
    code = _build.dtype_code(q, "q")
    _check(q, "q", q.device, q.dtype, 3)
    _check(k, "k", q.device, q.dtype, 4)
    _check(v, "v", q.device, q.dtype, 4)
    b, h, dh = q.shape
    n, hk = k.shape[1], k.shape[2]
    if tuple(k.shape) != (b, n, hk, dh) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k and v must be (B, L, Hk, dh) = {(b, n, hk, dh)}, got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"the CUDA kernel takes dh in {HEAD_DIMS}, got {dh}")
    if hk == 0 or h % hk or h // hk > MAX_GROUP:
        raise ValueError(f"heads {h} must be 1 to {MAX_GROUP} times the KV heads {hk}")
    for name, t in (("k", k), ("v", v)):
        if any(st % 4 for st in t.stride()[:3]) or t.data_ptr() % (4 * t.element_size()):
            raise ValueError(f"{name}'s rows must start on 4-element boundaries for the "
                             "kernel's vector loads")
    length = max(0, min(int(length), n))
    splits = n_splits(length, n, bk)
    part_ml = torch.empty((b * h * splits, 2), dtype=torch.float32, device=q.device)
    part_acc = torch.empty((b * h * splits, dh), dtype=torch.float32, device=q.device)
    out = torch.empty((b, h, dh), dtype=q.dtype, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        rc = lib.flash_decode_launch(
            bk, dh, code, _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(part_ml),
            _build.ptr(part_acc), _build.ptr(out), b, hk, h // hk, length, splits,
            *q.stride()[:2], *k.stride()[:3], *v.stride()[:3], dh ** -0.5,
            _build.stream_ptr(q.device))
    _build.check(lib, rc, "flash_decode_launch")
    flash_decode_cuda.launches += 1
    return out


flash_decode_cuda.launches = 0


def attributes(bk: int, dh: int, dtype: torch.dtype) -> Dict[str, int]:
    """``cudaFuncGetAttributes`` of one split-pass instantiation (see
    ``_build.attributes``)."""
    return _build.attributes(_lib(), "flash_decode_attributes", bk, dh,
                             _build.DTYPE_CODES[dtype])
