"""Latency-tuned matmul: the CUDA kernel's wrapper and its plain version.

:func:`matmul_cuda` launches ``csrc/latency_matmul.cu`` for one of the
instantiated tiles (:data:`TILES`) on float32 or bfloat16 operands with
contiguous rows, ragged shapes masked in place (rows that are not 16-byte
aligned, and bfloat16, take the kernel's register path instead of
cp.async); :func:`matmul_plain` (:mod:`.ref`) is the same function in
torch ops.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.latency_matmul.ref import matmul_plain

__all__ = ["TILES", "attributes", "matmul_cuda", "matmul_plain", "tolerance"]

#: The (bm, bn, bk) tiles the CUDA kernel is instantiated for (``MM_TILES``
#: in the source), in the order of ``ops.CANDIDATES``.
TILES: Tuple[Tuple[int, int, int], ...] = (
    (64, 64, 16), (128, 64, 16), (64, 128, 16), (128, 128, 8), (128, 128, 16),
    (128, 128, 32), (128, 256, 16))


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("latency_matmul")
    lib.latency_matmul_launch.argtypes = (
        [ctypes.c_int32] * 4 + [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 5
        + [ctypes.c_void_p])
    lib.latency_matmul_launch.restype = ctypes.c_int
    return lib


def tolerance(plain: torch.Tensor) -> float:
    """How far the kernel may be from :func:`matmul_plain`'s result ``plain``:
    ``1e-5 * max|plain| + 1e-6`` in float32 (the same float32 products summed
    in another order), plus one bfloat16 rounding step at the largest
    magnitude, ``2**-7 * max|plain|``, for bfloat16 results (two float32 sums
    an ulp apart may round to neighbouring bfloat16 values)."""
    top = float(plain.float().abs().max()) if plain.numel() else 0.0
    tol = 1e-5 * top + 1e-6
    if plain.dtype == torch.bfloat16:
        tol += 2.0 ** -7 * top
    return tol


def _check(t: torch.Tensor, name: str, device: torch.device) -> None:
    if not t.is_cuda or t.device != device:
        raise ValueError(f"{name} must be a CUDA tensor on {device}, got {t.device}")
    if t.dim() != 2 or (t.shape[1] > 1 and t.stride(1) != 1):
        raise ValueError(f"{name} must be 2-D with contiguous rows")


def matmul_cuda(x: torch.Tensor, y: torch.Tensor, bm: int, bn: int, bk: int) -> torch.Tensor:
    """Launch ``csrc/latency_matmul.cu``'s ``(bm, bn, bk)`` instantiation on
    PyTorch's current stream. Counts its launches in ``matmul_cuda.launches``."""
    if (bm, bn, bk) not in TILES:
        raise ValueError(f"tile {(bm, bn, bk)} is not instantiated; the kernel has {TILES}")
    _check(x, "x", x.device)
    _check(y, "y", x.device)
    m, k = x.shape
    if y.shape[0] != k:
        raise ValueError(f"x is {tuple(x.shape)} but y is {tuple(y.shape)}")
    if y.dtype != x.dtype:
        raise ValueError(f"x and y must share a dtype, got {x.dtype} and {y.dtype}")
    code = _build.dtype_code(x, "x")
    n = y.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        rc = lib.latency_matmul_launch(bm, bn, bk, code, _build.ptr(x), _build.ptr(y),
                                       _build.ptr(out), m, n, k, max(x.stride(0), 1),
                                       max(y.stride(0), 1), _build.stream_ptr(x.device))
    _build.check(lib, rc, "latency_matmul_launch")
    matmul_cuda.launches += 1
    return out


matmul_cuda.launches = 0


def attributes(tile: Tuple[int, int, int], dtype: torch.dtype,
               aligned: bool = True) -> Dict[str, int]:
    """``cudaFuncGetAttributes`` of one instantiation (see ``_build.attributes``):
    for float32, the cp.async build that operands with 16-byte aligned rows
    take, or with ``aligned=False`` the register-path build that other rows
    take (bfloat16 always takes the register path)."""
    return _build.attributes(_lib(), "latency_matmul_attributes", *tile,
                             _build.DTYPE_CODES[dtype], int(aligned))
