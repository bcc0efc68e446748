"""RG-LRU scan: the CUDA kernel's wrapper and its plain version.

:func:`rglru_scan_cuda` launches ``csrc/rglru_scan.cu`` for one of the
instantiated tiles (:data:`TILES`) on contiguous float32 or bfloat16
operands, ragged S and D masked in place; :func:`rglru_scan_plain`
(:mod:`.ref`) is the same function in torch ops. The two agree bitwise.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rglru_scan.ref import rglru_scan_plain

__all__ = ["TILES", "attributes", "rglru_scan_cuda", "rglru_scan_plain"]

#: The (bd, bs) tiles the CUDA kernel is instantiated for (``SCAN_TILES`` in
#: the source), in the order of ``ops.CANDIDATES``.
TILES: Tuple[Tuple[int, int], ...] = ((64, 4), (64, 16), (128, 8), (128, 16), (128, 32),
                                      (256, 16))


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("rglru_scan")
    lib.rglru_scan_launch.argtypes = (
        [ctypes.c_int32] * 3 + [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 3
        + [ctypes.c_void_p])
    lib.rglru_scan_launch.restype = ctypes.c_int
    return lib


def rglru_scan_cuda(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor, bd: int,
                    bs: int) -> torch.Tensor:
    """Launch ``csrc/rglru_scan.cu``'s ``(bd, bs)`` instantiation on PyTorch's
    current stream. Counts its launches in ``rglru_scan_cuda.launches``."""
    if (bd, bs) not in TILES:
        raise ValueError(f"tile {(bd, bs)} is not instantiated; the kernel has {TILES}")
    if a.dim() != 3:
        raise ValueError(f"a must be (B, S, D), got {tuple(a.shape)}")
    bsz, s, d = a.shape
    code = _build.dtype_code(a, "a")
    _build.require(a, "a", a.dtype)
    if a.device != b.device or a.device != h0.device:
        raise ValueError("a, b and h0 must be on one device")
    _build.require(b, "b", a.dtype, a.shape)
    _build.require(h0, "h0", a.dtype, (bsz, d))
    out = torch.empty_like(a)
    lib = _lib()
    with torch.cuda.device(a.device):
        rc = lib.rglru_scan_launch(bd, bs, code, _build.ptr(a), _build.ptr(b), _build.ptr(h0),
                                   _build.ptr(out), bsz, s, d, _build.stream_ptr(a.device))
    _build.check(lib, rc, "rglru_scan_launch")
    rglru_scan_cuda.launches += 1
    return out


rglru_scan_cuda.launches = 0


def attributes(tile: Tuple[int, int], dtype: torch.dtype) -> Dict[str, int]:
    """``cudaFuncGetAttributes`` of one instantiation (see ``_build.attributes``)."""
    return _build.attributes(_lib(), "rglru_scan_attributes", *tile, _build.DTYPE_CODES[dtype])
