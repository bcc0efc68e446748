"""Build and load the CUDA kernels of ``repro_torch/csrc``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds). Libraries land in ``build/`` at the
repository root, keyed by a hash of the source and flags, at first use.

The flags are part of the kernels' numerics contract: no
``--use_fast_math`` (precise ``expf``, IEEE division) and ``-fmad=false``
(no contraction of ``a * b + c`` into an FMA), so each float32 operation
rounds once, exactly as a PyTorch elementwise op does.

Each library links its own (static) CUDA runtime, which launches in the
context current on the calling thread, not on the device of the pointers it
is given. So every wrapper launches under ``torch.cuda.device`` of its
tensors: a kernel on ``cuda:1`` runs in ``cuda:1``'s context and on its
stream whatever the current device is.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

import torch

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"

#: ``nvcc`` runs started by :func:`build` in this process (a new source, or
#: new flags: a build); ``analysis.RetraceCounter`` samples it.
BUILDS = 0

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return nvcc


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to (content- and flag-addressed)."""
    digest = hashlib.sha256(
        (CSRC_DIR / f"{name}.cu").read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named source that is not built yet, one ``nvcc`` per
    source, all started together. Returns each new build's compiler output
    (``-Xptxas -v`` register and spill report); raises on a failed build."""
    global BUILDS
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
        BUILDS += 1
    logs = {}
    for name, (proc, tmp, target) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{out}")
        os.replace(tmp, target)
        logs[name] = out
    return logs


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    build([name])
    lib = ctypes.CDLL(str(library_path(name)))
    lib.error_string.argtypes = [ctypes.c_int]
    lib.error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error (``cudaGetLastError``)."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}: {lib.error_string(rc).decode()}")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device: torch.device) -> ctypes.c_void_p:
    """PyTorch's current stream on ``device``, for the launch."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def require(t: torch.Tensor, name: str, dtype: torch.dtype, shape=None) -> None:
    """Wrapper-side checks before a pointer crosses into a kernel."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


#: dtype codes of the kernels that take float32 or bfloat16 operands.
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(t: torch.Tensor, name: str) -> int:
    if t.dtype not in DTYPE_CODES:
        raise ValueError(f"{name} must be float32 or bfloat16, got {t.dtype}")
    return DTYPE_CODES[t.dtype]


def attributes(lib: ctypes.CDLL, fn: str, *args: int) -> Dict[str, int]:
    """``cudaFuncGetAttributes`` of one instantiation, through the library's
    ``<fn>(args..., int32 out[5])``: registers a thread, shared memory a block
    (static plus the dynamic amount its launcher requests), the most threads a
    block may have, local (spill) bytes a thread, threads it launches with."""
    out = (ctypes.c_int32 * 5)()
    f = getattr(lib, fn)
    f.argtypes = [ctypes.c_int32] * len(args) + [ctypes.POINTER(ctypes.c_int32)]
    f.restype = ctypes.c_int
    check(lib, f(*args, out), fn)
    return dict(zip(("registers", "smem_bytes", "max_threads", "local_bytes", "threads"),
                    list(out)))
