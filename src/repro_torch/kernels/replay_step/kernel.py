"""Fused replay chunk scan: the CUDA kernel's wrapper and its plain
PyTorch version, on the slot-major layouts the streaming engine keeps.

Layouts (N DIMMs, B bins, chunk steps), every per-DIMM operand slot-major
so that a warp's reads are coalesced:

* ``state3``  ``(3, N)`` int32 — bin index, cool streak, fused (0/1)
* ``occ``     ``(B + 1, N)`` int32 — steps per effective bin (B = JEDEC)
* ``sw``      ``(N,)`` int32 — timing-set switches
* ``sums``    ``(8, N)`` float32 — realized timing sums, slot ``a * 4 + p``
* ``stack_t`` ``(B * 8, N)`` float32 — the table, slot ``b * 8 + a * 4 + p``
* ``temps``   ``(chunk, N)`` float32, ``errs`` ``(chunk, N)`` uint8

:func:`replay_chunk_cuda` launches ``csrc/replay_step.cu``;
:func:`replay_chunk_plain` converts to the public layouts and runs the
reference scan (:func:`.ref.chunk_scan`). Both return new
``(state3, occ, sw, sums)``.

The emitting entry also returns each step's decisions (:class:`Decisions`:
the realized ``(chunk, N, 2, 4)`` rows, the effective bin, the switch and
the post-step fuse flags): :func:`replay_chunk_emit_cuda` launches the
kernel's ``EMIT`` instantiation and writes into outputs the caller may
pass in; :func:`replay_chunk_emit_plain` runs the plain emit scan. Both
return ``(state3, occ, sw, sums, decisions)``, the first four bitwise
those of the non-emitting entry.

The fused score accumulation over a materialized history works on the
public layouts instead (the reference's ``(S, N, ...)`` replay outputs and
``ScorePartials``): :func:`accumulate_cuda` launches ``csrc/accumulate.cu``,
:func:`accumulate_plain` is the plain version. Both take and return
``(occ (N, B+1) int32, sw (N,) int32, sums (N, 2, 4) float32)``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core.controller import ControllerParams, ControllerState
from repro_torch.core.perfmodel import ScorePartials, trace_score_accumulate_plain
from repro_torch.kernels import _build
from repro_torch.kernels.replay_step import ref

#: Flattened (access, param) slots per timing row.
ROW_SLOTS: int = 8

#: Largest bin count the CUDA kernel is instantiated for.
MAX_BINS: int = 8

Operands = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


class Decisions(NamedTuple):
    """Per-step outputs of the emitting entry, in the public step-major
    layouts; a field is ``None`` where it was not asked for."""

    rows: Optional[torch.Tensor]      # (chunk, N, 2, 4) float32 realized rows, ns
    eff: Optional[torch.Tensor]       # (chunk, N) int32 effective bin (B = JEDEC)
    switched: Optional[torch.Tensor]  # (chunk, N) bool
    fused: Optional[torch.Tensor]     # (chunk, N) bool, post-step fuse state

    @staticmethod
    def empty(chunk: int, n: int, device, fields=("rows", "eff", "switched", "fused")
              ) -> "Decisions":
        """Uninitialized outputs for the named fields, ``None`` for the rest."""
        make = {"rows": lambda: torch.empty((chunk, n, 2, 4), dtype=torch.float32,
                                            device=device),
                "eff": lambda: torch.empty((chunk, n), dtype=torch.int32, device=device),
                "switched": lambda: torch.empty((chunk, n), dtype=torch.bool, device=device),
                "fused": lambda: torch.empty((chunk, n), dtype=torch.bool, device=device)}
        return Decisions(**{k: make[k]() if k in fields else None for k in make})


@dataclasses.dataclass(frozen=True)
class ReplayScalars:
    """Controller policy the scan closes over; every float is the exact
    float32 value of the Python policy (built by :func:`.ops.replay_scalars`)."""

    edges: Tuple[float, ...]    # bin upper edges, ascending
    guard_band_c: float
    hysteresis_c: float
    hysteresis_steps: int
    jedec: Tuple[float, ...]    # flattened (2, 4) JEDEC sentinel row


class _ReplayParamsC(ctypes.Structure):
    """Mirror of ``ReplayParams`` in ``csrc/replay_step.cu``."""

    _fields_ = [
        ("edges", ctypes.c_float * MAX_BINS),
        ("jedec", ctypes.c_float * ROW_SLOTS),
        ("guard_band_c", ctypes.c_float),
        ("hysteresis_c", ctypes.c_float),
        ("n_bins", ctypes.c_int32),
        ("hysteresis_steps", ctypes.c_int32),
    ]


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("replay_step")
    lib.replay_chunk_launch.argtypes = [ctypes.c_void_p] * 11 + [
        ctypes.c_int64, ctypes.c_int32, ctypes.POINTER(_ReplayParamsC), ctypes.c_void_p,
    ]
    lib.replay_chunk_launch.restype = ctypes.c_int
    lib.replay_chunk_emit_launch.argtypes = [ctypes.c_void_p] * 15 + [
        ctypes.c_int64, ctypes.c_int32, ctypes.POINTER(_ReplayParamsC), ctypes.c_void_p,
    ]
    lib.replay_chunk_emit_launch.restype = ctypes.c_int
    lib.replay_max_bins.restype = ctypes.c_int
    if lib.replay_max_bins() != MAX_BINS:
        raise RuntimeError(f"csrc/replay_step.cu is built for {lib.replay_max_bins()} "
                           f"bins, this wrapper for {MAX_BINS}")
    return lib


def _shapes(scal: ReplayScalars, n: int, chunk: int):
    b = len(scal.edges)
    return {
        "state3": (3, n), "occ": (b + 1, n), "sw": (n,), "sums": (ROW_SLOTS, n),
        "stack_t": (b * ROW_SLOTS, n), "temps": (chunk, n), "errs": (chunk, n),
    }


def _plain_scan(scan, state3, occ, sw, sums, stack_t, temps, errs, scal: ReplayScalars):
    """Run a scan of :mod:`.ref` on the public layouts of the slot-major
    operands: returns the new slot-major ``(state3, occ, sw, sums)`` and the
    scan's outputs past its partials."""
    n_bins, n = len(scal.edges), state3.shape[1]
    state = ControllerState(state3[0], state3[1], state3[2] != 0)
    params = ControllerParams(scal.guard_band_c, scal.hysteresis_c, scal.hysteresis_steps)
    edges = torch.tensor(scal.edges, dtype=torch.float32, device=state3.device)
    stack = stack_t.t().reshape(n, n_bins, 2, 4)
    zero = torch.zeros((), dtype=torch.int32, device=state3.device)
    st, occ_o, sw_o, sums_o, _, *rest = scan(
        stack, edges, params, state, occ.t(), sw, sums.t().reshape(n, 2, 4), zero,
        temps, errs != 0,
    )
    state_o = torch.stack([st.bin_idx, st.cool_streak, st.fused.to(torch.int32)])
    return (state_o, occ_o.t().contiguous(), sw_o,
            sums_o.reshape(n, ROW_SLOTS).t().contiguous()), rest


def replay_chunk_plain(state3, occ, sw, sums, stack_t, temps, errs,
                       scal: ReplayScalars) -> Operands:
    """The chunk scan in torch ops on any device (same contract as
    :func:`replay_chunk_cuda`)."""
    return _plain_scan(ref.chunk_scan, state3, occ, sw, sums, stack_t, temps, errs, scal)[0]


def replay_chunk_emit_plain(state3, occ, sw, sums, stack_t, temps, errs, scal: ReplayScalars):
    """The emitting chunk scan in torch ops on any device (same contract as
    :func:`replay_chunk_emit_cuda` with every decision field asked for)."""
    carry, (rows, switched, eff, fused) = _plain_scan(
        ref.emit_scan, state3, occ, sw, sums, stack_t, temps, errs, scal)
    return carry + (Decisions(rows, eff, switched, fused),)


def _check_operands(state3, occ, sw, sums, stack_t, temps, errs, scal: ReplayScalars) -> int:
    """The wrapper-side checks of both entries; returns the bin count."""
    n_bins = len(scal.edges)
    if not 1 <= n_bins <= MAX_BINS:
        raise ValueError(f"the CUDA replay kernel takes 1..{MAX_BINS} bins, got {n_bins}")
    shapes = _shapes(scal, state3.shape[-1], temps.shape[0])
    args = dict(state3=state3, occ=occ, sw=sw, sums=sums, stack_t=stack_t,
                temps=temps, errs=errs)
    dtypes = dict(state3=torch.int32, occ=torch.int32, sw=torch.int32,
                  sums=torch.float32, stack_t=torch.float32, temps=torch.float32,
                  errs=torch.uint8)
    for name, t in args.items():
        _build.require(t, name, dtypes[name], shapes[name])
        if t.device != state3.device:
            raise ValueError(f"{name} is on {t.device}, state3 on {state3.device}")
    return n_bins


def _params(scal: ReplayScalars, n_bins: int) -> _ReplayParamsC:
    return _ReplayParamsC(
        (ctypes.c_float * MAX_BINS)(*scal.edges),
        (ctypes.c_float * ROW_SLOTS)(*scal.jedec),
        scal.guard_band_c, scal.hysteresis_c, n_bins, scal.hysteresis_steps,
    )


def replay_chunk_cuda(state3, occ, sw, sums, stack_t, temps, errs,
                      scal: ReplayScalars) -> Operands:
    """Launch ``csrc/replay_step.cu`` on PyTorch's current stream. All
    operands are contiguous CUDA tensors on one device, in the layouts of
    this module. Counts its launches in ``replay_chunk_cuda.launches``."""
    n_bins = _check_operands(state3, occ, sw, sums, stack_t, temps, errs, scal)
    n, chunk = state3.shape[-1], temps.shape[0]
    outs = tuple(torch.empty_like(t) for t in (state3, occ, sw, sums))
    params = _params(scal, n_bins)
    lib = _lib()
    with torch.cuda.device(state3.device):
        rc = lib.replay_chunk_launch(
            *(_build.ptr(t) for t in (state3, occ, sw, sums, stack_t, temps, errs)),
            *(_build.ptr(t) for t in outs),
            n, chunk, ctypes.byref(params), _build.stream_ptr(state3.device),
        )
    _build.check(lib, rc, "replay_chunk_launch")
    replay_chunk_cuda.launches += 1
    return outs


replay_chunk_cuda.launches = 0


def replay_chunk_emit_cuda(state3, occ, sw, sums, stack_t, temps, errs, scal: ReplayScalars,
                           out: Optional[Decisions] = None):
    """Launch the emitting entry of ``csrc/replay_step.cu`` on PyTorch's
    current stream: :func:`replay_chunk_cuda`, and each step's decisions
    written into ``out`` (default: all four fields allocated here). A field
    of ``out`` that is ``None`` is not written; the others are contiguous
    CUDA tensors on the operands' device in :class:`Decisions`' shapes and
    dtypes (``switched`` and ``fused`` bool or uint8, written 0 or 1; rows
    at any 4-byte offset), e.g. slices of a caller's history. Returns
    ``(state3, occ, sw, sums, out)``. Counts its launches in
    ``replay_chunk_cuda.launches``."""
    n_bins = _check_operands(state3, occ, sw, sums, stack_t, temps, errs, scal)
    n, chunk = state3.shape[-1], temps.shape[0]
    if out is None:
        out = Decisions.empty(chunk, n, state3.device)
    specs = dict(rows=((chunk, n, 2, 4), (torch.float32,)),
                 eff=((chunk, n), (torch.int32,)),
                 switched=((chunk, n), (torch.bool, torch.uint8)),
                 fused=((chunk, n), (torch.bool, torch.uint8)))
    ptrs = []
    for name, t in out._asdict().items():
        if t is None:
            ptrs.append(ctypes.c_void_p(None))
            continue
        shape, dtypes = specs[name]
        if t.dtype not in dtypes:
            raise ValueError(f"{name} must be one of {dtypes}, got {t.dtype}")
        _build.require(t, name, t.dtype, shape)
        if t.device != state3.device:
            raise ValueError(f"{name} is on {t.device}, state3 on {state3.device}")
        ptrs.append(_build.ptr(t))
    outs = tuple(torch.empty_like(t) for t in (state3, occ, sw, sums))
    params = _params(scal, n_bins)
    lib = _lib()
    with torch.cuda.device(state3.device):
        rc = lib.replay_chunk_emit_launch(
            *(_build.ptr(t) for t in (state3, occ, sw, sums, stack_t, temps, errs)),
            *(_build.ptr(t) for t in outs), *ptrs,
            n, chunk, ctypes.byref(params), _build.stream_ptr(state3.device),
        )
    _build.check(lib, rc, "replay_chunk_emit_launch")
    replay_chunk_cuda.launches += 1
    return outs + (out,)


# ---------------------------------------------------------------------------
# Fused score accumulation over a materialized history
# ---------------------------------------------------------------------------
Partials3 = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


@functools.lru_cache(maxsize=None)
def _accumulate_lib() -> ctypes.CDLL:
    lib = _build.load("accumulate")
    lib.accumulate_launch.argtypes = [ctypes.c_void_p] * 9 + [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p,
    ]
    lib.accumulate_launch.restype = ctypes.c_int
    lib.accumulate_max_bins.restype = ctypes.c_int
    if lib.accumulate_max_bins() != MAX_BINS:
        raise RuntimeError(f"csrc/accumulate.cu is built for {lib.accumulate_max_bins()} "
                           f"bins, this wrapper for {MAX_BINS}")
    return lib


def accumulate_plain(occ, sw, sums, timings, bins, switched) -> Partials3:
    """Fold ``timings`` (S, N, 2, 4), ``bins`` (S, N) and ``switched`` (S, N)
    into the running ``(occ, sw, sums)`` in torch ops on any device (same
    contract as :func:`accumulate_cuda`)."""
    zero = torch.zeros((), dtype=torch.int32, device=occ.device)
    p = trace_score_accumulate_plain(ScorePartials(occ, sw, sums, zero), timings, bins,
                                     switched != 0)
    return p.occupancy, p.switches, p.timing_sums


def accumulate_cuda(occ, sw, sums, timings, bins, switched) -> Partials3:
    """Launch ``csrc/accumulate.cu`` on PyTorch's current stream: ``occ``
    (N, B+1) int32, ``sw`` (N,) int32, ``sums`` (N, 2, 4) float32 running
    partials; ``timings`` (S, N, 2, 4) float32 (16-byte aligned), ``bins``
    (S, N) int32, ``switched`` (S, N) uint8 — all contiguous on one card.
    Returns new partials. Counts its launches in ``accumulate_cuda.launches``."""
    n, n_bins1 = occ.shape
    if not 2 <= n_bins1 <= MAX_BINS + 1:
        raise ValueError(f"the CUDA accumulate kernel takes 1..{MAX_BINS} bins, "
                         f"got {n_bins1 - 1}")
    steps = bins.shape[0]
    shapes = dict(occ=(n, n_bins1), sw=(n,), sums=(n, 2, 4), timings=(steps, n, 2, 4),
                  bins=(steps, n), switched=(steps, n))
    dtypes = dict(occ=torch.int32, sw=torch.int32, sums=torch.float32,
                  timings=torch.float32, bins=torch.int32, switched=torch.uint8)
    args = dict(occ=occ, sw=sw, sums=sums, timings=timings, bins=bins, switched=switched)
    for name, t in args.items():
        _build.require(t, name, dtypes[name], shapes[name])
        if t.device != occ.device:
            raise ValueError(f"{name} is on {t.device}, occ on {occ.device}")
    if timings.data_ptr() % 16:
        raise ValueError("timings must be 16-byte aligned for the kernel's float4 loads")
    outs = tuple(torch.empty_like(t) for t in (occ, sw, sums))
    lib = _accumulate_lib()
    with torch.cuda.device(occ.device):
        rc = lib.accumulate_launch(
            *(_build.ptr(t) for t in (bins, switched, timings, occ, sw, sums)),
            *(_build.ptr(t) for t in outs),
            n, steps, n_bins1 - 1, _build.stream_ptr(occ.device),
        )
    _build.check(lib, rc, "accumulate_launch")
    accumulate_cuda.launches += 1
    return outs


accumulate_cuda.launches = 0
