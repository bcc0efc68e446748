"""Fused one-pass charge-sweep grid search: the CUDA kernel's wrapper and
its plain PyTorch version.

Per (cell, search) only one exponential varies with the candidate timing;
everything else is a per-cell invariant, hoisted by :mod:`.ops` into an
``(18, cells)`` float32 stack (:data:`INVARIANT_NAMES`). The search walks
the shared timing grid once, evaluating all seven searches per candidate
cycle and folding each monotone pass/fail into a running first-True
index — no ``(grid × cells)`` matrix is materialized.

:func:`charge_sweep_cuda` launches ``csrc/charge_sweep.cu`` (one thread per
cell); :func:`charge_sweep_plain` is the same arithmetic in torch ops, in
the same operand order, so the two agree bit for bit on the same inputs.
Neither uses a multiplicative carry ``E_{k+1} = E_k · e^{Δt/τ}``: its
accumulated rounding could flip a threshold comparison that the model's
eps slack does not cover.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.charge_sweep.ref import SEARCH_GRID_SIZES, SEARCH_NAMES

#: Rows of the stacked invariant input, in order. The ``m_*`` rows are the
#: fixed-parameter masks: the other three JEDEC-held parameters' pass/fail
#: at this cell, pre-ANDed per search (0.0 / 1.0).
INVARIANT_NAMES: Tuple[str, ...] = (
    "dv0_r",       # initial read bitline differential (full restore)
    "rts",         # r · τ_sa
    "t_sense_r",   # sense-latch time from dv0_r
    "thr_rest",    # restore-target threshold v_tgt · (1 − eps)
    "rtr",         # r · τ_restore
    "rtb",         # r · τ_bl
    "thr_trp",     # precharge residual threshold δ_ok · (1 + eps)
    "tau_wr",      # r · τ_write · drive_factor(T)
    "t_sense_w",   # sense-latch time from the write-assisted dv0
    "thr_trcd_w",  # min_trcd_write · (1 − eps)
    "thr_trp_w",   # min_trp_write · (1 − eps)
    "m_r_trcd", "m_r_tras", "m_r_trp",
    "m_w_trcd", "m_w_tras", "m_w_twr", "m_w_trp",
)
N_INVARIANTS: int = len(INVARIANT_NAMES)
N_SEARCHES: int = len(SEARCH_NAMES)


@dataclasses.dataclass(frozen=True)
class SweepScalars:
    """Model constants the search closes over, each the float32 rounding of
    the Python constant (built by :func:`.ops.kernel_scalars`)."""

    tck: float
    ovh_rcd: float
    ovh_ras: float
    ovh_wr: float
    ovh_rp: float
    thr_sense: float          # v_sense_target · (1 − eps)
    one_minus_vrs: float      # 1 − v_restore_start
    v_half: float             # v_half_swing
    v_over: float             # v_overdrive
    v_over_minus_vrs: float   # v_overdrive − v_restore_start


class _SweepParamsC(ctypes.Structure):
    """Mirror of ``SweepParams`` in ``csrc/charge_sweep.cu``."""

    _fields_ = [(f.name, ctypes.c_float) for f in dataclasses.fields(SweepScalars)] + [
        ("n_grid", ctypes.c_int32 * N_SEARCHES)
    ]


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("charge_sweep")
    lib.charge_sweep_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.POINTER(_SweepParamsC), ctypes.c_void_p,
    ]
    lib.charge_sweep_launch.restype = ctypes.c_int
    return lib


def _check_inv(inv: torch.Tensor) -> None:
    if inv.dtype != torch.float32 or inv.dim() != 2 or inv.shape[0] != N_INVARIANTS:
        raise ValueError(
            f"invariants must be ({N_INVARIANTS}, cells) float32, got "
            f"{tuple(inv.shape)} {inv.dtype}"
        )


def charge_sweep_plain(
    inv: torch.Tensor,
    scal: SweepScalars,
    n_grid: Tuple[int, ...] = SEARCH_GRID_SIZES,
) -> torch.Tensor:
    """The fused search in torch ops: ``(18, cells)`` float32 invariants in,
    ``(7, cells)`` int32 min-safe grid indices out (``SEARCH_NAMES`` order).
    Runs on any device; the CPU path of :func:`.ops.sweep_min_indices`."""
    _check_inv(inv)
    (dv0_r, rts, t_sense_r, thr_rest, rtr, rtb, thr_trp, tau_wr,
     t_sense_w, thr_trcd_w, thr_trp_w) = inv[:11]
    masks = inv[11:] > 0.5
    n_grid_t = torch.tensor(n_grid, dtype=torch.int32, device=inv.device)
    # All-False searches keep the last grid index: the JEDEC pin.
    idx = (n_grid_t - 1)[:, None].expand(N_SEARCHES, inv.shape[1]).clone()
    found = torch.zeros_like(masks)
    for k in range(max(n_grid)):
        # Grid point k is (k + 1) cycles: one float32 product, as in the grid.
        t = torch.full_like(rts, k + 1) * scal.tck
        dv = dv0_r * torch.exp((t - scal.ovh_rcd) / rts)
        ta_r = t - scal.ovh_ras - t_sense_r
        v_reached = 1.0 - scal.one_minus_vrs * torch.exp(
            -torch.clamp(ta_r, min=0.0) / rtr
        )
        delta = scal.v_half * torch.exp(-(t - scal.ovh_rp) / rtb)
        ta_w = t - scal.ovh_ras - t_sense_w
        v_row = scal.v_over - scal.v_over_minus_vrs * torch.exp(
            -torch.clamp(ta_w, min=0.0) / tau_wr
        )
        v_wr = scal.v_over * (1.0 - torch.exp(-(t - scal.ovh_wr) / tau_wr))
        passes = torch.stack([
            dv >= scal.thr_sense,     # r_trcd
            v_reached >= thr_rest,    # r_tras
            delta <= thr_trp,         # r_trp
            t >= thr_trcd_w,          # w_trcd
            v_row >= thr_rest,        # w_tras
            v_wr >= thr_rest,         # w_twr
            t >= thr_trp_w,           # w_trp
        ])
        ok = passes & masks & (k < n_grid_t)[:, None]
        idx = torch.where(ok & ~found, k, idx)
        found = found | ok
    return idx


def charge_sweep_cuda(
    inv: torch.Tensor,
    scal: SweepScalars,
    n_grid: Tuple[int, ...] = SEARCH_GRID_SIZES,
) -> torch.Tensor:
    """Launch ``csrc/charge_sweep.cu`` on PyTorch's current stream. Same
    contract as :func:`charge_sweep_plain`; ``inv`` must be a contiguous
    CUDA tensor. Counts its launches in ``charge_sweep_cuda.launches``."""
    _check_inv(inv)
    _build.require(inv, "invariants", torch.float32)
    if len(n_grid) != N_SEARCHES:
        raise ValueError(f"n_grid must have {N_SEARCHES} entries, got {n_grid}")
    n = inv.shape[1]
    out = torch.empty((N_SEARCHES, n), dtype=torch.int32, device=inv.device)
    params = _SweepParamsC(*dataclasses.astuple(scal),
                           (ctypes.c_int32 * N_SEARCHES)(*n_grid))
    lib = _lib()
    with torch.cuda.device(inv.device):
        rc = lib.charge_sweep_launch(_build.ptr(inv), _build.ptr(out), n,
                                     ctypes.byref(params), _build.stream_ptr(inv.device))
    _build.check(lib, rc, "charge_sweep_launch")
    charge_sweep_cuda.launches += 1
    return out


charge_sweep_cuda.launches = 0
