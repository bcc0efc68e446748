"""Invariant precompute and dispatch for the fused charge-sweep search.

:func:`sweep_min_indices` / :func:`sweep_min_timings` take effective cell
parameters (data pattern applied) and temperatures that broadcast
together, hoist the per-cell invariants in plain torch
(:func:`cell_invariants`), flatten them to one ``(18, cells)`` stack and
run the fused search: a CPU tensor goes to the plain version
(:func:`.kernel.charge_sweep_plain`), a CUDA tensor to the CUDA kernel
(:func:`.kernel.charge_sweep_cuda`), which raises if it cannot launch.
Both access modes come out of one pass.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core import charge
from repro_torch.core.charge import CellParams, ChargeModelConstants, DEFAULT_CONSTANTS, div
from repro_torch.core.timing import JEDEC_DDR3_1600, TCK_DDR3_1600_NS
from repro_torch.kernels.charge_sweep import ref
from repro_torch.kernels.charge_sweep.kernel import (
    SweepScalars,
    charge_sweep_cuda,
    charge_sweep_plain,
)


class SweepIndices(NamedTuple):
    """Min-safe grid indices per access mode, ``PARAM_NAMES`` columns;
    ``read[..., 2] == write[..., 2]`` (tWR is the shared write-test search)."""

    read: torch.Tensor    # (..., 4) int32
    write: torch.Tensor   # (..., 4) int32


def kernel_scalars(consts: ChargeModelConstants = DEFAULT_CONSTANTS) -> SweepScalars:
    """Fold the Python constants with the forward predicates' grouping, then
    round each to float32 (the value a float32 op sees)."""
    folded = dict(
        tck=TCK_DDR3_1600_NS,
        ovh_rcd=consts.ovh_rcd,
        ovh_ras=consts.ovh_ras,
        ovh_wr=consts.ovh_wr,
        ovh_rp=consts.ovh_rp,
        thr_sense=consts.v_sense_target * (1.0 - charge._EPS),
        one_minus_vrs=1.0 - consts.v_restore_start,
        v_half=consts.v_half_swing,
        v_over=consts.v_overdrive,
        v_over_minus_vrs=consts.v_overdrive - consts.v_restore_start,
    )
    return SweepScalars(**{k: float(np.float32(v)) for k, v in folded.items()})


def cell_invariants(
    cells_eff: CellParams,
    temp_c,
    window_s: float = charge.REFRESH_WINDOW_S,
    consts: ChargeModelConstants = DEFAULT_CONSTANTS,
) -> Tuple[torch.Tensor, ...]:
    """The per-cell quantities the grid loop carries, in
    :data:`.kernel.INVARIANT_NAMES` order (each broadcastable to the common
    cells × temperature shape). Every line mirrors the corresponding
    expression of ``charge.read_ok`` / ``charge.write_ok``; the Python-float
    JEDEC terms fold in float64 before they meet float32 tensors."""
    eps = charge._EPS
    base = JEDEC_DDR3_1600
    temp = torch.as_tensor(temp_c, dtype=torch.float32, device=cells_eff.r.device)

    dv0_r = charge.sense_dv0(cells_eff, temp, consts.v_full, window_s, consts)
    rts = cells_eff.r * consts.tau_sa
    t_sense_r = charge.sense_time(cells_eff, dv0_r, consts)
    v_tgt = charge.restore_target(cells_eff, temp, window_s, consts)
    thr_rest = v_tgt * (1.0 - eps)
    rtr = cells_eff.r * consts.tau_restore
    rtb = cells_eff.r * consts.tau_bl
    delta_ok = torch.clamp(charge.tolerable_residual(cells_eff, temp, consts),
                           max=0.4 * consts.v_half_swing)
    thr_trp = delta_ok * (1.0 + eps)
    tau_wr = cells_eff.r * consts.tau_write * charge.drive_factor(temp, cells_eff.r, consts)
    dv0_w = charge._wm_dv0(cells_eff, temp, window_s, consts)
    t_sense_w = charge.sense_time(cells_eff, dv0_w, consts)
    thr_trcd_w = charge.min_trcd_write(cells_eff, temp, window_s, consts) * (1.0 - eps)
    thr_trp_w = charge.min_trp_write(cells_eff, temp, window_s, consts) * (1.0 - eps)

    # Fixed-parameter components at JEDEC.
    sense_r_j = dv0_r * torch.exp(div(base.trcd - consts.ovh_rcd, rts)) >= \
        consts.v_sense_target * (1.0 - eps)
    rest_r_j = 1.0 - (1.0 - consts.v_restore_start) * torch.exp(
        -torch.clamp(base.tras - consts.ovh_ras - t_sense_r, min=0.0) / rtr
    ) >= thr_rest
    prech_r_j = consts.v_half_swing * torch.exp(
        div(-(base.trp - consts.ovh_rp), rtb)
    ) <= thr_trp
    wr_j = consts.v_overdrive * (
        1.0 - torch.exp(div(-(base.twr - consts.ovh_wr), tau_wr))
    ) >= thr_rest
    tras_w_j = consts.v_overdrive - (
        consts.v_overdrive - consts.v_restore_start
    ) * torch.exp(
        -torch.clamp(base.tras - consts.ovh_ras - t_sense_w, min=0.0) / tau_wr
    ) >= thr_rest
    trcd_w_j = base.trcd >= thr_trcd_w
    trp_w_j = base.trp >= thr_trp_w

    def m(*bits: torch.Tensor) -> torch.Tensor:
        out = bits[0]
        for b in bits[1:]:
            out = out & b
        return out.to(torch.float32)

    return (
        dv0_r, rts, t_sense_r, thr_rest, rtr, rtb, thr_trp, tau_wr,
        t_sense_w, thr_trcd_w, thr_trp_w,
        m(rest_r_j, prech_r_j),            # m_r_trcd
        m(sense_r_j, prech_r_j),           # m_r_tras
        m(sense_r_j, rest_r_j),            # m_r_trp
        m(wr_j, tras_w_j, trp_w_j),        # m_w_trcd
        m(wr_j, trcd_w_j, trp_w_j),        # m_w_tras
        m(tras_w_j, trcd_w_j, trp_w_j),    # m_w_twr
        m(wr_j, tras_w_j, trcd_w_j),       # m_w_trp
    )


def stacked_invariants(
    cells_eff: CellParams,
    temp_c,
    window_s: float = charge.REFRESH_WINDOW_S,
    consts: ChargeModelConstants = DEFAULT_CONSTANTS,
) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    """The invariants broadcast, flattened and stacked to the search's
    contiguous ``(18, cells)`` input, plus the broadcast cell shape. Each
    invariant is copied straight into its row of the stack, so no flattened
    copy is made beside it."""
    inv = cell_invariants(cells_eff, temp_c, window_s, consts)
    shape = tuple(torch.broadcast_shapes(*(a.shape for a in inv)))
    flat = torch.empty((len(inv), math.prod(shape)), dtype=torch.float32,
                       device=inv[0].device)
    for row, a in zip(flat, inv):
        row.view(shape).copy_(a)
    return flat, shape


def search_indices(inv: torch.Tensor, consts: ChargeModelConstants = DEFAULT_CONSTANTS
                   ) -> torch.Tensor:
    """Dispatch the fused search on ``inv``'s device: CPU → plain version,
    CUDA → kernel. ``(18, cells)`` in, ``(7, cells)`` int32 out."""
    scal = kernel_scalars(consts)
    if inv.device.type == "cpu":
        return charge_sweep_plain(inv, scal, ref.SEARCH_GRID_SIZES)
    return charge_sweep_cuda(inv, scal, ref.SEARCH_GRID_SIZES)


def sweep_min_indices(
    cells_eff: CellParams,
    temp_c,
    window_s: float = charge.REFRESH_WINDOW_S,
    consts: ChargeModelConstants = DEFAULT_CONSTANTS,
) -> SweepIndices:
    """Min-safe grid indices for BOTH access modes in one pass:
    ``(broadcast_shape, 4)`` int32 stacks in ``PARAM_NAMES`` columns."""
    flat, shape = stacked_invariants(cells_eff, temp_c, window_s, consts)
    s = search_indices(flat, consts).t().reshape(shape + (len(ref.SEARCH_NAMES),))
    return SweepIndices(
        read=s[..., list(ref.READ_STACK_SEARCHES)],
        write=s[..., list(ref.WRITE_STACK_SEARCHES)],
    )


def sweep_min_timings(
    cells_eff: CellParams,
    temp_c,
    window_s: float = charge.REFRESH_WINDOW_S,
    consts: ChargeModelConstants = DEFAULT_CONSTANTS,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both ``(..., 4)`` ns timing stacks (read-mode, write-mode) in one pass."""
    idx = sweep_min_indices(cells_eff, temp_c, window_s, consts)
    return ref.indices_to_ns(idx.read), ref.indices_to_ns(idx.write)
