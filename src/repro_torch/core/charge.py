"""Cell charge <-> latency model (paper §1.3), in PyTorch.

Expression-for-expression port of the reference charge model: sensing
(tRCD) from the charge-sharing differential, restore (tRAS/tWR) toward an
adaptive target, precharge (tRP) against an equalizer margin, and the
write-mode variants. Every time constant is anchored so that the
worst-case cell at 85 °C needs exactly the JEDEC DDR3-1600 value.

Numerics follow the reference, which runs in float32: Python-float
constants fold in float64 and meet float32 tensors as float32 scalars, and
each tensor op rounds once. Two torch idioms would break that and are
avoided here: a division with a Python-float operand (torch evaluates
``scalar / tensor`` as ``reciprocal(tensor) * scalar``, and on CUDA
``tensor / scalar`` as a product with the reciprocal; see :func:`div`) and
int64/float64 defaults of tensor factories. Transcendentals (``exp``, ``log``, ``pow``)
are the backend's own and may differ from XLA's by an ulp; the tests hold
the derived quantities to a tolerance and the decisions to exact equality.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import torch

from repro_torch.core.timing import JEDEC_DDR3_1600, TimingParams

#: Refresh window (DDR3 64 ms retention requirement), in seconds.
REFRESH_WINDOW_S: float = 64e-3

#: The worst-case qualification temperature (°C) of the DDR3 standard.
T_WORST_C: float = 85.0

#: Extended-temperature boundary (°C): above it the standard mandates 2x
#: refresh, so retention is evaluated over half the window.
EXTENDED_TEMP_BOUNDARY_C: float = 85.0
EXTENDED_WINDOW_FACTOR: float = 0.5

#: Relative tolerance for forward correctness predicates: the worst-case
#: cell at JEDEC timings sits exactly on the threshold by construction.
_EPS: float = 1e-4


class CellParams(NamedTuple):
    """Worst-case-cell parameters of a DIMM (tensors broadcast together).

    r     peripheral RC multiplier, 1 = best .. r_max = JEDEC worst corner.
    c     worst-cell capacitance fraction, c_min = corner .. 1 = nominal.
    leak  worst-cell leakage multiplier, 1 = corner.
    """

    r: torch.Tensor
    c: torch.Tensor
    leak: torch.Tensor


def div(num, den) -> torch.Tensor:
    """``num / den`` as ONE rounded float32 division on every device, also
    for a Python-float numerator or denominator. torch rounds twice there:
    ``float / tensor`` is ``reciprocal(den) * num``, and on CUDA
    ``tensor / float`` is ``num * (1 / den)``. A Python operand becomes a
    0-d float32 tensor by a fill on the other operand's device, not a
    host-to-device copy, which would wait for the device."""
    if not isinstance(num, torch.Tensor):
        num = torch.full((), num, dtype=torch.float32, device=den.device)
    elif not isinstance(den, torch.Tensor):
        den = torch.full((), den, dtype=torch.float32, device=num.device)
    return torch.div(num, den)


def _f32_log(x: float) -> float:
    """float32 log of a Python float, as the exact float32 value."""
    return float(torch.log(torch.tensor(x, dtype=torch.float32)))


def _anchor(num: float, r_max: float, ratio: float) -> float:
    """``num / (r_max * log(ratio))`` evaluated in float32 (the reference
    folds the anchors with a float32 ``log``)."""
    den = torch.tensor(r_max, dtype=torch.float32) * _f32_log(ratio)
    return float(torch.div(torch.tensor(num, dtype=torch.float32), den))


@dataclasses.dataclass(frozen=True)
class ChargeModelConstants:
    """Model constants (calibrated defaults of the reference model)."""

    ret85: float = 0.9282
    leak_doubling_c: float = 7.24
    v_full: float = 0.975
    v_sense_target: float = 0.75
    cs_alpha: float = 0.20
    c_min: float = 0.70
    r_max: float = 1.45
    ovh_rcd: float = 3.0
    ovh_ras: float = 6.0
    ovh_wr: float = 2.0
    ovh_rp: float = 3.5
    v_restore_start: float = 0.55
    v_overdrive: float = 0.9830
    mobility_exp: float = 1.418
    delta_floor: float = 0.010
    pc_var: float = 1.011
    pc_temp: float = 0.672
    v_half_swing: float = 0.50
    wm_gain_rcd: float = 2.186
    wm_temp: float = 1.26
    wm_gain_rp: float = 2.709
    #: Per-region (design-induced) variation span: the peripheral RC
    #: multiplier of the nearest region is ``(1 - region_span)`` times that
    #: of the farthest, which is the anchor (factor exactly 1.0, the
    #: per-DIMM worst-case profile every region-free table is built from).
    region_span: float = 0.25

    # ---- derived anchors (worst case at 85 °C == JEDEC, by construction) --
    @property
    def dv_floor(self) -> float:
        """Bitline differential of the worst-case cell at worst conditions."""
        return self.cs_alpha * self.c_min * self.v_full * self.ret85

    @property
    def t_sense_worst(self) -> float:
        return JEDEC_DDR3_1600.trcd - self.ovh_rcd

    @functools.cached_property
    def tau_sa(self) -> float:
        return _anchor(
            JEDEC_DDR3_1600.trcd - self.ovh_rcd, self.r_max,
            self.v_sense_target / self.dv_floor,
        )

    @functools.cached_property
    def tau_restore(self) -> float:
        return _anchor(
            JEDEC_DDR3_1600.tras - self.ovh_ras - self.t_sense_worst, self.r_max,
            (1.0 - self.v_restore_start) / (1.0 - self.v_full),
        )

    @functools.cached_property
    def tau_write(self) -> float:
        return _anchor(
            JEDEC_DDR3_1600.twr - self.ovh_wr, self.r_max,
            self.v_overdrive / (self.v_overdrive - self.v_full),
        )

    @functools.cached_property
    def tau_bl(self) -> float:
        return _anchor(
            JEDEC_DDR3_1600.trp - self.ovh_rp, self.r_max,
            self.v_half_swing / self.delta_floor,
        )

    def validate(self) -> None:
        """Raise ``ValueError`` unless the constants describe a physical cell
        (the reference's checks)."""
        checks = (
            ("0 <= region_span < 1", 0.0 <= self.region_span < 1.0),
            ("0 < ret85 < 1", 0.0 < self.ret85 < 1.0),
            ("0 < c_min < 1 and r_max > 1", 0.0 < self.c_min < 1.0 and self.r_max > 1.0),
            ("v_restore_start < v_full < v_overdrive",
             self.v_restore_start < self.v_full < self.v_overdrive),
            ("0 < dv_floor < v_sense_target", 0.0 < self.dv_floor < self.v_sense_target),
            ("every time constant > 0", min(self.tau_sa, self.tau_restore,
                                            self.tau_write, self.tau_bl) > 0.0),
        )
        failed = [name for name, ok in checks if not ok]
        if failed:
            raise ValueError(f"charge-model constants violate: {failed}")


DEFAULT_CONSTANTS = ChargeModelConstants()


def _temp(temp_c, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(temp_c, dtype=torch.float32, device=like.device)


# ---------------------------------------------------------------------------
# Temperature channels
# ---------------------------------------------------------------------------
def window_factor(temp_c: torch.Tensor) -> torch.Tensor:
    """Refresh-window multiplier: 1.0 up to and including 85 °C, 0.5 above."""
    return torch.where(temp_c > EXTENDED_TEMP_BOUNDARY_C, EXTENDED_WINDOW_FACTOR, 1.0)


def log_retention(cell: CellParams, temp_c, window_s: float = REFRESH_WINDOW_S,
                  consts: ChargeModelConstants = DEFAULT_CONSTANTS) -> torch.Tensor:
    """log charge fraction retained over one refresh window at ``temp_c``."""
    t = _temp(temp_c, cell.leak)
    temp_scale = 2.0 ** div(t - T_WORST_C, consts.leak_doubling_c)
    return (
        _f32_log(consts.ret85)
        * cell.leak
        * temp_scale
        * window_factor(t)
        * (window_s / REFRESH_WINDOW_S)
    )


def retention(cell: CellParams, temp_c, window_s: float = REFRESH_WINDOW_S,
              consts: ChargeModelConstants = DEFAULT_CONSTANTS) -> torch.Tensor:
    return torch.exp(log_retention(cell, temp_c, window_s, consts))


def drive_factor(temp_c, like: torch.Tensor,
                 consts: ChargeModelConstants = DEFAULT_CONSTANTS) -> torch.Tensor:
    """Write-driver speed factor ``(T_abs / 358.15 K)^mobility_exp``."""
    t_abs = _temp(temp_c, like) + 273.15
    return div(t_abs, T_WORST_C + 273.15) ** consts.mobility_exp


def quality_index(cell: CellParams,
                  consts: ChargeModelConstants = DEFAULT_CONSTANTS) -> torch.Tensor:
    """Peripheral quality q in [0, 1]: 0 = JEDEC corner, 1 = best silicon."""
    return div(consts.r_max - cell.r, consts.r_max - 1.0)


def apply_pattern(cell: CellParams, pattern) -> CellParams:
    """Fold a data-pattern margin factor into the effective capacitance."""
    return CellParams(r=cell.r, c=cell.c * pattern, leak=cell.leak)


# ---------------------------------------------------------------------------
# Per-region (design-induced) variation
# ---------------------------------------------------------------------------
def region_fracs(n_regions: int, device: str | torch.device = "cpu") -> torch.Tensor:
    """Normalized distance from the sense amplifiers of each region,
    ``(R,)`` float32: index 0 the nearest (fastest) class, index R-1 the
    farthest, frac exactly 1.0 (the anchor, whose effective cell is the
    per-DIMM worst-case profile). One region is the region-free model."""
    if n_regions < 1:
        raise ValueError(f"n_regions must be >= 1, got {n_regions}")
    idx = torch.arange(1, n_regions + 1, dtype=torch.float32, device=device)
    return div(idx, float(n_regions))


def region_factor(region_frac, consts: ChargeModelConstants = DEFAULT_CONSTANTS
                  ) -> torch.Tensor:
    """Peripheral-RC multiplier of a region at normalized distance
    ``region_frac`` in (0, 1]: linear in distance, exactly 1.0 at 1.0."""
    f = torch.as_tensor(region_frac, dtype=torch.float32)
    return 1.0 - consts.region_span * (1.0 - f)


def apply_region(cell: CellParams, region_frac,
                 consts: ChargeModelConstants = DEFAULT_CONSTANTS) -> CellParams:
    """Fold a region's distance class into the effective cell: distance is a
    peripheral (bitline/wordline RC) channel, so only ``r`` is scaled, and
    every min-safe timing is monotone non-decreasing in the region index.
    At the anchor the factor is 1.0 and ``r * 1.0`` is ``r`` bitwise."""
    f = torch.as_tensor(region_frac, dtype=torch.float32, device=cell.r.device)
    return CellParams(r=cell.r * region_factor(f, consts), c=cell.c, leak=cell.leak)


# ---------------------------------------------------------------------------
# Sensing, restore, precharge
# ---------------------------------------------------------------------------
def sense_dv0(cell: CellParams, temp_c, v_restored, window_s: float = REFRESH_WINDOW_S,
              consts: ChargeModelConstants = DEFAULT_CONSTANTS) -> torch.Tensor:
    """Initial bitline differential at the end of the refresh window."""
    v_access = v_restored * retention(cell, temp_c, window_s, consts)
    return consts.cs_alpha * cell.c * v_access


def sense_time(cell: CellParams, dv0: torch.Tensor,
               consts: ChargeModelConstants = DEFAULT_CONSTANTS) -> torch.Tensor:
    """Sense-amplifier latch time from an initial differential ``dv0``."""
    return cell.r * consts.tau_sa * torch.log(div(consts.v_sense_target, dv0))


def min_trcd(cell: CellParams, temp_c, v_restored=None, window_s: float = REFRESH_WINDOW_S,
             consts: ChargeModelConstants = DEFAULT_CONSTANTS) -> torch.Tensor:
    """Minimal safe tRCD (ns); ``v_restored`` defaults to a full restore
    (the individual profiling mode, other timings at JEDEC)."""
    v = consts.v_full if v_restored is None else v_restored
    dv0 = sense_dv0(cell, temp_c, v, window_s, consts)
    return consts.ovh_rcd + sense_time(cell, dv0, consts)


def restore_target(cell: CellParams, temp_c, window_s: float = REFRESH_WINDOW_S,
                   consts: ChargeModelConstants = DEFAULT_CONSTANTS) -> torch.Tensor:
    """Smallest restored voltage whose end-of-window differential still
    meets the worst-case floor (the paper's Figure-1 guarantee)."""
    ret = retention(cell, temp_c, window_s, consts)
    v_needed = div(consts.dv_floor, consts.cs_alpha * cell.c * ret)
    lo = consts.v_restore_start + 0.02
    return torch.clamp(v_needed, lo, consts.v_full)


def restore_time(cell: CellParams, v_tgt: torch.Tensor,
                 consts: ChargeModelConstants = DEFAULT_CONSTANTS) -> torch.Tensor:
    """Restore time from the post-latch level to ``v_tgt``."""
    return cell.r * consts.tau_restore * torch.log(
        div(1.0 - consts.v_restore_start, 1.0 - v_tgt)
    )


def min_tras(cell: CellParams, temp_c, window_s: float = REFRESH_WINDOW_S,
             consts: ChargeModelConstants = DEFAULT_CONSTANTS,
             v_tgt: torch.Tensor | None = None) -> torch.Tensor:
    """Minimal safe tRAS (ns): sensing from a full restore, then restore to
    the adaptive target (or ``v_tgt``)."""
    dv0 = sense_dv0(cell, temp_c, consts.v_full, window_s, consts)
    if v_tgt is None:
        v_tgt = restore_target(cell, temp_c, window_s, consts)
    return consts.ovh_ras + sense_time(cell, dv0, consts) + restore_time(cell, v_tgt, consts)


def write_time(cell: CellParams, v_tgt: torch.Tensor, temp_c,
               consts: ChargeModelConstants = DEFAULT_CONSTANTS) -> torch.Tensor:
    """Write-driver time from the opposite rail to ``v_tgt``."""
    return (
        cell.r
        * consts.tau_write
        * drive_factor(temp_c, cell.r, consts)
        * torch.log(div(consts.v_overdrive, consts.v_overdrive - v_tgt))
    )


def min_twr(cell: CellParams, temp_c, window_s: float = REFRESH_WINDOW_S,
            consts: ChargeModelConstants = DEFAULT_CONSTANTS,
            v_tgt: torch.Tensor | None = None) -> torch.Tensor:
    """Minimal safe tWR (ns): drive the cell to the adaptive target."""
    if v_tgt is None:
        v_tgt = restore_target(cell, temp_c, window_s, consts)
    return consts.ovh_wr + write_time(cell, v_tgt, temp_c, consts)


def tolerable_residual(cell: CellParams, temp_c,
                       consts: ChargeModelConstants = DEFAULT_CONSTANTS) -> torch.Tensor:
    """Bitline residual the next access can overcome."""
    q = quality_index(cell, consts)
    dt = div(T_WORST_C - _temp(temp_c, cell.r), 30.0)
    return consts.delta_floor * torch.exp(consts.pc_var * q + consts.pc_temp * dt)


def min_trp(cell: CellParams, temp_c, window_s: float = REFRESH_WINDOW_S,
            consts: ChargeModelConstants = DEFAULT_CONSTANTS) -> torch.Tensor:
    """Minimal safe tRP (ns); it does not depend on the restore."""
    delta = torch.clamp(tolerable_residual(cell, temp_c, consts),
                        max=0.4 * consts.v_half_swing)
    return consts.ovh_rp + cell.r * consts.tau_bl * torch.log(
        div(consts.v_half_swing, delta)
    )


def _wm_dv0(cell: CellParams, temp_c, window_s: float,
            consts: ChargeModelConstants) -> torch.Tensor:
    dt = div(T_WORST_C - _temp(temp_c, cell.r), 30.0)
    dv0 = sense_dv0(cell, temp_c, consts.v_full, window_s, consts)
    dv0 = dv0 * consts.wm_gain_rcd * torch.exp(consts.wm_temp * dt)
    return torch.clamp(dv0, max=consts.v_sense_target * 0.95)


def min_trcd_write(cell: CellParams, temp_c, window_s: float = REFRESH_WINDOW_S,
                   consts: ChargeModelConstants = DEFAULT_CONSTANTS) -> torch.Tensor:
    """Minimal tRCD for a write access (write-driver-assisted sensing)."""
    dv0 = _wm_dv0(cell, temp_c, window_s, consts)
    return consts.ovh_rcd + sense_time(cell, dv0, consts)


def min_trp_write(cell: CellParams, temp_c, window_s: float = REFRESH_WINDOW_S,
                  consts: ChargeModelConstants = DEFAULT_CONSTANTS) -> torch.Tensor:
    delta = tolerable_residual(cell, temp_c, consts) * consts.wm_gain_rp
    delta = torch.clamp(delta, max=0.4 * consts.v_half_swing)
    return consts.ovh_rp + cell.r * consts.tau_bl * torch.log(
        div(consts.v_half_swing, delta)
    )


def restore_under_write_time(cell: CellParams, v_tgt: torch.Tensor, temp_c,
                             consts: ChargeModelConstants = DEFAULT_CONSTANTS) -> torch.Tensor:
    """Row-restore time when the write driver overdrives the restore, from
    the post-latch level to ``v_tgt`` (the write-mode tRAS channel)."""
    tau = cell.r * consts.tau_write * drive_factor(temp_c, cell.r, consts)
    return tau * torch.log(
        div(consts.v_overdrive - consts.v_restore_start, consts.v_overdrive - v_tgt)
    )


def min_tras_write(cell: CellParams, temp_c, window_s: float = REFRESH_WINDOW_S,
                   consts: ChargeModelConstants = DEFAULT_CONSTANTS,
                   v_tgt: torch.Tensor | None = None) -> torch.Tensor:
    """Minimal safe tRAS for a write access (ns): write-assisted sensing,
    then restore under write drive to the adaptive target."""
    dv0 = _wm_dv0(cell, temp_c, window_s, consts)
    if v_tgt is None:
        v_tgt = restore_target(cell, temp_c, window_s, consts)
    return (
        consts.ovh_ras
        + sense_time(cell, dv0, consts)
        + restore_under_write_time(cell, v_tgt, temp_c, consts)
    )


# ---------------------------------------------------------------------------
# Forward correctness predicates (what the profiler tests)
# ---------------------------------------------------------------------------
def read_ok(cell: CellParams, timings: TimingParams, temp_c,
            window_s: float = REFRESH_WINDOW_S,
            consts: ChargeModelConstants = DEFAULT_CONSTANTS) -> torch.Tensor:
    """Does a read with these timings retrieve correct data?"""
    dv0 = sense_dv0(cell, temp_c, consts.v_full, window_s, consts)
    t_avail = timings.trcd - consts.ovh_rcd
    dv_reached = dv0 * torch.exp(div(t_avail, cell.r * consts.tau_sa))
    sense_pass = dv_reached >= consts.v_sense_target * (1.0 - _EPS)

    t_restore_avail = timings.tras - consts.ovh_ras - sense_time(cell, dv0, consts)
    v_reached = 1.0 - (1.0 - consts.v_restore_start) * torch.exp(
        -torch.clamp(t_restore_avail, min=0.0) / (cell.r * consts.tau_restore)
    )
    v_tgt = restore_target(cell, temp_c, window_s, consts)
    restore_pass = v_reached >= v_tgt * (1.0 - _EPS)

    delta_reached = consts.v_half_swing * torch.exp(
        div(-(timings.trp - consts.ovh_rp), cell.r * consts.tau_bl)
    )
    delta_ok = torch.clamp(tolerable_residual(cell, temp_c, consts),
                           max=0.4 * consts.v_half_swing)
    prech_pass = delta_reached <= delta_ok * (1.0 + _EPS)
    return sense_pass & restore_pass & prech_pass


def write_ok(cell: CellParams, timings: TimingParams, temp_c,
             window_s: float = REFRESH_WINDOW_S,
             consts: ChargeModelConstants = DEFAULT_CONSTANTS) -> torch.Tensor:
    """Does a write with these timings commit correct data?"""
    tau_wr = cell.r * consts.tau_write * drive_factor(temp_c, cell.r, consts)
    t_avail = timings.twr - consts.ovh_wr
    v_reached = consts.v_overdrive * (1.0 - torch.exp(div(-t_avail, tau_wr)))
    v_tgt = restore_target(cell, temp_c, window_s, consts)
    write_pass = v_reached >= v_tgt * (1.0 - _EPS)

    dv0w = _wm_dv0(cell, temp_c, window_s, consts)
    t_restore_avail = timings.tras - consts.ovh_ras - sense_time(cell, dv0w, consts)
    v_row = consts.v_overdrive - (
        consts.v_overdrive - consts.v_restore_start
    ) * torch.exp(-torch.clamp(t_restore_avail, min=0.0) / tau_wr)
    tras_pass = v_row >= v_tgt * (1.0 - _EPS)

    trcd_pass = timings.trcd >= min_trcd_write(cell, temp_c, window_s, consts) * (1.0 - _EPS)
    trp_pass = timings.trp >= min_trp_write(cell, temp_c, window_s, consts) * (1.0 - _EPS)
    return write_pass & tras_pass & trcd_pass & trp_pass

