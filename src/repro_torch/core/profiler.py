"""DRAM latency profiler (paper §1.5), in PyTorch.

For each DIMM and temperature the profiler tests progressively reduced
timings with worst-case data patterns and keeps the smallest that pass.
Three pure stack functions map ``(cells, temp_c, pattern)`` to a
``(..., 4)`` timing stack (``PARAM_NAMES`` columns, ns, cycle-quantized):

* :func:`individual_min_timings` — one parameter reduced, the others at
  JEDEC (the §1.5 per-parameter figures);
* :func:`write_mode_min_timings` — the write test (Fig. 2b), tRAS through
  the restore-under-write path;
* :func:`joint_min_timings` — all four reduced together (§1.7): the
  closed-form minima given the reduced restore, rounded up to the clock.

The first two are grid searches of the forward predicates and run the fused
charge-sweep search (:func:`repro_torch.kernels.charge_sweep.ops.sweep_min_timings`):
the plain version on a CPU tensor, the CUDA kernel on a card. The joint
stack has no search and no kernel in the reference either; it is eager
torch on the cells' device. ``profile_*`` wrap the stacks in per-parameter
dicts; :func:`fig2_summary` and :func:`repeatability` are the paper's Fig. 2
lines and its §1.7 repeatability figure.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Tuple

import torch

from repro_torch.core import charge
from repro_torch.core.charge import CellParams, ChargeModelConstants, DEFAULT_CONSTANTS, div
from repro_torch.core.timing import (
    JEDEC_DDR3_1600,
    PARAM_NAMES,
    TCK_DDR3_1600_NS,
    TimingParams,
)
from repro_torch.kernels.charge_sweep import ops as charge_sweep

#: Test data patterns, as effective-margin multipliers (1.0 = the worst-case
#: coupling pattern every safety claim is made against).
PATTERNS: Mapping[str, float] = {
    "checkerboard": 1.00,
    "inv_checker": 1.00,
    "walking_ones": 1.03,
    "walking_zeros": 1.03,
    "all_zeros": 1.08,
    "all_ones": 1.08,
    "random": 1.02,
}

#: JEDEC baseline as a (4,) vector in ``PARAM_NAMES`` order.
JEDEC_VEC: Tuple[float, float, float, float] = tuple(
    getattr(JEDEC_DDR3_1600, p) for p in PARAM_NAMES
)

#: Sentinel (ns) for a timing that was not tested in the current profiling
#: mode. A negative timing is impossible, so every table builder refuses it
#: instead of programming JEDEC behind the caller's back.
WRITE_TRAS_UNTESTED_NS: float = -1.0

#: Accepted ``tras_mode`` values for :func:`write_mode_min_timings`.
WRITE_TRAS_MODES: Tuple[str, str] = ("profiled", "untested")


@dataclasses.dataclass(frozen=True)
class ProfileResult:
    """Per-DIMM minimal safe timings (ns, cycle-quantized) and reductions."""

    timings: Dict[str, torch.Tensor]      # param -> (n_dimms,) ns
    reductions: Dict[str, torch.Tensor]   # param -> (n_dimms,) fraction
    temp_c: float
    window_s: float

    def mean_reductions(self) -> Dict[str, float]:
        return {k: float(v.mean()) for k, v in self.reductions.items()}

    def min_max_reductions(self) -> Dict[str, Tuple[float, float]]:
        return {k: (float(v.min()), float(v.max())) for k, v in self.reductions.items()}


def _effective(cells: CellParams, pattern, region_frac,
               consts: ChargeModelConstants) -> CellParams:
    """The cells with a data pattern folded in and, unless ``region_frac``
    is ``None`` (the region-free computation, unchanged), a region class."""
    eff = charge.apply_pattern(cells, pattern)
    if region_frac is not None:
        eff = charge.apply_region(eff, region_frac, consts)
    return eff


def _jedec(like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(JEDEC_VEC, dtype=torch.float32, device=like.device).broadcast_to(
        like.shape)


# ---------------------------------------------------------------------------
# Pure stack functions
# ---------------------------------------------------------------------------
def individual_min_timings(
    cells: CellParams,
    temp_c,
    pattern=1.0,
    window_s: float = charge.REFRESH_WINDOW_S,
    consts: ChargeModelConstants = DEFAULT_CONSTANTS,
    *,
    region_frac=None,
) -> torch.Tensor:
    """Per-parameter minimal safe timings, the others at JEDEC (§1.5):
    ``(broadcast shape of cells and temp_c, 4)`` ns. Both access modes come
    out of one fused search; batch callers wanting both stacks call
    :func:`~repro_torch.kernels.charge_sweep.ops.sweep_min_timings` once,
    as ``fleet.sweep`` does. ``region_frac`` folds a distance-from-sense-amp
    class into the effective cell (:func:`charge.apply_region`)."""
    eff = _effective(cells, pattern, region_frac, consts)
    read, _ = charge_sweep.sweep_min_timings(eff, temp_c, window_s, consts)
    return read


def untested_tras(write: torch.Tensor) -> torch.Tensor:
    """``write`` with its tRAS column set to :data:`WRITE_TRAS_UNTESTED_NS`."""
    out = write.clone()
    out[..., PARAM_NAMES.index("tras")] = WRITE_TRAS_UNTESTED_NS
    return out


def write_mode_min_timings(
    cells: CellParams,
    temp_c,
    pattern=1.0,
    window_s: float = charge.REFRESH_WINDOW_S,
    consts: ChargeModelConstants = DEFAULT_CONSTANTS,
    tras_mode: str = "profiled",
    *,
    region_frac=None,
) -> torch.Tensor:
    """Write-test minimal timings for all four parameters (Fig. 2b):
    ``(..., 4)`` ns. ``tras_mode="untested"`` fills the tRAS column with
    :data:`WRITE_TRAS_UNTESTED_NS`, which every table builder refuses (for
    tests of that refusal, never for real tables). ``region_frac`` as in
    :func:`individual_min_timings`."""
    if tras_mode not in WRITE_TRAS_MODES:
        raise ValueError(f"tras_mode must be one of {WRITE_TRAS_MODES}, got {tras_mode!r}")
    eff = _effective(cells, pattern, region_frac, consts)
    _, write = charge_sweep.sweep_min_timings(eff, temp_c, window_s, consts)
    return untested_tras(write) if tras_mode == "untested" else write


def joint_raw_timings(
    cells: CellParams,
    temp_c,
    restore_scale=1.0,
    window_s: float = charge.REFRESH_WINDOW_S,
    consts: ChargeModelConstants = DEFAULT_CONSTANTS,
) -> torch.Tensor:
    """The simultaneous-reduction minima before the clock rounding:
    ``(..., 4)`` ns. The restore target is the minimal one scaled by
    ``restore_scale`` (1.0 = maximally reduced, capped at a full restore);
    tRAS and tWR restore to it and tRCD senses from it."""
    v_tgt_min = charge.restore_target(cells, temp_c, window_s, consts)
    v_tgt = torch.clamp(torch.maximum(v_tgt_min * restore_scale, v_tgt_min),
                        max=consts.v_full)
    tras = charge.min_tras(cells, temp_c, window_s, consts, v_tgt=v_tgt)
    twr = charge.min_twr(cells, temp_c, window_s, consts, v_tgt=v_tgt)
    trcd = charge.min_trcd(cells, temp_c, v_restored=v_tgt, window_s=window_s, consts=consts)
    trp = charge.min_trp(cells, temp_c, window_s, consts)
    return torch.stack(torch.broadcast_tensors(trcd, tras, twr, trp), dim=-1)


def joint_min_timings(
    cells: CellParams,
    temp_c,
    restore_scale=1.0,
    window_s: float = charge.REFRESH_WINDOW_S,
    consts: ChargeModelConstants = DEFAULT_CONSTANTS,
) -> torch.Tensor:
    """Simultaneous-reduction minimal timings (§1.7): the minima of
    :func:`joint_raw_timings` rounded up to whole clock cycles (one float32
    division on every device) and capped at JEDEC. ``(..., 4)`` ns."""
    tck = TCK_DDR3_1600_NS
    quantized = torch.ceil(div(joint_raw_timings(cells, temp_c, restore_scale, window_s,
                                                 consts), tck)) * tck
    return torch.minimum(quantized, _jedec(quantized))


def stack_reductions(timings: torch.Tensor) -> torch.Tensor:
    """Fractional reduction vs JEDEC of a ``(..., 4)`` timing stack."""
    return 1.0 - timings / _jedec(timings)


def _unstack(timings: torch.Tensor) -> Dict[str, torch.Tensor]:
    return {p: timings[..., i] for i, p in enumerate(PARAM_NAMES)}


def _result(timings: torch.Tensor, temp_c: float, window_s: float) -> ProfileResult:
    return ProfileResult(_unstack(timings), _unstack(stack_reductions(timings)),
                         temp_c, window_s)


# ---------------------------------------------------------------------------
# One (temperature, pattern) point at a time
# ---------------------------------------------------------------------------
def profile_individual(cells: CellParams, temp_c: float,
                       window_s: float = charge.REFRESH_WINDOW_S,
                       consts: ChargeModelConstants = DEFAULT_CONSTANTS,
                       pattern: float = 1.0) -> ProfileResult:
    """Per-parameter minimal safe timings, the others at JEDEC (§1.5)."""
    t = individual_min_timings(cells, temp_c, pattern, window_s, consts)
    return _result(t, temp_c, window_s)


def profile_write_mode(cells: CellParams, temp_c: float,
                       window_s: float = charge.REFRESH_WINDOW_S,
                       consts: ChargeModelConstants = DEFAULT_CONSTANTS,
                       pattern: float = 1.0) -> ProfileResult:
    """Write-test minimal timings for all four parameters (Fig. 2b)."""
    t = write_mode_min_timings(cells, temp_c, pattern, window_s, consts)
    return _result(t, temp_c, window_s)


def profile_joint(cells: CellParams, temp_c: float,
                  window_s: float = charge.REFRESH_WINDOW_S,
                  consts: ChargeModelConstants = DEFAULT_CONSTANTS,
                  restore_scale: float = 1.0) -> ProfileResult:
    """Simultaneous reduction (§1.7): with ``restore_scale`` 1 the next
    access sees exactly the floor charge, so tRCD has no slack left."""
    t = joint_min_timings(cells, temp_c, restore_scale, window_s, consts)
    return _result(t, temp_c, window_s)


# ---------------------------------------------------------------------------
# Fig. 2 aggregates
# ---------------------------------------------------------------------------
def latency_sums(read: ProfileResult, write: ProfileResult) -> Dict[str, torch.Tensor]:
    """Per-DIMM read and write latency sums (the y-axes of Fig. 2)."""
    r, w = read.timings, write.timings
    return {"read_sum_ns": r["trcd"] + r["tras"] + r["trp"],
            "write_sum_ns": w["trcd"] + w["twr"] + w["trp"]}


def fig2_summary(cells: CellParams, temp_c: float,
                 window_s: float = charge.REFRESH_WINDOW_S,
                 consts: ChargeModelConstants = DEFAULT_CONSTANTS) -> Dict[str, float]:
    """Mean read and write latency reductions at ``temp_c`` (Fig. 2 lines),
    with each parameter's (tWR from the write test)."""
    read = profile_individual(cells, temp_c, window_s, consts)
    write = profile_write_mode(cells, temp_c, window_s, consts)
    sums = latency_sums(read, write)
    out = {
        "read_reduction": float(1.0 - (sums["read_sum_ns"] / JEDEC_DDR3_1600.read_sum).mean()),
        "write_reduction": float(
            1.0 - (sums["write_sum_ns"] / JEDEC_DDR3_1600.write_sum).mean()),
    }
    out.update({f"{p}_reduction": v for p, v in read.mean_reductions().items()})
    out["twr_reduction"] = write.mean_reductions()["twr"]
    return out


# ---------------------------------------------------------------------------
# Repeatability (§1.7)
# ---------------------------------------------------------------------------
def repeatability_from_normals(
    normals: torch.Tensor,
    cells: CellParams,
    temp_c: float,
    noise: float = 0.006,
    window_s: float = charge.REFRESH_WINDOW_S,
    consts: ChargeModelConstants = DEFAULT_CONSTANTS,
) -> Dict[str, float]:
    """:func:`repeatability` on given standard-normal draws ``normals``,
    ``(n_trials, n_dimms)``: trial k scales each DIMM's capacitance by
    ``1 + noise · normals[k]`` and retests a tRCD one cycle below its
    profiled minimum (the other timings at JEDEC)."""
    prof = profile_individual(cells, temp_c, window_s, consts)
    trcd_minus = prof.timings["trcd"] - TCK_DDR3_1600_NS
    eps = 1.0 + noise * normals.to(torch.float32)
    eff = CellParams(r=cells.r, c=cells.c * eps, leak=cells.leak)
    base = JEDEC_DDR3_1600
    oks = charge.read_ok(eff, TimingParams(trcd_minus, base.tras, base.twr, base.trp),
                         temp_c, window_s, consts)                       # (T, n)
    fails = ~oks
    ever_fails = fails.any(dim=0)
    always_fails = fails.all(dim=0)
    n_ever = max(int(ever_fails.sum()), 1)
    return {
        "repeat_fraction": float(div(always_fails.sum().to(torch.float32), float(n_ever))),
        "ever_fail_fraction": float(ever_fails.to(torch.float32).mean()),
        "n_trials": int(normals.shape[0]),
    }


def repeatability(
    generator: torch.Generator,
    cells: CellParams,
    temp_c: float,
    n_trials: int = 10,
    noise: float = 0.006,
    window_s: float = charge.REFRESH_WINDOW_S,
    consts: ChargeModelConstants = DEFAULT_CONSTANTS,
) -> Dict[str, float]:
    """Fraction of DIMMs whose failure at a slightly too aggressive timing
    repeats in every one of ``n_trials`` noisy trials (paper: > 95 %). The
    measurement noise is drawn from ``generator`` (on the cells' device);
    :func:`repeatability_from_normals` does the work."""
    normals = torch.randn((n_trials,) + tuple(cells.c.shape), generator=generator,
                          dtype=torch.float32, device=cells.c.device)
    return repeatability_from_normals(normals, cells, temp_c, noise, window_s, consts)
