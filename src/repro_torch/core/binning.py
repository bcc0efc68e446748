"""Shared bin-selection state machine — the scalar kernel of AL-DRAM.

Both embodiments of the paper's runtime mechanism select a pre-validated
configuration by binning a scalar operating condition (DRAM temperature in
:mod:`repro_torch.core.controller`, normalized load in
:mod:`repro_torch.core.altune.runtime`) with the same asymmetric discipline:
degrading to a more conservative bin is immediate, recovering to a more
aggressive one requires a sustained streak of calm readings (the paper's
hysteresis, justified by the <0.1 °C/s drift measurement). This module is
the single definition of that transition — plain Python — so the stateful
wrappers cannot drift apart; the vectorized path
(:func:`repro_torch.core.controller.step`) mirrors it in array form and is
tested bit-exact against it. The port keeps its own copy so that it never
imports the JAX package.

The embodiments intentionally differ in two knobs, both explicit here:

* ``margin`` — the DRAM controller only counts a reading as calm when it
  clears the target bin's edge by ``hysteresis_c`` (temperatures near an
  edge must not flap the timing registers). The altune executor uses
  ``margin=0``: any reading that bins better is calm, because load bins
  are already coarse ratios.
* ``stepwise`` — the DRAM controller recovers straight to the target bin
  (every bin's timing set was validated at boot, so the jump is safe);
  the altune executor recovers one bin at a time (execution configs are
  re-validated on the way up, so the ramp is deliberate).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

__all__ = ["bin_index", "advance_bin"]


def bin_index(edges: Sequence[float], value: float) -> int:
    """Index of the smallest bin covering ``value``.

    ``edges`` are ascending upper edges; returns the first ``b`` with
    ``value <= edges[b]``, or ``len(edges)`` (the beyond-last sentinel —
    JEDEC / worst-case) when ``value`` exceeds every edge. The single
    definition behind ``DimmTimingTable.lookup``, the controller's target
    selection and altune's ``ConditionBins.bin_of``."""
    for b, edge in enumerate(edges):
        if value <= edge:
            return b
    return len(edges)


def advance_bin(
    edges: Sequence[float],
    bin_idx: int,
    streak: int,
    value: float,
    *,
    guard: float = 0.0,
    margin: float = 0.0,
    hysteresis_steps: int = 1,
    stepwise: bool = False,
) -> Tuple[int, int, bool]:
    """One transition of the select state machine.

    ``value`` is the raw observation; ``guard`` is added before binning
    (the controller's always-assume-hotter guard band). Returns
    ``(bin_idx, streak, switched)``. The caller owns the error fuse —
    a fused unit must not be advanced at all.
    """
    v = value + guard
    target = bin_index(edges, v)
    if target > bin_idx:
        # More conservative: switch immediately (the safe direction).
        return target, 0, True
    if target < bin_idx:
        edge = edges[target] if target < len(edges) else math.inf
        streak = streak + 1 if v <= edge - margin else 0
        if streak >= hysteresis_steps:
            return (bin_idx - 1 if stepwise else target), 0, True
        return bin_idx, streak, False
    return bin_idx, 0, False
