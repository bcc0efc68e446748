"""Adaptive runtime controller — AL-DRAM's temperature loop, for load.

Ported from the reference (``src/repro/core/altune/runtime.py``). The
paper's controller maps (DIMM, temperature-bin) → timing set, with a guard
band, hysteresis (temperature drifts <0.1 °C/s) and a permanent error
fuse. Here the operating condition is the *measured step time / host
health*: a node running hot/slow gets the conservative config; a healthy
node in the fast bin runs the profiled aggressive one; a numerical error
fuses the unit back to the worst case.

The state machine IS the controller's — both advance through the shared
scalar kernel :func:`repro_torch.core.binning.advance_bin`. Two knobs
intentionally differ (documented there): this executor recovers one bin at
a time (``stepwise=True``) and uses no calm margin (``margin=0``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence

from repro_torch.core.binning import advance_bin, bin_index


@dataclasses.dataclass
class ConditionBins:
    """Condition = normalized load (e.g. step_time / baseline_step_time).
    Bin edges ascending; bin 0 is the healthiest (fastest config allowed)."""

    edges: Sequence[float] = (1.05, 1.2, 1.5)

    def bin_of(self, load: float) -> int:
        return bin_index(self.edges, load)


@dataclasses.dataclass
class _UnitState:
    bin_idx: int
    calm_streak: int = 0
    fused: bool = False


class AdaptiveExecutor:
    """Selects per-unit execution configs by condition bin.

    configs_by_bin[b] = config to use in bin b (b beyond the list, or a
    fused unit, gets ``worst_case``). Moving to a *worse* bin is immediate;
    recovering to a better bin needs ``hysteresis_steps`` calm readings —
    AL-DRAM's asymmetric switching, verbatim.
    """

    def __init__(
        self,
        configs_by_bin: Sequence[Any],
        worst_case: Any,
        bins: Optional[ConditionBins] = None,
        hysteresis_steps: int = 3,
    ):
        self.configs_by_bin = list(configs_by_bin)
        self.worst_case = worst_case
        self.bins = bins or ConditionBins()
        self.hysteresis_steps = hysteresis_steps
        self._units: Dict[str, _UnitState] = {}
        self.switches = 0
        self.fallbacks = 0

    def _state(self, unit: str) -> _UnitState:
        if unit not in self._units:
            self._units[unit] = _UnitState(bin_idx=len(self.bins.edges))
        return self._units[unit]

    def observe(self, unit: str, load: float) -> Any:
        st = self._state(unit)
        if st.fused:
            return self.worst_case
        st.bin_idx, st.calm_streak, switched = advance_bin(
            self.bins.edges,
            st.bin_idx,
            st.calm_streak,
            load,
            hysteresis_steps=self.hysteresis_steps,
            stepwise=True,
        )
        if switched:
            self.switches += 1
        return self.current(unit)

    def current(self, unit: str) -> Any:
        st = self._state(unit)
        if st.fused or st.bin_idx >= len(self.configs_by_bin):
            return self.worst_case
        return self.configs_by_bin[st.bin_idx]

    def report_error(self, unit: str) -> Any:
        """Numerical error → permanent fuse to the worst case (paper
        reliability guarantee; pair with checkpoint restore)."""
        self._state(unit).fused = True
        self.fallbacks += 1
        return self.worst_case
