"""Temperature-driven DRAM refresh model (tREFI / tRFC), in PyTorch.

Above the 85 °C extended-temperature boundary DDR3 mandates 2× refresh
(tREFI halved); LPDDR-style temperature-compensated refresh goes to 4×.
Every tREFI the rank executes one REFRESH and is unavailable for tRFC, so a
hot DIMM pays twice: slower timing registers and more time lost to refresh.

* :class:`RefreshPolicy` — the temperature → refresh-rate-multiplier
  staircase plus the base tREFI / tRFC. :data:`DDR3_EXTENDED` is the
  standard 1×/2× policy, :data:`DDR3_EXTENDED_4X` the 1×/2×/4× variant.
* :func:`multiplier_at` / :func:`occupancy_at` — the multiplier and the
  refresh occupancy at raw temperatures; a temperature exactly on a
  boundary belongs to the cooler side, as in
  :func:`repro_torch.core.charge.window_factor`.
* :func:`bin_refresh` — the per-effective-bin :class:`BinRefresh` load of
  a controller bin grid: each profiled bin carries the multiplier at its
  upper edge, the beyond-last JEDEC sentinel the policy's last multiplier.

The occupancy is a function of the selected bin, so the score partials'
time-in-bin counts already carry everything refresh scoring needs; refresh
enters at finalize only (:mod:`repro_torch.core.perfmodel`, ``refresh=``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence, Tuple

import torch

from repro_torch.core.charge import EXTENDED_TEMP_BOUNDARY_C

#: Base average refresh interval, ns: the 64 ms retention window over the
#: 8192 row-refresh commands of a DDR3 device (7.8125 µs).
TREFI_BASE_NS: float = 64e6 / 8192.0

#: Refresh cycle time, ns: how long the rank is unavailable per REFRESH
#: command (JESD79-3F, 4 Gb density class).
TRFC_NS: float = 260.0


@dataclasses.dataclass(frozen=True)
class RefreshPolicy:
    """Temperature → refresh-rate-multiplier staircase (frozen, hashable).

    ``multipliers[i]`` applies to temperatures in
    ``(boundaries[i-1], boundaries[i]]`` (first segment: up to and including
    ``boundaries[0]``; last: strictly above ``boundaries[-1]``). The
    staircase must be non-decreasing."""

    boundaries: Tuple[float, ...] = (EXTENDED_TEMP_BOUNDARY_C,)
    multipliers: Tuple[float, ...] = (1.0, 2.0)
    trefi_base_ns: float = TREFI_BASE_NS
    trfc_ns: float = TRFC_NS

    def __post_init__(self) -> None:
        if len(self.multipliers) != len(self.boundaries) + 1:
            raise ValueError(
                f"{len(self.boundaries)} boundaries need "
                f"{len(self.boundaries) + 1} multipliers, got {len(self.multipliers)}"
            )
        if tuple(sorted(self.boundaries)) != self.boundaries:
            raise ValueError(f"boundaries must be sorted: {self.boundaries}")
        if any(m <= 0.0 for m in self.multipliers):
            raise ValueError(f"multipliers must be positive: {self.multipliers}")
        if tuple(sorted(self.multipliers)) != self.multipliers:
            raise ValueError("refresh-rate multipliers must be non-decreasing in "
                             f"temperature: {self.multipliers}")
        if not (self.trefi_base_ns > 0.0 and self.trfc_ns > 0.0):
            raise ValueError("tREFI and tRFC must be positive")
        if self.trfc_ns * max(self.multipliers) >= self.trefi_base_ns:
            raise ValueError(
                f"refresh occupancy would reach 100%: max multiplier "
                f"{max(self.multipliers)} × tRFC {self.trfc_ns} ns ≥ tREFI "
                f"{self.trefi_base_ns} ns"
            )

    def occupancy_of(self, multiplier: float) -> float:
        """Fraction of time the rank spends refreshing at a multiplier."""
        return float(multiplier) * self.trfc_ns / self.trefi_base_ns


#: The DDR3 standard policy: 1× up to 85 °C, 2× in the extended range.
DDR3_EXTENDED = RefreshPolicy()

#: Pluggable aggressive policy: LPDDR-style 4× above 95 °C.
DDR3_EXTENDED_4X = RefreshPolicy(boundaries=(EXTENDED_TEMP_BOUNDARY_C, 95.0),
                                 multipliers=(1.0, 2.0, 4.0))


def multiplier_at(policy: RefreshPolicy, temp_c) -> torch.Tensor:
    """float32 refresh-rate multiplier at raw temperature(s) ``temp_c`` (a
    boundary itself belongs to the cooler segment)."""
    t = torch.as_tensor(temp_c, dtype=torch.float32)
    bounds = torch.tensor(policy.boundaries, dtype=torch.float32, device=t.device)
    idx = torch.searchsorted(bounds, t.reshape(-1), right=False).reshape(t.shape)
    mults = torch.tensor(policy.multipliers, dtype=torch.float32, device=t.device)
    return mults[idx]


def occupancy_at(policy: RefreshPolicy, temp_c) -> torch.Tensor:
    """Refresh occupancy (fraction of time lost to REFRESH) at raw
    temperature(s), float32."""
    return multiplier_at(policy, temp_c) * (policy.trfc_ns / policy.trefi_base_ns)


class BinRefresh(NamedTuple):
    """Per-effective-bin refresh load of one bin grid: ``occupancy[b]`` while
    the selected effective bin is ``b`` (the last entry is the JEDEC
    sentinel), and ``trfc_ns`` for the expected-blocking latency term."""

    occupancy: Tuple[float, ...]  # (n_bins + 1,)
    trfc_ns: float


def bin_multipliers(policy: RefreshPolicy, temp_bins: Sequence[float]) -> Tuple[float, ...]:
    """Refresh-rate multiplier per effective bin (length ``n_bins + 1``):
    each profiled bin's at its upper edge, the sentinel's the policy's last."""
    edges = tuple(float(t) for t in temp_bins)
    if edges != tuple(sorted(edges)):
        raise ValueError(f"temp_bins must be sorted: {edges}")
    at_edges = multiplier_at(policy, torch.tensor(edges, dtype=torch.float32))
    return tuple(float(m) for m in at_edges.tolist()) + (float(policy.multipliers[-1]),)


def bin_refresh(policy: RefreshPolicy, temp_bins: Sequence[float]) -> BinRefresh:
    """The :class:`BinRefresh` load of a bin grid under ``policy`` — what the
    ``refresh=`` parameter of the ``trace_score`` family consumes."""
    occ = policy.trfc_ns / policy.trefi_base_ns
    return BinRefresh(occupancy=tuple(m * occ for m in bin_multipliers(policy, temp_bins)),
                      trfc_ns=policy.trfc_ns)
