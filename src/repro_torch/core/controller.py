"""AL-DRAM memory-controller mechanism (paper §1.4), in PyTorch.

* :class:`DimmTimingTable` — the controller's timing registers: one
  ``(n_dimms, n_bins, 2, 4)`` float32 stack (access axis read, write;
  ``PARAM_NAMES`` last) on the device, plus the bin edges. Temperatures
  above the last edge select JEDEC (the beyond-last sentinel row). A
  negative entry is the profiler's untested sentinel and is refused.
* The pure state machine: :class:`ControllerState` (``bin_idx`` /
  ``cool_streak`` / ``fused`` over the DIMM axis) advanced by :func:`step`
  — guard band, hysteresis on cooling, immediate degrade on heating, and
  an error fuse that drops a DIMM to JEDEC for good.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.core.timing import ACCESS_TYPES, JEDEC_DDR3_1600, PARAM_NAMES

#: Temperature bins (°C upper edges) for which timing sets are profiled.
DEFAULT_TEMP_BINS: Tuple[float, ...] = (45.0, 55.0, 65.0, 75.0, 85.0)

#: Guard band added to the measured temperature before bin selection.
GUARD_BAND_C: float = 5.0

#: Hysteresis: switch to a cooler bin only after the temperature stayed
#: below the bin edge minus this margin for ``HYSTERESIS_STEPS`` steps.
HYSTERESIS_C: float = 2.0
HYSTERESIS_STEPS: int = 3

#: JEDEC (2, 4) sentinel rows, selected beyond the last bin or after a fuse.
JEDEC_ROWS: Tuple[Tuple[float, ...], ...] = (
    tuple(getattr(JEDEC_DDR3_1600, p) for p in PARAM_NAMES),
) * len(ACCESS_TYPES)


def jedec_rows(device: str | torch.device) -> torch.Tensor:
    return torch.tensor(JEDEC_ROWS, dtype=torch.float32, device=device)


@dataclasses.dataclass(eq=False)
class DimmTimingTable:
    """Per-DIMM, per-access-type timing sets, one per temperature bin.

    ``stack[dimm, bin]`` is a ``(2, 4)`` block (read set, write set; ns).
    ``refresh`` must be ``None``: refresh policies are not ported yet."""

    temp_bins: Tuple[float, ...]
    stack: torch.Tensor
    refresh: None = None

    def __post_init__(self) -> None:
        if self.refresh is not None:
            raise NotImplementedError(
                "refresh.py and a table's refresh policy are not ported yet"
            )
        self.temp_bins = tuple(float(t) for t in self.temp_bins)
        if list(self.temp_bins) != sorted(set(self.temp_bins)):
            raise ValueError(f"temp_bins must ascend strictly, got {self.temp_bins}")
        self.stack = torch.as_tensor(self.stack, dtype=torch.float32)
        if self.stack.dim() == 5:
            raise NotImplementedError(
                "regions (sweep_regions, schema v5) are not ported yet"
            )
        tail = (len(ACCESS_TYPES), len(PARAM_NAMES))
        if self.stack.dim() != 4 or tuple(self.stack.shape[1:]) != (self.n_bins,) + tail:
            raise ValueError(
                f"stack shape {tuple(self.stack.shape)} does not match "
                f"{self.n_bins} bins × {tail[0]} access types × {tail[1]} params"
            )
        if bool((self.stack < 0.0).any()):
            raise ValueError(
                "timing stack contains negative entries (the profiler's "
                "untested sentinel): refusing to program untested timings"
            )

    @property
    def n_dimms(self) -> int:
        return int(self.stack.shape[0])

    @property
    def n_bins(self) -> int:
        return len(self.temp_bins)

    @property
    def device(self) -> torch.device:
        return self.stack.device

    def oblivious_stack(self) -> torch.Tensor:
        """The ``(n_dimms, n_bins, 2, 4)`` registers (region-free tables
        only, so this is :attr:`stack` itself)."""
        return self.stack

    @classmethod
    def from_fleet(cls, result, temp_bins: Optional[Sequence[float]] = None
                   ) -> "DimmTimingTable":
        """Transpose a :class:`~repro_torch.core.fleet.SweepResult`'s
        ``(T, N, 2, 4)`` stacked sets into ``(N, T, 2, 4)`` registers, on the
        sweep's device. The bin edges are the sweep's exact temperatures
        unless ``temp_bins`` overrides them."""
        if temp_bins is None:
            temp_bins = result.bin_edges()
        elif len(temp_bins) != result.read.shape[0]:
            raise ValueError(
                f"{len(temp_bins)} temp_bins for a "
                f"{result.read.shape[0]}-temperature sweep"
            )
        stack = result.stacked_timings().permute(1, 0, 2, 3).contiguous()
        return cls(temp_bins=tuple(temp_bins), stack=stack)


# ---------------------------------------------------------------------------
# Pure state machine
# ---------------------------------------------------------------------------
class ControllerParams(NamedTuple):
    """Static policy of the runtime selector."""

    guard_band_c: float = GUARD_BAND_C
    hysteresis_c: float = HYSTERESIS_C
    hysteresis_steps: int = HYSTERESIS_STEPS


class ControllerState(NamedTuple):
    """Per-DIMM controller registers. ``bin_idx`` may hold the beyond-last
    sentinel ``n_bins``; ``fused`` DIMMs are frozen at JEDEC forever."""

    bin_idx: torch.Tensor      # (N,) int32
    cool_streak: torch.Tensor  # (N,) int32
    fused: torch.Tensor        # (N,) bool


def init_state(n_dimms: int, n_bins: int,
               device: str | torch.device = "cuda") -> ControllerState:
    """Boot state: every DIMM in the most conservative profiled bin."""
    return ControllerState(
        bin_idx=torch.full((n_dimms,), n_bins - 1, dtype=torch.int32, device=device),
        cool_streak=torch.zeros((n_dimms,), dtype=torch.int32, device=device),
        fused=torch.zeros((n_dimms,), dtype=torch.bool, device=device),
    )


def step(
    stack: torch.Tensor,
    edges: torch.Tensor,
    params: ControllerParams,
    state: ControllerState,
    temps_c: torch.Tensor,
    errors: Optional[torch.Tensor] = None,
) -> Tuple[ControllerState, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Advance the whole fleet one observation.

    ``stack`` (N, B, 2, 4) float32, ``edges`` (B,) float32, ``temps_c`` /
    ``errors`` (N,). Errors fuse before the temperature is considered.
    Returns ``(state, rows (N, 2, 4), switched (N,), effective_bin (N,))``;
    the effective bin ``n_bins`` is the JEDEC sentinel."""
    n_bins = edges.shape[0]
    fused = state.fused if errors is None else state.fused | errors.to(torch.bool)
    t_eff = temps_c + params.guard_band_c
    target = torch.searchsorted(edges, t_eff, right=False).to(torch.int32)
    hotter = target > state.bin_idx
    cooler = target < state.bin_idx
    target_edge = torch.where(
        target < n_bins, edges[target.clamp(0, n_bins - 1).long()], torch.inf
    )
    calm = t_eff <= target_edge - params.hysteresis_c
    streak_if_cooler = torch.where(calm, state.cool_streak + 1, 0)
    recover = cooler & (streak_if_cooler >= params.hysteresis_steps)
    new_bin = torch.where(hotter | recover, target, state.bin_idx)
    new_streak = torch.where(cooler & ~recover, streak_if_cooler, 0)
    switched = (hotter | recover) & ~fused
    # A fused DIMM's registers are frozen.
    new_bin = torch.where(fused, state.bin_idx, new_bin)
    new_streak = torch.where(fused, state.cool_streak, new_streak)
    eff_bin = torch.where(fused, n_bins, new_bin).to(torch.int32)
    picked = stack[torch.arange(stack.shape[0], device=stack.device),
                   new_bin.clamp(0, n_bins - 1).long()]
    rows = torch.where((eff_bin >= n_bins)[:, None, None],
                       jedec_rows(stack.device), picked)
    return ControllerState(new_bin, new_streak.to(torch.int32), fused), rows, switched, eff_bin
