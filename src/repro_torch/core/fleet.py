"""Fleet-scale DIMM characterization: the whole (temperature × pattern ×
DIMM) study as one fused charge-sweep search.

A fleet is struct-of-arrays (:class:`Fleet`): one tensor per physical
quantity over the DIMM axis. :func:`sweep` broadcasts the cells against
the temperature and pattern grids, hoists the per-cell invariants and runs
all seven min-safe searches of every grid point in ONE call of the fused
search (the CUDA kernel for a fleet on the card). :class:`SweepResult`
holds the ``(T, P, N, 4)`` read and write stacks and hands the per-access
sets at the guarantee pattern to the controller's
:class:`~repro_torch.core.controller.DimmTimingTable`.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.core import charge, dimm
from repro_torch.core.charge import CellParams, ChargeModelConstants, DEFAULT_CONSTANTS
from repro_torch.kernels.charge_sweep import ops as charge_sweep

#: Default characterization temperatures (°C).
DEFAULT_TEMPS_C: Tuple[float, ...] = (45.0, 55.0, 65.0, 75.0, 85.0)

#: Default data-pattern margin factors (worst-case first).
DEFAULT_PATTERNS: Tuple[float, ...] = (1.0, 1.02, 1.03, 1.08)


class Fleet(NamedTuple):
    """A DIMM population in struct-of-arrays layout."""

    cells: CellParams      # leaves shaped (n_dimms,) float32
    vendor: torch.Tensor   # (n_dimms,) int32 vendor index

    @property
    def n_dimms(self) -> int:
        return int(self.cells.r.shape[0])


def vendor_split(n_dimms: int) -> Tuple[int, ...]:
    """The paper's 40/40/35 vendor split scaled to ``n_dimms``."""
    base = dimm.VENDOR_SPLIT
    split = [n_dimms * b // sum(base) for b in base]
    split[0] += n_dimms - sum(split)
    return tuple(split)


def synthesize(
    generator: torch.Generator,
    n_dimms: int,
    vendors: Sequence[dimm.VendorModel] = dimm.VENDORS,
    consts: ChargeModelConstants = DEFAULT_CONSTANTS,
    device: str | torch.device = "cuda",
) -> Fleet:
    """Sample a synthetic fleet of ``n_dimms`` modules on ``device``."""
    cells, vidx = dimm.sample_population(
        generator, n_dimms=n_dimms, vendors=vendors, split=vendor_split(n_dimms),
        consts=consts, device=device,
    )
    return Fleet(cells=cells, vendor=vidx)


class SweepResult(NamedTuple):
    """Dense characterization output over the (temp × pattern × DIMM) grid.
    Stacks are ns, cycle-quantized, last axis in ``PARAM_NAMES`` order."""

    temps_c: torch.Tensor   # (T,)
    patterns: torch.Tensor  # (P,)
    read: torch.Tensor      # (T, P, N, 4) read-mode minima
    write: torch.Tensor     # (T, P, N, 4) write-mode minima
    #: The caller's exact Python temperatures (bin edges come from here).
    temps_exact: Tuple[float, ...] = ()

    def bin_edges(self) -> Tuple[float, ...]:
        return self.temps_exact or tuple(float(t) for t in self.temps_c.tolist())

    def _guarantee_pattern_idx(self) -> int:
        """Worst-pattern index, refusing sweeps that never tested the
        guarantee pattern (margin factor 1.0)."""
        p = int(torch.argmin(self.patterns))
        worst = float(self.patterns[p])
        if worst > 1.0:
            raise ValueError(
                f"sweep lacks the worst-case guarantee pattern: min margin "
                f"factor is {worst} (> 1.0); re-sweep with pattern 1.0 "
                "before programming controller tables"
            )
        return p

    def read_timings(self) -> torch.Tensor:
        """(T, N, 4) read-access sets at the worst-case pattern."""
        return self.read[:, self._guarantee_pattern_idx()]

    def write_timings(self) -> torch.Tensor:
        """(T, N, 4) write-access sets at the worst-case pattern."""
        w = self.write[:, self._guarantee_pattern_idx()]
        if bool((w < 0.0).any()):
            raise ValueError("write-mode sweep carries an untested (negative) "
                             "entry: refusing to program it")
        return w

    def stacked_timings(self) -> torch.Tensor:
        """(T, N, 2, 4) per-access-type sets (read, write) at the worst-case
        pattern: what :class:`DimmTimingTable` ingests."""
        return torch.stack([self.read_timings(), self.write_timings()], dim=-2)

    def to_table(self):
        """Build the controller's :class:`DimmTimingTable` from the sweep."""
        from repro_torch.core.controller import DimmTimingTable

        return DimmTimingTable.from_fleet(self)


def sweep(
    fleet: Fleet | CellParams,
    temps_c: Sequence[float] = DEFAULT_TEMPS_C,
    patterns: Sequence[float] = DEFAULT_PATTERNS,
    window_s: float = charge.REFRESH_WINDOW_S,
    consts: ChargeModelConstants = DEFAULT_CONSTANTS,
) -> SweepResult:
    """Characterize a whole fleet over the (T, P, N) grid in one fused
    search, on the fleet's own device. ``read`` / ``write`` are
    ``(T, P, n_dimms, 4)`` ns."""
    cells = fleet.cells if isinstance(fleet, Fleet) else fleet
    dev = resolve_device(cells.r.device)
    t = torch.tensor([float(x) for x in temps_c], dtype=torch.float32, device=dev)
    p = torch.tensor([float(x) for x in patterns], dtype=torch.float32, device=dev)
    eff = charge.apply_pattern(
        CellParams(*(a[None, None, :] for a in cells)), p[None, :, None]
    )
    read, write = charge_sweep.sweep_min_timings(eff, t[:, None, None], window_s, consts)
    return SweepResult(
        temps_c=t, patterns=p, read=read, write=write,
        temps_exact=tuple(float(x) for x in temps_c),
    )
