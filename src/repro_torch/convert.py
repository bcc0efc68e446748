"""State carried across packages, as numpy arrays.

This system has no model weights; what a deployment carries is state: the
fleet's cell parameters and vendor index, a timing table (bin edges,
``(N, B, 2, 4)`` stack and refresh policy), the controller registers, the
score partials and a materialized replay history.
The ``*_from_numpy`` functions take them as numpy arrays — as
``np.asarray`` gives them from the reference package's objects, which use
the same field names and layouts — and return this package's objects on a
device; the ``*_to_numpy`` functions go back, for comparisons.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.charge import CellParams
from repro_torch.core.controller import ControllerState, DimmTimingTable, ReplayResult
from repro_torch.core.fleet import Fleet
from repro_torch.core.perfmodel import ScorePartials
from repro_torch.core.refresh import RefreshPolicy


def _t(a, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def cells_from_numpy(r, c, leak, device="cuda") -> CellParams:
    return CellParams(*(_t(a, torch.float32, device) for a in (r, c, leak)))


def fleet_from_numpy(r, c, leak, vendor, device="cuda") -> Fleet:
    return Fleet(cells=cells_from_numpy(r, c, leak, device),
                 vendor=_t(vendor, torch.int32, device))


def table_from_numpy(temp_bins: Sequence[float], stack, device="cuda",
                     refresh: Optional[RefreshPolicy] = None) -> DimmTimingTable:
    """``refresh`` is a policy with the reference's field names (a
    ``RefreshPolicy`` of either package, or ``None``)."""
    if refresh is not None and not isinstance(refresh, RefreshPolicy):
        refresh = RefreshPolicy(tuple(refresh.boundaries), tuple(refresh.multipliers),
                                refresh.trefi_base_ns, refresh.trfc_ns)
    return DimmTimingTable(temp_bins=tuple(float(t) for t in temp_bins),
                           stack=_t(stack, torch.float32, device), refresh=refresh)


def state_from_numpy(bin_idx, cool_streak, fused, device="cuda") -> ControllerState:
    return ControllerState(_t(bin_idx, torch.int32, device),
                           _t(cool_streak, torch.int32, device),
                           _t(fused, torch.bool, device))


def partials_from_numpy(occupancy, switches, timing_sums, n_steps,
                        device="cuda") -> ScorePartials:
    return ScorePartials(_t(occupancy, torch.int32, device), _t(switches, torch.int32, device),
                         _t(timing_sums, torch.float32, device),
                         _t(n_steps, torch.int32, device))


def replay_from_numpy(timings, bin_idx, switched, fused, state, device="cuda") -> ReplayResult:
    """A replay history; ``state`` is ``(bin_idx, cool_streak, fused)``."""
    return ReplayResult(_t(timings, torch.float32, device), _t(bin_idx, torch.int32, device),
                        _t(switched, torch.bool, device), _t(fused, torch.bool, device),
                        state_from_numpy(*state, device=device))


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def cells_to_numpy(cells: CellParams) -> Dict[str, np.ndarray]:
    return {k: _np(v) for k, v in cells._asdict().items()}


def fleet_to_numpy(fl: Fleet) -> Dict[str, np.ndarray]:
    """Cell parameters and the vendor index (what ``vendor_skew`` reads)."""
    return {**cells_to_numpy(fl.cells), "vendor": _np(fl.vendor)}


def table_to_numpy(table: DimmTimingTable) -> Dict[str, np.ndarray]:
    return {"temp_bins": np.asarray(table.temp_bins, np.float64),
            "stack": _np(table.stack)}


def state_to_numpy(state: ControllerState) -> Dict[str, np.ndarray]:
    return {k: _np(v) for k, v in state._asdict().items()}


def partials_to_numpy(partials: ScorePartials) -> Dict[str, np.ndarray]:
    return {k: _np(v) for k, v in partials._asdict().items()}


def replay_to_numpy(res: ReplayResult) -> Dict[str, np.ndarray]:
    """History arrays plus the final state under ``state_*`` keys."""
    out = {k: _np(getattr(res, k)) for k in ("timings", "bin_idx", "switched", "fused")}
    out.update({f"state_{k}": v for k, v in state_to_numpy(res.state).items()})
    return out
