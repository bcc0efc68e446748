"""Plain PyTorch reference for the charge-sweep grid search.

The profiler's execution model: for every candidate timing on the
cycle-quantized grid, re-evaluate the forward correctness predicates
:func:`~repro_torch.core.charge.read_ok` / ``write_ok`` (the other three
timings held at JEDEC) and take the first passing index. It defines the
accepted behaviour — monotone first-True index, all-False columns pinned
to the last grid point (the JEDEC pin), the eps-sloped comparisons — and
the grids every other path shares. The fused search (:mod:`.kernel`) must
return exactly these indices.

The seven distinct searches are the three read-mode parameters (tRCD,
tRAS, tRP under ``read_ok``) and the four write-mode ones (under
``write_ok``); the read stack takes its tWR column from the write test.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.core import charge
from repro_torch.core.charge import CellParams, ChargeModelConstants, DEFAULT_CONSTANTS
from repro_torch.core.timing import JEDEC_DDR3_1600, PARAM_NAMES, TCK_DDR3_1600_NS, TimingParams

#: The seven grid searches, in kernel-output order.
SEARCH_NAMES: Tuple[str, ...] = (
    "r_trcd", "r_tras", "r_trp", "w_trcd", "w_tras", "w_twr", "w_trp"
)

#: Column order of the two public stacks, as kernel-output indices.
READ_STACK_SEARCHES: Tuple[int, int, int, int] = (0, 1, 5, 2)
WRITE_STACK_SEARCHES: Tuple[int, int, int, int] = (3, 4, 5, 6)


def grid_size(param: str, tck: float = TCK_DDR3_1600_NS) -> int:
    """Number of candidate cycle-quantized values from 1 cycle up to JEDEC."""
    return int(round(getattr(JEDEC_DDR3_1600, param) / tck + 0.5))


def param_grid(param: str, tck: float = TCK_DDR3_1600_NS,
               device: str | torch.device = "cpu") -> torch.Tensor:
    """All candidate values (ns) for one parameter, ascending, float32."""
    k = torch.arange(1, grid_size(param, tck) + 1, dtype=torch.float32, device=device)
    return k * tck


#: Grid lengths per parameter at the DDR3-1600 clock.
GRID_SIZES: Dict[str, int] = {p: grid_size(p) for p in PARAM_NAMES}

#: Grid length per search (searches inherit their parameter's grid).
SEARCH_GRID_SIZES: Tuple[int, ...] = tuple(
    GRID_SIZES[name.split("_", 1)[1]] for name in SEARCH_NAMES
)


def first_true_index(ok: torch.Tensor) -> torch.Tensor:
    """First True along dim 0 of an ``(n_grid, ...)`` bool stack, int32;
    all-False columns fall back to the LAST index (the JEDEC pin)."""
    idx = torch.argmax(ok.to(torch.uint8), dim=0)
    none_ok = ~ok.any(dim=0)
    return torch.where(none_ok, ok.shape[0] - 1, idx).to(torch.int32)


def indices_to_ns(idx: torch.Tensor) -> torch.Tensor:
    """Map a ``(..., 4)`` index stack (``PARAM_NAMES`` columns) to grid ns."""
    return torch.stack(
        [param_grid(p, device=idx.device)[idx[..., i].long()]
         for i, p in enumerate(PARAM_NAMES)],
        dim=-1,
    )


def search_min_indices(
    cells_eff: CellParams,
    temp_c,
    window_s: float = charge.REFRESH_WINDOW_S,
    consts: ChargeModelConstants = DEFAULT_CONSTANTS,
) -> torch.Tensor:
    """All seven searches as one ``(..., 7)`` int32 index stack
    (``SEARCH_NAMES`` order). ``cells_eff`` carries any data-pattern factor
    already; its leaves and ``temp_c`` broadcast together. Materializes one
    ``(n_grid, ...)`` pass/fail stack per search."""
    temp = torch.as_tensor(temp_c, dtype=torch.float32, device=cells_eff.r.device)
    ndim = max(temp.dim(), *(a.dim() for a in cells_eff))
    cols = []
    for name in SEARCH_NAMES:
        mode, param = name.split("_", 1)
        grid = param_grid(param, device=temp.device).reshape((-1,) + (1,) * ndim)
        kw = JEDEC_DDR3_1600.as_dict()
        kw[param] = grid
        ok_fn = charge.read_ok if mode == "r" else charge.write_ok
        ok = ok_fn(cells_eff, TimingParams(**kw), temp, window_s, consts)
        cols.append(first_true_index(ok))
    return torch.stack(cols, dim=-1)
