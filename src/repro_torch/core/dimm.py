"""Process-variation DIMM population (the paper's 115 DIMMs from three
vendors), in PyTorch.

Each DIMM is its worst cell plus its peripheral quality. Gaps from the
process corner are ``floor + scale · u^shape`` with ``u ~ U(0, 1)``.
:func:`sample_population` draws ``u`` from a ``torch.Generator``;
:func:`population_from_uniforms` takes pre-drawn uniforms, which is how the
tests feed both packages the same draws (torch cannot reproduce the
reference's threefry bits).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.core.charge import CellParams, ChargeModelConstants, DEFAULT_CONSTANTS

#: Paper population: 115 modules, 862 chips, 3 manufacturers.
N_DIMMS: int = 115
N_CHIPS: int = 862
VENDOR_SPLIT: Tuple[int, int, int] = (40, 40, 35)

GapSpec = Tuple[float, float, float]  # (floor, scale, shape)


@dataclasses.dataclass(frozen=True)
class VendorModel:
    """Per-vendor gap distributions (floor, scale, shape) per field."""

    name: str
    r_gap: GapSpec
    c_gap: GapSpec
    leak_gap: GapSpec
    leak_range: float = 0.20


#: Calibrated vendor population (same values as the reference).
VENDORS: Tuple[VendorModel, ...] = (
    VendorModel("A", r_gap=(0.330, 0.83, 0.556), c_gap=(0.0001, 0.0050, 1.0),
                leak_gap=(0.002, 0.104, 1.0), leak_range=0.056),
    VendorModel("B", r_gap=(0.345, 0.85, 0.556), c_gap=(0.0001, 0.0052, 1.0),
                leak_gap=(0.002, 0.108, 1.0), leak_range=0.056),
    VendorModel("C", r_gap=(0.360, 0.88, 0.556), c_gap=(0.0001, 0.0054, 1.0),
                leak_gap=(0.002, 0.112, 1.0), leak_range=0.056),
)

#: Pre-drawn uniforms of one vendor block: (u_r, u_c, u_leak), each (n,).
Uniforms = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _gap(u: torch.Tensor, spec: GapSpec) -> torch.Tensor:
    floor, scale, shape = spec
    return torch.clamp(floor + scale * u**shape, 0.0, 1.0)


def population_from_uniforms(
    uniforms: Sequence[Uniforms],
    vendors: Sequence[VendorModel] = VENDORS,
    consts: ChargeModelConstants = DEFAULT_CONSTANTS,
) -> Tuple[CellParams, torch.Tensor]:
    """Map per-vendor uniform draws to ``(cells, vendor_idx)``; each field
    of ``cells`` is ``(n_dimms,)`` float32, ``vendor_idx`` int32."""
    rs, cs, ls, vidx = [], [], [], []
    for i, (vm, (u_r, u_c, u_l)) in enumerate(zip(vendors, uniforms)):
        gap_r = _gap(u_r.to(torch.float32), vm.r_gap)
        gap_c = _gap(u_c.to(torch.float32), vm.c_gap)
        gap_l = _gap(u_l.to(torch.float32), vm.leak_gap)
        rs.append(1.0 + (consts.r_max - 1.0) * (1.0 - gap_r))
        cs.append(consts.c_min + (1.0 - consts.c_min) * gap_c)
        ls.append(1.0 - vm.leak_range * gap_l)
        vidx.append(torch.full(u_r.shape, i, dtype=torch.int32, device=u_r.device))
    cells = CellParams(r=torch.cat(rs), c=torch.cat(cs), leak=torch.cat(ls))
    return cells, torch.cat(vidx)


def sample_population(
    generator: torch.Generator,
    n_dimms: int = N_DIMMS,
    vendors: Sequence[VendorModel] = VENDORS,
    split: Sequence[int] = VENDOR_SPLIT,
    consts: ChargeModelConstants = DEFAULT_CONSTANTS,
    device: str | torch.device = "cuda",
) -> Tuple[CellParams, torch.Tensor]:
    """Sample a DIMM population on ``device`` (the generator must live
    there too). Returns ``(cells, vendor_idx)`` as in
    :func:`population_from_uniforms`."""
    if sum(split) != n_dimms:
        raise ValueError(f"vendor split {tuple(split)} does not sum to {n_dimms}")
    dev = resolve_device(device)
    uniforms = [
        tuple(
            torch.rand(n, generator=generator, dtype=torch.float32, device=dev)
            for _ in range(3)
        )
        for n in split
    ]
    return population_from_uniforms(uniforms, vendors, consts)


def worst_case_cell(consts: ChargeModelConstants = DEFAULT_CONSTANTS,
                    device: str | torch.device = "cuda") -> CellParams:
    """The JEDEC provisioning corner: the cell the standard is sized for,
    as 0-d float32 tensors on ``device``."""
    dev = resolve_device(device)
    return CellParams(*(torch.full((), v, dtype=torch.float32, device=dev)
                        for v in (consts.r_max, consts.c_min, 1.0)))


def population_summary(cells: CellParams) -> Dict[str, float]:
    """Means and extremes of a population's worst-cell parameters."""
    return {
        "r_mean": float(cells.r.mean()),
        "r_max": float(cells.r.max()),
        "c_mean": float(cells.c.mean()),
        "c_min": float(cells.c.min()),
        "leak_mean": float(cells.leak.mean()),
        "leak_max": float(cells.leak.max()),
        "n": int(cells.r.shape[0]),
    }
