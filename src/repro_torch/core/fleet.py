"""Fleet-scale DIMM characterization: the whole (temperature × pattern ×
DIMM) study as one fused charge-sweep search.

A fleet is struct-of-arrays (:class:`Fleet`): one tensor per physical
quantity over the DIMM axis. :func:`sweep` broadcasts the cells against
the temperature and pattern grids, hoists the per-cell invariants and runs
all seven min-safe searches of every grid point in ONE call of the fused
search (the CUDA kernel for a fleet on the card); the joint stack, which
has no search, is the closed form once per temperature, broadcast over the
patterns. :class:`SweepResult` holds the ``(T, P, N, 4)`` read, write and
joint stacks, their reductions and the paper-style summary, and hands the
per-access sets at the guarantee pattern to the controller's
:class:`~repro_torch.core.controller.DimmTimingTable`.

:func:`sweep_regions` raises the study by one rank, the distance-from-sense-amp
region classes of :func:`~repro_torch.core.charge.region_fracs`: the whole
``(T, P, R, N)`` grid is still one fused search (the region axis is one more
leading axis of the cells; the search never knows it exists), and
:class:`RegionSweepResult` hands ``(T, R, N, 2, 4)`` sets to a rank-5 table.

Both take ``mesh=`` (:func:`~repro_torch.core.shard.fleet_mesh`): each rank
sweeps its block of DIMMs, one launch of the search a rank, and the stacks
are gathered, so every rank holds the same whole result, bitwise the
single-device one.
"""

from __future__ import annotations

import warnings
from typing import Dict, NamedTuple, Sequence, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.core import charge, dimm, profiler, shard
from repro_torch.core.charge import CellParams, ChargeModelConstants, DEFAULT_CONSTANTS
from repro_torch.core.timing import ACCESS_TYPES, PARAM_NAMES
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

    def take(self, idx) -> "Fleet":
        """Sub-fleet selection (the same layout, every field)."""
        return Fleet(cells=CellParams(*(a[idx] for a in self.cells)), vendor=self.vendor[idx])


def from_population(cells: CellParams, vendor: torch.Tensor | None = None) -> Fleet:
    """Wrap a sampled population as a fleet (vendor 0 for every DIMM unless
    ``vendor`` is given)."""
    if vendor is None:
        vendor = torch.zeros(cells.r.shape, dtype=torch.int32, device=cells.r.device)
    return Fleet(cells=cells, vendor=vendor)


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


def _guarantee_pattern_idx(patterns: torch.Tensor) -> int:
    """Worst-pattern index, refusing sweeps that never tested the guarantee
    pattern (margin factor 1.0)."""
    p = int(torch.argmin(patterns))
    worst = float(patterns[p])
    if worst > 1.0:
        raise ValueError(
            f"sweep lacks the worst-case guarantee pattern: min margin "
            f"factor is {worst} (> 1.0); re-sweep with pattern 1.0 "
            "before programming controller tables"
        )
    return p


def _tested(write: torch.Tensor) -> torch.Tensor:
    """``write``, refused if it carries the untested-tRAS sentinel."""
    if bool((write < 0.0).any()):
        raise ValueError(
            "write-mode sweep carries the untested-tRAS sentinel "
            f"({profiler.WRITE_TRAS_UNTESTED_NS} ns): re-sweep with "
            "tras_mode='profiled' before programming write registers"
        )
    return write


class SweepResult(NamedTuple):
    """Dense characterization output over the (temp × pattern × DIMM) grid.
    Stacks are ns, cycle-quantized, last axis in ``PARAM_NAMES`` order."""

    temps_c: torch.Tensor   # (T,)
    patterns: torch.Tensor  # (P,)
    read: torch.Tensor      # (T, P, N, 4) read-mode minima
    write: torch.Tensor     # (T, P, N, 4) write-mode minima
    joint: torch.Tensor     # (T, P, N, 4) simultaneous-reduction minima
    #: The caller's exact Python temperatures (bin edges come from here).
    temps_exact: Tuple[float, ...] = ()

    def bin_edges(self) -> Tuple[float, ...]:
        return self.temps_exact or tuple(float(t) for t in self.temps_c.tolist())

    # -- reductions ---------------------------------------------------------
    @property
    def read_reductions(self) -> torch.Tensor:
        return profiler.stack_reductions(self.read)

    @property
    def write_reductions(self) -> torch.Tensor:
        return profiler.stack_reductions(self.write)

    @property
    def joint_reductions(self) -> torch.Tensor:
        return profiler.stack_reductions(self.joint)

    # -- controller-facing views -------------------------------------------
    def worst_pattern_idx(self) -> int:
        """Index of the guarantee pattern (smallest margin factor)."""
        return int(torch.argmin(self.patterns))

    def read_timings(self) -> torch.Tensor:
        """(T, N, 4) read-access sets at the worst-case pattern."""
        return self.read[:, _guarantee_pattern_idx(self.patterns)]

    def write_timings(self) -> torch.Tensor:
        """(T, N, 4) write-access sets at the worst-case pattern; refuses a
        sweep that carries the untested-tRAS sentinel."""
        return _tested(self.write[:, _guarantee_pattern_idx(self.patterns)])

    def stacked_timings(self) -> torch.Tensor:
        """(T, N, 2, 4) per-access-type sets (read, write) at the worst-case
        pattern: what :class:`DimmTimingTable` ingests."""
        return torch.stack([self.read_timings(), self.write_timings()], dim=-2)

    def merged_timings(self) -> torch.Tensor:
        """(T, N, 4) elementwise max of the read and write sets at the
        worst-case pattern.

        .. deprecated::
            Compat shim for single-register-set consumers: the merge gives
            each parameter its slower mode's requirement. Program the
            per-access-type sets (:meth:`stacked_timings`) instead."""
        warnings.warn(
            "SweepResult.merged_timings() is a deprecated compat shim for "
            "single-register-set consumers: it programs the elementwise max "
            "of the read/write sets, re-inheriting each parameter's slower-"
            "mode conservatism. Program the per-access-type sets instead "
            "(stacked_timings() / read_timings() / write_timings()).",
            DeprecationWarning,
            stacklevel=2,
        )
        return torch.maximum(self.read_timings(), self.write_timings())

    def table_entries(self):
        """Iterate ``(bin_idx, temp_c, dimm_idx, access_type, [trcd, tras,
        twr, trp], margin)`` over the per-access-type sets at the worst
        pattern; ``margin`` is that set's mean fractional reduction vs
        JEDEC. A Python generator for per-entry consumers (altune's
        ``TimingTable.from_fleet``); it copies the stacks to the host, so
        keep it to small fleets."""
        stacked = self.stacked_timings()                          # (T, N, 2, 4)
        grid = stacked.tolist()
        margins = profiler.stack_reductions(stacked).mean(dim=-1).tolist()
        for b, t in enumerate(self.bin_edges()):
            for i, per_access in enumerate(grid[b]):
                for a, access in enumerate(ACCESS_TYPES):
                    yield b, t, i, access, per_access[a], margins[b][i][a]

    def to_table(self):
        """Build the controller's :class:`DimmTimingTable` from the sweep."""
        from repro_torch.core.controller import DimmTimingTable

        return DimmTimingTable.from_fleet(self)

    # -- paper-style aggregates --------------------------------------------
    def summary(self) -> Dict[float, Dict[str, Tuple[float, float, float]]]:
        """Per temperature, per parameter: the (min, mean, max) fractional
        reduction across the fleet at the worst-case pattern, tWR from the
        write test (the paper's headline figures)."""
        p = self.worst_pattern_idx()
        red = self.read_reductions[:, p]           # (T, N, 4)
        wred = self.write_reductions[:, p]
        twr = PARAM_NAMES.index("twr")
        cols = torch.cat([red[..., :twr], wred[..., twr:twr + 1], red[..., twr + 1:]], dim=-1)
        stats = torch.stack([cols.amin(dim=1), cols.mean(dim=1), cols.amax(dim=1)],
                            dim=-1).tolist()       # (T, 4, 3)
        return {
            float(t): {name: tuple(stats[ti][pi]) for pi, name in enumerate(PARAM_NAMES)}
            for ti, t in enumerate(self.bin_edges())
        }


class RegionSweepResult(NamedTuple):
    """Dense characterization output over the (temp × pattern × region ×
    DIMM) grid: :class:`SweepResult`'s read and write stacks raised by one
    rank. Region index 0 is the nearest class, R-1 the anchor (farthest),
    equal to the region-free profile."""

    temps_c: torch.Tensor       # (T,)
    patterns: torch.Tensor      # (P,)
    region_fracs: torch.Tensor  # (R,) normalized distance classes
    read: torch.Tensor          # (T, P, R, N, 4) read-mode minima
    write: torch.Tensor         # (T, P, R, N, 4) write-mode minima
    temps_exact: Tuple[float, ...] = ()

    @property
    def n_regions(self) -> int:
        return int(self.region_fracs.shape[0])

    def bin_edges(self) -> Tuple[float, ...]:
        return self.temps_exact or tuple(float(t) for t in self.temps_c.tolist())

    def worst_pattern_idx(self) -> int:
        return int(torch.argmin(self.patterns))

    def read_timings(self) -> torch.Tensor:
        """(T, R, N, 4) read-access sets at the worst-case pattern."""
        return self.read[:, _guarantee_pattern_idx(self.patterns)]

    def write_timings(self) -> torch.Tensor:
        """(T, R, N, 4) write-access sets at the worst-case pattern; refuses
        the untested-tRAS sentinel."""
        return _tested(self.write[:, _guarantee_pattern_idx(self.patterns)])

    def stacked_timings(self) -> torch.Tensor:
        """(T, R, N, 2, 4) per-access-type sets at the worst-case pattern."""
        return torch.stack([self.read_timings(), self.write_timings()], dim=-2)

    def to_table(self):
        """The rank-5 :class:`DimmTimingTable` (``(N, B, R, 2, 4)``)."""
        from repro_torch.core.controller import DimmTimingTable

        return DimmTimingTable.from_fleet(self)


def sweep_regions(
    fleet: Fleet | CellParams,
    temps_c: Sequence[float] = DEFAULT_TEMPS_C,
    patterns: Sequence[float] = DEFAULT_PATTERNS,
    n_regions: int = 1,
    window_s: float = charge.REFRESH_WINDOW_S,
    consts: ChargeModelConstants = DEFAULT_CONSTANTS,
    write_tras: str = "profiled",
    mesh=None,
) -> RegionSweepResult:
    """Characterize a fleet over the (T, P, R, N) grid on the fleet's own
    device: the cells take the pattern (:func:`charge.apply_pattern`) and
    then the region class (:func:`charge.apply_region`), and both stacks
    of the whole grid come out of ONE fused search. Stacks are
    ``(T, P, R, n_dimms, 4)`` ns; region R-1 is the anchor, bitwise the
    region-free :func:`sweep`'s stacks, so ``n_regions=1`` reproduces them.
    ``mesh`` splits the DIMM axis as in :func:`sweep`."""
    if write_tras not in profiler.WRITE_TRAS_MODES:
        raise ValueError(
            f"write_tras must be one of {profiler.WRITE_TRAS_MODES}, got {write_tras!r}")
    cells = fleet.cells if isinstance(fleet, Fleet) else fleet
    dev = resolve_device(cells.r.device)
    t = torch.tensor([float(x) for x in temps_c], dtype=torch.float32, device=dev)
    p = torch.tensor([float(x) for x in patterns], dtype=torch.float32, device=dev)
    f = charge.region_fracs(int(n_regions), device=dev)

    def stacks(c: CellParams):
        eff = charge.apply_pattern(
            CellParams(*(a[None, None, None, :] for a in c)), p[None, :, None, None]
        )
        eff = charge.apply_region(eff, f[None, None, :, None], consts)
        read, write = charge_sweep.sweep_min_timings(eff, t[:, None, None, None], window_s,
                                                     consts)
        if write_tras == "untested":
            write = profiler.untested_tras(write)
        return read, write

    if mesh is None:
        read, write = stacks(cells)
    else:
        read, write = shard.sharded_dimm_map(stacks, mesh, in_axes=(0,), out_axes=(3, 3),
                                             n_dimms=int(cells.r.shape[0]), gather=True)(cells)
    return RegionSweepResult(
        temps_c=t, patterns=p, region_fracs=f, read=read, write=write,
        temps_exact=tuple(float(x) for x in temps_c),
    )


def sweep(
    fleet: Fleet | CellParams,
    temps_c: Sequence[float] = DEFAULT_TEMPS_C,
    patterns: Sequence[float] = DEFAULT_PATTERNS,
    window_s: float = charge.REFRESH_WINDOW_S,
    consts: ChargeModelConstants = DEFAULT_CONSTANTS,
    write_tras: str = "profiled",
    mesh=None,
) -> SweepResult:
    """Characterize a whole fleet over the (T, P, N) grid, on the fleet's
    own device: the read and write stacks in one fused search, the joint
    stack once per temperature and broadcast over the patterns (it does not
    depend on the pattern). Every stack is ``(T, P, n_dimms, 4)`` ns.
    ``write_tras="untested"`` fills the write tRAS column with the refused
    sentinel (for tests of the refusal, never for real tables).

    ``mesh`` — a 1-D ``"dimm"`` mesh (:func:`repro_torch.core.shard.fleet_mesh`):
    each rank sweeps its contiguous block of DIMMs (edge-replication padding
    where the shard count does not divide the fleet), one launch of the
    search a rank, and the read, write and joint stacks are gathered. So
    every rank returns the same whole :class:`SweepResult`, bitwise the
    single-device one: the stacks are O(N·T·P), small beside a replay's
    history, and every rank programs the whole table (:meth:`~SweepResult.to_table`)
    that its replay and scores read."""
    if write_tras not in profiler.WRITE_TRAS_MODES:
        raise ValueError(
            f"write_tras must be one of {profiler.WRITE_TRAS_MODES}, got {write_tras!r}")
    cells = fleet.cells if isinstance(fleet, Fleet) else fleet
    dev = resolve_device(cells.r.device)
    t = torch.tensor([float(x) for x in temps_c], dtype=torch.float32, device=dev)
    p = torch.tensor([float(x) for x in patterns], dtype=torch.float32, device=dev)

    def stacks(c: CellParams):
        eff = charge.apply_pattern(CellParams(*(a[None, None, :] for a in c)), p[None, :, None])
        read, write = charge_sweep.sweep_min_timings(eff, t[:, None, None], window_s, consts)
        if write_tras == "untested":
            write = profiler.untested_tras(write)
        joint = profiler.joint_min_timings(
            CellParams(*(a[None, :] for a in c)), t[:, None], 1.0, window_s, consts)
        return read, write, joint

    if mesh is None:
        read, write, joint = stacks(cells)
    else:
        read, write, joint = shard.sharded_dimm_map(
            stacks, mesh, in_axes=(0,), out_axes=(2, 2, 1), n_dimms=int(cells.r.shape[0]),
            gather=True)(cells)
    return SweepResult(
        temps_c=t, patterns=p, read=read, write=write,
        joint=joint[:, None].expand(read.shape),
        temps_exact=tuple(float(x) for x in temps_c),
    )


def sweep_loop_baseline(
    fleet: Fleet | CellParams,
    temps_c: Sequence[float] = DEFAULT_TEMPS_C,
    patterns: Sequence[float] = DEFAULT_PATTERNS,
    window_s: float = charge.REFRESH_WINDOW_S,
    consts: ChargeModelConstants = DEFAULT_CONSTANTS,
) -> SweepResult:
    """Per-DIMM Python-loop characterization: one ``profile_*`` call per
    (DIMM, temperature, pattern) point, reassembled from dicts. The
    equivalence baseline of :func:`sweep`; O(N·T·P) dispatches, never for
    real fleets."""
    cells = fleet.cells if isinstance(fleet, Fleet) else fleet
    dev = cells.r.device
    stacks = {"read": [], "write": [], "joint": []}
    for t in temps_c:
        rows = {k: [] for k in stacks}
        for p in patterns:
            per = {k: [] for k in stacks}
            for i in range(int(cells.r.shape[0])):
                one = CellParams(*(a[i:i + 1] for a in cells))
                for k, prof in (
                    ("read", profiler.profile_individual(one, t, window_s, consts, pattern=p)),
                    ("write", profiler.profile_write_mode(one, t, window_s, consts, pattern=p)),
                    ("joint", profiler.profile_joint(one, t, window_s, consts)),
                ):
                    per[k].append([float(prof.timings[q][0]) for q in PARAM_NAMES])
            for k in stacks:
                rows[k].append(per[k])
        for k in stacks:
            stacks[k].append(rows[k])

    def as_t(x) -> torch.Tensor:
        return torch.tensor(x, dtype=torch.float32, device=dev)

    return SweepResult(
        temps_c=as_t([float(x) for x in temps_c]), patterns=as_t([float(x) for x in patterns]),
        **{k: as_t(v) for k, v in stacks.items()},
        temps_exact=tuple(float(x) for x in temps_c),
    )
