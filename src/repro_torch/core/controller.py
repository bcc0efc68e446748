"""AL-DRAM memory-controller mechanism (paper §1.4), in PyTorch.

* :class:`DimmTimingTable` — the controller's timing registers: one
  ``(n_dimms, n_bins, 2, 4)`` float32 stack (access axis read, write;
  ``PARAM_NAMES`` last) on the device, or ``(n_dimms, n_bins, n_regions,
  2, 4)`` for a region-profiled table, the bin edges and an optional
  :class:`~repro_torch.core.refresh.RefreshPolicy`. Temperatures above the
  last edge select JEDEC (the beyond-last sentinel row). A negative entry
  is the profiler's untested sentinel and is refused.
* The pure state machine: :class:`ControllerState` (``bin_idx`` /
  ``cool_streak`` / ``fused`` over the DIMM axis) advanced by :func:`step`
  — guard band, hysteresis on cooling, immediate degrade on heating, and
  an error fuse that drops a DIMM to JEDEC for good. On a CPU tensor
  :func:`step` is :func:`step_plain`; on a CUDA tensor it is the
  replay-chunk kernel's emitting entry at chunk 1
  (:class:`repro_torch.kernels.replay_step.ops.StepKernel`).
* :func:`replay` — whole traces with the dense ``(n_steps, n_dimms, ...)``
  history (:class:`ReplayResult`): on a CPU tensor one :func:`step_plain`
  per observation, on a card the emitting entry writing the history in
  place (:func:`repro_torch.kernels.replay_step.ops.replay_history`);
  ``mesh=`` replays each rank's block of DIMMs and keeps its history there.
* :class:`ALDRAMController` — the per-observation API over the shared
  scalar transition (:func:`repro_torch.core.binning.advance_bin`), its
  registers on the host; the exactness baseline for :func:`replay`.
"""

from __future__ import annotations

import dataclasses
import json
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import charge, shard
from repro_torch.core.binning import advance_bin, bin_index
from repro_torch.core.charge import CellParams, ChargeModelConstants, DEFAULT_CONSTANTS
from repro_torch.core.refresh import BinRefresh, RefreshPolicy, bin_refresh as _bin_refresh
from repro_torch.core.timing import (
    ACCESS_TYPES,
    JEDEC_ACCESS,
    JEDEC_DDR3_1600,
    PARAM_NAMES,
    AccessTimings,
    TimingParams,
)

#: Temperature bins (°C upper edges) for which timing sets are profiled.
DEFAULT_TEMP_BINS: Tuple[float, ...] = (45.0, 55.0, 65.0, 75.0, 85.0)

#: Guard band added to the measured temperature before bin selection.
GUARD_BAND_C: float = 5.0

#: Hysteresis: switch to a cooler bin only after the temperature stayed
#: below the bin edge minus this margin for ``HYSTERESIS_STEPS`` steps.
HYSTERESIS_C: float = 2.0
HYSTERESIS_STEPS: int = 3

#: Persisted-table format version, the reference's: v1 nested per-DIMM
#: lists of merged timing dicts, v2 one merged ``(N, B, 4)`` stack, v3 the
#: per-access ``(N, B, 2, 4)`` stack, v4 adds the refresh policy
#: (nullable), v5 the region axis (``(N, B, n_regions, 2, 4)`` and
#: ``"n_regions"``). :meth:`DimmTimingTable.from_json` reads all five;
#: :meth:`DimmTimingTable.to_json` writes v5.
TABLE_SCHEMA_VERSION: int = 5

#: JEDEC (2, 4) sentinel rows, selected beyond the last bin or after a fuse.
JEDEC_ROWS: Tuple[Tuple[float, ...], ...] = (
    tuple(getattr(JEDEC_DDR3_1600, p) for p in PARAM_NAMES),
) * len(ACCESS_TYPES)


def jedec_rows(device: str | torch.device) -> torch.Tensor:
    return torch.tensor(JEDEC_ROWS, dtype=torch.float32, device=device)


def access_timings(block) -> AccessTimings:
    """A ``(2, 4)`` nested sequence of ns as :class:`AccessTimings`."""
    return AccessTimings(read=TimingParams(*(float(v) for v in block[0])),
                         write=TimingParams(*(float(v) for v in block[1])))


@dataclasses.dataclass(eq=False)
class DimmTimingTable:
    """Per-DIMM, per-access-type timing sets, one per temperature bin.

    ``stack[dimm, bin]`` is a ``(2, 4)`` block (read set, write set; ns).
    A region-profiled table (schema v5) carries a rank-5 ``(n_dimms,
    n_bins, n_regions, 2, 4)`` stack instead, regions ordered nearest
    (fastest) to farthest (the per-DIMM worst case); a one-region rank-5
    stack is squeezed to the canonical rank-4 form. Consumers that program
    one register set per (DIMM, bin) read :meth:`oblivious_stack` (the max
    over regions, safe for every region); region-resolved lookups read
    :meth:`region_stack`. ``refresh`` is the temperature-driven refresh
    policy the DIMMs run under; ``None`` scores latency only."""

    temp_bins: Tuple[float, ...]
    stack: torch.Tensor
    refresh: Optional[RefreshPolicy] = None

    def __post_init__(self) -> None:
        if self.refresh is not None and not isinstance(self.refresh, RefreshPolicy):
            raise TypeError(f"refresh must be a RefreshPolicy or None, got "
                            f"{type(self.refresh).__name__}")
        self.temp_bins = tuple(float(t) for t in self.temp_bins)
        if list(self.temp_bins) != sorted(set(self.temp_bins)):
            raise ValueError(f"temp_bins must ascend strictly, got {self.temp_bins}")
        self.stack = torch.as_tensor(self.stack, dtype=torch.float32)
        if self.stack.dim() == 5 and self.stack.shape[2] == 1:
            self.stack = self.stack[:, :, 0]  # one region is the region-free table
        tail = (len(ACCESS_TYPES), len(PARAM_NAMES))
        shape = tuple(self.stack.shape)
        ok = (len(shape) == 4 and shape[1:] == (self.n_bins,) + tail) or (
            len(shape) == 5 and shape[1] == self.n_bins and shape[2] >= 2
            and shape[3:] == tail)
        if not ok:
            raise ValueError(
                f"stack shape {shape} does not match {self.n_bins} bins × "
                f"[n_regions ×] {tail[0]} access types × {tail[1]} params"
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
    def n_regions(self) -> int:
        """Distance-from-sense-amp classes per DIMM (1 for rank-4 tables)."""
        return int(self.stack.shape[2]) if self.stack.dim() == 5 else 1

    @property
    def device(self) -> torch.device:
        return self.stack.device

    def __eq__(self, other: object) -> bool:
        return (
            isinstance(other, DimmTimingTable)
            and self.temp_bins == other.temp_bins
            and self.refresh == other.refresh
            and torch.equal(self.stack, other.stack.to(self.stack.device))
        )

    def region_stack(self) -> torch.Tensor:
        """The region-explicit ``(n_dimms, n_bins, n_regions, 2, 4)`` view
        (a rank-4 table gains a length-1 region axis, no copy)."""
        return self.stack if self.stack.dim() == 5 else self.stack[:, :, None]

    def oblivious_stack(self) -> torch.Tensor:
        """The region-oblivious ``(n_dimms, n_bins, 2, 4)`` registers: the
        max over regions per (bin, access, param), the one set safe for
        every region; :attr:`stack` itself for a rank-4 table."""
        return self.stack.amax(dim=2) if self.stack.dim() == 5 else self.stack

    def bin_refresh(self) -> Optional[BinRefresh]:
        """Per-effective-bin refresh load under this table's policy — the
        ``refresh=`` argument of the ``trace_score`` family (``None``:
        latency-only scoring)."""
        if self.refresh is None:
            return None
        return _bin_refresh(self.refresh, self.temp_bins)

    def row(self, dimm: int, bin_idx: int, region: Optional[int] = None) -> AccessTimings:
        """Read + write timing sets at ``(dimm, bin)``; the beyond-last
        sentinel (``bin_idx >= n_bins``) is JEDEC for both access types.
        ``region`` selects one distance class; ``None`` on a region table
        is the region-oblivious set."""
        if bin_idx >= self.n_bins:
            return JEDEC_ACCESS
        if region is None:
            block = self.stack[dimm, bin_idx]
            return access_timings((block.amax(dim=0) if block.dim() == 3 else block).tolist())
        if not 0 <= region < self.n_regions:
            raise IndexError(f"region {region} out of range for a "
                             f"{self.n_regions}-region table")
        return access_timings(self.region_stack()[dimm, bin_idx, region].tolist())

    def lookup(self, dimm: int, temp_c: float) -> AccessTimings:
        """Timing sets for the smallest bin covering ``temp_c`` (guard-banded
        by the caller); above the last bin → JEDEC."""
        return self.row(dimm, bin_index(self.temp_bins, temp_c))

    def to(self, device: str | torch.device) -> "DimmTimingTable":
        """The same registers and policy on ``device``."""
        return DimmTimingTable(self.temp_bins, self.stack.to(device), self.refresh)

    @property
    def sets(self) -> List[List[AccessTimings]]:
        """Nested-list view ``sets[dimm][bin]`` for per-DIMM consumers (the
        storage is :attr:`stack`); a region table shows its oblivious sets."""
        return [[access_timings(block) for block in per_dimm]
                for per_dimm in self.oblivious_stack().tolist()]

    @classmethod
    def profile(
        cls,
        cells: CellParams,
        temp_bins: Sequence[float] = DEFAULT_TEMP_BINS,
        window_s: float = charge.REFRESH_WINDOW_S,
        consts: ChargeModelConstants = DEFAULT_CONSTANTS,
        refresh: Optional[RefreshPolicy] = None,
        n_regions: int = 1,
    ) -> "DimmTimingTable":
        """Boot-time profiling: one fleet sweep over every bin at the
        worst-case pattern, on the cells' device, programming each access
        type at its own profiled margin. ``n_regions > 1`` profiles each
        distance class (one region sweep) into a rank-5 table;
        ``n_regions=1`` is the region-free profile."""
        from repro_torch.core import fleet as fleet_mod

        if n_regions < 1:
            raise ValueError(f"n_regions must be >= 1, got {n_regions}")
        if n_regions == 1:
            result = fleet_mod.sweep(cells, temps_c=tuple(temp_bins), patterns=(1.0,),
                                     window_s=window_s, consts=consts)
        else:
            result = fleet_mod.sweep_regions(cells, temps_c=tuple(temp_bins),
                                             patterns=(1.0,), n_regions=n_regions,
                                             window_s=window_s, consts=consts)
        return cls.from_fleet(result, temp_bins=temp_bins, refresh=refresh)

    @classmethod
    def from_sets(
        cls,
        temp_bins: Sequence[float],
        sets: Sequence[Sequence[TimingParams | AccessTimings]],
        device: str | torch.device = "cuda",
    ) -> "DimmTimingTable":
        """Build from nested per-DIMM timing-set lists, on ``device``. A plain
        :class:`TimingParams` (the v1 merged layout) goes into both access
        slots; :class:`AccessTimings` keeps its split sets. Entries are
        matched by field name, so the reference's timing classes work too."""
        def block(entry):
            pair = (entry, entry) if not hasattr(entry, "read") else (entry.read, entry.write)
            return [[float(getattr(t, p)) for p in PARAM_NAMES] for t in pair]

        stack = torch.tensor([[block(t) for t in per_dimm] for per_dimm in sets],
                             dtype=torch.float32, device=resolve_device(device))
        return cls(temp_bins=tuple(float(t) for t in temp_bins), stack=stack)

    # -- persistence (the controller's registers survive a reboot) -----------
    def to_json(self) -> str:
        """The table as schema-v5 JSON, the reference's layout: a
        region-explicit ``(N, B, R, 2, 4)`` stack and ``n_regions``."""
        refresh = None
        if self.refresh is not None:
            refresh = {
                "boundaries": list(self.refresh.boundaries),
                "multipliers": list(self.refresh.multipliers),
                "trefi_base_ns": self.refresh.trefi_base_ns,
                "trfc_ns": self.refresh.trfc_ns,
            }
        return json.dumps({
            "schema_version": TABLE_SCHEMA_VERSION,
            "params": list(PARAM_NAMES),
            "access_types": list(ACCESS_TYPES),
            "temp_bins": list(self.temp_bins),
            "n_regions": self.n_regions,
            "stack": self.region_stack().tolist(),
            "refresh": refresh,
        })

    @classmethod
    def from_json(cls, text: str, device: str | torch.device = "cuda") -> "DimmTimingTable":
        """Load a table of schema v1–v5 onto ``device``: v1/v2 merged sets go
        into both access slots, pre-v4 files have no refresh policy, and a
        v5 file's stack must carry its declared region axis (one region
        loads as the rank-4 table)."""
        obj = json.loads(text)
        version = obj.get("schema_version", 1)
        dev = resolve_device(device)
        if version == 1:
            return cls.from_sets(
                obj["temp_bins"],
                [[TimingParams(**d) for d in per_dimm] for per_dimm in obj["sets"]],
                device=dev,
            )
        if version not in (2, 3, 4, 5):
            raise ValueError(f"unknown DimmTimingTable schema_version {version!r}")
        if obj.get("params", list(PARAM_NAMES)) != list(PARAM_NAMES):
            raise ValueError(f"persisted parameter order {obj['params']} does not "
                             f"match {list(PARAM_NAMES)}")
        stack = torch.tensor(obj["stack"], dtype=torch.float32, device=dev)
        if version == 2:
            return cls(temp_bins=tuple(obj["temp_bins"]),
                       stack=stack[:, :, None, :].repeat(1, 1, len(ACCESS_TYPES), 1))
        if obj.get("access_types", list(ACCESS_TYPES)) != list(ACCESS_TYPES):
            raise ValueError(f"persisted access-type order {obj['access_types']} does "
                             f"not match {list(ACCESS_TYPES)}")
        refresh = None
        if version >= 4 and obj.get("refresh") is not None:
            r = obj["refresh"]
            refresh = RefreshPolicy(
                boundaries=tuple(float(b) for b in r["boundaries"]),
                multipliers=tuple(float(m) for m in r["multipliers"]),
                trefi_base_ns=float(r["trefi_base_ns"]),
                trfc_ns=float(r["trfc_ns"]),
            )
        if version == 5:
            n_regions = int(obj.get("n_regions", 1))
            if stack.dim() != 5 or stack.shape[2] != n_regions:
                raise ValueError(f"v5 stack shape {tuple(stack.shape)} does not carry the "
                                 f"declared n_regions={n_regions} region axis")
        return cls(temp_bins=tuple(obj["temp_bins"]), stack=stack, refresh=refresh)

    @classmethod
    def from_fleet(cls, result, temp_bins: Optional[Sequence[float]] = None,
                   refresh: Optional[RefreshPolicy] = None) -> "DimmTimingTable":
        """Transpose a :class:`~repro_torch.core.fleet.SweepResult`'s
        ``(T, N, 2, 4)`` stacked sets into ``(N, T, 2, 4)`` registers, or a
        :class:`~repro_torch.core.fleet.RegionSweepResult`'s ``(T, R, N, 2,
        4)`` into ``(N, T, R, 2, 4)``, on the sweep's device. The bin edges
        are the sweep's exact temperatures unless ``temp_bins`` overrides
        them."""
        if temp_bins is None:
            temp_bins = result.bin_edges()
        elif len(temp_bins) != result.read.shape[0]:
            raise ValueError(
                f"{len(temp_bins)} temp_bins for a "
                f"{result.read.shape[0]}-temperature sweep"
            )
        stacked = result.stacked_timings()
        order = (2, 0, 1, 3, 4) if stacked.dim() == 5 else (1, 0, 2, 3)
        stack = stacked.permute(*order).contiguous()
        return cls(temp_bins=tuple(temp_bins), stack=stack, refresh=refresh)


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


StepOut = Tuple[ControllerState, torch.Tensor, torch.Tensor, torch.Tensor]


def step(
    stack: torch.Tensor,
    edges: torch.Tensor,
    params: ControllerParams,
    state: ControllerState,
    temps_c: torch.Tensor,
    errors: Optional[torch.Tensor] = None,
) -> StepOut:
    """Advance the whole fleet one observation.

    ``stack`` (N, B, 2, 4) float32, ``edges`` (B,) float32, ``temps_c`` /
    ``errors`` (N,). Errors fuse before the temperature is considered.
    Returns ``(state, rows (N, 2, 4), switched (N,), effective_bin (N,))``;
    the effective bin ``n_bins`` is the JEDEC sentinel. A CPU ``stack``
    runs :func:`step_plain`; a CUDA one launches the replay-chunk kernel's
    emitting entry for one step (bitwise the same outputs), or raises."""
    if stack.device.type == "cpu":
        return step_plain(stack, edges, params, state, temps_c, errors)
    from repro_torch.kernels.replay_step import ops as replay_ops

    return replay_ops.step_kernel(stack, edges, params, state, temps_c, errors)


def step_plain(
    stack: torch.Tensor,
    edges: torch.Tensor,
    params: ControllerParams,
    state: ControllerState,
    temps_c: torch.Tensor,
    errors: Optional[torch.Tensor] = None,
) -> StepOut:
    """:func:`step` in torch ops, on any device: the semantics definition."""
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


# ---------------------------------------------------------------------------
# Materialized replay
# ---------------------------------------------------------------------------
class ReplayResult(NamedTuple):
    """Dense output of a trace replay (every array over (n_steps, n_dimms))."""

    timings: torch.Tensor    # (S, N, 2, 4) float32 realized rows, ns
    bin_idx: torch.Tensor    # (S, N) int32 effective bin (n_bins = JEDEC)
    switched: torch.Tensor   # (S, N) bool
    fused: torch.Tensor      # (S, N) bool, post-step fuse state
    state: ControllerState   # final registers

    @property
    def switch_counts(self) -> torch.Tensor:
        """(N,) per-DIMM timing-set switches over the trace."""
        return self.switched.sum(dim=0)

    @property
    def total_switches(self) -> int:
        return int(self.switched.sum())


def replay(
    table: DimmTimingTable,
    traces,
    errors=None,
    params: ControllerParams = ControllerParams(),
    state: Optional[ControllerState] = None,
    mesh=None,
) -> ReplayResult:
    """Replay whole ``(n_steps, n_dimms)`` temperature traces through the
    controller on the table's device, keeping the dense history: on the CPU
    one :func:`step_plain` per observation; on a card the replay-chunk
    kernel's emitting entry, one launch a
    :data:`~repro_torch.kernels.replay_step.ops.REPLAY_CHUNK_STEPS` steps
    (the whole trace by default), writing the history in place.
    ``errors`` is an optional same-shaped bool mask of error
    injections (each fuses its DIMM to JEDEC from that step on); ``state``
    an optional starting state (default: the boot state). Bit-exact with
    feeding the same observations to :meth:`ALDRAMController.observe`.

    ``mesh`` — a 1-D ``"dimm"`` mesh (:func:`repro_torch.core.shard.fleet_mesh`):
    the table, traces, errors and state are whole on every rank, as above,
    and each rank replays its contiguous block of DIMMs with the same
    single-device replay (on a card the emitting entry of the replay-chunk
    kernel). The ``(S, N, ...)`` history is too large to gather (21 GB at
    65,536 DIMMs × 10,000 steps), so it stays where it was computed: the
    result holds this rank's real DIMMs ``[lo:hi]``
    (:func:`~repro_torch.core.shard.local_range`) — timings, bins, switch
    and fuse flags ``(S, hi - lo, ...)`` and the block's final state —
    bitwise those columns of the single-device replay."""
    dev = table.device
    traces = torch.as_tensor(traces).to(device=dev, dtype=torch.float32)
    if traces.dim() != 2:
        raise ValueError(f"traces must be (n_steps, n_dimms), got {tuple(traces.shape)}")
    if traces.shape[1] != table.n_dimms:
        raise ValueError(f"trace has {traces.shape[1]} DIMMs, table has {table.n_dimms}")
    if errors is not None:
        errors = torch.as_tensor(errors).to(device=dev, dtype=torch.bool)
        if errors.shape != traces.shape:
            raise ValueError(f"errors shape {tuple(errors.shape)} != traces shape "
                             f"{tuple(traces.shape)}")
    if state is None:
        state = init_state(table.n_dimms, table.n_bins, dev)
    if mesh is not None:
        def local(stack_b, traces_b, errors_b, state_b):
            r = replay(DimmTimingTable(table.temp_bins, stack_b), traces_b, errors_b,
                       params, state_b)
            return r.timings, r.bin_idx, r.switched, r.fused, r.state

        run = shard.sharded_dimm_map(
            local, mesh, in_axes=(0, 1, None if errors is None else 1, 0),
            out_axes=(1, 1, 1, 1, 0), n_dimms=table.n_dimms)
        return ReplayResult(*run(table.oblivious_stack(), traces, errors, state))
    n_steps, n = traces.shape
    stack = table.oblivious_stack()
    timings = torch.empty((n_steps, n) + tuple(stack.shape[2:]), dtype=torch.float32,
                          device=dev)
    bin_idx = torch.empty((n_steps, n), dtype=torch.int32, device=dev)
    switched = torch.empty((n_steps, n), dtype=torch.bool, device=dev)
    fused = torch.empty((n_steps, n), dtype=torch.bool, device=dev)
    if dev.type != "cpu":
        from repro_torch.kernels.replay_step import ops as replay_ops

        state = replay_ops.replay_history(
            stack, table.temp_bins, params, state, traces, errors,
            replay_ops.Decisions(timings, bin_idx, switched, fused),
            replay_ops.REPLAY_CHUNK_STEPS)
        return ReplayResult(timings, bin_idx, switched, fused, state)
    edges = torch.tensor(table.temp_bins, dtype=torch.float32, device=dev)
    for k in range(n_steps):
        state, rows, sw, eff = step_plain(stack, edges, params, state, traces[k],
                                          None if errors is None else errors[k])
        timings[k] = rows
        bin_idx[k] = eff
        switched[k] = sw
        fused[k] = state.fused
    return ReplayResult(timings, bin_idx, switched, fused, state)


def replay_stream(table: DimmTimingTable, traces, errors=None,
                  params: ControllerParams = ControllerParams(),
                  state: Optional[ControllerState] = None, chunk_steps: Optional[int] = None,
                  mesh=None):
    """Streamed (chunked) replay: the same state machine with no
    materialized history. Delegates to
    :func:`repro_torch.core.stream.replay_stream` (stream imports this
    module, so the import is deferred); ``mesh`` splits the DIMM axis
    there."""
    from repro_torch.core import stream as _stream

    kwargs = {} if chunk_steps is None else {"chunk_steps": chunk_steps}
    return _stream.replay_stream(table, traces, errors=errors, params=params, state=state,
                                 mesh=mesh, **kwargs)


# ---------------------------------------------------------------------------
# Stateful wrapper (the per-observation API)
# ---------------------------------------------------------------------------
class ALDRAMController:
    """Runtime timing selection with guard band, hysteresis and error fuse.

    Every :meth:`observe` is one :func:`repro_torch.core.binning.advance_bin`
    call on this DIMM's registers, which live on the host as numpy arrays,
    as do the timing rows it reads (a host copy of the table). For whole
    traces use :meth:`replay` (the whole fleet on the table's device, the
    same transition as :func:`step`)."""

    def __init__(self, table: DimmTimingTable, guard_band_c: float = GUARD_BAND_C,
                 hysteresis_c: float = HYSTERESIS_C,
                 hysteresis_steps: int = HYSTERESIS_STEPS):
        self.table = table
        self._host_table = table if table.device.type == "cpu" else table.to("cpu")
        self.guard_band_c = guard_band_c
        self.hysteresis_c = hysteresis_c
        self.hysteresis_steps = hysteresis_steps
        n, b = table.n_dimms, table.n_bins
        self._bin = np.full((n,), b - 1, np.int32)
        self._streak = np.zeros((n,), np.int32)
        self._fused = np.zeros((n,), bool)
        self.switch_count = 0
        self.fallback_count = 0

    @property
    def params(self) -> ControllerParams:
        return ControllerParams(self.guard_band_c, self.hysteresis_c, self.hysteresis_steps)

    def observe(self, dimm: int, temp_c: float) -> AccessTimings:
        """Feed a temperature observation; returns the read + write timing
        sets to program."""
        if self._fused[dimm]:
            return JEDEC_ACCESS
        new_bin, streak, switched = advance_bin(
            self.table.temp_bins, int(self._bin[dimm]), int(self._streak[dimm]), temp_c,
            guard=self.guard_band_c, margin=self.hysteresis_c,
            hysteresis_steps=self.hysteresis_steps,
        )
        self._bin[dimm] = new_bin
        self._streak[dimm] = streak
        if switched:
            self.switch_count += 1
        return self.current(dimm)

    def current(self, dimm: int) -> AccessTimings:
        if self._fused[dimm]:
            return JEDEC_ACCESS
        return self._host_table.row(dimm, int(self._bin[dimm]))

    def report_error(self, dimm: int) -> AccessTimings:
        """Reliability fallback: any observed error fuses the DIMM to JEDEC
        timings for good."""
        self._fused[dimm] = True
        self.fallback_count += 1
        return JEDEC_ACCESS

    def bin_of(self, dimm: int) -> Optional[int]:
        return None if self._fused[dimm] else int(self._bin[dimm])

    def state(self) -> ControllerState:
        """Current registers as a :class:`ControllerState` on the table's device."""
        dev = self.table.device
        return ControllerState(
            bin_idx=torch.from_numpy(self._bin.copy()).to(dev),
            cool_streak=torch.from_numpy(self._streak.copy()).to(dev),
            fused=torch.from_numpy(self._fused.copy()).to(dev),
        )

    def load_state(self, state: ControllerState) -> None:
        self._bin = state.bin_idx.detach().cpu().numpy().astype(np.int32)
        self._streak = state.cool_streak.detach().cpu().numpy().astype(np.int32)
        self._fused = state.fused.detach().cpu().numpy().astype(bool)

    def _absorb(self, state: ControllerState, switches: int, mesh) -> None:
        """Take a replay's final registers (this rank's block under a mesh,
        gathered whole here) and its switch total."""
        if mesh is not None:
            state = shard.gather_dimm(state, mesh, self.table.n_dimms)
        self.load_state(state)
        self.switch_count += switches

    def replay(self, traces, errors=None, mesh=None) -> ReplayResult:
        """Advance this controller over whole traces with :func:`replay`,
        then absorb the final registers and counters. ``mesh`` splits the
        DIMM axis as in :func:`replay` (the result is this rank's block; the
        registers absorbed are the whole fleet's)."""
        result = replay(self.table, traces, errors=errors, params=self.params,
                        state=self.state(), mesh=mesh)
        switches = result.total_switches
        if mesh is not None:
            switches = int(shard.psum(result.switched.sum().to(torch.int64), mesh))
        self._absorb(result.state, switches, mesh)
        if errors is not None:
            self.fallback_count += int(torch.as_tensor(errors).to(torch.bool).sum())
        return result

    def replay_stream(self, traces, errors=None, chunk_steps: Optional[int] = None,
                      mesh=None):
        """Advance this controller over a host-memory trace in chunks
        (:func:`replay_stream`) — the same absorption as :meth:`replay`
        without a materialized history; ``mesh`` as there."""
        result = replay_stream(self.table, traces, errors=errors, params=self.params,
                               state=self.state(), chunk_steps=chunk_steps, mesh=mesh)
        self._absorb(result.state, result.total_switches, mesh)
        self.fallback_count += result.errors_total
        return result
