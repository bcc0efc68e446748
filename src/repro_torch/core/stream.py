"""Streaming (chunked) controller replay with constant device memory.

The controller is a runtime service over an unbounded observation stream,
so nothing step-indexed is kept: each ``(chunk_steps, n_dimms)`` chunk of
telemetry runs through the fused replay chunk scan
(:func:`repro_torch.kernels.replay_step.ops.chunk_scan` — the CUDA kernel
on the card), and only the controller state and the running
:class:`~repro_torch.core.perfmodel.ScorePartials` are carried. Realized
timings are cycle-quantized, so the float32 sums are exact under any
chunking, and :meth:`StreamingController.score` is the same finalize the
materialized scorer runs.

The engine keeps state and partials slot-major (``(3, N)``, ``(B+1, N)``,
``(8, N)``) so the kernel reads them coalesced; they convert to the public
layouts only when :attr:`~StreamingController.state`,
:attr:`~StreamingController.partials` or :meth:`~StreamingController.score`
is read.

A caller that programs hardware asks for each chunk's decisions
(:meth:`StreamingController.ingest` ``return_decisions=True``): the realized
``(chunk, N, 2, 4)`` rows, effective bins and switch flags, from the
kernel's emitting entry on the card and the plain emit scan on the CPU.
The engine keeps none of them; emitting and non-emitting chunks may
alternate, and the partials stay bitwise those of a non-emitting stream.

A region-profiled table's stream may carry a per-step region-access mix
(:func:`replay_stream` ``region_mix=``): the engine then also carries int32
``(N, B+1, R)`` counts of the accesses each region took in each effective
bin. On the CPU a chunk runs the plain
:func:`~repro_torch.kernels.replay_step.ref.region_chunk_scan`; on the card
each chunk is one launch of the emitting entry on the running partials,
asking only for the effective bins, and the chunk's mix is added at them,
so the partials are those of a mix-free stream bitwise.

Ingestion (:class:`_Ingestor`): on the card each chunk is copied into one
of two pinned host buffers and sent with a ``non_blocking`` copy on a side
stream; events order the copy before the kernel that reads it and the next
reuse of a buffer after that kernel, so while the card copies and scans
chunk k the host fills the other buffer with chunk k+1. The buffers are
allocated when the engine is built (``chunk_steps``) or at the first chunk
that outgrows them; error buffers only once a chunk carries errors.

Under a mesh (``mesh=``, :func:`~repro_torch.core.shard.fleet_mesh`) each rank
holds its padded block of DIMMs (:func:`~repro_torch.core.shard.local_block`)
of the state, the partials and the table, and the replay kernel runs on that
block: telemetry chunks still arrive full width on every rank, and the
ingestor stages only the rank's columns (padding on the host only for a block
that reaches past the fleet). The state, partials, decisions and region counts
a caller reads are the rank's real DIMMs; the switch total is summed across
ranks, and the score is the sharded finalize
(:func:`~repro_torch.core.perfmodel.trace_score_finalize` ``mesh=``), so a
streamed sharded score is bitwise the materialized sharded one.
"""

from __future__ import annotations

from typing import Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import shard
from repro_torch.core.controller import (
    ControllerParams,
    ControllerState,
    DimmTimingTable,
    init_state,
)
from repro_torch.core.perfmodel import (
    MULTI_CORE,
    PAPER_CLAIM_SPEEDUP,
    WORKLOADS,
    ScorePartials,
    region_counts_add_,
    region_counts_init,
    region_score_finalize,
    trace_score_finalize,
    trace_score_init,
)
from repro_torch.kernels.replay_step import ops as replay_ops
from repro_torch.kernels.replay_step import ref as replay_ref

#: Default step-axis chunk length: 256 minute-cadence observations ≈ 4 h.
DEFAULT_CHUNK_STEPS: int = 256


def iter_chunks(traces, errors=None, chunk_steps: int = DEFAULT_CHUNK_STEPS
                ) -> Iterator[Tuple[object, Optional[object]]]:
    """Slice a materialized ``(n_steps, n_dimms)`` trace into
    ``(temps_chunk, errors_chunk)`` pairs (the last chunk may be ragged)."""
    if chunk_steps < 1:
        raise ValueError(f"chunk_steps must be >= 1, got {chunk_steps}")
    for s in range(0, traces.shape[0], chunk_steps):
        e = None if errors is None else errors[s:s + chunk_steps]
        yield traces[s:s + chunk_steps], e


def _host_tensor(a, dtype: torch.dtype) -> torch.Tensor:
    if not isinstance(a, torch.Tensor):
        a = np.asarray(a)
        t = torch.from_numpy(a if a.flags.writeable else a.copy())
    else:
        t = a
    if t.device.type != "cpu":
        raise ValueError(f"telemetry chunks arrive in host memory, got {t.device}")
    return t.to(dtype)


class _Slot:
    """One staging pair for up to ``rows`` steps: pinned host memory and its
    device twin. The error pair is added by :meth:`errors` when first needed.

    The device buffers come from the caching allocator on the compute
    stream, which may hand out a block that work still queued there (on
    the tensor the block last held) reads or writes; the side stream that
    fills the buffers is not ordered after that work. So ``consumed`` is
    recorded on the compute stream at each allocation, and the first copy
    into a new buffer waits for it, as every later copy waits for the
    kernel that read the buffer last."""

    def __init__(self, rows: int, n_dimms: int, device: torch.device):
        self.rows = rows
        self.host_temps = torch.empty((rows, n_dimms), dtype=torch.float32, pin_memory=True)
        self.temps = torch.empty((rows, n_dimms), dtype=torch.float32, device=device)
        self.host_errs: Optional[torch.Tensor] = None
        self.errs: Optional[torch.Tensor] = None
        self.copied = torch.cuda.Event()    # H2D done: device ready, host reusable
        self.consumed = torch.cuda.Event()  # the compute stream is done with the device buffers
        self.consumed.record(torch.cuda.current_stream(device))

    def errors(self) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.errs is None:
            shape, dev = self.temps.shape, self.temps.device
            self.host_errs = torch.empty(shape, dtype=torch.uint8, pin_memory=True)
            self.errs = torch.empty(shape, dtype=torch.uint8, device=dev)
            self.consumed.record(torch.cuda.current_stream(dev))
        return self.host_errs, self.errs


class _Ingestor:
    """Host → device chunk feeder (see the module docstring). ``cols`` —
    ``(lo, hi, b)``: stage the block of ``b`` columns that starts with the
    real columns ``lo:hi`` of each ``n_dimms``-wide chunk (default: all)."""

    def __init__(self, n_dimms: int, device: torch.device, rows: int = 0,
                 cols: Optional[Tuple[int, int, int]] = None):
        self.n_dimms = n_dimms
        self.cols = (0, n_dimms, n_dimms) if cols is None else cols
        self.width = self.cols[2]
        self.device = device
        self.errors_seen = 0
        self._slots = [None, None]
        self._next = 0
        self._no_errors: Optional[torch.Tensor] = None  # device zeros: errs of error-free chunks
        self._copy_stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        if rows:
            self.reserve(rows)

    def reserve(self, rows: int) -> None:
        """On a card, allocate both slots and the error-free buffer for
        chunks of up to ``rows`` steps (a no-op where they are large enough)."""
        if self._copy_stream is None:
            return
        for i, slot in enumerate(self._slots):
            if slot is None or slot.rows < rows:
                if slot is not None:
                    slot.consumed.synchronize()
                    slot.copied.synchronize()
                self._slots[i] = _Slot(rows, self.width, self.device)
        if self._no_errors is None or self._no_errors.shape[0] < rows:
            self._no_errors = torch.zeros((rows, self.width), dtype=torch.uint8,
                                          device=self.device)

    def stage(self, temps, errors) -> Tuple[torch.Tensor, torch.Tensor, Optional[_Slot]]:
        """Validate one full-width chunk and make its column block readable
        on the compute stream. Returns ``(temps (c, b) float32, errs (c, b)
        uint8, slot)``; pass the slot to :meth:`release` after launching the
        work that reads it."""
        temps = _host_tensor(temps, torch.float32)
        if temps.dim() != 2 or temps.shape[1] != self.n_dimms:
            raise ValueError(f"chunk must be (chunk_steps, {self.n_dimms}), "
                             f"got {tuple(temps.shape)}")
        if errors is not None:
            errors = _host_tensor(errors, torch.bool)
            if errors.shape != temps.shape:
                raise ValueError(f"errors chunk shape {tuple(errors.shape)} != "
                                 f"temps {tuple(temps.shape)}")
            self.errors_seen += int(errors.sum())
        lo, hi, b = self.cols
        if self._copy_stream is None:
            errs = (torch.zeros((temps.shape[0], b), dtype=torch.uint8) if errors is None
                    else shard.padded_block(errors, lo, hi, b, axis=1).to(torch.uint8))
            return (shard.padded_block(temps, lo, hi, b, axis=1).contiguous(),
                    errs.contiguous(), None)

        c = temps.shape[0]
        self.reserve(c)
        slot = self._slots[self._next]
        self._next ^= 1
        slot.copied.synchronize()  # the last copy out of this pinned buffer is done
        shard.padded_block(temps, lo, hi, b, axis=1, out=slot.host_temps[:c])
        if errors is not None:
            host_errs, errs = slot.errors()
            shard.padded_block(errors, lo, hi, b, axis=1, out=host_errs[:c])
        with torch.cuda.stream(self._copy_stream):
            self._copy_stream.wait_event(slot.consumed)
            slot.temps[:c].copy_(slot.host_temps[:c], non_blocking=True)
            if errors is not None:
                errs[:c].copy_(host_errs[:c], non_blocking=True)
            slot.copied.record(self._copy_stream)
        torch.cuda.current_stream(self.device).wait_event(slot.copied)
        return slot.temps[:c], (self._no_errors if errors is None else errs)[:c], slot

    def release(self, slot: Optional[_Slot]) -> None:
        """Mark the slot's device buffers free once the queued work ends."""
        if slot is not None:
            slot.consumed.record(torch.cuda.current_stream(self.device))


class StreamResult(NamedTuple):
    """Final controller registers and accumulated score partials."""

    state: ControllerState
    partials: ScorePartials
    table: DimmTimingTable
    n_chunks: int
    errors_total: int
    #: (n_dimms, n_bins + 1, n_regions) int32 region-access counts, only when
    #: the stream carried a region mix (``replay_stream(region_mix=)``).
    region_counts: Optional[torch.Tensor] = None
    #: The stream's ``"dimm"`` mesh: state, partials, switch and region counts
    #: are then this rank's real DIMMs.
    mesh: object = None

    @property
    def n_steps(self) -> int:
        return int(self.partials.n_steps)

    @property
    def switch_counts(self) -> torch.Tensor:
        """(N,) int32 per-DIMM timing-set switches over the stream (this
        rank's DIMMs under a mesh)."""
        return self.partials.switches

    @property
    def total_switches(self) -> int:
        """Switches over the stream, all DIMMs (summed across ranks)."""
        total = self.partials.switches.to(torch.int64).sum()
        return int(total if self.mesh is None else shard.psum(total, self.mesh))

    def score(self, cfg=MULTI_CORE, claim: float = PAPER_CLAIM_SPEEDUP,
              workloads=WORKLOADS):
        """The trace-score dict, with the table's refresh figures; under a
        mesh, the sharded finalize on the stream's own mesh (the partials
        are this rank's block, so no other mesh can finalize them)."""
        return trace_score_finalize(self.partials, self.table.oblivious_stack(),
                                    cfg, claim, workloads, self.table.bin_refresh(),
                                    mesh=self.mesh)

    def region_score(self, cfg=MULTI_CORE, claim: float = PAPER_CLAIM_SPEEDUP,
                     workloads=WORKLOADS):
        """The region-score dict of the streamed counts and the table's rank-5
        registers, equal to the materialized ``region_trace_score``. Under a
        mesh the counts are gathered (``(N, B+1, R)`` int32) and every rank
        runs the single-device finalize."""
        if self.region_counts is None:
            raise ValueError("this stream carried no region mix; pass region_mix= to "
                             "replay_stream")
        counts = self.region_counts
        if self.mesh is not None:
            counts = shard.gather_dimm(counts, self.mesh, self.table.n_dimms)
        return region_score_finalize(counts, self.table.region_stack(), cfg, claim,
                                     workloads)


class StreamingController:
    """Stateful fleet-controller engine over an observation stream: feed it
    batched chunks (:meth:`ingest`), read the running score (:meth:`score`).
    It runs on the table's device and retains O(n_dimms) state. On a card,
    ``chunk_steps`` sizes the staging buffers up front and the replay kernel
    is built and loaded here, so neither lands inside the first chunk.
    ``mesh`` splits the DIMM axis (see the module docstring); ``table`` and
    ``state`` are whole on every rank."""

    def __init__(self, table: DimmTimingTable,
                 params: ControllerParams = ControllerParams(),
                 state: Optional[ControllerState] = None, chunk_steps: int = 0,
                 mesh=None):
        self.table = table
        self.params = params
        self.mesh = mesh
        dev = table.device
        n = table.n_dimms
        if state is None:
            state = init_state(n, table.n_bins, dev)
        cols = None
        self._stack = table.oblivious_stack()
        self._real = n
        if mesh is not None:
            lo, hi = shard.local_range(n, mesh)
            cols, self._real = (lo, hi, shard.block_size(n, mesh)), hi - lo
            self._stack, state = (shard.local_block(x, mesh, n)
                                  for x in (self._stack, state))
        width = self._stack.shape[0]
        self._scal = replay_ops.replay_scalars(table.temp_bins, params)
        self._stack_t = replay_ops.to_stack_t(self._stack)
        self._state3 = replay_ops.to_state3(state)
        self._occ, self._sw, self._sums = replay_ops.to_slot_partials(
            trace_score_init(width, table.n_bins, dev)
        )
        self._n_steps = 0
        self._region_counts: Optional[torch.Tensor] = None
        self._ingest = _Ingestor(n, dev, rows=chunk_steps, cols=cols)
        if dev.type == "cuda":
            replay_ops.load_kernel()
        self.n_chunks = 0

    def _block_state(self) -> ControllerState:
        return replay_ops.from_state3(self._state3)

    def _block_partials(self) -> ScorePartials:
        return replay_ops.from_slot_partials(self._occ, self._sw, self._sums, self._n_steps)

    @property
    def state(self) -> ControllerState:
        """The registers (this rank's real DIMMs under a mesh)."""
        return shard.slice_dimm(self._block_state(), self._real)

    @property
    def partials(self) -> ScorePartials:
        """The score partials (this rank's real DIMMs under a mesh)."""
        p = self._block_partials()
        return p._replace(occupancy=p.occupancy[:self._real], switches=p.switches[:self._real],
                          timing_sums=p.timing_sums[:self._real])

    @property
    def n_steps(self) -> int:
        return self._n_steps

    @property
    def errors_total(self) -> int:
        return self._ingest.errors_seen

    @property
    def total_switches(self) -> torch.Tensor:
        """Timing-set switches over the stream, all DIMMs: a 0-d int64 tensor
        on the engine's device, computed when read and never copied to the
        host here (``int()`` reads it), so reading it each chunk adds no
        host sync to a serve loop. Under a mesh each rank sums its real DIMMs
        and the ranks' sums are ``all_reduce``d (on cards an NCCL
        collective queued on the device, still no host sync)."""
        total = self._sw[:self._real].to(torch.int64).sum()
        return total if self.mesh is None else shard.psum(total, self.mesh)

    def ingest(self, temps, errors=None, return_decisions: bool = False):
        """Absorb one ``(chunk_steps, n_dimms)`` chunk from host memory (a
        1-D ``(n_dimms,)`` row is one step). The chunk's scan is queued on
        the device and nothing step-indexed is kept. With
        ``return_decisions=True`` returns ``(timings (c, N, 2, 4) float32,
        bin_idx (c, N) int32, switched (c, N) bool)`` on the engine's device
        — the realized rows, the effective bin (``n_bins`` = the JEDEC
        sentinel) and the switch flags — which the caller owns; otherwise
        ``None``. State and partials advance the same either way. Under a
        mesh the chunk is full width and the decisions are this rank's real
        DIMMs, ``(c, hi - lo, ...)``."""
        dec = self._absorb(temps, errors, emit=return_decisions)
        if dec is None:
            return None
        return dec.rows[:, :self._real], dec.eff[:, :self._real], dec.switched[:, :self._real]

    def _absorb(self, temps, errors, region_mix: Optional[torch.Tensor] = None,
                emit: bool = False):
        """:meth:`ingest`, with the chunk's ``(c, N, R)`` region mix when the
        stream carries one (:func:`replay_stream`). Returns the chunk's
        :class:`~repro_torch.kernels.replay_step.kernel.Decisions` when
        ``emit``, else ``None``."""
        if np.ndim(temps) == 1:
            temps = temps[None]
            errors = None if errors is None else errors[None]
        temps_d, errs_d, slot = self._ingest.stage(temps, errors)
        if region_mix is not None and self.mesh is not None:
            region_mix = shard.local_block(region_mix, self.mesh, self.table.n_dimms, axis=1)
        dec = None
        carry = (self._state3, self._occ, self._sw, self._sums, self._stack_t,
                 temps_d, errs_d, self._scal)
        if region_mix is not None:
            self._scan_regions(temps_d, errs_d, region_mix)
        elif emit:
            *out, dec = replay_ops.chunk_scan_emit(*carry)
            self._state3, self._occ, self._sw, self._sums = out
        else:
            self._state3, self._occ, self._sw, self._sums = replay_ops.chunk_scan(*carry)
        self._ingest.release(slot)
        self._n_steps += int(temps_d.shape[0])
        self.n_chunks += 1
        return dec

    def _scan_regions(self, temps_d: torch.Tensor, errs_d: torch.Tensor,
                      region_mix: torch.Tensor) -> None:
        """One chunk with the region-count carry (see the module docstring)."""
        table = self.table
        if self._region_counts is None:
            self._region_counts = region_counts_init(self._stack.shape[0], table.n_bins,
                                                     table.n_regions, table.device)
        if table.device.type == "cpu":
            edges = torch.tensor(table.temp_bins, dtype=torch.float32)
            out = replay_ref.region_chunk_scan(
                self._stack, edges, self.params, self._block_state(), *self._block_partials(),
                self._region_counts, temps_d, errs_d != 0, region_mix)
            self._state3 = replay_ops.to_state3(out[0])
            self._occ, self._sw, self._sums = replay_ops.to_slot_partials(
                ScorePartials(*out[1:5]))
            self._region_counts = out[5]
            return
        self._state3, self._occ, self._sw, self._sums, dec = replay_ops.chunk_scan_emit(
            self._state3, self._occ, self._sw, self._sums, self._stack_t,
            temps_d, errs_d, self._scal, fields=("eff",),
        )
        region_counts_add_(self._region_counts, dec.eff, region_mix)

    def score(self, cfg=MULTI_CORE, claim: float = PAPER_CLAIM_SPEEDUP,
              workloads=WORKLOADS):
        """The running trace-score dict over everything ingested so far,
        with the refresh figures when the table carries a refresh policy
        (under a mesh, the sharded finalize: the same dict on every rank)."""
        return self.result().score(cfg, claim, workloads)

    def result(self) -> StreamResult:
        counts = self._region_counts
        return StreamResult(state=self.state, partials=self.partials, table=self.table,
                            n_chunks=self.n_chunks, errors_total=self.errors_total,
                            region_counts=None if counts is None else counts[:self._real],
                            mesh=self.mesh)


def replay_stream(table: DimmTimingTable, traces, errors=None,
                  params: ControllerParams = ControllerParams(),
                  state: Optional[ControllerState] = None,
                  chunk_steps: int = DEFAULT_CHUNK_STEPS,
                  region_mix=None, mesh=None) -> StreamResult:
    """Replay a host-memory ``(n_steps, n_dimms)`` trace in step-axis chunks
    through a :class:`StreamingController`.

    ``region_mix`` — optional ``(n_steps, n_dimms, n_regions)`` int32
    per-step region-access counts of the table's regions (a tensor on the
    table's device or on the host, or an array): the stream then carries the
    region counts (:attr:`StreamResult.region_counts`,
    :meth:`StreamResult.region_score`), chunked in lockstep with the trace,
    equal to a materialized accumulation at every chunking.

    ``mesh`` — a 1-D ``"dimm"`` mesh: the trace (and mix) are whole on every
    rank and each rank's engine runs its block of DIMMs (see the module
    docstring); the result is that of :class:`StreamingController` under
    the mesh."""
    if region_mix is not None:
        if not hasattr(traces, "shape"):
            raise ValueError("region_mix requires a materialized (n_steps, n_dimms) "
                             "traces array (chunked in lockstep with the mix)")
        region_mix = torch.as_tensor(region_mix)
        if region_mix.dim() != 3 or region_mix.shape[2] != table.n_regions:
            raise ValueError(f"region_mix must be (n_steps, n_dimms, {table.n_regions}), "
                             f"got {tuple(region_mix.shape)}")
        if tuple(region_mix.shape[:2]) != tuple(traces.shape):
            raise ValueError(f"region_mix leading shape {tuple(region_mix.shape[:2])} != "
                             f"traces shape {tuple(traces.shape)}")
    if traces.shape[1] != table.n_dimms:
        raise ValueError(f"trace has {traces.shape[1]} DIMMs, table has {table.n_dimms}")
    engine = StreamingController(table, params, state, mesh=mesh)
    for s, (temps, errs) in zip(range(0, traces.shape[0], chunk_steps),
                                iter_chunks(traces, errors, chunk_steps)):
        engine._absorb(temps, errs,
                       None if region_mix is None else region_mix[s:s + chunk_steps])
    return engine.result()
