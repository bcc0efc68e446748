"""Policy folding, layout conversion and dispatch for the fused replay
chunk scan and the fused score accumulation.

:func:`chunk_scan` runs one chunk on the slot-major operands of
:mod:`.kernel`: a CPU tensor goes to the plain version
(:func:`.kernel.replay_chunk_plain`), a CUDA tensor to the CUDA kernel
(:func:`.kernel.replay_chunk_cuda`), which raises if it cannot launch.
:func:`chunk_scan_emit` does the same for the emitting entry, which also
returns each step's decisions (:class:`.kernel.Decisions`).
:func:`replay_history` is ``controller.replay`` on a card: the emitting
entry writing the dense history in place, one launch a
:data:`REPLAY_CHUNK_STEPS` steps. :class:`StepKernel` is
``controller.step`` on a card: the emitting entry at chunk 1.
:func:`accumulate_chunk` is ``perfmodel.trace_score_accumulate``
on a card (:func:`.kernel.accumulate_cuda`). The ``to_*`` / ``from_*``
helpers convert between the public layouts and the slot-major ones; the
streaming engine converts the table once and the partials only when they
are read.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.controller import JEDEC_ROWS, ControllerParams, ControllerState
from repro_torch.core.perfmodel import ScorePartials
from repro_torch.kernels.replay_step.kernel import (
    ROW_SLOTS,
    Decisions,
    Operands,
    ReplayScalars,
    _lib,
    accumulate_cuda,
    accumulate_plain,
    replay_chunk_cuda,
    replay_chunk_emit_cuda,
    replay_chunk_emit_plain,
    replay_chunk_plain,
)

#: Steps a launch of :func:`replay_history` takes; ``None``: the whole trace
#: in one launch.
REPLAY_CHUNK_STEPS: Optional[int] = None


def replay_scalars(temp_bins: Sequence[float], params: ControllerParams) -> ReplayScalars:
    """Fold the controller policy into the scan's scalars, each rounded
    f64 → f32 (``float(np.float32(x))`` is exact), so the scan's float32
    view of every scalar equals the reference's ``float32`` policy."""
    return ReplayScalars(
        edges=tuple(float(np.float32(e)) for e in temp_bins),
        guard_band_c=float(np.float32(params.guard_band_c)),
        hysteresis_c=float(np.float32(params.hysteresis_c)),
        hysteresis_steps=int(params.hysteresis_steps),
        jedec=tuple(float(np.float32(v)) for row in JEDEC_ROWS for v in row),
    )


def load_kernel() -> None:
    """Build (if needed) and load the CUDA kernel's library now."""
    _lib()


def chunk_scan(state3, occ, sw, sums, stack_t, temps, errs, scal: ReplayScalars) -> Operands:
    """Advance one chunk on the operands' device: CPU → plain, CUDA → kernel."""
    if state3.device.type == "cpu":
        return replay_chunk_plain(state3, occ, sw, sums, stack_t, temps, errs, scal)
    return replay_chunk_cuda(state3, occ, sw, sums, stack_t, temps, errs, scal)


def chunk_scan_emit(state3, occ, sw, sums, stack_t, temps, errs, scal: ReplayScalars,
                    fields: Sequence[str] = ("rows", "eff", "switched")):
    """Advance one chunk and emit its decisions on the operands' device:
    CPU → plain, CUDA → the kernel's emitting entry, writing only the named
    :class:`.kernel.Decisions` fields (the rest are ``None``). Returns
    ``(state3, occ, sw, sums, decisions)``."""
    if state3.device.type == "cpu":
        *carry, dec = replay_chunk_emit_plain(state3, occ, sw, sums, stack_t, temps, errs, scal)
        return (*carry, Decisions(*(t if k in fields else None
                                    for k, t in dec._asdict().items())))
    out = Decisions.empty(temps.shape[0], state3.shape[1], state3.device, fields)
    return replay_chunk_emit_cuda(state3, occ, sw, sums, stack_t, temps, errs, scal, out)


def _partials_zero(n_bins: int, n: int, device) -> Tuple[torch.Tensor, ...]:
    return (torch.zeros((n_bins + 1, n), dtype=torch.int32, device=device),
            torch.zeros((n,), dtype=torch.int32, device=device),
            torch.zeros((ROW_SLOTS, n), dtype=torch.float32, device=device))


def replay_history(stack: torch.Tensor, temp_bins: Sequence[float], params: ControllerParams,
                   state: ControllerState, traces: torch.Tensor,
                   errors: Optional[torch.Tensor], out: Decisions,
                   chunk_steps: Optional[int]) -> ControllerState:
    """``controller.replay`` on a card: run the emitting entry over the
    ``(S, N)`` float32 trace on the card, ``chunk_steps`` steps a launch
    (``None``: one launch), writing each step's decisions into ``out``'s
    ``(S, N, ...)`` tensors in place (bool fields through uint8 views).
    Returns the final state; the partials it carries are dropped."""
    n_steps, n = traces.shape
    dev = traces.device
    c = n_steps if chunk_steps is None else chunk_steps
    scal = replay_scalars(temp_bins, params)
    stack_t = to_stack_t(stack)
    zero = _partials_zero(len(temp_bins), n, dev)
    traces = traces.contiguous()
    if errors is None:
        no_errors = torch.zeros((min(c, n_steps), n), dtype=torch.uint8, device=dev)
    else:
        errors = errors.contiguous().view(torch.uint8)
    state3 = to_state3(state)
    for s in range(0, n_steps, max(c, 1)):
        e = min(s + c, n_steps)
        errs = no_errors[:e - s] if errors is None else errors[s:e]
        state3, *_ = replay_chunk_emit_cuda(state3, *zero, stack_t, traces[s:e], errs, scal,
                                            Decisions(*(t[s:e] for t in out)))
    return from_state3(state3)


class StepKernel:
    """``controller.step`` on a card, bound to one table: each call launches
    the emitting entry for one step, which writes the realized rows, the
    effective bin and the switch flag directly. The table is converted to
    the slot-major layout once, here; the partials it carries are dropped."""

    def __init__(self, stack: torch.Tensor, temp_bins: Sequence[float],
                 params: ControllerParams):
        n, n_bins = stack.shape[0], len(temp_bins)
        dev = stack.device
        self.scal = replay_scalars(temp_bins, params)
        self.stack_t = to_stack_t(stack)
        self.zero = _partials_zero(n_bins, n, dev)
        self.no_errors = torch.zeros((1, n), dtype=torch.uint8, device=dev)

    def __call__(self, state: ControllerState, temps_c: torch.Tensor,
                 errors: Optional[torch.Tensor] = None):
        n = self.stack_t.shape[1]
        temps = temps_c.to(torch.float32).reshape(1, n).contiguous()
        errs = (self.no_errors if errors is None
                else errors.to(torch.uint8).reshape(1, n).contiguous())
        state3, _, _, _, dec = chunk_scan_emit(to_state3(state), *self.zero, self.stack_t,
                                               temps, errs, self.scal)
        return from_state3(state3), dec.rows[0], dec.switched[0], dec.eff[0]


def step_kernel(stack, edges, params: ControllerParams, state: ControllerState, temps_c,
                errors=None):
    """One fleet observation on a card; ``controller.step``'s contract."""
    return StepKernel(stack, edges.tolist(), params)(state, temps_c, errors)


def accumulate_chunk(partials: ScorePartials, timings, bin_idx, switched) -> ScorePartials:
    """``perfmodel.trace_score_accumulate`` through the fused kernel: fold a
    ``(chunk, N)`` block of replay outputs into the running partials on the
    operands' device — CPU → plain, CUDA → kernel."""
    fn = accumulate_plain if partials.occupancy.device.type == "cpu" else accumulate_cuda
    occ, sw, sums = fn(
        partials.occupancy.contiguous(), partials.switches.contiguous(),
        partials.timing_sums.contiguous(), timings.to(torch.float32).contiguous(),
        bin_idx.to(torch.int32).contiguous(),
        switched.contiguous().view(torch.uint8) if switched.dtype == torch.bool
        else switched.to(torch.uint8).contiguous(),
    )
    return ScorePartials(occ, sw, sums, partials.n_steps + int(timings.shape[0]))


# ---------------------------------------------------------------------------
# Public layout <-> slot-major layout
# ---------------------------------------------------------------------------
def to_stack_t(stack: torch.Tensor) -> torch.Tensor:
    """``(N, B, 2, 4)`` table → ``(B * 8, N)`` slot-major."""
    n = stack.shape[0]
    return stack.reshape(n, -1).t().contiguous()


def to_state3(state: ControllerState) -> torch.Tensor:
    return torch.stack([state.bin_idx.to(torch.int32), state.cool_streak.to(torch.int32),
                        state.fused.to(torch.int32)]).contiguous()


def from_state3(state3: torch.Tensor) -> ControllerState:
    return ControllerState(bin_idx=state3[0], cool_streak=state3[1], fused=state3[2] != 0)


def to_slot_partials(p: ScorePartials) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(occupancy, switches, timing_sums)`` → ``(occ (B+1, N), sw, sums (8, N))``."""
    n = p.switches.shape[0]
    return (p.occupancy.t().contiguous(), p.switches.contiguous(),
            p.timing_sums.reshape(n, ROW_SLOTS).t().contiguous())


def from_slot_partials(occ: torch.Tensor, sw: torch.Tensor, sums: torch.Tensor,
                       n_steps: int) -> ScorePartials:
    n = sw.shape[0]
    return ScorePartials(
        occupancy=occ.t().contiguous(), switches=sw,
        timing_sums=sums.t().reshape(n, 2, 4).contiguous(),
        n_steps=torch.tensor(n_steps, dtype=torch.int32, device=sw.device),
    )
