"""Plain PyTorch replay chunk scan — the semantics definition.

One chunk of observations advances the controller state machine
(:func:`repro_torch.core.controller.step_plain`) step by step and folds each
step's decisions into the running :class:`ScorePartials`
(:func:`repro_torch.core.perfmodel.trace_score_accumulate_plain` on a
one-step block). Timing sums therefore take one float32 add per (step, slot) in
step order; the CUDA kernel (:mod:`.kernel`) must reproduce the final
state and partials bit for bit. Public layouts are the reference's:
``(N,)`` state, ``(N, B+1)`` occupancy, ``(N, 2, 4)`` sums,
``(N, B, 2, 4)`` stack, ``(chunk, N)`` telemetry.

:func:`chunk_scan_emit` is the decision-emitting scan (the serving path):
the same loop, which also returns each step's realized rows, switch flags
and effective bins; :func:`emit_scan` adds the post-step fuse flags
(the kernel's emitting entry's plain version).

:func:`region_chunk_scan` adds the int32 ``(N, B+1, R)`` region-access-count
carry of a region-profiled table's stream; it has no kernel of its own (on a
card the stream advances each step on the chunk kernel and adds that step's
mix row at its effective bin).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.controller import ControllerParams, ControllerState, step_plain
from repro_torch.core.perfmodel import (
    ScorePartials,
    region_counts_add_,
    trace_score_accumulate_plain,
)


def chunk_body(stack: torch.Tensor, edges: torch.Tensor, params: ControllerParams,
               state: ControllerState, partials: ScorePartials, temps: torch.Tensor,
               errors: Optional[torch.Tensor], history=None
               ) -> Tuple[ControllerState, ScorePartials]:
    """Scan one chunk, accumulating score partials per step. ``history``,
    optional ``(rows (c, N, 2, 4), switched (c, N), eff (c, N), fused (c,
    N))`` tensors, receives each step's decisions."""
    for k in range(temps.shape[0]):
        state, rows, switched, eff = step_plain(
            stack, edges, params, state, temps[k], None if errors is None else errors[k]
        )
        partials = trace_score_accumulate_plain(partials, rows[None], eff[None], switched[None])
        if history is not None:
            for dst, v in zip(history, (rows, switched, eff, state.fused)):
                dst[k] = v
    return state, partials


def emit_scan(stack, edges, params, state, occupancy, switches, timing_sums, n_steps,
              temps, errors):
    """:func:`chunk_scan_emit`, and the ``(chunk, N)`` post-step fuse flags
    last: ``(state, occupancy, switches, timing_sums, n_steps, rows,
    switched, eff, fused)``."""
    c, n = temps.shape
    dev = temps.device
    history = (torch.empty((c, n, 2, 4), dtype=torch.float32, device=dev),
               torch.empty((c, n), dtype=torch.bool, device=dev),
               torch.empty((c, n), dtype=torch.int32, device=dev),
               torch.empty((c, n), dtype=torch.bool, device=dev))
    partials = ScorePartials(occupancy, switches, timing_sums, n_steps)
    state, partials = chunk_body(stack, edges, params, state, partials, temps, errors, history)
    return (state,) + tuple(partials) + history


def chunk_scan(stack, edges, params, state, occupancy, switches, timing_sums, n_steps,
               temps, errors):
    """Memory-bounded chunk scan with the reference's signature: returns
    ``(state, occupancy, switches, timing_sums, n_steps)`` and nothing
    step-indexed."""
    partials = ScorePartials(occupancy, switches, timing_sums, n_steps)
    state, partials = chunk_body(stack, edges, params, state, partials, temps, errors)
    return (state,) + tuple(partials)


def chunk_scan_emit(stack, edges, params, state, occupancy, switches, timing_sums, n_steps,
                    temps, errors):
    """Decision-emitting chunk scan with the reference's signature and
    return order: ``(state, occupancy, switches, timing_sums, n_steps,
    rows (c, N, 2, 4) float32, switched (c, N) bool, eff (c, N) int32)``;
    the partials are those of :func:`chunk_scan` bitwise."""
    return emit_scan(stack, edges, params, state, occupancy, switches, timing_sums, n_steps,
                     temps, errors)[:8]


def region_chunk_scan(stack, edges, params, state, occupancy, switches, timing_sums, n_steps,
                      region_counts, temps, errors, region_mix):
    """:func:`chunk_scan` plus the region-count carry: each step advances the
    same state machine on ``stack``, the region-oblivious ``(N, B, 2, 4)``
    registers (bin dynamics depend on the temperature only), then adds that
    step's ``(N, R)`` row of ``region_mix`` at its effective bin. Returns
    ``(state, occupancy, switches, timing_sums, n_steps, region_counts)``;
    the partials are those of :func:`chunk_scan` bitwise."""
    partials = ScorePartials(occupancy, switches, timing_sums, n_steps)
    counts = region_counts.clone(memory_format=torch.contiguous_format)
    for k in range(temps.shape[0]):
        state, rows, switched, eff = step_plain(
            stack, edges, params, state, temps[k], None if errors is None else errors[k]
        )
        partials = trace_score_accumulate_plain(partials, rows[None], eff[None], switched[None])
        region_counts_add_(counts, eff[None], region_mix[k:k + 1])
    return (state,) + tuple(partials) + (counts,)
