"""Execution-parameter profiler — the FPGA-test-platform analogue for
kernels, ported from the reference (``src/repro/core/altune/profiler.py``).

For each candidate config of a kernel/shape class:
1. **Feasibility** (the timing-violation analogue): the tile gate of the
   cost model; an infeasible config is "erroneous at any latency".
2. **Correctness validation**: run the kernel (the plain version on a CPU
   tensor, the CUDA kernel on a CUDA tensor) against its oracle across
   *adversarial data patterns* — the analogue of the paper's
   checkerboard/walking-bit tests — with repeatability (N trials, fresh
   random draws). A config the kernel is not instantiated for raises on the
   card and is recorded exactly as the reference records a compile error:
   not validated.
3. **Latency**: the analytical cost model (SPICE analogue) by default;
   ``backend="wallclock"`` times real executions (CUDA events on a card:
   one warm-up, then the mean of 3 runs). The estimate is kept beside a
   measured time.

The outcome is a :class:`ProfileEntry` per candidate; ``select()`` returns
the fastest *validated* one, falling back to the worst-case config — the
same guarantee shape as AL-DRAM's per-DIMM minimal safe timings. The
patterns are drawn on the profiled device from a ``torch.Generator``
seeded with ``seed``: ``zeros``, ``ones`` and ``alternating`` are the
reference's exactly, the random ones are torch's draws, not ``jax.random``'s.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from repro_torch import resolve_device


def _patterns(gen: torch.Generator, shape, dtype, device):
    """Adversarial data patterns (name, tensor), drawn lazily."""
    normal = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    yield "random", normal.to(dtype)
    yield "zeros", torch.zeros(shape, dtype=dtype, device=device)
    yield "ones", torch.ones(shape, dtype=dtype, device=device)
    parity = torch.arange(math.prod(shape), device=device).reshape(shape) % 2
    yield "alternating", torch.where(parity == 0, 1.0, -1.0).to(dtype)
    yield "large", (normal * 1e4).to(dtype)
    yield "tiny", (normal * 1e-4).to(dtype)


@dataclasses.dataclass
class ProfileEntry:
    config: object
    feasible: bool
    validated: bool
    t_seconds: float
    bound: str
    fail_pattern: Optional[str] = None
    repeat_ok: bool = True
    estimate_s: float = math.inf   # the cost model's time, beside a measured one


@dataclasses.dataclass
class ProfileResult:
    kernel: str
    shape_key: str
    entries: List[ProfileEntry]
    worst_case: object

    def select(self) -> object:
        """Fastest validated config; worst-case fallback (the guarantee)."""
        ok = [e for e in self.entries if e.feasible and e.validated and e.repeat_ok]
        if not ok:
            return self.worst_case
        return min(ok, key=lambda e: e.t_seconds).config

    def margin(self) -> float:
        """Harvested latency margin vs the worst-case config (the paper's
        Fig.2 quantity, transplanted)."""
        wc = [e for e in self.entries if e.config == self.worst_case]
        best = self.select()
        bt = [e for e in self.entries if e.config == best]
        if not wc or not bt or not wc[0].t_seconds:
            return 0.0
        return 1.0 - bt[0].t_seconds / wc[0].t_seconds


def _close(out, ref, rtol: float, atol: float) -> bool:
    """Scale-aware closeness: |out−ref|∞ ≤ rtol·|ref|∞ + atol, in float32 on
    the tensors' device. Elementwise rtol would flag benign cancellation
    (large inputs, near-zero outputs)."""
    out = torch.as_tensor(out).float()
    ref = torch.as_tensor(ref).float()
    return float((out - ref).abs().max()) <= rtol * float(ref.abs().max()) + atol


def _seconds(run: Callable[[], object], device: torch.device, reps: int = 3) -> float:
    """Mean seconds of ``reps`` runs after one warm-up: CUDA events on a
    card, the host clock on the CPU."""
    run()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            run()
        return (time.perf_counter() - t0) / reps
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        run()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / 1e3 / reps


def profile_kernel(
    kernel_name: str,
    run_fn: Callable[..., torch.Tensor],       # (inputs..., config) -> out
    ref_fn: Callable[..., torch.Tensor],       # (inputs...) -> out
    make_inputs: Callable[[torch.Tensor], Tuple],  # pattern tensor -> args
    estimate_fn: Callable[[object], object],   # config -> costmodel.Estimate
    candidates: Sequence[object],
    worst_case: object,
    input_shape: Tuple[int, ...],
    dtype: torch.dtype = torch.float32,
    rtol: float = 2e-2,
    atol: float = 1e-4,
    n_repeat: int = 3,
    backend: str = "costmodel",
    seed: int = 0,
    device: str | torch.device = "cuda",
) -> ProfileResult:
    if backend not in ("costmodel", "wallclock"):
        raise ValueError(f"backend must be 'costmodel' or 'wallclock', got {backend!r}")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    entries: List[ProfileEntry] = []
    for cfg in candidates:
        est = estimate_fn(cfg)
        if not est.feasible:
            entries.append(ProfileEntry(cfg, False, False, float("inf"), "infeasible",
                                        estimate_s=est.t_seconds))
            continue
        validated, fail_pattern, repeat_ok, raised = True, None, True, False
        for name, arr in _patterns(gen, input_shape, dtype, dev):
            args = make_inputs(arr)
            try:
                out = run_fn(*args, cfg)
                ref = ref_fn(*args)
            except Exception:  # not instantiated / shape error = timing violation
                validated, fail_pattern, raised = False, name, True
                break
            if not _close(out, ref, rtol, atol):
                validated, fail_pattern = False, name
                break
            del out, ref, args
        if validated:
            # Repeatability (paper §1.7): same verdict across fresh draws.
            for _ in range(n_repeat):
                arr = torch.randn(input_shape, generator=gen, dtype=torch.float32,
                                  device=dev).to(dtype)
                args = make_inputs(arr)
                if not _close(run_fn(*args, cfg), ref_fn(*args), rtol, atol):
                    repeat_ok = False
                    break
                del args
        if backend == "wallclock" and not raised:
            args = make_inputs(torch.randn(input_shape, generator=gen, dtype=torch.float32,
                                           device=dev).to(dtype))
            t = _seconds(lambda: run_fn(*args, cfg), dev)
            del args
        elif backend == "wallclock":
            t = float("inf")  # a config that cannot run has no time
        else:
            t = est.t_seconds
        entries.append(ProfileEntry(cfg, True, validated, t, est.bound, fail_pattern,
                                    repeat_ok, est.t_seconds))
    return ProfileResult(kernel_name, "x".join(map(str, input_shape)), entries, worst_case)
