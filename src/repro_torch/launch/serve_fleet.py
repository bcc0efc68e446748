"""Fleet-controller service: batched observation chunks in, running score out.

A long-lived AL-DRAM controller that holds the fleet's timing registers
(:class:`~repro_torch.core.controller.DimmTimingTable`) and per-DIMM state
on the card, takes batched temperature/error telemetry chunks from host
memory and answers with the running realized-speedup score. At boot
:func:`bootstrap_table` profiles every DIMM (the charge-sweep CUDA kernel);
every chunk runs through the replay-chunk CUDA kernel
(:class:`~repro_torch.core.stream.StreamingController`).

Usage (demo driver feeding a synthetic day through the service; ``--trace``
also records the streaming loop with ``torch.profiler`` as a Chrome trace):
  PYTHONPATH=src python -m repro_torch.launch.serve_fleet --device cuda \\
      --n-dimms 1048576 --n-steps 1440 --chunk 256 [--trace serve_trace.json]
"""

from __future__ import annotations

import argparse
import contextlib
import time
from typing import Dict, Optional

import torch

from repro_torch import resolve_device
from repro_torch.core import fleet, stream, traces
from repro_torch.core.controller import ControllerParams, DimmTimingTable

#: Bins profiled by the bootstrap (the paper's evaluation points).
DEFAULT_TEMP_BINS = (45.0, 55.0, 70.0, 85.0)


class FleetControllerService:
    """The request/response face of the streaming fleet controller: one
    instance per fleet; :meth:`submit` absorbs a chunk, :meth:`running_score`
    finalizes the partials without disturbing the stream."""

    def __init__(self, table: DimmTimingTable,
                 params: ControllerParams = ControllerParams(), chunk_steps: int = 0):
        self.engine = stream.StreamingController(table, params=params,
                                                 chunk_steps=chunk_steps)

    @property
    def table(self) -> DimmTimingTable:
        return self.engine.table

    def submit(self, temps, errors=None, decisions: bool = False) -> Dict:
        """Ingest one ``(chunk_steps, n_dimms)`` observation chunk."""
        self.engine.ingest(temps, errors, return_decisions=decisions)
        return {
            "n_steps": self.engine.n_steps,
            "n_chunks": self.engine.n_chunks,
            "errors_total": self.engine.errors_total,
        }

    def running_score(self) -> Dict[str, float]:
        """The trace-score dict over everything submitted."""
        return self.engine.score()


def bootstrap_table(generator: torch.Generator, n_dimms: int,
                    temp_bins=DEFAULT_TEMP_BINS,
                    device: str | torch.device = "cuda") -> DimmTimingTable:
    """Profile a synthetic fleet into the controller's timing registers
    (the boot-time characterization pass a deployment runs once)."""
    fl = fleet.synthesize(generator, n_dimms, device=device)
    return fleet.sweep(fl, tuple(temp_bins), (1.0,)).to_table()


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


#: Name of the profiler range around the streaming loop.
_LOOP_RANGE = "serve_loop"


def _trace_summary(prof, top: int = 6, range_name: str = _LOOP_RANGE) -> Dict:
    """Read a profiled loop (the ``record_function`` range ``range_name``):
    the loop's span, the device's busy time in it (the union of kernel, copy
    and memset intervals), device time by activity, and the host operations
    with the most self time."""
    from torch.autograd import DeviceType

    events = prof.events()
    loop = next(e for e in events if e.name == range_name
                and e.device_type == DeviceType.CPU)
    lo, hi = loop.time_range.start, loop.time_range.end
    spans = sorted(
        (max(e.time_range.start, lo), min(e.time_range.end, hi), e.name)
        for e in events
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation
        and e.name != range_name
    )
    busy_us, reach, by_name = 0.0, lo, {}
    for a, b, name in spans:
        if b <= a:
            continue
        by_name[name[:80]] = by_name.get(name[:80], 0.0) + (b - a) * 1e-6
        if b > reach:
            busy_us += b - max(a, reach)
            reach = b
    host = sorted(((e.key, e.self_cpu_time_total * 1e-6, e.count)
                   for e in prof.key_averages() if e.key != range_name),
                  key=lambda r: -r[1])[:top]
    loop_s = (hi - lo) * 1e-6
    return {
        "loop_s": loop_s,
        "device_busy_s": busy_us * 1e-6,
        "device_busy_frac": busy_us / max(hi - lo, 1e-9),
        "device_s_by_name": dict(sorted(by_name.items(), key=lambda kv: -kv[1])),
        "host_self_s_top": [{"op": k, "s": t, "calls": n} for k, t, n in host],
    }


def serve(
    n_dimms: int = 512,
    n_steps: int = 1440,
    chunk: int = stream.DEFAULT_CHUNK_STEPS,
    scenario: str = "diurnal",
    error_rate: float = 0.0,
    dt_s: float = traces.DEFAULT_DT_S,
    seed: int = 0,
    table: Optional[DimmTimingTable] = None,
    device: str | torch.device = "cuda",
    trace_path: Optional[str] = None,
) -> Dict:
    """Demo driver: boot the service, stream a synthetic scenario through it
    chunk by chunk from host memory, return the score and the run's figures
    (``wall_s`` of the streaming loop, ``obs_per_s``, ``peak_device_bytes``
    over streaming + scoring on a card, ``boot_s`` for profiling the fleet,
    ``setup_s`` for building the service with its staging buffers,
    ``score_s`` for finalizing the score). With ``trace_path`` the loop runs
    under ``torch.profiler``, the Chrome trace is written there and
    ``report["trace"]`` summarizes it (:func:`_trace_summary`)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    if table is None:
        table = bootstrap_table(gen, n_dimms, device=dev)
        _sync(dev)
    boot_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    service = FleetControllerService(table, chunk_steps=chunk)
    _sync(dev)
    setup_s = time.perf_counter() - t0

    # Telemetry reaches the service from host memory.
    trace = traces.generate(scenario, gen, n_dimms, n_steps, dt_s, device=dev).cpu()
    errors = (traces.error_injections(gen, n_steps, n_dimms, error_rate, device=dev).cpu()
              if error_rate > 0.0 else None)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)

    prof = contextlib.nullcontext()
    if trace_path is not None:
        from torch.profiler import ProfilerActivity, profile, record_function

        prof = profile(activities=[ProfilerActivity.CPU]
                       + ([ProfilerActivity.CUDA] if dev.type == "cuda" else []))
    _sync(dev)
    resp: Dict = {}
    with prof:
        loop = (record_function(_LOOP_RANGE) if trace_path is not None
                else contextlib.nullcontext())
        t0 = time.perf_counter()
        with loop:
            for temps_c, errs_c in stream.iter_chunks(trace, errors, chunk):
                resp = service.submit(temps_c, errs_c)
            _sync(dev)
        wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    score = service.running_score()
    score_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None

    report = {
        "score": score,
        "n_chunks": resp.get("n_chunks", 0),
        "wall_s": wall,
        "obs_per_s": n_steps * n_dimms / max(wall, 1e-9),
        "boot_s": boot_s,
        "setup_s": setup_s,
        "score_s": score_s,
        "peak_device_bytes": peak,
    }
    if trace_path is not None:
        prof.export_chrome_trace(trace_path)
        report["trace"] = _trace_summary(prof)
    print(
        f"[serve_fleet] {scenario}: {n_dimms} DIMMs × {n_steps} steps "
        f"(chunk {chunk}, device {dev}) | {report['n_chunks']} chunks in "
        f"{wall:.3f} s ({report['obs_per_s']:,.0f} obs/s, "
        f"{n_steps * dt_s / max(wall, 1e-9):,.0f}× real time)"
    )
    print(
        f"[serve_fleet] running score: realized "
        f"{score['speedup_realized_mean'] * 100:+.2f} % "
        f"(intensive {score['speedup_realized_intensive_mean'] * 100:+.2f} %), "
        f"switches {score['switches_total']:.0f}, "
        f"time at JEDEC {score['time_at_jedec_frac'] * 100:.1f} %"
    )
    return report


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-dimms", type=int, default=512)
    ap.add_argument("--n-steps", type=int, default=1440)
    ap.add_argument("--chunk", type=int, default=stream.DEFAULT_CHUNK_STEPS)
    ap.add_argument("--scenario", default="diurnal", choices=traces.SCENARIOS)
    ap.add_argument("--error-rate", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", default=None, help="write a Chrome trace of the loop here")
    args = ap.parse_args()
    serve(n_dimms=args.n_dimms, n_steps=args.n_steps, chunk=args.chunk,
          scenario=args.scenario, error_rate=args.error_rate, seed=args.seed,
          device=args.device, trace_path=args.trace)


if __name__ == "__main__":
    main()
