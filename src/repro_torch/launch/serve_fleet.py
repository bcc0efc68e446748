"""Fleet-controller service: batched observation chunks in, timing
decisions and the running score out.

A long-lived AL-DRAM controller that holds the fleet's timing registers
(:class:`~repro_torch.core.controller.DimmTimingTable`) and per-DIMM state
on the card, takes batched temperature/error telemetry chunks from host
memory and answers with the running realized-speedup score and, when
asked (``decisions=True``), the realized per-access timing rows, effective
bins and switch flags a hardware agent programs. At boot
:func:`bootstrap_table` profiles every DIMM (the charge-sweep CUDA kernel);
every chunk runs through the replay-chunk CUDA kernel, its emitting entry
for a chunk with decisions
(:class:`~repro_torch.core.stream.StreamingController`).

With a ``"dimm"`` mesh (``mesh=``, :func:`~repro_torch.core.shard.fleet_mesh`;
``serve(sharded=True)``, ``--sharded``) the service is one process a device:
each rank boots with the sharded sweep, takes every full-width chunk, stages
and scans its own block of DIMMs, and answers with its own DIMMs' decisions;
the switch total and the score are combined across ranks.

Usage (demo driver feeding a synthetic day through the service;
``--decisions`` asks for each chunk's decisions and prints DIMM 0's last
ones; ``--trace`` also records the streaming loop with ``torch.profiler``
as a Chrome trace):
  PYTHONPATH=src python -m repro_torch.launch.serve_fleet --device cuda \\
      --n-dimms 1048576 --n-steps 1440 --chunk 256 [--decisions] \\
      [--trace serve_trace.json]

Sharded over every visible card (one spawned rank each), over N gloo ranks
on the CPU, or over the ranks of ``torchrun``:
  PYTHONPATH=src python -m repro_torch.launch.serve_fleet --device cuda --sharded \\
      --n-dimms 1048576 --n-steps 1440
  PYTHONPATH=src python -m repro_torch.launch.serve_fleet --device cpu --sharded \\
      --shards 4 --n-dimms 513 --n-steps 300
  PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \\
      -m repro_torch.launch.serve_fleet --device cuda --sharded --n-dimms 1048576
"""

from __future__ import annotations

import argparse
import contextlib
import os
import time
from typing import Dict, Optional

import torch

from repro_torch import resolve_device
from repro_torch.core import fleet, shard, stream, traces
from repro_torch.core.controller import ControllerParams, DimmTimingTable
from repro_torch.core.timing import ACCESS_TYPES, PARAM_NAMES
from repro_torch.kernels.replay_step.kernel import Decisions

#: Bins profiled by the bootstrap (the paper's evaluation points).
DEFAULT_TEMP_BINS = (45.0, 55.0, 70.0, 85.0)


class FleetControllerService:
    """The request/response face of the streaming fleet controller: one
    instance per fleet; :meth:`submit` absorbs a chunk (and with
    ``decisions=True`` answers with its decisions), :meth:`running_score`
    finalizes the partials without disturbing the stream. ``mesh`` splits
    the DIMM axis (the engine's ``mesh=``): every rank submits the same
    full-width chunks and gets its own DIMMs' decisions."""

    def __init__(self, table: DimmTimingTable,
                 params: ControllerParams = ControllerParams(), chunk_steps: int = 0,
                 mesh=None):
        self.engine = stream.StreamingController(table, params=params,
                                                 chunk_steps=chunk_steps, mesh=mesh)

    @property
    def table(self) -> DimmTimingTable:
        return self.engine.table

    def submit(self, temps, errors=None, decisions: bool = False) -> Dict:
        """Ingest one ``(chunk_steps, n_dimms)`` observation chunk. The
        response's ``total_switches`` is a 0-d int64 tensor on the engine's
        device (``int()`` reads it; see
        :attr:`~repro_torch.core.stream.StreamingController.total_switches`),
        so a serve loop on a card does not wait on the host each chunk. With
        ``decisions=True`` it also carries the chunk's ``timings`` (c, N, 2,
        4), ``bin_idx`` (c, N) and ``switched`` (c, N) on that device (N:
        this rank's DIMMs under a mesh; ``total_switches`` is the fleet's)."""
        out = self.engine.ingest(temps, errors, return_decisions=decisions)
        resp = {
            "n_steps": self.engine.n_steps,
            "n_chunks": self.engine.n_chunks,
            "total_switches": self.engine.total_switches,
            "errors_total": self.engine.errors_total,
        }
        if decisions:
            rows, bin_idx, switched = out
            resp.update(timings=rows, bin_idx=bin_idx, switched=switched)
        return resp

    def running_score(self) -> Dict[str, float]:
        """The trace-score dict over everything submitted."""
        return self.engine.score()


def bootstrap_table(generator: torch.Generator, n_dimms: int,
                    temp_bins=DEFAULT_TEMP_BINS,
                    device: str | torch.device = "cuda", mesh=None) -> DimmTimingTable:
    """Profile a synthetic fleet into the controller's timing registers
    (the boot-time characterization pass a deployment runs once; ``mesh``:
    the sharded sweep, the whole table on every rank)."""
    fl = fleet.synthesize(generator, n_dimms, device=device)
    return fleet.sweep(fl, tuple(temp_bins), (1.0,), mesh=mesh).to_table()


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


#: Name of the profiler range around the streaming loop.
_LOOP_RANGE = "serve_loop"

#: CUDA runtime calls that make the host wait for the device.
_SYNC_CALLS = ("cudaDeviceSynchronize", "cudaStreamSynchronize", "cudaEventSynchronize",
               "cudaMemcpy")


def _trace_summary(prof, top: int = 6, range_name: str = _LOOP_RANGE) -> Dict:
    """Read a profiled loop (the ``record_function`` range ``range_name``):
    the loop's span, the device's busy time in it (the union of kernel, copy
    and memset intervals), device time by activity, the host's waits for the
    device in it (``_SYNC_CALLS``), and the host operations with the most
    self time."""
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
    syncs = sum(1 for e in events if e.name in _SYNC_CALLS and e.device_type == DeviceType.CPU
                and lo <= e.time_range.start <= hi)
    host = sorted(((e.key, e.self_cpu_time_total * 1e-6, e.count)
                   for e in prof.key_averages() if e.key != range_name),
                  key=lambda r: -r[1])[:top]
    loop_s = (hi - lo) * 1e-6
    return {
        "loop_s": loop_s,
        "device_busy_s": busy_us * 1e-6,
        "device_busy_frac": busy_us / max(hi - lo, 1e-9),
        "device_s_by_name": dict(sorted(by_name.items(), key=lambda kv: -kv[1])),
        "host_syncs": syncs,
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
    decisions: bool = False,
    sharded: bool = False,
) -> Dict:
    """Demo driver: boot the service, stream a synthetic scenario through it
    chunk by chunk from host memory, return the score and the run's figures
    (``wall_s`` of the streaming loop, ``obs_per_s``, ``peak_device_bytes``
    over streaming + scoring on a card, ``boot_s`` for profiling the fleet,
    ``setup_s`` for building the service with its staging buffers,
    ``score_s`` for finalizing the score, ``total_switches``). With
    ``decisions`` every chunk is submitted with ``decisions=True``, DIMM 0's
    last read and write sets and bin are printed, and on a card
    ``loop_peak_device_bytes`` is the loop's own peak (the last two chunks'
    decisions are alive at once). With ``trace_path`` the loop runs under
    ``torch.profiler``, the Chrome trace is written there and
    ``report["trace"]`` summarizes it (:func:`_trace_summary`).

    ``sharded`` — run as one rank of the process group
    (:func:`~repro_torch.core.shard.fleet_mesh` over it; ``torchrun`` or
    :func:`~repro_torch.core.shard.launch` made it): the sharded boot, every
    rank generating the same whole trace from ``seed`` on its own device and
    streaming its columns. The figures are this rank's but ``wall_s``, the
    slowest rank's loop (``all_reduce`` MAX), over which ``obs_per_s``
    counts the whole fleet; the report adds ``n_shards``, and only rank 0
    prints (DIMM 0 is its own)."""
    dev = resolve_device(device)
    mesh = shard.fleet_mesh(device=dev) if sharded else None
    width = n_dimms if mesh is None else shard.block_size(n_dimms, mesh)
    printer = mesh is None or mesh.get_local_rank(shard.DIMM_AXIS) == 0
    gen = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    if table is None:
        table = bootstrap_table(gen, n_dimms, device=dev, mesh=mesh)
        _sync(dev)
    boot_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    service = FleetControllerService(table, chunk_steps=chunk, mesh=mesh)
    _sync(dev)
    setup_s = time.perf_counter() - t0

    # Telemetry reaches the service from host memory.
    trace = traces.generate(scenario, gen, n_dimms, n_steps, dt_s, device=dev).cpu()
    errors = (traces.error_injections(gen, n_steps, n_dimms, error_rate, device=dev).cpu()
              if error_rate > 0.0 else None)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        if decisions:
            # The loop holds two chunks' decisions at once (the last response
            # and the one being made): their memory enters the allocator's
            # cache here, so that no cudaMalloc lands inside the loop.
            reserved = [Decisions.empty(chunk, width, dev, ("rows", "eff", "switched"))
                        for _ in range(2)]
            del reserved
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
        if mesh is not None:
            # Every rank's loop starts together: the chunks' switch totals
            # are collectives, so a rank that started early would time its
            # wait for the others' set-up.
            torch.distributed.barrier(group=mesh.get_group(shard.DIMM_AXIS))
            _sync(dev)
        t0 = time.perf_counter()
        with loop:
            for temps_c, errs_c in stream.iter_chunks(trace, errors, chunk):
                resp = service.submit(temps_c, errs_c, decisions=decisions)
            _sync(dev)
        wall = time.perf_counter() - t0
    rank_wall = wall
    if mesh is not None:
        wall = float(shard.pmax(torch.tensor([wall], dtype=torch.float64, device=dev), mesh))
    loop_peak = (torch.cuda.max_memory_allocated(dev)
                 if decisions and dev.type == "cuda" else None)
    last = None
    if decisions and resp:
        # DIMM 0's last step, indexed on the device: a chunk's rows are GiBs.
        last = (resp["timings"][-1, 0].cpu(), int(resp["bin_idx"][-1, 0]))
    n_chunks, total_switches = resp.get("n_chunks", 0), int(resp.get("total_switches", 0))
    del resp  # the last chunk's decisions, before scoring allocates
    t0 = time.perf_counter()
    score = service.running_score()
    score_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None

    report = {
        "score": score,
        "n_chunks": n_chunks,
        "total_switches": total_switches,
        "decisions": decisions,
        "wall_s": wall,
        "n_shards": 1 if mesh is None else shard.n_shards(mesh),
        "obs_per_s": n_steps * n_dimms / max(wall, 1e-9),
        "boot_s": boot_s,
        "setup_s": setup_s,
        "score_s": score_s,
        "peak_device_bytes": peak,
        "loop_peak_device_bytes": loop_peak,
    }
    if trace_path is not None:
        if mesh is not None:  # one trace a rank
            root, ext = os.path.splitext(trace_path)
            trace_path = f"{root}.rank{mesh.get_local_rank(shard.DIMM_AXIS)}{ext}"
        prof.export_chrome_trace(trace_path)
        report["trace"] = _trace_summary(prof)
    if mesh is not None:
        mine = {"rank": mesh.get_local_rank(shard.DIMM_AXIS), "wall_s": rank_wall,
                "score_s": score_s, "peak_device_bytes": peak,
                "device_busy_frac": report.get("trace", {}).get("device_busy_frac")}
        report["per_rank"] = [None] * report["n_shards"]
        torch.distributed.all_gather_object(report["per_rank"], mine,
                                            group=mesh.get_group(shard.DIMM_AXIS))
    if not printer:
        return report
    print(
        f"[serve_fleet] {scenario}: {n_dimms} DIMMs × {n_steps} steps "
        f"(chunk {chunk}, device {dev}{', decisions' if decisions else ''}"
        f"{'' if mesh is None else ', %d shards' % report['n_shards']}) | "
        f"{report['n_chunks']} chunks in {wall:.3f} s ({report['obs_per_s']:,.0f} obs/s, "
        f"{n_steps * dt_s / max(wall, 1e-9):,.0f}× real time)"
    )
    print(
        f"[serve_fleet] running score: realized "
        f"{score['speedup_realized_mean'] * 100:+.2f} % "
        f"(intensive {score['speedup_realized_intensive_mean'] * 100:+.2f} %), "
        f"switches {report['total_switches']}, "
        f"time at JEDEC {score['time_at_jedec_frac'] * 100:.1f} %"
    )
    for r in report.get("per_rank", ()):
        peak_gib = "n/a" if r["peak_device_bytes"] is None else \
            f"{r['peak_device_bytes'] / 2**30:.2f} GiB"
        busy = ("" if r["device_busy_frac"] is None
                else f", device busy {r['device_busy_frac'] * 100:.2f} %")
        print(f"[serve_fleet] rank {r['rank']}: loop {r['wall_s']:.3f} s, score finalize "
              f"{r['score_s']:.3f} s, peak device memory {peak_gib}{busy}")
    if last is not None:
        rows, last_bin = last
        for a, ai in (("read", 0), ("write", 1)):
            sets = ", ".join(f"{p}={float(rows[ai, pi]):.2f}"
                             for pi, p in enumerate(PARAM_NAMES))
            print(f"[serve_fleet] DIMM 0 last {a} set (ns): {sets}")
        print(f"[serve_fleet] DIMM 0 last bin: {last_bin} "
              f"(JEDEC sentinel = {table.n_bins}); access order {ACCESS_TYPES}")
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
    ap.add_argument("--decisions", action="store_true",
                    help="return per-chunk timing rows / bin decisions")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", default=None, help="write a Chrome trace of the loop here")
    ap.add_argument("--sharded", action="store_true",
                    help="split the DIMM axis: one rank a visible card (or --shards CPU "
                         "ranks), or the ranks of torchrun")
    ap.add_argument("--shards", type=int, default=None,
                    help="ranks to spawn with --sharded (default: every visible card)")
    args = ap.parse_args()
    kwargs = dict(n_dimms=args.n_dimms, n_steps=args.n_steps, chunk=args.chunk,
                  scenario=args.scenario, error_rate=args.error_rate, seed=args.seed,
                  device=args.device, trace_path=args.trace, decisions=args.decisions)
    if args.sharded:
        shard.run_ranks(sharded_serve, args.device, args.shards, kwargs)
    else:
        serve(**kwargs)


def sharded_serve(kwargs: Dict) -> Dict:
    """One rank of ``--sharded``: :func:`serve` with ``sharded=True``."""
    return serve(**kwargs, sharded=True)


if __name__ == "__main__":
    main()
