#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. Card check: name and power limit, versions, and the build of both CUDA
   kernels (one ``nvcc`` per source, started together).
2. Charge sweep, kernel vs plain PyTorch version, on the full boot sweep
   (1,048,576 DIMMs × 4 bins) plus the JEDEC-corner cell and a 95 °C
   above-grid column: indices must be equal. Timed at the boot shape.
3. Replay chunk, kernel vs plain, on 65,536 DIMMs at chunkings 1, 37, 256
   with error injections and a ladder of boundary temperatures, and at the
   main path's shapes: a full-width chunk (1,048,576 DIMMs × 256 steps)
   followed by the ragged 160-step chunk that ends a day. State, occupancy,
   switches and timing sums must be bitwise equal. The full-width chunk is
   timed, and so are its ingest steps and two ways of streaming chunks from
   pageable host memory: the engine's pinned double buffer and a plain
   ``tensor.to(device)``.
4. Serve: the fleet-controller service on a small fleet, card vs CPU (the
   plain versions) on the same table and trace; then the main path,
   ``serve_fleet.serve`` at 1,048,576 DIMMs × 1,440 steps (one day at one
   reading a minute), with every kernel's launch count read around it; then
   the same run under ``torch.profiler`` (trace in ``chiprun_out/``) for the
   device's busy share and where the loop's time goes.
5. One JSON line describing each kernel; the card's name and power limit;
   the last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

FULL_DIMMS = 1 << 20
BOOT_BINS = (45.0, 55.0, 70.0, 85.0)
REPLAY_DIMMS = 65536
CHUNKINGS = (1, 37, 256)
ERROR_RATE = 1e-3
SERVE_STEPS = 1440
CHUNK = 256
RAGGED = SERVE_STEPS % CHUNK
INGEST_CHUNKS = 6
SMALL_DIMMS, SMALL_STEPS = 4096, 300

#: Published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 non-tensor FLOP/s.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

#: Float operations per (cell, candidate) of the charge sweep, counted in
#: csrc/charge_sweep.cu with expf and a division as one each: candidate 1,
#: r_trcd 5, r_tras 9, r_trp 6, w_trcd/w_trp 2, w_tras 9, w_twr 7.
SWEEP_OPS_PER_CANDIDATE = 39
#: Float operations per (DIMM, step) of the replay chunk: the guard-band add,
#: four edge compares, the hysteresis subtract and compare, eight sum adds.
REPLAY_OPS_PER_STEP = 15


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls (after one
    warm-up call), by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a GPU")
    try:
        from repro_torch.core import charge, controller, fleet, stream
        from repro_torch.kernels import _build
        from repro_torch.kernels.charge_sweep import kernel as sweep_k
        from repro_torch.kernels.charge_sweep import ops as sweep_ops
        from repro_torch.kernels.replay_step import kernel as replay_k
        from repro_torch.kernels.replay_step import ops as replay_ops
        from repro_torch.launch import serve_fleet
    except ImportError as e:
        fail(f"cannot import the port (run from the repository root): {e}")

    dev = torch.device("cuda")
    # ---- 1. card check and build -------------------------------------------
    smi = nvidia_smi()
    log(f"card: {smi} | torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    logs = _build.build(["charge_sweep", "replay_step"])
    log(f"kernels built in {time.perf_counter() - t0:.2f} s (parallel nvcc)")
    for name, out in logs.items():
        regs = sorted({line.split("Used ")[1].split(",")[0]
                       for line in out.splitlines() if "Used " in line})
        log(f"  {name}: ptxas {regs}")
    gen = torch.Generator(device=dev).manual_seed(0)

    # ---- 2. charge sweep: kernel vs plain ------------------------------------
    fl = fleet.synthesize(gen, FULL_DIMMS, device=dev)
    boot_t = torch.tensor(BOOT_BINS, dtype=torch.float32, device=dev)[:, None, None]
    cells = charge.CellParams(*(a[None, None, :] for a in fl.cells))
    inv_boot, _ = sweep_ops.stacked_invariants(cells, boot_t)
    consts = charge.DEFAULT_CONSTANTS
    corner = charge.CellParams(*(torch.tensor([[[v]]], dtype=torch.float32, device=dev)
                                 for v in (consts.r_max, consts.c_min, 1.0)))
    inv_corner, _ = sweep_ops.stacked_invariants(
        corner, torch.tensor([45.0, 85.0, 95.0], device=dev)[:, None, None])
    inv_hot, _ = sweep_ops.stacked_invariants(cells, torch.tensor(95.0, device=dev))
    inv_all = torch.cat([inv_boot, inv_corner, inv_hot], dim=1).contiguous()
    scal = sweep_ops.kernel_scalars()
    got = sweep_k.charge_sweep_cuda(inv_all, scal)
    want = sweep_k.charge_sweep_plain(inv_all, scal)
    torch.cuda.synchronize()
    sweep_mism = int((got != want).sum())
    sweep_err = float((got - want).abs().max())
    corner_idx = got[:, inv_boot.shape[1]:inv_boot.shape[1] + 3].t().tolist()
    log(f"charge sweep: {inv_all.shape[1]:,} cells, {sweep_mism} index mismatches "
        f"(corner cell at 45/85/95 °C: {corner_idx})")
    if sweep_mism:
        fail(f"charge-sweep kernel disagrees with its plain version on {sweep_mism} indices")
    n_boot = inv_boot.shape[1]
    sweep_ms = cuda_ms(torch, lambda: sweep_k.charge_sweep_cuda(inv_boot, scal), 20)
    sweep_plain_ms = cuda_ms(torch, lambda: sweep_k.charge_sweep_plain(inv_boot, scal), 3)
    sweep_bound, sweep_by = bound_ms(
        n_boot * (inv_boot.shape[0] + sweep_k.N_SEARCHES) * 4,
        n_boot * max(sweep_ops.ref.SEARCH_GRID_SIZES) * SWEEP_OPS_PER_CANDIDATE,
    )
    log(f"charge sweep at {n_boot:,} cells: kernel {sweep_ms:.4f} ms, plain "
        f"{sweep_plain_ms:.3f} ms, bound {sweep_bound:.4f} ms ({sweep_by})")
    del inv_all, inv_hot, got, want

    # ---- 3. replay chunk: kernel vs plain ------------------------------------
    table = serve_fleet.bootstrap_table(gen, REPLAY_DIMMS, device=dev)
    params = controller.ControllerParams()
    rscal = replay_ops.replay_scalars(table.temp_bins, params)
    ladder = []
    for e in table.temp_bins:
        g = e - params.guard_band_c
        ladder += [e, g, g - params.hysteresis_c,
                   float(np.nextafter(np.float32(g), np.float32(-np.inf)))]
    ladder = torch.tensor(sorted(ladder, reverse=True) * 3, dtype=torch.float32, device=dev)
    rand = torch.rand((300, REPLAY_DIMMS), generator=gen, device=dev) * 75.0 + 20.0
    temps = torch.cat([ladder[:, None].expand(-1, REPLAY_DIMMS), rand]).contiguous()
    errs = (torch.rand(temps.shape, generator=gen, device=dev) < ERROR_RATE).to(torch.uint8)
    stack_t = replay_ops.to_stack_t(table.stack)

    def fresh(n):
        st = replay_ops.to_state3(controller.init_state(n, table.n_bins, dev))
        occ = torch.zeros((table.n_bins + 1, n), dtype=torch.int32, device=dev)
        return (st, occ, torch.zeros(n, dtype=torch.int32, device=dev),
                torch.zeros((replay_k.ROW_SLOTS, n), dtype=torch.float32, device=dev))

    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    replay_mism, replay_err, finals = 0, 0.0, []
    for c in CHUNKINGS:
        x = y = fresh(REPLAY_DIMMS)
        for s in range(0, temps.shape[0], c):
            tc, ec = temps[s:s + c].contiguous(), errs[s:s + c].contiguous()
            x = replay_k.replay_chunk_cuda(*x, stack_t, tc, ec, rscal)
            y = replay_k.replay_chunk_plain(*y, stack_t, tc, ec, rscal)
        torch.cuda.synchronize()
        mism = sum(int((bits(a) != bits(b)).sum()) for a, b in zip(x, y))
        replay_mism += mism
        replay_err = max([replay_err] + [float((a.double() - b.double()).abs().max())
                                         for a, b in zip(x, y)])
        finals.append(x)
        log(f"replay chunk {c:>3}: {temps.shape[0]} steps × {REPLAY_DIMMS:,} DIMMs, "
            f"{mism} mismatching words, switches {int(x[2].sum()):,}, "
            f"fused {int(x[0][2].sum()):,}")
    chunk_inv = all(torch.equal(bits(a), bits(b))
                    for f in finals[1:] for a, b in zip(finals[0], f))
    if replay_mism or not chunk_inv:
        fail(f"replay-chunk kernel: {replay_mism} mismatching words vs plain, "
             f"chunking-invariant={chunk_inv}")

    big_table = fleet.sweep(fl, BOOT_BINS, (1.0,)).to_table()
    big_stack_t = replay_ops.to_stack_t(big_table.stack)
    big_scal = replay_ops.replay_scalars(big_table.temp_bins, params)
    big_temps = (torch.rand((CHUNK, FULL_DIMMS), generator=gen, device=dev) * 20.0 + 25.0)
    big_errs = torch.zeros((CHUNK, FULL_DIMMS), dtype=torch.uint8, device=dev)
    big_state = fresh(FULL_DIMMS)
    rag_temps = (torch.rand((RAGGED, FULL_DIMMS), generator=gen, device=dev) * 75.0 + 20.0)
    rag_errs = (torch.rand(rag_temps.shape, generator=gen, device=dev)
                < ERROR_RATE).to(torch.uint8)
    full_mism = {}
    x, y = big_state, big_state
    for label, tc, ec in ((f"{CHUNK}-step", big_temps, big_errs),
                          (f"ragged {RAGGED}-step", rag_temps, rag_errs)):
        x = replay_k.replay_chunk_cuda(*x, big_stack_t, tc, ec, big_scal)
        y = replay_k.replay_chunk_plain(*y, big_stack_t, tc, ec, big_scal)
        torch.cuda.synchronize()
        full_mism[label] = sum(int((bits(a) != bits(b)).sum()) for a, b in zip(x, y))
        replay_err = max([replay_err] + [float((a.double() - b.double()).abs().max())
                                         for a, b in zip(x, y)])
        log(f"replay chunk at full width, {label} chunk × {FULL_DIMMS:,} DIMMs: "
            f"{full_mism[label]} mismatching words, switches {int(x[2].sum()):,}, "
            f"fused {int(x[0][2].sum()):,}")
    replay_mism += sum(full_mism.values())
    if any(full_mism.values()):
        fail(f"replay-chunk kernel disagrees with its plain version at full width: {full_mism}")
    del x, y, rag_temps, rag_errs
    replay_ms = cuda_ms(torch, lambda: replay_k.replay_chunk_cuda(
        *big_state, big_stack_t, big_temps, big_errs, big_scal), 10)
    replay_plain_ms = cuda_ms(torch, lambda: replay_k.replay_chunk_plain(
        *big_state, big_stack_t, big_temps, big_errs, big_scal), 1)
    per_dimm = (CHUNK * (4 + 1) + big_stack_t.shape[0] * 4
                + 2 * (3 * 4 + (big_table.n_bins + 1) * 4 + 4 + replay_k.ROW_SLOTS * 4))
    replay_bound, replay_by = bound_ms(FULL_DIMMS * per_dimm,
                                       FULL_DIMMS * CHUNK * REPLAY_OPS_PER_STEP)
    host = torch.empty((CHUNK, FULL_DIMMS), dtype=torch.float32, pin_memory=True)
    h2d_ms = cuda_ms(torch, lambda: big_temps.copy_(host, non_blocking=True), 5)
    pageable = torch.full((CHUNK, FULL_DIMMS), 30.0)
    stage_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        host.copy_(pageable)
        stage_s.append(time.perf_counter() - t0)
    stage_ms = 1e3 * sum(stage_s) / len(stage_s)
    gb = host.numel() * 4 / 1e9
    log(f"replay chunk at {FULL_DIMMS:,} DIMMs × {CHUNK} steps: kernel {replay_ms:.4f} ms, "
        f"plain {replay_plain_ms:.3f} ms, bound {replay_bound:.4f} ms ({replay_by})")
    log(f"ingest of that chunk's temperatures ({gb:.3f} GB): host staging copy into "
        f"pinned memory {stage_ms:.3f} ms ({gb / stage_ms * 1e3:.1f} GB/s, "
        f"{torch.get_num_threads()} threads), host→device copy {h2d_ms:.3f} ms "
        f"({gb / h2d_ms * 1e3:.1f} GB/s) = {h2d_ms / replay_ms:.1f}× the kernel")
    del host

    # Streaming chunks from pageable host memory, kernel included: the
    # engine's double buffer against a plain synchronous copy, in turns.
    t0 = time.perf_counter()
    ingestor = stream._Ingestor(FULL_DIMMS, dev, rows=CHUNK)
    torch.cuda.synchronize()
    reserve_ms = (time.perf_counter() - t0) * 1e3

    def stream_ms(double_buffer: bool) -> float:
        st = big_state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(INGEST_CHUNKS):
            if double_buffer:
                tc, ec, slot = ingestor.stage(pageable, None)
            else:
                tc, ec, slot = pageable.to(dev), big_errs, None
            st = replay_k.replay_chunk_cuda(*st, big_stack_t, tc, ec, big_scal)
            ingestor.release(slot)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / INGEST_CHUNKS

    turns = [("plain .to", False), ("double buffer", True),
             ("double buffer", True), ("plain .to", False)]
    ingest_ms = {}
    for label, db in turns:
        ingest_ms.setdefault(label, []).append(stream_ms(db))
    log(f"streaming {INGEST_CHUNKS} full-width chunks from pageable host memory, ms per "
        f"chunk in turns {[(k, [round(v, 3) for v in vs]) for k, vs in ingest_ms.items()]}; "
        f"allocating the double buffer (two pinned + device slots, no error "
        f"buffers) took {reserve_ms:.3f} ms")
    del big_temps, big_errs, big_state, pageable, big_stack_t, big_table, ingestor

    # ---- 4. serve: small card-vs-CPU check, then the main path ---------------
    small_table = serve_fleet.bootstrap_table(gen, SMALL_DIMMS, device=dev)
    small_trace = (torch.rand((SMALL_STEPS, SMALL_DIMMS), generator=gen, device=dev)
                   * 60.0 + 20.0).cpu()
    small_errs = (torch.rand((SMALL_STEPS, SMALL_DIMMS), generator=gen, device=dev)
                  < ERROR_RATE).cpu()
    cpu_table = controller.DimmTimingTable(small_table.temp_bins, small_table.stack.cpu())
    svc_gpu = serve_fleet.FleetControllerService(small_table)
    svc_cpu = serve_fleet.FleetControllerService(cpu_table)
    for s in range(0, SMALL_STEPS, 64):
        svc_gpu.submit(small_trace[s:s + 64], small_errs[s:s + 64])
        svc_cpu.submit(small_trace[s:s + 64], small_errs[s:s + 64])
    pg, pc = svc_gpu.engine.partials, svc_cpu.engine.partials
    same = all(torch.equal(bits(a.cpu()), bits(b)) for a, b in zip(pg, pc))
    sg, sc = svc_gpu.running_score(), svc_cpu.running_score()
    score_err = max(abs(sg[k] - sc[k]) for k in sg)
    log(f"serve {SMALL_DIMMS} DIMMs × {SMALL_STEPS} steps, card vs CPU: partials "
        f"bitwise equal={same}, max score difference {score_err:.3e}")
    if not same or score_err > 1e-5:
        fail("the service on the card disagrees with the CPU reference")

    sweep_k.charge_sweep_cuda.launches = 0
    replay_k.replay_chunk_cuda.launches = 0
    report = serve_fleet.serve(n_dimms=FULL_DIMMS, n_steps=SERVE_STEPS, chunk=CHUNK,
                               scenario="diurnal", error_rate=0.0, device=dev)
    launches = {"charge_sweep": sweep_k.charge_sweep_cuda.launches,
                "replay_chunk": replay_k.replay_chunk_cuda.launches}
    score = report["score"]
    log(f"serve main path: {FULL_DIMMS:,} DIMMs × {SERVE_STEPS} steps in "
        f"{report['n_chunks']} chunks: wall {report['wall_s']:.3f} s, "
        f"{report['obs_per_s']:,.0f} obs/s, boot {report['boot_s']:.3f} s, service "
        f"setup (staging buffers) {report['setup_s']:.3f} s, score "
        f"{report['score_s']:.3f} s, peak device "
        f"memory {report['peak_device_bytes'] / 2**30:.2f} GiB, launches {launches}")
    log("score: " + json.dumps(score, sort_keys=True))
    if launches["charge_sweep"] < 1:
        fail("the main path never launched the charge-sweep kernel")
    if launches["replay_chunk"] != report["n_chunks"]:
        fail(f"replay-chunk launches {launches['replay_chunk']} != chunks {report['n_chunks']}")
    if not all(math.isfinite(v) for v in score.values()):
        fail("non-finite score figure")
    if {m.split(".")[0] for m in sys.modules} & {"jax", "jaxlib", "repro"}:
        fail("the port imported JAX or the JAX package")

    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    traced = serve_fleet.serve(n_dimms=FULL_DIMMS, n_steps=SERVE_STEPS, chunk=CHUNK,
                               scenario="diurnal", error_rate=0.0, device=dev,
                               trace_path=os.path.join(out_dir, "serve_trace.json"))
    tr = traced["trace"]
    log(f"serve main path under torch.profiler: wall {traced['wall_s']:.3f} s, loop span "
        f"{tr['loop_s']:.3f} s, device busy {tr['device_busy_s'] * 1e3:.3f} ms "
        f"({tr['device_busy_frac'] * 100:.2f} %)")
    log("  device time by activity (s): " + json.dumps(tr["device_s_by_name"]))
    log("  host ops by self time: " + json.dumps(tr["host_self_s_top"]))

    # ---- 5. summary ------------------------------------------------------------
    kernels = [
        {"name": "charge_sweep", "route": "cuda",
         "source": "src/repro_torch/csrc/charge_sweep.cu",
         "replaces": "src/repro/kernels/charge_sweep/kernel.py:96",
         "launches": launches["charge_sweep"], "mismatches": sweep_mism,
         "max_abs_err": sweep_err, "ms": sweep_ms, "plain_ms": sweep_plain_ms,
         "bound_ms": sweep_bound, "bound_by": sweep_by, "library_ms": None},
        {"name": "replay_chunk", "route": "cuda",
         "source": "src/repro_torch/csrc/replay_step.cu",
         "replaces": "src/repro/kernels/replay_step/kernel.py:92",
         "launches": launches["replay_chunk"], "mismatches": replay_mism,
         "max_abs_err": replay_err, "ms": replay_ms, "plain_ms": replay_plain_ms,
         "bound_ms": replay_bound, "bound_by": replay_by, "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
