"""Analytical H100 kernel-latency model and the tile-feasibility gate.

The counterpart of the reference's TPU cost model
(``src/repro/core/altune/costmodel.py``): the profiler's ``costmodel``
backend estimates a kernel's latency from first principles,

    t ≈ max(flops / FP32_FLOPS, hbm_bytes / HBM_BW)
        + LAUNCH_OVERHEAD_S + grid · STEP_OVERHEAD_S / N_SMS

with a hard feasibility gate: a config names the thread-block tile a CUDA
kernel is instantiated for, and a tile that cannot exist as one block on
an SM (more shared memory, registers or threads than a block may have) is
the analogue of a timing violation — never selected, however fast.

The traffic and operation counts are the reference's tiling analysis, line
for line (a (bm, bn, bk) matmul re-reads A n/bn times and B m/bm times);
they do not depend on the device. The constants are the card's and are
read at call time, so a test can patch them:

* peaks: NVIDIA H100 SXM data sheet — 67 TFLOP/s float32 FMA outside the
  tensor cores (the kernels do not use them: TF32 would change the
  numbers), 3.35 TB/s HBM3, 132 SMs;
* per-block budget (Hopper): 227 KB of shared memory, 65,536 registers of
  which at most 255 a thread, 1,024 threads;
* overheads: measured by ``chip_smoke.py`` (``launch_overheads``) with an
  empty kernel (``csrc/launch_probe.cu``) on an NVIDIA H100 80GB HBM3 at a
  700.00 W power limit — one launch of one block, 200 back to back, timed
  by CUDA events: 3.3121 µs a launch (``LAUNCH_OVERHEAD_S``); one launch of
  1,081,344 blocks: 0.6540 ms, 79.4347 ns a block on its SM, the wall time
  a block times the SM count (``STEP_OVERHEAD_S``). The estimate charges
  one such step per grid step of the reference's tiling.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

FP32_FLOPS = 67e12             # float32 FMA outside the tensor cores, per card
HBM_BW = 3.35e12               # bytes/s
N_SMS = 132
SMEM_PER_BLOCK = 232_448       # bytes a block may use (227 KB)
REGS_PER_BLOCK = 65_536
MAX_REGS_PER_THREAD = 255
MAX_THREADS_PER_BLOCK = 1_024
LAUNCH_OVERHEAD_S = 3.3121e-6  # per launch (chip_smoke.py, see above)
STEP_OVERHEAD_S = 79.4347e-9   # per block on its SM (chip_smoke.py, see above)


@dataclasses.dataclass(frozen=True)
class Estimate:
    feasible: bool
    t_seconds: float
    flops: float
    hbm_bytes: float
    smem_bytes: int
    note: str = ""

    @property
    def bound(self) -> str:
        if not self.feasible:
            return "infeasible"
        return "compute" if self.flops / FP32_FLOPS >= self.hbm_bytes / HBM_BW else "memory"


def gate(smem_bytes: int, threads: int, registers: int) -> Tuple[bool, str]:
    """Whether a tile fits one thread block on an SM. ``registers`` is the
    tile's lower bound a thread (accumulators and staged operands); the
    compiler adds addressing on top, which ``chip_smoke.py`` reads back with
    ``cudaFuncGetAttributes`` for every instantiated tile."""
    if smem_bytes > SMEM_PER_BLOCK:
        return False, f"shared memory {smem_bytes} B > {SMEM_PER_BLOCK} B a block"
    if threads > MAX_THREADS_PER_BLOCK:
        return False, f"{threads} threads > {MAX_THREADS_PER_BLOCK} a block"
    if registers > MAX_REGS_PER_THREAD:
        return False, f"{registers} registers a thread > {MAX_REGS_PER_THREAD}"
    if registers * threads > REGS_PER_BLOCK:
        return False, f"{registers * threads} registers > {REGS_PER_BLOCK} a block"
    return True, ""


def _time(flops: float, hbm_bytes: float, grid: int) -> float:
    t = max(flops / FP32_FLOPS, hbm_bytes / HBM_BW)
    t += LAUNCH_OVERHEAD_S + grid * STEP_OVERHEAD_S / N_SMS
    return t


def matmul_estimate(m: int, k: int, n: int, cfg, in_bytes: int = 2) -> Estimate:
    smem = cfg.smem_bytes()
    ok, note = gate(smem, cfg.threads(), cfg.registers())
    flops = 2.0 * m * k * n
    reads = in_bytes * (m * k * (n // cfg.bn) + k * n * (m // cfg.bm))
    writes = in_bytes * m * n
    grid = (m // cfg.bm) * (n // cfg.bn) * (k // cfg.bk)
    t = _time(flops, reads + writes, grid) if ok else float("inf")
    return Estimate(ok, t, flops, reads + writes, smem, note)


def flash_estimate(
    b: int, sq: int, skv: int, h: int, hk: int, dh: int, cfg,
    causal: bool = True, in_bytes: int = 2,
) -> Estimate:
    smem = cfg.smem_bytes(dh)
    ok, note = gate(smem, cfg.threads(dh), cfg.registers(dh))
    pairs = sq * skv * (0.5 if causal else 1.0)
    flops = 4.0 * b * h * dh * pairs
    # Each (q-tile, kv-tile) step streams one KV tile; KV is re-read once
    # per q tile. Q/O stream once.
    reads = in_bytes * b * (
        h * sq * dh + hk * skv * dh * (sq // cfg.bq)
    )
    writes = in_bytes * b * h * sq * dh
    grid = b * h * (sq // cfg.bq) * (skv // cfg.bk)
    t = _time(flops, reads + writes, grid) if ok else float("inf")
    return Estimate(ok, t, flops, reads + writes, smem, note)


def scan_estimate(b: int, s: int, d: int, cfg, in_bytes: int = 4) -> Estimate:
    smem = cfg.smem_bytes()
    ok, note = gate(smem, cfg.threads(), cfg.registers())
    flops = 3.0 * b * s * d  # fma + write per element
    traffic = in_bytes * b * s * d * 3  # a, b in; h out
    grid = b * (d // cfg.bd) * (s // cfg.bs)
    # The recurrence is elementwise: memory-bound plus step cost.
    t = (traffic / HBM_BW + LAUNCH_OVERHEAD_S + grid * STEP_OVERHEAD_S / N_SMS
         if ok else float("inf"))
    return Estimate(ok, t, flops, traffic, smem, note)
