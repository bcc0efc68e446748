"""Memory-system performance model and trace scoring, in PyTorch.

The analytic DRAM + core model of the reference (bank timing per row-hit /
empty / conflict request, bank and bus queueing, IPC by a 60-step
bisection on ``ipc = 1 / cpi(ipc)``) evaluated over whole timing stacks at
once, and the trace scorer the streaming controller finalizes:
:class:`ScorePartials` (int32 occupancy per effective bin, int32 switch
counts, float32 sums of the realized cycle-quantized timings — exact
under any chunking), :func:`trace_score_accumulate` (on a card, the fused
CUDA kernel) and :func:`trace_score_finalize`, which weights each
(DIMM, bin) register block's speedup over JEDEC by its time in that bin;
with ``mesh=`` each rank finalizes its own DIMMs and the sums meet in one
``all_reduce`` of each kind. With ``refresh=`` (a :class:`~repro_torch.core.refresh.BinRefresh`) the
score adds the combined latency + refresh figures: refresh steals bank and
bus capacity and adds blocking latency in :func:`evaluate`.

Region-resolved scoring (rank-5 tables): int32 region-access counts per
(DIMM, effective bin, region) (:func:`region_counts_accumulate`, an integer
scatter, exact under any chunking) weigh each region's own register block
against the region-oblivious max-over-regions set
(:func:`region_score_finalize`, :func:`region_trace_score`).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.core import shard
from repro_torch.core.charge import div
from repro_torch.core.timing import (
    ACCESS_TYPES,
    JEDEC_DDR3_1600,
    PARAM_NAMES,
    TBURST_NS,
    TCL_NS,
    TimingParams,
)


#: Deployed reductions from the paper's real-system evaluation (§1.6).
DEPLOYED_REDUCTIONS_55C: Dict[str, float] = {
    "trcd": 0.27,
    "tras": 0.32,
    "twr": 0.33,
    "trp": 0.18,
}


@dataclasses.dataclass(frozen=True)
class Workload:
    name: str
    mpki: float           # last-level-cache misses per kilo-instruction
    row_hit: float        # row-buffer hit fraction
    write_frac: float     # fraction of DRAM requests that are writes
    mlp: float            # memory-level parallelism
    category: str         # "stream" | "intensive" | "non-intensive"


# 35 workloads: 4 STREAM kernels + 17 memory-intensive + 14 non-intensive.
WORKLOADS: Tuple[Workload, ...] = (
    Workload("stream.copy", 70.0, 0.42, 0.45, 10.0, "stream"),
    Workload("stream.scale", 70.0, 0.42, 0.45, 10.0, "stream"),
    Workload("stream.add", 70.0, 0.42, 0.33, 10.0, "stream"),
    Workload("stream.triad", 70.0, 0.42, 0.33, 10.0, "stream"),
    Workload("mcf", 67.0, 0.38, 0.28, 6.0, "intensive"),
    Workload("lbm", 45.0, 0.52, 0.42, 7.0, "intensive"),
    Workload("libquantum", 50.0, 0.65, 0.20, 7.5, "intensive"),
    Workload("milc", 29.0, 0.48, 0.30, 5.0, "intensive"),
    Workload("soplex", 27.0, 0.45, 0.25, 4.5, "intensive"),
    Workload("GemsFDTD", 25.0, 0.50, 0.33, 5.0, "intensive"),
    Workload("omnetpp", 21.0, 0.30, 0.30, 3.0, "intensive"),
    Workload("leslie3d", 20.0, 0.52, 0.35, 4.5, "intensive"),
    Workload("bwaves", 18.0, 0.55, 0.30, 5.0, "intensive"),
    Workload("sphinx3", 13.0, 0.46, 0.15, 3.0, "intensive"),
    Workload("zeusmp", 12.0, 0.48, 0.35, 3.5, "intensive"),
    Workload("cactusADM", 11.0, 0.42, 0.35, 2.5, "intensive"),
    Workload("astar", 10.5, 0.35, 0.25, 2.0, "intensive"),
    Workload("wrf", 10.0, 0.50, 0.30, 3.0, "intensive"),
    Workload("xalancbmk", 10.0, 0.32, 0.25, 2.5, "intensive"),
    Workload("gcc", 10.2, 0.40, 0.30, 2.5, "intensive"),
    Workload("bzip2", 11.5, 0.42, 0.35, 2.5, "intensive"),
    Workload("perlbench", 2.7, 0.45, 0.30, 1.5, "non-intensive"),
    Workload("gobmk", 1.8, 0.40, 0.30, 1.5, "non-intensive"),
    Workload("sjeng", 1.5, 0.38, 0.30, 1.4, "non-intensive"),
    Workload("h264ref", 2.4, 0.50, 0.25, 1.8, "non-intensive"),
    Workload("hmmer", 2.1, 0.52, 0.30, 1.8, "non-intensive"),
    Workload("namd", 1.2, 0.50, 0.25, 1.5, "non-intensive"),
    Workload("povray", 0.45, 0.45, 0.25, 1.2, "non-intensive"),
    Workload("calculix", 1.05, 0.50, 0.28, 1.5, "non-intensive"),
    Workload("gamess", 0.6, 0.45, 0.25, 1.2, "non-intensive"),
    Workload("gromacs", 2.7, 0.50, 0.28, 1.8, "non-intensive"),
    Workload("tonto", 1.8, 0.48, 0.27, 1.5, "non-intensive"),
    Workload("dealII", 3.0, 0.50, 0.28, 1.8, "non-intensive"),
    Workload("sixtrack", 0.6, 0.45, 0.25, 1.2, "non-intensive"),
    Workload("wupwise", 3.6, 0.52, 0.30, 2.0, "non-intensive"),
)


@dataclasses.dataclass(frozen=True)
class SystemConfig:
    """Evaluated memory system + calibrated constants."""

    n_cores: int = 1
    n_banks: int = 8
    bank_balance: float = 0.55
    cpu_ghz: float = 3.2
    cpi_exe: float = 0.5
    ctrl_overhead_ns: float = 14.0
    empty_frac: float = 0.35
    ras_residual: float = 0.35
    wr_turnaround: float = 0.55
    rho_max: float = 0.995
    bisect_iters: int = 60


#: The paper's two evaluated configurations.
SINGLE_CORE = SystemConfig(n_cores=1)
MULTI_CORE = SystemConfig(n_cores=4)

#: The paper's headline claim: 14 % average speedup, memory-intensive.
PAPER_CLAIM_SPEEDUP: float = 0.14

#: The claim's cohort: STREAM + memory-intensive SPEC.
MEM_INTENSIVE_WORKLOADS: Tuple[Workload, ...] = tuple(
    w for w in WORKLOADS if w.category != "non-intensive"
)

#: Read-to-precharge gate (DDR3 tRTP, ns).
TRTP_NS: float = 7.5

#: Timing rows evaluated per block by :func:`evaluate_stack` (bounds the
#: bisection's temporaries; every row is independent, so blocking does not
#: change a result).
_ROWS_PER_BLOCK: int = 1 << 19


@functools.lru_cache(maxsize=16)
def _fields(ws: Tuple[Workload, ...], device: torch.device) -> Dict[str, torch.Tensor]:
    return {
        name: torch.tensor([getattr(w, name) for w in ws], dtype=torch.float32,
                           device=device)
        for name in ("mpki", "row_hit", "write_frac", "mlp")
    }


def access_latency_ns(t: TimingParams, f: Dict[str, torch.Tensor], cfg: SystemConfig,
                      t_write: Optional[TimingParams] = None) -> torch.Tensor:
    """Expected bank access latency (no queueing) per request."""
    tw = t if t_write is None else t_write
    h = f["row_hit"]
    wf = f["write_frac"]
    miss = 1.0 - h
    empty = cfg.empty_frac * miss
    conflict = miss - empty
    trcd_eff = (1.0 - wf) * t.trcd + wf * tw.trcd
    trp_eff = (1.0 - wf) * t.trp + wf * tw.trp
    t_hit = TCL_NS + TBURST_NS
    t_empty = trcd_eff + TCL_NS + TBURST_NS
    ras_read = torch.clamp(t.tras - (t.trcd + TCL_NS + TBURST_NS), min=0.0)
    ras_write = torch.clamp(tw.tras - (tw.trcd + TCL_NS + TBURST_NS), min=0.0)
    ras_extra = cfg.ras_residual * ((1.0 - wf) * ras_read + wf * ras_write)
    wr_extra = cfg.wr_turnaround * wf * tw.twr
    t_conf = trp_eff + trcd_eff + TCL_NS + TBURST_NS + ras_extra + wr_extra
    return h * t_hit + empty * t_empty + conflict * t_conf + cfg.ctrl_overhead_ns


def miss_service_ns(t: TimingParams, f: Dict[str, torch.Tensor], cfg: SystemConfig,
                    t_write: Optional[TimingParams] = None) -> torch.Tensor:
    """Bank occupancy per miss: the row cycle (writes add tWR recovery)."""
    tw = t if t_write is None else t_write
    h = f["row_hit"]
    wf = f["write_frac"]
    miss = torch.clamp(1.0 - h, min=1e-9)
    empty = cfg.empty_frac * miss
    conflict = miss - empty
    trcd_eff = (1.0 - wf) * t.trcd + wf * tw.trcd
    wr_extra = cfg.wr_turnaround * wf * tw.twr
    occ_read = torch.maximum(t.tras, t.trcd + TRTP_NS) + t.trp
    occ_write = torch.maximum(tw.tras, tw.trcd + TRTP_NS) + tw.trp
    occ_conf = (1.0 - wf) * occ_read + wf * occ_write + wr_extra
    return (empty * (trcd_eff + TBURST_NS) + conflict * occ_conf) / miss


def evaluate(t: TimingParams, cfg: SystemConfig, workloads: Tuple[Workload, ...] = WORKLOADS,
             t_write: Optional[TimingParams] = None, refresh_occ=0.0,
             trfc_ns: float = 0.0) -> Dict[str, torch.Tensor]:
    """IPC per workload under timing set ``t`` (reads) and ``t_write``
    (writes). Timing fields are tensors that broadcast against the
    workload axis (the last one).

    ``refresh_occ`` — the rank's refresh occupancy (a float or a tensor
    broadcasting like the timing fields): refresh shrinks the capacity of
    the bank pool and the data bus by ``1 − occ`` and adds the expected
    blocking ``occ · tRFC / 2`` to every request's latency. At the defaults
    every term reduces exactly to the refresh-free arithmetic."""
    f = _fields(workloads, t.trcd.device)
    lat = access_latency_ns(t, f, cfg, t_write) + refresh_occ * trfc_ns * 0.5
    svc = miss_service_ns(t, f, cfg, t_write)
    miss = 1.0 - f["row_hit"]
    banks_eff = cfg.n_banks * cfg.bank_balance
    ghz = cfg.cpu_ghz
    avail = 1.0 - refresh_occ

    def cpi_of(ipc: torch.Tensor) -> torch.Tensor:
        rate = cfg.n_cores * ipc * ghz * f["mpki"] * 1e-3  # req/ns
        rho_bank = torch.clamp(rate * miss * svc / (banks_eff * avail), 0.0, cfg.rho_max)
        rho_bus = torch.clamp(rate * TBURST_NS / avail, 0.0, cfg.rho_max)
        queue = (
            rho_bank / (1.0 - rho_bank) * svc * 0.5
            + rho_bus / (1.0 - rho_bus) * TBURST_NS * 0.5
        )
        return cfg.cpi_exe + f["mpki"] * 1e-3 * (lat + queue) * ghz / f["mlp"]

    # Bisection on the unique fixed point ipc = 1/cpi(ipc).
    lo = torch.full_like(lat, 1e-4)
    hi = torch.full_like(lat, 1.0 / cfg.cpi_exe)
    for _ in range(cfg.bisect_iters):
        mid = 0.5 * (lo + hi)
        go_up = div(1.0, cpi_of(mid)) > mid
        lo = torch.where(go_up, mid, lo)
        hi = torch.where(go_up, hi, mid)
    return {"ipc": 0.5 * (lo + hi), "latency_ns": lat, "service_ns": svc}


def _on_device(t: TimingParams, device: torch.device) -> TimingParams:
    """``t``'s four values as 0-d float32 tensors on ``device``."""
    return TimingParams(*(torch.full((), float(v), dtype=torch.float32, device=device)
                          for v in t))


def _deployed_speedups(cfg: SystemConfig, reductions: Dict[str, float],
                       workloads: Tuple[Workload, ...], device) -> torch.Tensor:
    """IPC ratio per workload of JEDEC reduced by ``reductions`` over JEDEC."""
    dev = resolve_device(device)
    base = evaluate(_on_device(JEDEC_DDR3_1600, dev), cfg, workloads)["ipc"]
    fast = evaluate(_on_device(JEDEC_DDR3_1600.reduced(reductions), dev), cfg,
                    workloads)["ipc"]
    return fast / base


def _geomean(x: torch.Tensor) -> float:
    return float(torch.exp(torch.log(x).mean()))


def speedup_report(cfg: SystemConfig,
                   reductions: Dict[str, float] = DEPLOYED_REDUCTIONS_55C,
                   workloads: Tuple[Workload, ...] = WORKLOADS,
                   device: str | torch.device = "cuda") -> Dict[str, float]:
    """Fig. 3 aggregates: per-category geometric-mean speedups of AL-DRAM
    (the deployed 55 °C reductions) over JEDEC, evaluated on ``device``."""
    speedup = _deployed_speedups(cfg, reductions, workloads, device)

    def cat(name: str) -> torch.Tensor:
        idx = [i for i, w in enumerate(workloads) if w.category == name]
        return speedup[torch.tensor(idx, dtype=torch.long, device=speedup.device)]

    mem = torch.cat([cat("stream"), cat("intensive")])
    return {
        "all_geomean": _geomean(speedup) - 1.0,
        "intensive_geomean": _geomean(mem) - 1.0,
        "nonintensive_geomean": _geomean(cat("non-intensive")) - 1.0,
        "stream_max": float(cat("stream").max()) - 1.0,
        "best": float(speedup.max()) - 1.0,
    }


def per_workload_speedups(cfg: SystemConfig,
                          reductions: Dict[str, float] = DEPLOYED_REDUCTIONS_55C,
                          workloads: Tuple[Workload, ...] = WORKLOADS,
                          device: str | torch.device = "cuda") -> List[Tuple[str, float]]:
    """``(workload, speedup over JEDEC)`` for each workload (Fig. 3 bars)."""
    sp = (_deployed_speedups(cfg, reductions, workloads, device) - 1.0).tolist()
    return [(w.name, sp[i]) for i, w in enumerate(workloads)]


def evaluate_stack(timings: torch.Tensor, cfg: SystemConfig,
                   workloads: Tuple[Workload, ...] = WORKLOADS,
                   refresh_occ: Optional[torch.Tensor] = None,
                   trfc_ns: float = 0.0) -> torch.Tensor:
    """IPC for a ``(..., 2, 4)`` per-access-type stack (read, write; ns):
    ``(leading..., n_workloads)``. ``refresh_occ`` — optional per-entry
    refresh occupancy, broadcastable to the stack's leading axes."""
    if timings.dim() < 2 or tuple(timings.shape[-2:]) != (len(ACCESS_TYPES), len(PARAM_NAMES)):
        raise ValueError(f"expected a (..., 2, 4) timing stack, got {tuple(timings.shape)}")
    flat = timings.to(torch.float32).reshape(-1, 2, 4)
    occ = None
    if refresh_occ is not None:
        occ = torch.as_tensor(refresh_occ, dtype=torch.float32, device=flat.device)
        occ = occ.broadcast_to(timings.shape[:-2]).reshape(-1, 1)
    blocks = []
    for s in range(0, flat.shape[0], _ROWS_PER_BLOCK):
        ts = flat[s:s + _ROWS_PER_BLOCK, :, :, None]   # (M, 2, 4, 1)
        tr = TimingParams(ts[:, 0, 0], ts[:, 0, 1], ts[:, 0, 2], ts[:, 0, 3])
        tw = TimingParams(ts[:, 1, 0], ts[:, 1, 1], ts[:, 1, 2], ts[:, 1, 3])
        kw = {} if occ is None else dict(refresh_occ=occ[s:s + _ROWS_PER_BLOCK],
                                         trfc_ns=trfc_ns)
        blocks.append(evaluate(tr, cfg, workloads, t_write=tw, **kw)["ipc"])
    ipc = torch.cat(blocks)
    return ipc.reshape(*timings.shape[:-2], ipc.shape[-1])


def fleet_speedups(timings: torch.Tensor, cfg: SystemConfig = MULTI_CORE,
                   workloads: Tuple[Workload, ...] = WORKLOADS,
                   refresh_occ: Optional[torch.Tensor] = None,
                   trfc_ns: float = 0.0) -> torch.Tensor:
    """Per-entry geometric-mean speedup over JEDEC for a ``(..., 2, 4)``
    per-access-type stack. With ``refresh_occ`` (per-entry occupancy,
    broadcastable to the leading axes) it is the combined latency + refresh
    speedup: each entry's JEDEC baseline pays the same refresh occupancy."""
    jedec = torch.tensor([list(JEDEC_DDR3_1600)] * 2, dtype=torch.float32,
                         device=timings.device)
    if refresh_occ is None:
        base = evaluate_stack(jedec, cfg, workloads)
        ratio = evaluate_stack(timings, cfg, workloads) / base
    else:
        kw = dict(refresh_occ=refresh_occ, trfc_ns=trfc_ns)
        base = evaluate_stack(jedec.broadcast_to(timings.shape), cfg, workloads, **kw)
        ratio = evaluate_stack(timings, cfg, workloads, **kw) / base
    return torch.exp(torch.log(ratio).mean(dim=-1))


# ---------------------------------------------------------------------------
# Trace scoring
# ---------------------------------------------------------------------------
def time_in_bin(bin_idx: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Occupancy fractions ``(n_dimms, n_bins + 1)`` of an ``(n_steps,
    n_dimms)`` effective-bin history (``n_bins`` = the JEDEC sentinel); each
    fraction is its count over the steps, one float32 division."""
    bins = torch.arange(n_bins + 1, device=bin_idx.device)
    counts = (bin_idx[:, :, None] == bins).sum(dim=0).to(torch.float32)
    return div(counts, float(bin_idx.shape[0]))


def realized_latency_reductions(timings: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-DIMM mean read and write latency reduction vs JEDEC over a
    replay's ``(n_steps, n_dimms, 2, 4)`` realized rows (a legacy merged
    ``(n_steps, n_dimms, 4)`` stack goes into both access slots): the
    Fig. 2 sums of each access type's own set, and ``read_params`` /
    ``write_params``, the ``(n_dimms, 4)`` per-parameter reductions."""
    timings = torch.as_tensor(timings, dtype=torch.float32)
    if timings.dim() == 3 and timings.shape[-1] == len(PARAM_NAMES):
        timings = torch.stack([timings, timings], dim=-2)
    if timings.dim() != 4 or tuple(timings.shape[-2:]) != (len(ACCESS_TYPES), len(PARAM_NAMES)):
        raise ValueError(f"expected (n_steps, n_dimms, 2, 4) or (n_steps, n_dimms, 4) "
                         f"rows, got {tuple(timings.shape)}")
    rs, ws = timings[..., 0, :], timings[..., 1, :]
    read = rs[..., 0] + rs[..., 1] + rs[..., 3]
    write = ws[..., 0] + ws[..., 2] + ws[..., 3]
    jedec = torch.tensor(list(JEDEC_DDR3_1600), dtype=torch.float32, device=timings.device)
    return {
        "read": 1.0 - read.mean(dim=0) / JEDEC_DDR3_1600.read_sum,
        "write": 1.0 - write.mean(dim=0) / JEDEC_DDR3_1600.write_sum,
        "read_params": 1.0 - rs.mean(dim=0) / jedec[None, :],
        "write_params": 1.0 - ws.mean(dim=0) / jedec[None, :],
    }


class ScorePartials(NamedTuple):
    """Running trace-score accumulators over the step axis.

    * ``occupancy`` — ``(n_dimms, n_bins + 1)`` int32 step counts per
      effective bin (last column = the JEDEC sentinel). Exact.
    * ``switches`` — ``(n_dimms,)`` int32 timing-set switch counts. Exact.
    * ``timing_sums`` — ``(n_dimms, 2, 4)`` float32 sums of the realized
      rows (ns). Realized timings are multiples of tCK = 1.25 ns, so the
      sums are exact under any accumulation order while every partial sum
      stays below 2²² ns, where the float32 spacing reaches 0.25 ns
      (``n_steps · max_timing < 2²²``: ~120k steps at JEDEC tRAS; the
      reference states ``2²⁴ · 1.25 ns``, which is 5× too loose).
    * ``n_steps`` — ``()`` int32 observations absorbed so far.
    """

    occupancy: torch.Tensor
    switches: torch.Tensor
    timing_sums: torch.Tensor
    n_steps: torch.Tensor


def trace_score_init(n_dimms: int, n_bins: int,
                     device: str | torch.device = "cuda") -> ScorePartials:
    """Zeroed accumulators for an ``n_dimms``-DIMM, ``n_bins``-bin fleet."""
    return ScorePartials(
        occupancy=torch.zeros((n_dimms, n_bins + 1), dtype=torch.int32, device=device),
        switches=torch.zeros((n_dimms,), dtype=torch.int32, device=device),
        timing_sums=torch.zeros((n_dimms, len(ACCESS_TYPES), len(PARAM_NAMES)),
                                dtype=torch.float32, device=device),
        n_steps=torch.zeros((), dtype=torch.int32, device=device),
    )


def trace_score_accumulate(partials: ScorePartials, timings: torch.Tensor,
                           bin_idx: torch.Tensor, switched: torch.Tensor) -> ScorePartials:
    """Absorb a ``(chunk, n_dimms, 2, 4)`` block of replay outputs: on CPU
    partials :func:`trace_score_accumulate_plain`, on a card the fused CUDA
    kernel (:func:`repro_torch.kernels.replay_step.ops.accumulate_chunk`),
    bitwise the same by the exactness notes on :class:`ScorePartials`."""
    if partials.occupancy.device.type == "cpu":
        return trace_score_accumulate_plain(partials, timings, bin_idx, switched)
    from repro_torch.kernels.replay_step import ops as replay_ops

    return replay_ops.accumulate_chunk(partials, timings, bin_idx, switched)


def trace_score_accumulate_plain(partials: ScorePartials, timings: torch.Tensor,
                                 bin_idx: torch.Tensor, switched: torch.Tensor) -> ScorePartials:
    """:func:`trace_score_accumulate` in torch ops, on any device."""
    n_bins1 = partials.occupancy.shape[-1]
    bins = torch.arange(n_bins1, dtype=torch.int32, device=bin_idx.device)
    occ = (bin_idx[:, :, None] == bins).sum(dim=0)
    return ScorePartials(
        occupancy=partials.occupancy + occ.to(torch.int32),
        switches=partials.switches + switched.sum(dim=0).to(torch.int32),
        timing_sums=partials.timing_sums + timings.to(torch.float32).sum(dim=0),
        n_steps=partials.n_steps + timings.shape[0],
    )


def _score_figures(partials: ScorePartials, stack: torch.Tensor, cfg: SystemConfig,
                   workloads: Tuple[Workload, ...], refresh=None):
    """Per-DIMM score figures of ``partials`` against the ``(n, B, 2, 4)``
    registers ``stack``: occupancy fractions, latency reductions, realized
    speedups (all workloads and the memory-intensive cohort), the coolest
    bin's tRAS flags, and with ``refresh`` the combined figures."""
    n_dimms = stack.shape[0]
    steps = partials.n_steps.to(torch.float32)
    occ = partials.occupancy.to(torch.float32) / steps           # (N, B+1)
    sums = partials.timing_sums                                  # (N, 2, 4)
    mean_rows = sums / steps
    rs, ws = mean_rows[:, 0, :], mean_rows[:, 1, :]
    read_mean = (sums[:, 0, 0] + sums[:, 0, 1] + sums[:, 0, 3]) / steps
    write_mean = (sums[:, 1, 0] + sums[:, 1, 2] + sums[:, 1, 3]) / steps
    jedec = torch.tensor(list(JEDEC_DDR3_1600), dtype=torch.float32, device=stack.device)
    red = {
        "read": 1.0 - read_mean / JEDEC_DDR3_1600.read_sum,
        "write": 1.0 - write_mean / JEDEC_DDR3_1600.write_sum,
        "read_params": 1.0 - rs / jedec[None, :],
        "write_params": 1.0 - ws / jedec[None, :],
    }
    jedec_rows = jedec.broadcast_to((n_dimms, 1, 2, 4))
    rows = torch.cat([stack, jedec_rows], dim=1)                 # (N, B+1, 2, 4)
    sp = fleet_speedups(rows, cfg, workloads)                    # (N, B+1)
    sp_mem = fleet_speedups(rows, cfg, MEM_INTENSIVE_WORKLOADS)
    realized = (occ * sp).sum(dim=-1)
    realized_mem = (occ * sp_mem).sum(dim=-1)
    tras_flags = (stack[:, 0, 0, 1] < JEDEC_DDR3_1600.tras - 1e-6).to(torch.float32)
    extra = None
    if refresh is not None:
        if len(refresh.occupancy) != occ.shape[-1]:
            raise ValueError(f"refresh carries {len(refresh.occupancy)} per-bin occupancies "
                             f"for {occ.shape[-1]} effective bins")
        occ_bins = torch.tensor(refresh.occupancy, dtype=torch.float32, device=stack.device)
        kw = dict(refresh_occ=occ_bins[None, :], trfc_ns=refresh.trfc_ns)
        sp_c = fleet_speedups(rows, cfg, workloads, **kw)             # (N, B+1)
        sp_c_mem = fleet_speedups(rows, cfg, MEM_INTENSIVE_WORKLOADS, **kw)
        extra = {
            "combined": (occ * sp_c).sum(dim=-1),
            "combined_mem": (occ * sp_c_mem).sum(dim=-1),
            "refresh_occ": (occ * occ_bins[None, :]).sum(dim=-1),
        }
    return occ, red, realized, realized_mem, tras_flags, extra


def trace_score_finalize(
    partials: ScorePartials,
    stack: torch.Tensor,
    cfg: SystemConfig = MULTI_CORE,
    claim: float = PAPER_CLAIM_SPEEDUP,
    workloads: Tuple[Workload, ...] = WORKLOADS,
    refresh=None,
    mesh=None,
) -> Dict[str, float]:
    """Final score dict from accumulated partials + the table's
    ``(n_dimms, n_bins, 2, 4)`` registers: realized latency reductions,
    realized speedups (all workloads and the claim's cohort), switching
    activity and time at JEDEC. ``refresh`` — an optional
    :class:`~repro_torch.core.refresh.BinRefresh` — adds
    ``refresh_occupancy_mean`` and ``speedup_combined_{mean, min,
    intensive_mean, vs_claim}``; the latency-only figures do not change.

    ``mesh`` — a 1-D ``"dimm"`` mesh: ``partials`` are this rank's real
    DIMMs ``[lo:hi]`` (:func:`~repro_torch.core.shard.local_range`, as a
    sharded replay or stream leaves them) and ``stack`` is whole. Each rank
    computes the figures of its own rows only, sums them (float64; the
    switch count in int64) and takes minima (``+inf`` on an empty block),
    and one ``all_reduce`` of each kind combines them
    (:func:`_psum_score_partials`, :func:`_score_dict_from_sums`): every
    rank returns the same dict; counts are exact and float means differ
    from ``mesh=None`` by summation order only."""
    stack = stack.to(torch.float32)
    n_dimms, n_bins = stack.shape[0], stack.shape[1]
    lo, hi = 0, n_dimms
    if mesh is not None:
        lo, hi = shard.local_range(n_dimms, mesh)
    if tuple(partials.occupancy.shape) != (hi - lo, n_bins + 1):
        raise ValueError(
            f"partials occupancy shape {tuple(partials.occupancy.shape)} does "
            f"not match {hi - lo} DIMMs of a {n_dimms}-DIMM, {n_bins}-bin table"
        )
    n_steps = int(partials.n_steps)
    if n_steps <= 0:
        raise ValueError("cannot finalize a score over zero observations")
    if mesh is not None:
        sums = _psum_score_partials(partials, stack[lo:hi], cfg, workloads, refresh, mesh)
        return _score_dict_from_sums(sums, n_dimms, n_steps, claim, refresh)
    occ, red, realized, realized_mem, tras_flags, extra = _score_figures(
        partials, stack, cfg, workloads, refresh)
    switches = partials.switches.to(torch.int64)
    out = {
        "read_reduction_mean": float(red["read"].mean()),
        "write_reduction_mean": float(red["write"].mean()),
        "speedup_realized_mean": float(realized.mean() - 1.0),
        "speedup_realized_min": float(realized.min() - 1.0),
        "speedup_realized_intensive_mean": float(realized_mem.mean() - 1.0),
        "speedup_vs_claim": float(realized_mem.mean() - 1.0) - claim,
        "switches_total": float(switches.sum()),
        "switches_per_dimm_mean": float(switches.to(torch.float64).mean()),
        "switches_per_kstep": float(switches.sum()) / (n_steps * n_dimms / 1000.0),
        "time_at_jedec_frac": float(occ[:, n_bins].mean()),
        "time_in_coolest_bin_frac": float(occ[:, 0].mean()),
        "tras_below_jedec_coolest_frac": float(tras_flags.mean()),
    }
    if extra is not None:
        combined_mem = float(extra["combined_mem"].mean() - 1.0)
        out.update({
            "refresh_occupancy_mean": float(extra["refresh_occ"].mean()),
            "speedup_combined_mean": float(extra["combined"].mean() - 1.0),
            "speedup_combined_min": float(extra["combined"].min() - 1.0),
            "speedup_combined_intensive_mean": combined_mem,
            "speedup_combined_vs_claim": combined_mem - claim,
        })
    for access in ACCESS_TYPES:
        per = red[f"{access}_params"]
        for pi, param in enumerate(PARAM_NAMES):
            out[f"{access}_{param}_reduction_mean"] = float(per[:, pi].mean())
    return out


#: The summed figures of a sharded finalize, in :func:`_psum_score_partials`'
#: order (the refresh sums last, present only with a refresh policy), and the
#: figures whose fleet minimum it takes.
_SUMMED = ("read", "write", "realized", "realized_mem", "jedec", "coolest", "tras",
           *(f"{a}_{p}" for a in ACCESS_TYPES for p in PARAM_NAMES))
_SUMMED_REFRESH = ("combined", "combined_mem", "refresh_occ")


def _psum_score_partials(partials: ScorePartials, stack_l: torch.Tensor, cfg: SystemConfig,
                         workloads: Tuple[Workload, ...], refresh, mesh) -> Dict:
    """This rank's score figures over its real rows ``stack_l`` →
    cross-rank sums: one float64 ``all_reduce`` SUM of the 15 figure sums
    (18 with refresh), one MIN of the realized (and combined) minima, and
    one int64 SUM of the switch count. An empty block contributes zeros
    and ``+inf``."""
    names = _SUMMED + (_SUMMED_REFRESH if refresh is not None else ())
    dev = stack_l.device
    sums = torch.zeros((len(names),), dtype=torch.float64, device=dev)
    mins = torch.full((1 if refresh is None else 2,), torch.inf, dtype=torch.float32,
                      device=dev)
    switches = partials.switches.to(torch.int64).sum()
    if stack_l.shape[0]:
        occ, red, realized, realized_mem, tras_flags, extra = _score_figures(
            partials, stack_l, cfg, workloads, refresh)
        n_bins = stack_l.shape[1]
        cols = [red["read"], red["write"], realized, realized_mem, occ[:, n_bins], occ[:, 0],
                tras_flags]
        cols += [red[f"{a}_params"][:, pi] for a in ACCESS_TYPES
                 for pi in range(len(PARAM_NAMES))]
        mins[0] = realized.min()
        if extra is not None:
            cols += [extra[k] for k in _SUMMED_REFRESH]
            mins[1] = extra["combined"].min()
        sums = torch.stack([c.to(torch.float64).sum() for c in cols])
    sums, mins = shard.psum(sums, mesh).tolist(), shard.pmin(mins, mesh).tolist()
    out = dict(zip(names, sums))
    out.update(realized_min=mins[0], switches=int(shard.psum(switches, mesh)))
    if refresh is not None:
        out["combined_min"] = mins[1]
    return out


def _score_dict_from_sums(sums: Dict, n_dimms: int, n_steps: int, claim: float,
                          refresh=None) -> Dict[str, float]:
    """The score dict of the cross-rank sums: each mean is its sum over
    ``n_dimms``."""
    n = float(n_dimms)
    mean = {k: v / n for k, v in sums.items() if k not in ("realized_min", "switches",
                                                           "combined_min")}
    s_switch = float(sums["switches"])
    out = {
        "read_reduction_mean": mean["read"],
        "write_reduction_mean": mean["write"],
        "speedup_realized_mean": mean["realized"] - 1.0,
        "speedup_realized_min": sums["realized_min"] - 1.0,
        "speedup_realized_intensive_mean": mean["realized_mem"] - 1.0,
        "speedup_vs_claim": (mean["realized_mem"] - 1.0) - claim,
        "switches_total": s_switch,
        "switches_per_dimm_mean": s_switch / n,
        "switches_per_kstep": s_switch / (n_steps * n / 1000.0),
        "time_at_jedec_frac": mean["jedec"],
        "time_in_coolest_bin_frac": mean["coolest"],
        "tras_below_jedec_coolest_frac": mean["tras"],
    }
    if refresh is not None:
        out.update({
            "refresh_occupancy_mean": mean["refresh_occ"],
            "speedup_combined_mean": mean["combined"] - 1.0,
            "speedup_combined_min": sums["combined_min"] - 1.0,
            "speedup_combined_intensive_mean": mean["combined_mem"] - 1.0,
            "speedup_combined_vs_claim": (mean["combined_mem"] - 1.0) - claim,
        })
    for access in ACCESS_TYPES:
        for param in PARAM_NAMES:
            out[f"{access}_{param}_reduction_mean"] = mean[f"{access}_{param}"]
    return out


def trace_score(stack: torch.Tensor, replay, cfg: SystemConfig = MULTI_CORE,
                claim: float = PAPER_CLAIM_SPEEDUP,
                workloads: Tuple[Workload, ...] = WORKLOADS, refresh=None,
                mesh=None) -> Dict[str, float]:
    """Score a materialized replay (duck-typed: ``timings`` (S, N, 2, 4),
    ``bin_idx`` and ``switched`` (S, N)): init → accumulate the whole trace
    as one block (on a card, one launch of the accumulate kernel) →
    finalize, with the refresh figures when ``refresh`` is given.

    ``mesh`` — the replay is a sharded one's (this rank's real DIMMs, as
    ``controller.replay(mesh=)`` returns it) and ``stack`` is whole: each
    rank accumulates its block (one launch a rank; none on a rank whose
    block is empty) and the sharded finalize combines the figures, the
    same finalize a sharded stream runs, so the two agree bitwise."""
    n_dimms, n_bins = stack.shape[0], stack.shape[1]
    rows = n_dimms
    if mesh is not None:
        lo, hi = shard.local_range(n_dimms, mesh)
        rows = hi - lo
    partials = trace_score_init(rows, n_bins, stack.device)
    if rows:
        partials = trace_score_accumulate(partials, replay.timings, replay.bin_idx,
                                          replay.switched)
    else:
        partials = partials._replace(n_steps=partials.n_steps + int(replay.timings.shape[0]))
    return trace_score_finalize(partials, stack, cfg, claim, workloads, refresh, mesh)


# ---------------------------------------------------------------------------
# Region-resolved scoring (design-induced variation, rank-5 tables)
# ---------------------------------------------------------------------------
#: Elements of the flattened ``(steps · n_dimms, n_regions)`` mix block one
#: region-count scatter takes (an expanded mix is copied a block at a time).
_REGION_ELEMS_PER_BLOCK: int = 1 << 26


def region_counts_init(n_dimms: int, n_bins: int, n_regions: int,
                       device: str | torch.device = "cuda") -> torch.Tensor:
    """Zeroed ``(n_dimms, n_bins + 1, n_regions)`` int32 region-access
    counters (the last bin column is the beyond-last JEDEC sentinel)."""
    return torch.zeros((n_dimms, n_bins + 1, n_regions), dtype=torch.int32,
                       device=resolve_device(device))


def region_counts_add_(counts: torch.Tensor, bin_idx: torch.Tensor,
                       region_mix: torch.Tensor) -> torch.Tensor:
    """:func:`region_counts_accumulate` into ``counts`` itself (contiguous),
    which it returns."""
    n, b1, r = counts.shape
    if bin_idx.dim() != 2 or tuple(bin_idx.shape[1:]) != (n,):
        raise ValueError(f"bin_idx must be (steps, {n}), got {tuple(bin_idx.shape)}")
    if tuple(region_mix.shape) != tuple(bin_idx.shape) + (r,):
        raise ValueError(f"region_mix shape {tuple(region_mix.shape)} does not match "
                         f"bin_idx {tuple(bin_idx.shape)} × {r} regions")
    dev = counts.device
    flat = counts.view(n * b1, r)
    base = torch.arange(n, dtype=torch.int64, device=dev) * b1
    block = max(1, _REGION_ELEMS_PER_BLOCK // max(1, n * r))
    for s in range(0, bin_idx.shape[0], block):
        idx = base + bin_idx[s:s + block].to(device=dev, dtype=torch.int64)
        mix = region_mix[s:s + block].to(device=dev, dtype=torch.int32)
        flat.index_add_(0, idx.reshape(-1), mix.reshape(-1, r))
    return counts


def region_counts_accumulate(counts: torch.Tensor, bin_idx: torch.Tensor,
                             region_mix: torch.Tensor) -> torch.Tensor:
    """Absorb a chunk of per-step region-access mixes at each step's
    effective bin: ``bin_idx`` the ``(chunk, n_dimms)`` effective-bin trace
    (``n_bins`` = the JEDEC sentinel, as :class:`ReplayResult` records it),
    ``region_mix`` the ``(chunk, n_dimms, n_regions)`` int32 access counts.
    An integer scatter over ``dimm · (n_bins + 1) + bin``, a block of steps
    at a time (no one-hot of the bins is built); integer adds are exact in
    any order, so the counts equal the reference's one-hot product."""
    return region_counts_add_(counts.clone(memory_format=torch.contiguous_format),
                              bin_idx, region_mix)


def _region_speedup_grids(region_stack: torch.Tensor, cfg: SystemConfig,
                          workloads: Tuple[Workload, ...]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(DIMM, effective bin, region) speedups of a rank-5 register stack
    (each region's own block, the JEDEC row appended as the last bin), and
    the region-oblivious per-(DIMM, effective bin) speedups of its
    max-over-regions rows. Each region row is elementwise at most the
    merge and IPC is monotone in every timing, so aware >= oblivious."""
    n_dimms, _, n_regions = region_stack.shape[:3]
    jedec = torch.tensor(list(JEDEC_DDR3_1600), dtype=torch.float32,
                         device=region_stack.device)
    jedec_rows = jedec.broadcast_to((n_dimms, 1, n_regions, len(ACCESS_TYPES),
                                     len(PARAM_NAMES)))
    rows = torch.cat([region_stack, jedec_rows], dim=1)          # (N, B+1, R, 2, 4)
    sp = fleet_speedups(rows, cfg, workloads)                    # (N, B+1, R)
    sp_obl = fleet_speedups(rows.amax(dim=2), cfg, workloads)    # (N, B+1)
    return sp, sp_obl


def region_score_finalize(
    counts: torch.Tensor,
    region_stack: torch.Tensor,
    cfg: SystemConfig = MULTI_CORE,
    claim: float = PAPER_CLAIM_SPEEDUP,
    workloads: Tuple[Workload, ...] = WORKLOADS,
) -> Dict[str, float]:
    """Region-occupancy-weighted realized speedups from accumulated counts
    (``(n_dimms, n_bins + 1, n_regions)`` int32) and a table's rank-5
    ``(n_dimms, n_bins, n_regions, 2, 4)`` registers
    (:meth:`~repro_torch.core.controller.DimmTimingTable.region_stack`):
    ``speedup_region_aware_*`` serves each access at its own region's
    timings, ``speedup_region_oblivious_*`` all of them at the
    max-over-regions set; their gap is what the region axis buys."""
    region_stack = region_stack.to(torch.float32)
    if region_stack.dim() != 5 or tuple(region_stack.shape[3:]) != (
            len(ACCESS_TYPES), len(PARAM_NAMES)):
        raise ValueError(f"region_stack must be (n_dimms, n_bins, n_regions, 2, 4), "
                         f"got {tuple(region_stack.shape)}")
    n_dimms, n_bins, n_regions = region_stack.shape[:3]
    if tuple(counts.shape) != (n_dimms, n_bins + 1, n_regions):
        raise ValueError(f"counts shape {tuple(counts.shape)} does not match a "
                         f"{n_dimms}-DIMM, {n_bins}-bin, {n_regions}-region table")
    counts = counts.to(region_stack.device)
    w = counts.to(torch.float32)                                 # (N, B+1, R)
    total = w.sum(dim=(1, 2))
    if bool((total <= 0).any()):
        raise ValueError("cannot finalize a region score with zero accesses")
    sp, sp_obl = _region_speedup_grids(region_stack, cfg, workloads)
    sp_m, sp_obl_m = _region_speedup_grids(region_stack, cfg, MEM_INTENSIVE_WORKLOADS)
    aware = (w * sp).sum(dim=(1, 2)) / total                     # (N,)
    aware_m = (w * sp_m).sum(dim=(1, 2)) / total
    per_bin = w.sum(dim=2)
    obl = (per_bin * sp_obl).sum(dim=1) / total
    obl_m = (per_bin * sp_obl_m).sum(dim=1) / total
    near_frac = w[:, :, 0].sum(dim=1) / total
    return {
        "n_regions": float(n_regions),
        "region_accesses_total": float(counts.to(torch.int64).sum()),
        "nearest_region_access_frac": float(near_frac.mean()),
        "speedup_region_aware_mean": float(aware.mean() - 1.0),
        "speedup_region_aware_min": float(aware.min() - 1.0),
        "speedup_region_aware_intensive_mean": float(aware_m.mean() - 1.0),
        "speedup_region_oblivious_mean": float(obl.mean() - 1.0),
        "speedup_region_oblivious_intensive_mean": float(obl_m.mean() - 1.0),
        "region_aware_advantage_intensive": float((aware_m - obl_m).mean()),
        "speedup_region_aware_vs_claim": float(aware_m.mean() - 1.0) - claim,
    }


def region_trace_score(
    region_stack: torch.Tensor,
    replay,
    region_mix: torch.Tensor,
    cfg: SystemConfig = MULTI_CORE,
    claim: float = PAPER_CLAIM_SPEEDUP,
    workloads: Tuple[Workload, ...] = WORKLOADS,
) -> Dict[str, float]:
    """Score a materialized replay (duck-typed: only ``bin_idx``, the
    ``(S, N)`` effective-bin history, is read; bin dynamics depend on the
    temperature only, so one replay scores any region resolution) against
    rank-5 registers, given the ``(S, N, R)`` per-step region-access mix:
    init, accumulate the whole trace, finalize — the counts a streamed
    replay carries chunk by chunk."""
    if region_stack.dim() != 5:
        raise ValueError(f"region_stack must be rank-5, got {tuple(region_stack.shape)}; "
                         "pass DimmTimingTable.region_stack()")
    n_dimms, n_bins, n_regions = region_stack.shape[:3]
    counts = region_counts_add_(
        region_counts_init(n_dimms, n_bins, n_regions, region_stack.device),
        replay.bin_idx, region_mix)
    return region_score_finalize(counts, region_stack, cfg, claim, workloads)
