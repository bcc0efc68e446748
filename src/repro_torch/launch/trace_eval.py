"""Trace-driven controller evaluation: a fleet's week of telemetry, replayed.

Profiles a synthetic fleet into timing registers (the charge-sweep kernel on
a card), gives the table a refresh policy, generates one of the thermal
scenarios (:mod:`repro_torch.core.traces`), replays it through the
controller with the dense history kept (:func:`~repro_torch.core.controller.replay`:
on a card the replay-chunk kernel's emitting entry, one launch a
``REPLAY_CHUNK_STEPS`` steps of the trace), holds the replay
bitwise against the per-observation :class:`ALDRAMController` loop on a
sub-grid, and scores the realized latency reductions, switching activity
and speedups against the paper's 14 % claim — latency-only and combined
with refresh (:func:`~repro_torch.core.perfmodel.trace_score_accumulate`:
on a card one launch of the accumulate kernel).

  PYTHONPATH=src python -m repro_torch.launch.trace_eval --device cpu --tiny
  PYTHONPATH=src python -m repro_torch.launch.trace_eval --device cuda \\
      --n-dimms 65536 --n-steps 10000 --scenario refresh_storm

With ``--regions R`` (default 4 for the scenarios of
``traces.SCENARIO_REGION_PROFILES``, ``design_skew`` and ``hot_bank``) the
same fleet is profiled again over R distance-from-sense-amp regions
(:func:`~repro_torch.core.fleet.sweep_regions`, one charge-sweep launch) into
a rank-5 table, and the same replay's bin history is scored under the
scenario's region-access mix (:func:`~repro_torch.core.perfmodel.region_trace_score`):
each access at its own region's registers (aware) against all of them at
the max-over-regions set (oblivious).

  PYTHONPATH=src python -m repro_torch.launch.trace_eval --device cpu --tiny \\
      --scenario design_skew

Gates (the run raises on any): the replay equals the observe loop
exactly on the sub-grid; every DIMM's coolest-bin read tRAS sits below
JEDEC; with a refresh policy the combined speedups do not exceed the
latency-only ones; the region table's max-over-regions registers equal the
region-free table's bitwise (the anchor region), and on a ``near`` mix the
region-aware speedup lies strictly above the oblivious one. Rows print as
``name,value,reference`` lines; no file is written.

With ``--sharded`` (``run(sharded=True)`` on the ranks of a process group;
the command line spawns one rank a visible card, ``--shards`` CPU ranks, or
joins ``torchrun``'s) the same trace is also replayed over the ``"dimm"``
mesh (:func:`~repro_torch.core.controller.replay` ``mesh=``: each rank its
block of DIMMs), timed, and held bitwise against the same rows of the
single-device replay on the same device, and scored through the sharded
``trace_score(mesh=)`` within ``1e-4`` relative of the single-device score
(rows ``trace/sharded_*``; only rank 0 prints).

  PYTHONPATH=src python -m repro_torch.launch.trace_eval --device cpu --tiny \\
      --sharded --shards 4
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import controller, fleet, perfmodel, shard, traces
from repro_torch.core import refresh as rf

#: --refresh choices -> table refresh policy.
REFRESH_POLICIES = {"ddr3": rf.DDR3_EXTENDED, "ddr3_4x": rf.DDR3_EXTENDED_4X, "off": None}

#: Regions profiled for the region section (``regions=None`` picks this for
#: the scenarios of ``traces.SCENARIO_REGION_PROFILES``, 0 for the others).
DEFAULT_N_REGIONS = 4


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def observe_loop(table: controller.DimmTimingTable, trace: np.ndarray,
                 errors: np.ndarray):
    """The per-observation execution model: one :meth:`ALDRAMController.observe`
    per (step, DIMM). Returns ``(rows (S, N, 2, 4) float32, seconds)``."""
    ctl = controller.ALDRAMController(table)
    n_steps, n_dimms = trace.shape
    rows = np.zeros((n_steps, n_dimms, 2, 4), np.float32)
    t0 = time.perf_counter()
    for s in range(n_steps):
        for d in range(n_dimms):
            if errors[s, d]:
                ctl.report_error(d)
            t = ctl.observe(d, float(trace[s, d]))
            rows[s, d, 0] = tuple(t.read)
            rows[s, d, 1] = tuple(t.write)
    return rows, time.perf_counter() - t0


def run(
    n_dimms: int = 1000,
    n_steps: int = 10_000,
    scenario: str = "diurnal",
    temp_bins=controller.DEFAULT_TEMP_BINS,
    dt_s: float = traces.DEFAULT_DT_S,
    error_rate: float = 0.0,
    baseline_dimms: int = 24,
    baseline_steps: int = 500,
    seed: int = 0,
    verbose: bool = True,
    sharded: bool = False,
    refresh: str = "ddr3",
    regions: Optional[int] = None,
    device: str | torch.device = "cuda",
    fleet_in: Optional[fleet.Fleet] = None,
    table: Optional[controller.DimmTimingTable] = None,
    trace: Optional[torch.Tensor] = None,
    errors: Optional[torch.Tensor] = None,
    region_mix: Optional[torch.Tensor] = None,
) -> Dict:
    """Evaluate the controller on one scenario; returns ``rows`` (name,
    value, reference) as the reference benchmark prints them, the ``score``
    dict, the ``partials``, the ``replay`` history, and the ``table``,
    ``trace`` and ``errors`` it used.

    Inputs are made from ``seed`` with one ``torch.Generator`` on the device
    (fleet, then trace, then errors, then the region mix) unless given:
    ``fleet_in`` (on ``device``) replaces the synthesized fleet, ``table``
    the profiled registers (its refresh policy is replaced by
    ``refresh``'s), ``trace`` / ``errors`` the generated telemetry,
    ``region_mix`` the ``(n_steps, n_dimms, regions)`` region-access mix;
    ``table``, ``trace`` and ``errors`` are moved to ``device``. With
    regions the report adds ``region_score``, ``region_table`` and
    ``region_s`` (the section's seconds).

    ``sharded`` — this process is one rank of a process group
    (:func:`~repro_torch.core.shard.fleet_mesh` over it): every rank runs the
    whole single-device evaluation on its device, then the sharded section
    (see the module docstring; the report adds ``sharded_replay``, this
    rank's block, and ``sharded_score``). Only rank 0 prints."""
    if regions is None:
        regions = DEFAULT_N_REGIONS if scenario in traces.SCENARIO_REGION_PROFILES else 0
    if regions and fleet_in is None and table is not None:
        raise ValueError("the region section profiles the fleet: pass fleet_in with the "
                         "table, or regions=0")
    if scenario not in traces.SCENARIOS:
        raise ValueError(f"unknown scenario {scenario!r}; choose from {sorted(traces.SCENARIOS)}")
    dev = resolve_device(device)
    mesh = shard.fleet_mesh(device=dev) if sharded else None
    verbose = verbose and (mesh is None or mesh.get_local_rank(shard.DIMM_AXIS) == 0)
    gen = torch.Generator(device=dev).manual_seed(seed)
    policy = REFRESH_POLICIES[refresh]

    fl = fleet_in
    if table is None:
        if fl is None:
            fl = fleet.synthesize(gen, n_dimms, device=dev)
        sweep = fleet.sweep(fl, temps_c=tuple(temp_bins), patterns=(1.0,))
        table = controller.DimmTimingTable.from_fleet(sweep, refresh=policy)
    else:
        table = controller.DimmTimingTable(table.temp_bins, table.stack.to(dev), policy)
    n_dimms = table.n_dimms
    if trace is None:
        kw = ({"vendor": None if fl is None else fl.vendor}
              if scenario == "vendor_skew" else {})
        trace = traces.generate(scenario, gen, n_dimms, n_steps, dt_s, device=dev, **kw)
    trace = torch.as_tensor(trace).to(device=dev, dtype=torch.float32)
    n_steps = int(trace.shape[0])
    if errors is None:
        errors = traces.error_injections(gen, n_steps, n_dimms, error_rate, device=dev)
    errors = torch.as_tensor(errors).to(device=dev, dtype=torch.bool)
    drift = traces.max_drift_rate(trace, dt_s)

    # -- replay: a warm run, then the timed one ----------------------------
    res = controller.replay(table, trace, errors)
    _sync(dev)
    res = None  # free the warm history before the timed replay allocates its own
    t0 = time.perf_counter()
    res = controller.replay(table, trace, errors)
    _sync(dev)
    t_scan = time.perf_counter() - t0

    # -- per-observation loop on a sub-grid, and the exactness gate --------
    n_b, s_b = min(baseline_dimms, n_dimms), min(baseline_steps, n_steps)
    sub_table = controller.DimmTimingTable(table.temp_bins, table.stack[:n_b].contiguous())
    sub_trace = trace[:s_b, :n_b].cpu().numpy()
    sub_err = errors[:s_b, :n_b].cpu().numpy()
    loop_rows, t_loop_measured = observe_loop(sub_table, sub_trace, sub_err)
    t_loop = t_loop_measured * (n_dimms * n_steps) / (n_b * s_b)
    speedup = t_loop / t_scan
    sub_res = controller.replay(sub_table, sub_trace, sub_err)
    sub_rows = sub_res.timings.cpu().numpy()
    exact = bool(np.array_equal(sub_rows, loop_rows))
    max_err = float(np.abs(sub_rows - loop_rows).max())
    if not exact:
        raise AssertionError(f"replay diverged from the observe loop: max|err| = {max_err} ns "
                             f"on the {n_b}x{s_b} sub-grid")

    # -- scoring: init -> accumulate the whole history -> finalize ---------
    t0 = time.perf_counter()
    partials = perfmodel.trace_score_accumulate(
        perfmodel.trace_score_init(n_dimms, table.n_bins, dev),
        res.timings, res.bin_idx, res.switched)
    _sync(dev)
    t_accumulate = time.perf_counter() - t0
    t0 = time.perf_counter()
    score = perfmodel.trace_score_finalize(partials, table.stack, refresh=table.bin_refresh())
    t_finalize = time.perf_counter() - t0
    fused_dimms = float(res.state.fused.sum())

    # -- sharded section: each rank's block against the single-device rows --
    shard_rows, sres, sscore = [], None, None
    if mesh is not None:
        sres = controller.replay(table, trace, errors, mesh=mesh)
        _sync(dev)
        sres = None  # the warm run's block, before the timed replay allocates its own
        t0 = time.perf_counter()
        sres = controller.replay(table, trace, errors, mesh=mesh)
        _sync(dev)
        t_sharded = time.perf_counter() - t0
        lo, hi = shard.local_range(n_dimms, mesh)
        mism, shard_err = sharded_replay_mismatches(res, sres, lo, hi)
        mism = int(shard.psum(torch.tensor(mism, dtype=torch.int64, device=dev), mesh))
        shard_err = float(shard.pmax(torch.tensor([shard_err], dtype=torch.float64,
                                                  device=dev), mesh))
        replay_exact = mism == 0
        if not replay_exact:
            raise AssertionError(f"sharded replay diverged from the single-device replay: "
                                 f"{mism} mismatching words, max|err| = {shard_err} ns on "
                                 f"{shard.n_shards(mesh)} ranks")
        t0 = time.perf_counter()
        sscore = perfmodel.trace_score(table.stack, sres, refresh=table.bin_refresh(),
                                       mesh=mesh)
        t_sharded_score = time.perf_counter() - t0
        score_err = max(abs(sscore[k] - score[k]) / max(abs(score[k]), 1.0) for k in score)
        if score_err > 1e-4:
            raise AssertionError(f"sharded trace_score diverged: max rel err {score_err:.2e}")
        shard_rows = [
            ("trace/sharded_n_devices", float(shard.n_shards(mesh)), ""),
            ("trace/sharded_replay_seconds", t_sharded, ""),
            ("trace/sharded_vs_single_device_ratio", t_scan / t_sharded,
             "scaling row; >1 = sharding wins"),
            ("trace/sharded_replay_parity_exact", 1.0 if replay_exact else 0.0, "==1"),
            ("trace/sharded_score_max_rel_err", score_err, "<=1e-4"),
            ("trace/sharded_score_seconds", t_sharded_score,
             f"accumulate + finalize of each rank's block (single device: "
             f"{t_accumulate + t_finalize:.4g})"),
        ]

    # -- region section: the same fleet's region registers, the same history --
    # The anchor region makes the region table's max-over-regions registers
    # the replay table's bitwise, so res.bin_idx is the bin history a
    # region-oblivious controller realizes: no second replay.
    region_rows, region_score, rtable, t_region = [], None, None, 0.0
    if regions:
        t0 = time.perf_counter()
        rtable = fleet.sweep_regions(fl, temps_c=tuple(temp_bins), patterns=(1.0,),
                                     n_regions=regions).to_table()
        if not torch.equal(rtable.oblivious_stack(), table.stack):
            raise AssertionError("the region table's max-over-regions registers differ from "
                                 "the region-free profile: the anchor contract is broken")
        profile = traces.SCENARIO_REGION_PROFILES.get(scenario, "uniform")
        if region_mix is None:
            region_mix = traces.region_access_mix(gen, n_steps, n_dimms, regions,
                                                  profile=profile, device=dev)
        region_score = perfmodel.region_trace_score(rtable.region_stack(), res, region_mix)
        t_region = time.perf_counter() - t0
        aware = region_score["speedup_region_aware_intensive_mean"]
        oblivious = region_score["speedup_region_oblivious_intensive_mean"]
        if profile == "near" and not aware > oblivious:
            raise AssertionError(f"region-aware intensive speedup {aware:.6f} is not strictly "
                                 f"above the oblivious {oblivious:.6f} on the near mix")
        region_rows = [
            ("trace/region_n_regions", float(regions), ""),
            ("trace/region_mix_" + profile, 1.0, ""),
            ("trace/region_seconds", t_region, ""),
            ("trace/nearest_region_access_frac",
             region_score["nearest_region_access_frac"], ""),
            ("trace/speedup_region_aware_intensive_mean", aware,
             "per-(DIMM,bin,region) lookup"),
            ("trace/speedup_region_oblivious_intensive_mean", oblivious,
             "max-over-regions registers"),
            ("trace/region_aware_advantage_intensive",
             region_score["region_aware_advantage_intensive"], "> 0 on skewed mixes"),
        ]

    if score["tras_below_jedec_coolest_frac"] < 1.0:
        raise AssertionError(
            "tRAS-at-JEDEC symptom: some DIMM's coolest-bin read set does not reduce "
            f"tRAS below JEDEC (frac={score['tras_below_jedec_coolest_frac']:.6f})")
    if policy is not None:
        for lat, comb in (("speedup_realized_mean", "speedup_combined_mean"),
                          ("speedup_realized_intensive_mean",
                           "speedup_combined_intensive_mean")):
            if score[comb] > score[lat]:
                raise AssertionError(f"{comb} {score[comb]:.6f} exceeds the latency-only "
                                     f"{lat} {score[lat]:.6f}")

    rows = [
        ("trace/scenario_" + scenario, 1.0, ""),
        ("trace/n_dimms", float(n_dimms), ""),
        ("trace/n_steps", float(n_steps), ""),
        ("trace/transitions", float(n_dimms) * n_steps, ""),
        ("trace/max_drift_c_per_s", drift, f"paper bound {traces.PAPER_MAX_DRIFT_C_PER_S}"),
        ("trace/scan_seconds", t_scan, f"device {dev}"),
        ("trace/accumulate_seconds", t_accumulate, ""),
        ("trace/finalize_seconds", t_finalize, ""),
        ("trace/loop_seconds_extrapolated", t_loop, ""),
        ("trace/speedup_vs_loop", speedup, ""),
        ("trace/loop_equivalence_exact", float(exact), "==1"),
        ("trace/loop_max_abs_error_ns", max_err, "==0"),
        ("trace/read_reduction_mean", score["read_reduction_mean"], ""),
        ("trace/write_reduction_mean", score["write_reduction_mean"], ""),
        ("trace/read_tras_reduction_mean", score["read_tras_reduction_mean"], "> 0"),
        ("trace/write_tras_reduction_mean", score["write_tras_reduction_mean"], ""),
        ("trace/read_trcd_reduction_mean", score["read_trcd_reduction_mean"], ""),
        ("trace/write_twr_reduction_mean", score["write_twr_reduction_mean"], ""),
        ("trace/tras_below_jedec_coolest_frac", score["tras_below_jedec_coolest_frac"], "==1"),
        ("trace/speedup_realized_mean", score["speedup_realized_mean"], ""),
        ("trace/speedup_realized_intensive_mean", score["speedup_realized_intensive_mean"],
         f"paper claim {perfmodel.PAPER_CLAIM_SPEEDUP}"),
        ("trace/speedup_vs_claim", score["speedup_vs_claim"], ""),
        ("trace/switches_total", score["switches_total"], ""),
        ("trace/switches_per_kstep", score["switches_per_kstep"], ""),
        ("trace/time_at_jedec_frac", score["time_at_jedec_frac"], ""),
        ("trace/time_in_coolest_bin_frac", score["time_in_coolest_bin_frac"], ""),
        ("trace/fused_dimms", fused_dimms, "0 unless error injection"),
    ]
    if policy is not None:
        rows.extend([
            ("trace/refresh_occupancy_mean", score["refresh_occupancy_mean"],
             f"1x floor {policy.occupancy_of(1.0):.5f}"),
            ("trace/speedup_combined_mean", score["speedup_combined_mean"], "<= latency-only"),
            ("trace/speedup_combined_intensive_mean", score["speedup_combined_intensive_mean"],
             f"paper claim {perfmodel.PAPER_CLAIM_SPEEDUP} (latency+refresh)"),
            ("trace/speedup_combined_vs_claim", score["speedup_combined_vs_claim"], ""),
            ("trace/refresh_dilution_intensive",
             score["speedup_realized_intensive_mean"] - score["speedup_combined_intensive_mean"],
             ">= 0"),
        ])
    rows.extend(shard_rows)
    rows.extend(region_rows)

    if verbose:
        print(f"# {scenario}: {n_dimms} DIMMs x {n_steps} steps = {n_dimms * n_steps:,} "
              f"transitions on {dev} (max drift {drift:.3f} C/s)")
        print(f"# replay: {t_scan:.3f} s | observe loop: {t_loop_measured:.2f} s for "
              f"{n_b}x{s_b} -> {t_loop:.1f} s extrapolated | speedup {speedup:,.0f}x")
        print(f"# loop equivalence: exact={exact} max|err|={max_err:.2e} ns")
        print(f"# realized: read -{score['read_reduction_mean'] * 100:.1f}% write "
              f"-{score['write_reduction_mean'] * 100:.1f}% | perf "
              f"+{score['speedup_realized_mean'] * 100:.1f}% all, "
              f"+{score['speedup_realized_intensive_mean'] * 100:.1f}% mem-intensive | "
              f"{score['switches_total']:.0f} switches")
        if policy is not None:
            print(f"# refresh ({refresh}): occupancy {score['refresh_occupancy_mean'] * 100:.2f}% "
                  f"of tREFI | combined +{score['speedup_combined_mean'] * 100:.1f}% all, "
                  f"+{score['speedup_combined_intensive_mean'] * 100:.1f}% mem-intensive")
        if region_score is not None:
            print(f"# regions ({regions}): aware "
                  f"+{region_score['speedup_region_aware_intensive_mean'] * 100:.1f}% vs "
                  f"oblivious "
                  f"+{region_score['speedup_region_oblivious_intensive_mean'] * 100:.1f}% "
                  f"mem-intensive (advantage "
                  f"+{region_score['region_aware_advantage_intensive'] * 100:.2f} pp)")
    return {"rows": rows, "score": score, "partials": partials, "replay": res,
            "table": table, "trace": trace, "errors": errors, "scan_s": t_scan,
            "loop_exact": exact, "region_score": region_score, "region_table": rtable,
            "region_mix": region_mix, "region_s": t_region, "sharded_replay": sres,
            "sharded_score": sscore, "sharded_s": t_sharded if mesh is not None else None}


#: Steps a block of the sharded parity comparison covers (bounds the
#: comparison's temporaries on a card).
_PARITY_STEPS = 1000


def sharded_replay_mismatches(res, sres, lo: int, hi: int):
    """Mismatching words between a sharded replay's block ``sres`` (this
    rank's DIMMs ``lo:hi``) and those columns of the single-device replay
    ``res`` — the timings as float32 bit patterns, bins, switch and fuse
    flags, and the final state — and the largest timing difference (ns)."""
    mism, err = 0, 0.0
    for s in range(0, res.timings.shape[0], _PARITY_STEPS):
        e = s + _PARITY_STEPS
        a, b = res.timings[s:e, lo:hi], sres.timings[s:e]
        mism += int((a.view(torch.int32) != b.view(torch.int32)).sum())
        if a.numel():
            err = max(err, float((a - b).abs().max()))
        for name in ("bin_idx", "switched", "fused"):
            mism += int((getattr(res, name)[s:e, lo:hi] != getattr(sres, name)[s:e]).sum())
    for x, y in zip(res.state, sres.state):
        mism += int((x[lo:hi] != y).sum())
    return mism, err


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--n-dimms", type=int, default=None, help="fleet size (default 1000)")
    ap.add_argument("--n-steps", type=int, default=None,
                    help="trace length in observations (default 10000)")
    ap.add_argument("--scenario", choices=sorted(traces.SCENARIOS), default="diurnal")
    ap.add_argument("--dt-s", type=float, default=traces.DEFAULT_DT_S,
                    help="seconds per observation (default 60)")
    ap.add_argument("--error-rate", type=float, default=0.0,
                    help="per-(step, DIMM) error-injection probability")
    ap.add_argument("--refresh", choices=sorted(REFRESH_POLICIES), default="ddr3",
                    help="refresh policy of the table (default ddr3: 1x/2x above 85 C)")
    ap.add_argument("--baseline-dimms", type=int, default=None,
                    help="DIMMs timed in the observe loop (default 24)")
    ap.add_argument("--baseline-steps", type=int, default=None,
                    help="steps timed in the observe loop (default 500)")
    ap.add_argument("--tiny", action="store_true", help="64 DIMMs x 512 steps, loop 8 x 128")
    ap.add_argument("--sharded", action="store_true",
                    help="add the sharded section: one rank a visible card (or --shards CPU "
                         "ranks), or the ranks of torchrun")
    ap.add_argument("--shards", type=int, default=None,
                    help="ranks to spawn with --sharded (default: every visible card)")
    ap.add_argument("--regions", type=int, default=None,
                    help=f"profile this many distance-from-sense-amp regions and add the "
                         f"region-aware vs -oblivious section (default {DEFAULT_N_REGIONS} "
                         f"for {', '.join(sorted(traces.SCENARIO_REGION_PROFILES))}, else 0)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    sizes = dict(n_dimms=args.n_dimms, n_steps=args.n_steps,
                 baseline_dimms=args.baseline_dimms, baseline_steps=args.baseline_steps)
    if args.tiny:
        conflicts = [f"--{k.replace('_', '-')}" for k, v in sizes.items() if v is not None]
        if conflicts:
            ap.error(f"--tiny fixes the configuration; remove {', '.join(conflicts)}")
        sizes = dict(n_dimms=64, n_steps=512, baseline_dimms=8, baseline_steps=128)
    defaults = dict(n_dimms=1000, n_steps=10_000, baseline_dimms=24, baseline_steps=500)
    sizes = {k: defaults[k] if v is None else v for k, v in sizes.items()}
    kwargs = dict(scenario=args.scenario, dt_s=args.dt_s, error_rate=args.error_rate,
                  seed=args.seed, refresh=args.refresh, regions=args.regions,
                  device=args.device, **sizes)
    if args.sharded:
        rows = shard.run_ranks(sharded_rows, args.device, args.shards, kwargs)
        if rows is None:  # a torchrun rank other than 0
            return
    else:
        rows = run(**kwargs)["rows"]
    for name, value, ref in rows:
        print(f"{name},{value:.6g},{ref}")


def sharded_rows(kwargs: Dict):
    """One rank of ``--sharded``: :func:`run` with ``sharded=True``; rank 0
    prints each rank's sharded replay seconds and peak device memory and
    returns the rows (no tensors: spawned ranks hand back only rank 0's
    return value), the others ``None``."""
    dev = resolve_device(kwargs.get("device", "cuda"))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    report = run(**kwargs, sharded=True)
    mine = (torch.distributed.get_rank(), report["sharded_s"],
            torch.cuda.max_memory_allocated() if dev.type == "cuda" else None)
    per_rank = [None] * torch.distributed.get_world_size()
    torch.distributed.all_gather_object(per_rank, mine)
    if torch.distributed.get_rank() != 0:
        return None
    for rank, secs, peak in per_rank:
        print(f"# rank {rank}: sharded replay {secs:.4f} s, peak device memory "
              + ("n/a" if peak is None else f"{peak / 2**30:.2f} GiB"))
    return report["rows"]


if __name__ == "__main__":
    main()
