"""The port's trace-driven evaluation vs the JAX reference, on the CPU.

Same numpy inputs through both packages; the port is fed the reference's
own ``jax.random`` draws through its pre-drawn arguments (threefry bits
cannot be reproduced in torch):

* every scenario's trace within 1e-5 °C (float32 ``sin``/``exp`` may differ
  by an ulp between the backends);
* the materialized ``replay`` history and final state, and the
  ``ALDRAMController`` observe loop, bitwise;
* the accumulation's plain version bitwise vs the reference's ref and its
  Pallas kernel in interpret mode;
* ``trace_score(refresh=...)`` figures within 1e-5 (the 60-step float32
  bisection may differ in its last step between backends);
* on the reference's ``--tiny`` draws, the committed goldens of
  ``benchmarks/baselines/`` (read, never written);
* ``launch.trace_eval`` end to end on the CPU.
"""

import json
import pathlib
import sys

import jax
import numpy as np
import pytest
import torch

from repro.core import controller as jcontroller
from repro.core import perfmodel as jperf
from repro.core import refresh as jrefresh
from repro.core import traces as jtraces
from repro.kernels.replay_step import ops as jreplay_ops
from repro_torch import convert
from repro_torch.core import controller, dimm, fleet, perfmodel, refresh, traces
from repro_torch.kernels.replay_step import kernel as replay_kernel
from repro_torch.kernels.replay_step import ops as replay_ops
from repro_torch.launch import trace_eval

BASELINES = pathlib.Path(__file__).resolve().parents[1] / "benchmarks" / "baselines"
N_DIMMS, N_STEPS = 64, 512            # benchmarks/trace_eval.py --tiny
SCEN_DIMMS, SCEN_STEPS = 16, 128
BINS = jcontroller.DEFAULT_TEMP_BINS
POLICIES = {"ddr3": (refresh.DDR3_EXTENDED, jrefresh.DDR3_EXTENDED),
            "ddr3_4x": (refresh.DDR3_EXTENDED_4X, jrefresh.DDR3_EXTENDED_4X),
            "off": (None, None)}


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a))


def _sets(a):
    """An ``AccessTimings`` of either package as nested tuples of ns."""
    return tuple(a.read), tuple(a.write)


def _diurnal_draws(key, n, s) -> traces.DiurnalNoise:
    k_phase, k_skew, k_noise = jax.random.split(key, 3)
    return traces.DiurnalNoise(
        phase=_t(jax.random.normal(k_phase, (n,))),
        skew=_t(jax.random.uniform(k_skew, (n,), minval=-1.0, maxval=1.0)),
        noise=_t(jax.random.normal(k_noise, (s, n))),
    )


def reference_draws(name, key, n, s):
    """The draws the reference's generator takes from ``key`` (a Bernoulli
    mask is ``uniform < p`` in ``jax.random``)."""
    if name in ("load_bursts", "refresh_storm", "hot_bank"):
        k_base, k_event = jax.random.split(key)
        shape = (s, n) if name == "load_bursts" else (n,)
        return traces.EventDraws(_diurnal_draws(k_base, n, s),
                                 _t(jax.random.uniform(k_event, shape)))
    return _diurnal_draws(key, n, s)


def reference_fleet(key, n) -> fleet.Fleet:
    """The reference's ``fleet.synthesize(key, n)`` population, mapped by the
    port from the reference's uniform draws."""
    split, uniforms = fleet.vendor_split(n), []
    for n_v in split:
        key, kr, kc, kl = jax.random.split(key, 4)
        uniforms.append(tuple(_t(jax.random.uniform(k, (n_v,))) for k in (kr, kc, kl)))
    cells, vendor = dimm.population_from_uniforms(uniforms)
    return fleet.Fleet(cells=cells, vendor=vendor)


@pytest.fixture(scope="module")
def tiny():
    """The --tiny configuration: the reference's seed-0 fleet profiled by the
    port, a refresh_storm trace from the reference's draws and errors at
    1e-3 (numpy); the same history replayed by both packages."""
    k_fleet, k_trace, _ = jax.random.split(jax.random.PRNGKey(0), 3)
    fl = reference_fleet(k_fleet, N_DIMMS)
    table = fleet.sweep(fl, BINS, (1.0,)).to_table()
    trace = traces.refresh_storm(None, N_DIMMS, N_STEPS,
                                 draws=reference_draws("refresh_storm", k_trace, N_DIMMS, N_STEPS))
    errors = np.random.default_rng(0).random((N_STEPS, N_DIMMS)) < 1e-3
    jtable = jcontroller.DimmTimingTable(BINS, table.stack.numpy())
    jres = jcontroller.replay(jtable, trace.numpy(), errors)
    res = controller.replay(table, trace, torch.from_numpy(errors))
    return dict(fl=fl, k_trace=k_trace, table=table, trace=trace, errors=errors,
                jtable=jtable, jres=jres, res=res)


@pytest.mark.parametrize("name", sorted(jtraces.SCENARIOS))
def test_scenario_matches_reference_on_its_draws(name):
    key = jax.random.PRNGKey(11)
    vendor = np.arange(SCEN_DIMMS, dtype=np.int32) % 3 * (np.arange(SCEN_DIMMS) % 5 > 1)
    kw = {"vendor": vendor} if name == "vendor_skew" else {}
    want = np.asarray(jtraces.generate(name, key, SCEN_DIMMS, SCEN_STEPS, **kw))
    got = traces.generate(name, None, SCEN_DIMMS, SCEN_STEPS, device="cpu",
                          draws=reference_draws(name, key, SCEN_DIMMS, SCEN_STEPS),
                          **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assert traces.max_drift_rate(got, 60.0) == pytest.approx(
        jtraces.max_drift_rate(want, 60.0), abs=1e-6)


def test_generators_draw_from_a_torch_generator():
    g = torch.Generator().manual_seed(3)
    for name in sorted(traces.SCENARIOS):
        t = traces.generate(name, g, 8, 40, device="cpu")
        assert tuple(t.shape) == (40, 8) and bool(torch.isfinite(t).all()), name
    rates = traces.drift_rates(t, 60.0)
    assert tuple(rates.shape) == (39, 8) and float(rates.max()) == traces.max_drift_rate(t, 60.0)
    with pytest.raises(ValueError, match="unknown scenario"):
        traces.generate("volcano", g, 8, 40, device="cpu")


def test_replay_history_bitwise(tiny):
    res, jres = tiny["res"], tiny["jres"]
    np.testing.assert_array_equal(res.timings.numpy().view(np.int32),
                                  np.asarray(jres.timings).view(np.int32))
    for k in ("bin_idx", "switched", "fused"):
        np.testing.assert_array_equal(getattr(res, k).numpy(), np.asarray(getattr(jres, k)),
                                      err_msg=k)
    for k, v in convert.state_to_numpy(res.state).items():
        np.testing.assert_array_equal(v, np.asarray(getattr(jres.state, k)), err_msg=k)
    assert res.total_switches == jres.total_switches > 0
    np.testing.assert_array_equal(res.switch_counts.numpy(), np.asarray(jres.switch_counts))
    assert int(res.state.fused.sum()) > 0 and int(res.bin_idx.max()) == len(BINS)
    back = convert.replay_to_numpy(convert.replay_from_numpy(
        *(np.asarray(getattr(jres, k)) for k in ("timings", "bin_idx", "switched", "fused")),
        tuple(np.asarray(x) for x in jres.state), device="cpu"))
    for k, v in convert.replay_to_numpy(res).items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_aldram_controller_matches_reference_and_replay(tiny):
    """The per-observation loop: bitwise the reference's wrapper and the
    port's replay on a sub-grid with errors; then the wrapper's own replay
    and streamed replay absorb the same registers and counters."""
    n, s = 8, 128
    stack = tiny["table"].stack[:n].contiguous()
    trace = tiny["trace"][:s, :n].numpy()
    errors = tiny["errors"][:s, :n].copy()
    errors[40, 3] = errors[90, 6] = True
    ctl = controller.ALDRAMController(controller.DimmTimingTable(BINS, stack))
    jctl = jcontroller.ALDRAMController(jcontroller.DimmTimingTable(BINS, stack.numpy()))
    rows = np.zeros((s, n, 2, 4), np.float32)
    for k in range(s):
        for d in range(n):
            if errors[k, d]:
                assert _sets(ctl.report_error(d)) == _sets(jctl.report_error(d))
            got, want = ctl.observe(d, float(trace[k, d])), jctl.observe(d, float(trace[k, d]))
            assert _sets(got) == _sets(want) and ctl.bin_of(d) == jctl.bin_of(d)
            rows[k, d] = (tuple(got.read), tuple(got.write))
    assert (ctl.switch_count, ctl.fallback_count) == (jctl.switch_count, jctl.fallback_count)
    for a, b in zip(ctl.state(), jctl.state()):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    res = controller.replay(controller.DimmTimingTable(BINS, stack), trace, errors)
    np.testing.assert_array_equal(res.timings.numpy(), rows)

    more = tiny["trace"][s:s + 64, :n].numpy()
    by_replay = controller.ALDRAMController(controller.DimmTimingTable(BINS, stack))
    by_stream = controller.ALDRAMController(controller.DimmTimingTable(BINS, stack))
    for c in (by_replay, by_stream):
        c.load_state(ctl.state())
    by_replay.replay(more)
    by_stream.replay_stream(more, chunk_steps=24)
    for a, b in zip(by_replay.state(), by_stream.state()):
        assert torch.equal(a, b)
    assert by_replay.switch_count == by_stream.switch_count
    for d, temp in ((0, 44.0), (3, 45.0), (5, 60.0), (7, 85.5)):
        assert _sets(tiny["table"].lookup(d, temp)) == _sets(tiny["jtable"].lookup(d, temp))
    assert _sets(tiny["table"].row(1, len(BINS))) == _sets(tiny["jtable"].row(1, len(BINS)))


def test_accumulate_plain_bitwise_vs_reference_and_interpret_kernel(tiny):
    """A ragged block (37 steps × 13 DIMMs) folded into nonzero partials."""
    jres = tiny["jres"]
    sl = (slice(100, 137), slice(0, 13))
    timings, bins, switched = (np.asarray(jres.timings)[sl], np.asarray(jres.bin_idx)[sl],
                               np.asarray(jres.switched)[sl])
    rng = np.random.default_rng(4)
    start = jperf.ScorePartials(
        rng.integers(0, 50, (13, len(BINS) + 1)).astype(np.int32),
        rng.integers(0, 50, (13,)).astype(np.int32),
        (rng.integers(0, 400, (13, 2, 4)) * 1.25).astype(np.float32), np.int32(7))
    want = jperf.trace_score_accumulate(start, timings, bins, switched)
    kernel = jreplay_ops.accumulate_chunk(start, timings, bins, switched, interpret=True)
    args = [torch.from_numpy(np.array(a)) for a in (*start[:3], timings, bins, switched)]
    got = replay_kernel.accumulate_plain(*args)
    for g, w, k in zip(got, want[:3], kernel[:3]):
        np.testing.assert_array_equal(g.numpy().view(np.int32), np.asarray(w).view(np.int32))
        np.testing.assert_array_equal(g.numpy().view(np.int32), np.asarray(k).view(np.int32))
    p = perfmodel.ScorePartials(*args[:3], torch.tensor(7, dtype=torch.int32))
    for got_p in (perfmodel.trace_score_accumulate(p, *args[3:]),
                  replay_ops.accumulate_chunk(p, *args[3:])):
        for g, w in zip(got_p, want):
            np.testing.assert_array_equal(np.asarray(g.numpy()).view(np.int32),
                                          np.asarray(w).view(np.int32))
    with pytest.raises(ValueError, match="CUDA tensor"):
        replay_kernel.accumulate_cuda(*args[:5], args[5].to(torch.uint8))


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_trace_score_with_refresh_matches_reference(tiny, policy):
    port, ref = POLICIES[policy]
    table = controller.DimmTimingTable(BINS, tiny["table"].stack, refresh=port)
    jtable = jcontroller.DimmTimingTable(BINS, tiny["jtable"].stack, refresh=ref)
    # The claim's cohort for both workload sets: one compiled reference
    # program per shape instead of two (the all-workload latency-only
    # figures are held to the reference in test_torch_serve_fleet.py).
    ws = jperf.MEM_INTENSIVE_WORKLOADS
    want = jperf.trace_score(jtable.stack, tiny["jres"], workloads=ws,
                             refresh=jtable.bin_refresh())
    got = perfmodel.trace_score(table.stack, tiny["res"], workloads=perfmodel.MEM_INTENSIVE_WORKLOADS,
                                refresh=table.bin_refresh())
    assert set(got) == set(want)
    assert ("speedup_combined_mean" in got) == (port is not None)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, abs=1e-5), k
    if port is not None:
        assert got["speedup_combined_intensive_mean"] < got["speedup_realized_intensive_mean"]


def _golden_run(scenario):
    """The reference's --tiny run (seed 0) on its own draws, through the
    port's trace_eval.run."""
    k_fleet, k_trace, _ = jax.random.split(jax.random.PRNGKey(0), 3)
    trace = traces.generate(scenario, None, N_DIMMS, N_STEPS, device="cpu",
                            draws=reference_draws(scenario, k_trace, N_DIMMS, N_STEPS))
    return trace_eval.run(n_dimms=N_DIMMS, n_steps=N_STEPS, scenario=scenario,
                          baseline_dimms=8, baseline_steps=128, verbose=False, device="cpu",
                          fleet_in=reference_fleet(k_fleet, N_DIMMS), trace=trace)


def test_tiny_golden_diurnal():
    base = json.loads((BASELINES / "trace_eval_tiny.json").read_text())
    score = _golden_run("diurnal")["score"]
    assert score["speedup_realized_intensive_mean"] >= (
        base["speedup_realized_intensive_mean"] - base["tolerance"])
    assert score["tras_below_jedec_coolest_frac"] == 1.0


def test_tiny_golden_refresh_storm():
    base = json.loads((BASELINES / "trace_eval_refresh_storm_tiny.json").read_text())
    score = _golden_run("refresh_storm")["score"]
    assert score["speedup_realized_intensive_mean"] >= (
        base["speedup_realized_intensive_mean"] - base["tolerance"])
    assert score["speedup_combined_intensive_mean"] >= (
        base["speedup_combined_intensive_mean"] - base["tolerance"])
    assert abs(score["refresh_occupancy_mean"] - base["refresh_occupancy_mean"]) <= (
        base["occupancy_tolerance"])


def test_trace_eval_cli_tiny_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["trace_eval", "--device", "cpu", "--tiny",
                                      "--error-rate", "0.002"])
    trace_eval.main()
    out = capsys.readouterr().out
    rows = dict(line.split(",")[:2] for line in out.splitlines() if line.startswith("trace/"))
    assert float(rows["trace/n_dimms"]) == 64 and float(rows["trace/n_steps"]) == 512
    assert float(rows["trace/loop_equivalence_exact"]) == 1.0
    assert float(rows["trace/fused_dimms"]) > 0
    assert all(np.isfinite(float(v)) for v in rows.values())
    assert 0.03328 <= float(rows["trace/refresh_occupancy_mean"]) < 0.0666


def test_trace_eval_unported_sections(capsys):
    """``sharded=True`` outside a process group raises (it never falls back
    to one device; the sharded section runs on ranks, tests/test_torch_shard.py);
    ``design_skew`` adds its region section by default (4 regions, near
    mix), with no note."""
    with pytest.raises(ValueError, match="torchrun"):
        trace_eval.run(sharded=True, device="cpu")
    rep = trace_eval.run(n_dimms=16, n_steps=48, scenario="design_skew", refresh="off",
                         baseline_dimms=4, baseline_steps=16, device="cpu")
    out = capsys.readouterr().out
    assert "not ported" not in out and "# regions (4): aware" in out
    assert "speedup_combined_mean" not in rep["score"] and rep["loop_exact"]
    assert tuple(rep["replay"].timings.shape) == (48, 16, 2, 4)
    rs = rep["region_score"]
    assert rep["region_table"].n_regions == 4 and rs["n_regions"] == 4.0
    assert rs["speedup_region_aware_intensive_mean"] > rs["speedup_region_oblivious_intensive_mean"]
    assert torch.equal(rep["region_table"].oblivious_stack(), rep["table"].stack)


def test_streaming_score_carries_the_tables_refresh(tiny):
    """The streaming engine scores with the table's refresh load, equal to
    the materialized score of the same history."""
    table = controller.DimmTimingTable(BINS, tiny["table"].stack, refresh=refresh.DDR3_EXTENDED)
    streamed = controller.replay_stream(table, tiny["trace"], torch.from_numpy(tiny["errors"]),
                                        chunk_steps=100)
    want = perfmodel.trace_score(table.stack, tiny["res"], refresh=table.bin_refresh())
    got = streamed.score()
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, abs=1e-6), k
    assert streamed.total_switches == tiny["res"].total_switches
    vendor = convert.fleet_to_numpy(tiny["fl"])["vendor"]
    np.testing.assert_array_equal(vendor, np.repeat(np.arange(3), fleet.vendor_split(N_DIMMS)))
