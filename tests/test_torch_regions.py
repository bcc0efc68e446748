"""The port's region axis vs the JAX reference, on the CPU.

Design-induced variation: a module's rows sit at different distances from
the sense amplifiers, region 0 nearest (fastest), region R−1 the anchor
(farthest, factor exactly 1.0, the region-free profile). Same numpy inputs
through both packages; the port gets the reference's seed-0 population and
its ``jax.random`` draws (``hot_bank``'s hot regions, the ``--tiny``
fleet and trace).

Tolerances: the charge model's region terms, grid minima, the region sweep's
stacks, rank-5 tables, v5 JSON, access mixes and region counts are exact;
region scores (a 60-step float32 bisection and float32 weighted means in a
different order) are held to 1e-5.
"""

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from repro.core import charge as jcharge
from repro.core import controller as jcontroller
from repro.core import fleet as jfleet
from repro.core import perfmodel as jperf
from repro.core import profiler as jprofiler
from repro.core import traces as jtraces
from repro_torch import convert
from repro_torch.core import charge, controller, fleet, perfmodel, profiler, stream, traces
from repro_torch.core.controller import DimmTimingTable
from repro_torch.launch import trace_eval
from test_torch_profiler import reference_population
from test_torch_trace_eval import (
    BASELINES,
    N_DIMMS,
    N_STEPS,
    _golden_run,
    reference_draws,
)

TEMPS = (45.0, 55.0, 85.0)
PATTERNS = (1.0, 1.03)
STREAM_STEPS = 96
SCORE_TOL = 1e-5


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


@pytest.fixture(scope="module")
def pop():
    return reference_population()


@pytest.fixture(scope="module")
def region_sweeps(pop):
    """``{R: (reference RegionSweepResult, port RegionSweepResult)}`` of the
    seed-0 population over TEMPS × PATTERNS, R in (1, 4)."""
    jcells, jvendor, cells, vendor = pop
    return {r: (jfleet.sweep_regions(jfleet.Fleet(jcells, jvendor), TEMPS, PATTERNS,
                                     n_regions=r, impl="ref"),
                fleet.sweep_regions(fleet.Fleet(cells, vendor), TEMPS, PATTERNS, n_regions=r))
            for r in (1, 4)}


# ---------------------------------------------------------------------------
# Charge model and profiler
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_regions", [1, 3, 4, 5])
def test_region_charge_model_matches_reference(pop, n_regions):
    jcells, _, cells, _ = pop
    fracs = charge.region_fracs(n_regions)
    np.testing.assert_array_equal(_np(fracs), np.asarray(jcharge.region_fracs(n_regions)))
    factors = charge.region_factor(fracs)
    np.testing.assert_array_equal(_np(factors), np.asarray(jcharge.region_factor(
        jcharge.region_fracs(n_regions), jcharge.DEFAULT_CONSTANTS)))
    assert float(charge.region_factor(1.0)) == 1.0 and float(fracs[-1]) == 1.0
    assert bool((factors.diff() > 0).all()) and bool((factors > 0).all())
    eff = charge.apply_region(cells, fracs[:, None])
    want = jcharge.apply_region(type(jcells)(*(a[None, :] for a in jcells)),
                                jcharge.region_fracs(n_regions)[:, None])
    for got_a, want_a in zip(eff, want):
        np.testing.assert_array_equal(_np(got_a.broadcast_to(eff.r.shape)),
                                      np.broadcast_to(np.asarray(want_a), eff.r.shape))
    # The anchor leaves r bitwise as it was.
    assert torch.equal(charge.apply_region(cells, 1.0).r, cells.r)


def test_region_span_is_validated():
    charge.ChargeModelConstants().validate()
    assert charge.DEFAULT_CONSTANTS.region_span == jcharge.DEFAULT_CONSTANTS.region_span
    for span in (-0.1, 1.0):
        with pytest.raises(ValueError, match="region_span"):
            charge.ChargeModelConstants(region_span=span).validate()


@pytest.mark.parametrize("mode", ["read", "write"])
def test_profiler_region_frac_matches_reference(pop, mode):
    """Both stack functions with ``region_frac`` over 4 regions × 115 DIMMs at
    45 and 85 °C: the same minima as the reference's search, exactly; the
    region axis is monotone and ``region_frac=None`` is the region-free
    stack."""
    jcells, _, cells, _ = pop
    temps = torch.tensor([45.0, 85.0])[:, None, None]
    port_fn, ref_fn = {"read": (profiler.individual_min_timings,
                                jprofiler.individual_min_timings),
                       "write": (profiler.write_mode_min_timings,
                                 jprofiler.write_mode_min_timings)}[mode]
    got = port_fn(charge.CellParams(*(a[None, None, :] for a in cells)), temps, 1.02,
                  region_frac=charge.region_fracs(4)[None, :, None])
    want = jax.jit(lambda c, f: ref_fn(c, jnp.asarray(_np(temps)), 1.02, impl="ref",
                                       region_frac=f))(
        type(jcells)(*(a[None, None, :] for a in jcells)),
        jcharge.region_fracs(4)[None, :, None])
    assert tuple(got.shape) == (2, 4, 115, 4)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    assert bool((got.diff(dim=1) >= 0).all())
    np.testing.assert_array_equal(_np(got[:, -1]), _np(port_fn(cells, temps[:, 0], 1.02)))


# ---------------------------------------------------------------------------
# Region sweep, rank-5 tables and JSON
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_regions", [1, 4])
def test_region_sweep_matches_reference(region_sweeps, pop, n_regions):
    want, got = region_sweeps[n_regions]
    assert got.n_regions == n_regions and got.bin_edges() == TEMPS
    assert tuple(got.read.shape) == (3, 2, n_regions, 115, 4)
    for name in ("read", "write", "region_fracs", "temps_c", "patterns"):
        np.testing.assert_array_equal(_np(getattr(got, name)), np.asarray(getattr(want, name)))
    # The anchor region is the region-free sweep, bitwise; the axis is monotone.
    _, _, cells, vendor = pop
    free = fleet.sweep(fleet.Fleet(cells, vendor), TEMPS, PATTERNS)
    assert torch.equal(got.read[:, :, -1], free.read)
    assert torch.equal(got.write[:, :, -1], free.write)
    assert bool((got.read.diff(dim=2) >= 0).all()) and bool((got.write.diff(dim=2) >= 0).all())
    untested = fleet.sweep_regions(charge.CellParams(*(a[:3] for a in cells)), TEMPS, PATTERNS,
                                   n_regions, write_tras="untested")
    with pytest.raises(ValueError, match="untested-tRAS"):
        untested.write_timings()
    with pytest.raises(ValueError, match="guarantee pattern"):
        got._replace(patterns=got.patterns + 0.5).read_timings()


def test_region_table_matches_reference(region_sweeps, pop):
    want_sweep, got_sweep = region_sweeps[4]
    want = jcontroller.DimmTimingTable.from_fleet(want_sweep)
    got = got_sweep.to_table()
    fed = convert.region_sweep_from_numpy(
        **convert.region_sweep_to_numpy(got_sweep), device="cpu").to_table()
    ref_fed = convert.region_sweep_from_numpy(
        *(np.asarray(getattr(want_sweep, k)) for k in
          ("temps_c", "patterns", "region_fracs", "read", "write")),
        temps_exact=want_sweep.temps_exact, device="cpu").to_table()
    assert got == fed == ref_fed and got.n_regions == want.n_regions == 4
    assert tuple(got.stack.shape) == (115, 3, 4, 2, 4)
    np.testing.assert_array_equal(_np(got.region_stack()), want.region_stack())
    np.testing.assert_array_equal(_np(got.oblivious_stack()), want.oblivious_stack())
    np.testing.assert_array_equal(_np(got.oblivious_stack()), _np(got.region_stack()[:, :, -1]))
    for dimm, b, region in ((0, 0, 0), (7, 1, 2), (114, 2, 3), (3, 2, None), (5, 3, 1)):
        g, w = got.row(dimm, b, region=region), want.row(dimm, b, region=region)
        assert (tuple(g.read), tuple(g.write)) == (tuple(w.read), tuple(w.write))
    with pytest.raises(IndexError, match="region"):
        got.row(0, 0, region=4)
    assert [[(tuple(a.read), tuple(a.write)) for a in d] for d in got.sets[:3]] == \
        [[(tuple(a.read), tuple(a.write)) for a in d] for d in want.sets[:3]]
    g, w = got.lookup(9, 50.0), want.lookup(9, 50.0)
    assert (tuple(g.read), tuple(g.write)) == (tuple(w.read), tuple(w.write))
    # Boot profiling over the same bins, and one region squeezed to rank 4.
    _, _, cells, _ = pop
    assert DimmTimingTable.profile(cells, TEMPS, n_regions=4) == got
    one = region_sweeps[1][1].to_table()
    assert one.stack.dim() == 4 and one.n_regions == 1
    assert one == DimmTimingTable.profile(cells, TEMPS) == DimmTimingTable(TEMPS, got.stack[:, :, -1])
    assert not got == one


def test_v5_region_json_crosses_both_ways(region_sweeps):
    got = region_sweeps[4][1].to_table()
    text = got.to_json()
    obj = json.loads(text)
    assert obj["schema_version"] == 5 and obj["n_regions"] == 4
    assert np.asarray(obj["stack"]).shape == (115, 3, 4, 2, 4)
    ref = jcontroller.DimmTimingTable.from_json(text)
    assert ref.n_regions == 4
    np.testing.assert_array_equal(ref.region_stack(), _np(got.region_stack()))
    assert ref.to_json() == text
    assert DimmTimingTable.from_json(ref.to_json(), device="cpu") == got
    with pytest.raises(ValueError, match="region axis"):
        DimmTimingTable.from_json(json.dumps(dict(obj, n_regions=3)), device="cpu")


# ---------------------------------------------------------------------------
# Access mixes and scoring
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_regions", [1, 3, 4, 5])
@pytest.mark.parametrize("profile", list(jtraces.REGION_MIX_PROFILES))
def test_region_access_mix_matches_reference(profile, n_regions):
    assert traces.REGION_MIX_PROFILES == jtraces.REGION_MIX_PROFILES
    key = jax.random.PRNGKey(3)
    hot = torch.from_numpy(np.array(jax.random.randint(key, (7,), 0, n_regions)))
    for total in (64, 57):
        want = np.asarray(jtraces.region_access_mix(key, 5, 7, n_regions, profile=profile,
                                                    accesses_per_step=total))
        got = traces.region_access_mix(None, 5, 7, n_regions, profile=profile,
                                       accesses_per_step=total, hot_region=hot, device="cpu")
        assert got.dtype == torch.int32 and got.stride(0) == 0
        np.testing.assert_array_equal(_np(got), want)
        assert bool((got.sum(dim=-1) == total).all())


def test_region_access_mix_draws_and_refusals():
    assert traces.SCENARIO_REGION_PROFILES == jtraces.SCENARIO_REGION_PROFILES
    g = torch.Generator().manual_seed(0)
    mix = traces.region_access_mix(g, 2, 9, 4, profile="hot_bank", device="cpu")
    assert bool((mix[0].amax(dim=-1) == 52).all())        # (0.75 + 0.25 / 4) · 64
    for kw, match in ((dict(n_regions=0), "n_regions"), (dict(accesses_per_step=0), "accesses"),
                      (dict(profile="skewed"), "profile")):
        args = dict(n_regions=4, profile="uniform") | kw
        with pytest.raises(ValueError, match=match):
            traces.region_access_mix(None, 2, 3, device="cpu", **args)


def test_region_counts_accumulate_is_exact(monkeypatch):
    rng = np.random.default_rng(5)
    counts = rng.integers(0, 100, (13, 6, 3)).astype(np.int32)
    bins = rng.integers(0, 6, (40, 13)).astype(np.int32)
    mix = rng.integers(0, 64, (40, 13, 3)).astype(np.int32)
    want = np.asarray(jperf.region_counts_accumulate(counts, bins, mix))
    args = [torch.from_numpy(a) for a in (counts, bins, mix)]
    got = perfmodel.region_counts_accumulate(*args)
    np.testing.assert_array_equal(_np(got), want)
    np.testing.assert_array_equal(_np(args[0]), counts)  # the input is not modified
    monkeypatch.setattr(perfmodel, "_REGION_ELEMS_PER_BLOCK", 3 * 13 * 7)   # 7-step blocks
    np.testing.assert_array_equal(_np(perfmodel.region_counts_accumulate(*args)), want)
    init = perfmodel.region_counts_init(13, 5, 3, device="cpu")
    assert init.dtype == torch.int32 and not init.any() and tuple(init.shape) == (13, 6, 3)
    with pytest.raises(ValueError, match="region_mix shape"):
        perfmodel.region_counts_accumulate(args[0], args[1], args[2][:, :, :2])


@pytest.fixture(scope="module")
def golden():
    """The reference's ``--tiny --scenario design_skew`` run (seed 0, 64 DIMMs
    × 512 steps, 4 regions, near mix) through the port's ``trace_eval.run``
    on the reference's draws."""
    return _golden_run("design_skew")


@pytest.fixture(scope="module")
def scored(golden):
    """The golden run's 4-region table, trace and replay (the scoring tests
    share the reference's compiled shapes with the golden check)."""
    return golden["region_table"], golden["trace"], golden["replay"]


@pytest.mark.parametrize("profile", list(jtraces.REGION_MIX_PROFILES))
def test_region_scores_match_reference(scored, profile):
    table, _, rep = scored
    key = jax.random.PRNGKey(7)
    jmix = jtraces.region_access_mix(key, N_STEPS, N_DIMMS, 4, profile=profile)
    hot = torch.from_numpy(np.array(jax.random.randint(key, (N_DIMMS,), 0, 4)))
    mix = traces.region_access_mix(None, N_STEPS, N_DIMMS, 4, profile=profile,
                                   hot_region=hot, device="cpu")
    jrep = types.SimpleNamespace(bin_idx=jnp.asarray(_np(rep.bin_idx)))
    want = jperf.region_trace_score(_np(table.region_stack()), jrep, jmix,
                                    workloads=jperf.MEM_INTENSIVE_WORKLOADS)
    got = perfmodel.region_trace_score(table.region_stack(), rep, mix,
                                       workloads=perfmodel.MEM_INTENSIVE_WORKLOADS)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, abs=SCORE_TOL), k
    assert got["region_accesses_total"] == N_DIMMS * N_STEPS * 64
    assert got["speedup_region_aware_mean"] >= got["speedup_region_oblivious_mean"]
    assert got["speedup_region_aware_intensive_mean"] >= \
        got["speedup_region_oblivious_intensive_mean"]
    with pytest.raises(ValueError, match="rank-5"):
        perfmodel.region_trace_score(table.oblivious_stack(), rep, mix)


@pytest.mark.parametrize("chunk_steps", [1, 17, 128])
def test_streamed_region_counts_equal_materialized(scored, chunk_steps):
    table, trace, _ = scored
    trace = trace[:STREAM_STEPS]
    rep = controller.replay(table, trace)
    mix = traces.region_access_mix(torch.Generator().manual_seed(1), STREAM_STEPS, N_DIMMS,
                                   4, profile="hot_bank", device="cpu")
    out = stream.replay_stream(table, trace, chunk_steps=chunk_steps, region_mix=mix)
    want = perfmodel.region_counts_accumulate(
        perfmodel.region_counts_init(N_DIMMS, table.n_bins, 4, device="cpu"),
        rep.bin_idx, mix)
    assert torch.equal(out.region_counts, want)
    free = stream.replay_stream(table, trace, chunk_steps=chunk_steps)
    assert free.region_counts is None
    for a, b in zip(out.partials, free.partials):
        assert torch.equal(a.view(torch.int32) if a.dtype == torch.float32 else a,
                           b.view(torch.int32) if b.dtype == torch.float32 else b)
    assert all(torch.equal(a, b) for a, b in zip(out.state, rep.state))
    assert out.region_score() == perfmodel.region_trace_score(table.region_stack(), rep, mix)
    with pytest.raises(ValueError, match="region mix"):
        free.region_score()


def test_stream_region_mix_refusals(scored):
    table, trace, _ = scored
    mix = traces.region_access_mix(None, N_STEPS, N_DIMMS, 4, device="cpu")
    with pytest.raises(ValueError, match="materialized"):
        stream.replay_stream(table, iter([(trace, None)]), region_mix=mix)
    with pytest.raises(ValueError, match="region_mix must be"):
        stream.replay_stream(table, trace, region_mix=mix[..., :3])
    with pytest.raises(ValueError, match="leading shape"):
        stream.replay_stream(table, trace[:10], region_mix=mix)


def test_region_sweep_threshold_rule(pop):
    """``chip_smoke.sweep_mismatches`` on region stacks, on the CPU: a sweep of
    capacitances scaled by 1 + 1e-5 stands in for the card; each entry it
    moves is reproduced at δ ≤ 1e-5 in its own region; a planted mismatch
    away from a threshold is refused."""
    _, _, cells, _ = pop
    big = charge.CellParams(*(a.repeat(8) * torch.linspace(0.999, 1.001, 920) for a in cells))
    host = fleet.sweep_regions(big, (45.0, 85.0), (1.0,), n_regions=3)
    moved = fleet.sweep_regions(charge.CellParams(big.r, big.c * (1.0 + 1e-5), big.leak),
                                (45.0, 85.0), (1.0,), n_regions=3)
    n_moved = int((moved.read != host.read).sum() + (moved.write != host.write).sum())
    got = chip_smoke.sweep_mismatches(moved, host, big, rtol=1e-5)
    assert n_moved > 0 and got["read"][0] + got["write"][0] == n_moved
    assert got["read"][1] == got["write"][1] == 0
    planted = host.write.clone()
    planted[1, 0, 0, 11, 3] += chip_smoke.TCK_NS
    got = chip_smoke.sweep_mismatches(host._replace(write=planted), host, big)
    assert got["write"][:2] == (0, 1) and "region 0" in got["write"][2][0]


# ---------------------------------------------------------------------------
# Trace-eval's region section and the committed golden
# ---------------------------------------------------------------------------
def test_tiny_golden_design_skew(golden):
    """The reference's ``--tiny --scenario design_skew`` run (seed 0, 4
    regions, near mix) through the port on the reference's draws: the
    committed region golden, aware strictly above oblivious, both within
    1e-5 of the reference's own region score of the same table, history
    and mix."""
    base = json.loads((BASELINES / "trace_eval_design_skew_tiny.json").read_text())
    rep = golden
    rs = rep["region_score"]
    aware = rs["speedup_region_aware_intensive_mean"]
    oblivious = rs["speedup_region_oblivious_intensive_mean"]
    assert aware >= base["speedup_region_aware_intensive_mean"] - base["tolerance"]
    assert aware > oblivious
    assert rep["score"]["speedup_realized_intensive_mean"] >= (
        base["speedup_realized_intensive_mean"] - base["tolerance"])
    rows = {name: value for name, value, _ in rep["rows"]}
    assert rows["trace/region_n_regions"] == 4 and rows["trace/region_mix_near"] == 1
    jmix = jtraces.region_access_mix(jax.random.fold_in(jax.random.PRNGKey(0), 4), N_STEPS,
                                     N_DIMMS, 4, profile="near")
    np.testing.assert_array_equal(_np(rep["region_mix"]), np.asarray(jmix))
    want = jperf.region_trace_score(
        _np(rep["region_table"].region_stack()),
        types.SimpleNamespace(bin_idx=jnp.asarray(_np(rep["replay"].bin_idx))), jmix,
        workloads=jperf.MEM_INTENSIVE_WORKLOADS)
    for k in ("speedup_region_aware_intensive_mean",
              "speedup_region_oblivious_intensive_mean"):
        assert rs[k] == pytest.approx(want[k], abs=SCORE_TOL), k


def test_trace_eval_hot_bank_regions_on_the_reference_draw():
    """``hot_bank`` takes 4 regions by default and its mix from the run's
    generator unless given; ``regions=0`` drops the section."""
    key = jax.random.PRNGKey(4)
    n, s = 16, 48
    trace = traces.generate("hot_bank", None, n, s, device="cpu",
                            draws=reference_draws("hot_bank", key, n, s))
    hot = torch.from_numpy(np.array(jax.random.randint(key, (n,), 0, 4)))
    mix = traces.region_access_mix(None, s, n, 4, profile="hot_bank", hot_region=hot,
                                   device="cpu")
    kw = dict(n_dimms=n, n_steps=s, scenario="hot_bank", baseline_dimms=4, baseline_steps=16,
              verbose=False, device="cpu", trace=trace)
    rep = trace_eval.run(region_mix=mix, **kw)
    rs = rep["region_score"]
    assert rep["region_mix"] is mix and rep["region_table"].n_regions == 4
    assert rs["speedup_region_aware_intensive_mean"] >= \
        rs["speedup_region_oblivious_intensive_mean"]
    drawn = trace_eval.run(**kw)
    assert drawn["region_mix"].shape == mix.shape
    assert trace_eval.run(regions=0, **kw)["region_score"] is None
    with pytest.raises(ValueError, match="fleet_in"):
        trace_eval.run(regions=2, table=rep["table"], **kw)
