"""PyTorch port vs JAX reference: the profiler, the sweep's views and the
paper's 55 °C reductions, on the CPU.

Both packages get the reference's seed-0 115-DIMM population (its uniform
draws fed to ``dimm.population_from_uniforms``, since torch cannot
reproduce threefry bits). The reference runs its pure-jnp search
(``impl="ref"``), each expensive call once in a module fixture.

Tolerances: grid minima, the read and write stacks and the latency sums
are exact; the joint stack is exact except where an entry differs by one
tCK and the reference's raw minimum sits within 1e-5 relative of a cycle
boundary (``exp``/``log`` differ by an ulp between torch and XLA; on this
population no entry flips, so none may); means (``summary``,
``fig2_summary``, reductions) are float32 reductions in a different order
and are held to 1e-6; the closed-form minima to rtol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from repro.core import charge as jcharge
from repro.core import dimm as jdimm
from repro.core import fleet as jfleet
from repro.core import profiler as jprofiler
from repro.core import timing as jtiming
from repro_torch import convert
from repro_torch.core import charge, controller, dimm, fleet, profiler, timing
from repro_torch.core.controller import DimmTimingTable

TEMPS = (45.0, 55.0, 85.0)
PATTERNS = (1.0, 1.03)
#: Paper §1.5 at 55 °C and its window (``tests/test_fleet.py``).
PAPER_55C = {"trcd": 0.173, "tras": 0.377, "twr": 0.548, "trp": 0.352}
PAPER_TOL = 0.025
N_TRIALS = 10


def reference_population():
    """The reference's seed-0 population: ``(jax cells, jax vendor, torch
    cells, torch vendor)`` from the same uniform draws."""
    key = jax.random.PRNGKey(0)
    jcells, jvendor = jdimm.sample_population(key)
    uniforms, k = [], key
    for n_v in jdimm.VENDOR_SPLIT:
        k, kr, kc, kl = jax.random.split(k, 4)
        uniforms.append(tuple(torch.tensor(np.asarray(jax.random.uniform(kk, (n_v,))))
                              for kk in (kr, kc, kl)))
    cells, vendor = dimm.population_from_uniforms(uniforms)
    return jcells, jvendor, cells, vendor


@pytest.fixture(scope="module")
def pop():
    return reference_population()


@pytest.fixture(scope="module")
def sweeps(pop):
    """``(reference sweep, port sweep)`` over TEMPS × PATTERNS."""
    jcells, jvendor, cells, vendor = pop
    want = jfleet.sweep(jfleet.Fleet(jcells, jvendor), TEMPS, PATTERNS, impl="ref")
    got = fleet.sweep(fleet.Fleet(cells, vendor), TEMPS, PATTERNS)
    return want, got


def _seeded_cells(n: int = 256, seed: int = 7):
    """Cells over the process-corner box plus the exact JEDEC corner last."""
    rng = np.random.default_rng(seed)
    c = jcharge.DEFAULT_CONSTANTS
    cols = [rng.uniform(1.0, c.r_max, n), rng.uniform(c.c_min, 1.0, n),
            rng.uniform(0.4, 1.0, n)]
    corner = (c.r_max, c.c_min, 1.0)
    return tuple(np.append(a, v).astype(np.float32) for a, v in zip(cols, corner))


def _jax_joint_raw(cells, temp_c, restore_scale=1.0):
    """The reference's joint minima before rounding, from its own closed
    forms (``src/repro/core/profiler.py:225-245``)."""
    c = jcharge.DEFAULT_CONSTANTS
    v_min = jcharge.restore_target(cells, temp_c)
    v = jnp.clip(v_min * restore_scale, v_min, c.v_full)
    cols = (jcharge.min_trcd(cells, temp_c, v_restored=v),
            jcharge.min_tras(cells, temp_c, v_tgt=v), jcharge.min_twr(cells, temp_c, v_tgt=v),
            jcharge.min_trp(cells, temp_c))
    return np.stack([np.broadcast_to(np.asarray(x), cells.r.shape) for x in cols], axis=-1)


# ---------------------------------------------------------------------------
# Timing, charge and population pieces
# ---------------------------------------------------------------------------
def test_timing_params_methods_match_reference():
    t = timing.TimingParams(12.3, 30.1, 14.9, 11.0)
    w = jtiming.TimingParams(12.3, 30.1, 14.9, 11.0)
    red = {"trcd": 0.27, "twr": 0.33}
    assert t.trc == w.trc
    assert tuple(t.scaled(t)) == tuple(w.scaled(w))
    assert tuple(t.reduced(red)) == tuple(w.reduced(red))
    assert tuple(t.quantize()) == tuple(w.quantize())
    assert t.cycles() == w.cycles()
    assert t.reduction_vs(timing.JEDEC_DDR3_1600) == w.reduction_vs(jtiming.JEDEC_DDR3_1600)
    t.validate()
    for bad in (timing.TimingParams(0.0, 1.0, 1.0, 1.0),
                timing.TimingParams(1.0, float("nan"), 1.0, 1.0)):
        with pytest.raises(ValueError, match="positive and finite"):
            bad.validate()
    a = timing.AccessTimings.merged(t)
    assert a.by_type("read") is t and a.by_type("write") is t
    with pytest.raises(KeyError):
        a.by_type("refresh")
    assert tuple(map(tuple, timing.JEDEC_ACCESS)) == tuple(map(tuple, jtiming.JEDEC_ACCESS))
    assert controller.JEDEC_ACCESS is timing.JEDEC_ACCESS


CLOSED_FORMS = ("min_trcd", "min_tras", "min_twr", "min_trp", "min_tras_write",
                "restore_time", "write_time", "restore_under_write_time")


@pytest.mark.parametrize("name", CLOSED_FORMS)
def test_charge_closed_forms_match_reference(name):
    """Each closed-form minimum within rtol 1e-6 of the reference's over
    seeded cells and the JEDEC corner at 45/55/85/95 °C; the corner needs
    JEDEC itself at 85 °C in the read-mode minima."""
    cells_np = _seeded_cells()
    jcells = jcharge.CellParams(*(jnp.asarray(a) for a in cells_np))
    cells = convert.cells_from_numpy(*cells_np, device="cpu")
    jv = jcharge.restore_target(jcells, 55.0)
    v = charge.restore_target(cells, 55.0)
    for temp in (45.0, 55.0, 85.0, 95.0):
        if name in ("restore_time",):
            want, got = getattr(jcharge, name)(jcells, jv), getattr(charge, name)(cells, v)
        elif name in ("write_time", "restore_under_write_time"):
            want = getattr(jcharge, name)(jcells, jv, temp)
            got = getattr(charge, name)(cells, v, temp)
        else:
            want, got = getattr(jcharge, name)(jcells, temp), getattr(charge, name)(cells, temp)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0,
                                   err_msg=f"{name} at {temp} °C")
    base = timing.JEDEC_DDR3_1600
    jedec = {"min_trcd": base.trcd, "min_tras": base.tras, "min_twr": base.twr,
             "min_trp": base.trp}
    if name in jedec:
        corner = float(getattr(charge, name)(cells, 85.0)[-1])
        assert corner == pytest.approx(jedec[name], rel=1e-5)


def test_constants_validate():
    charge.DEFAULT_CONSTANTS.validate()
    jcharge.DEFAULT_CONSTANTS.validate()
    bad = dict(v_restore_start=0.99)  # above v_full: no restore phase
    with pytest.raises(ValueError, match="v_restore_start < v_full"):
        charge.ChargeModelConstants(**bad).validate()
    with pytest.raises(AssertionError):
        jcharge.ChargeModelConstants(**bad).validate()


def test_worst_case_cell_and_population_summary(pop):
    jcells, _, cells, _ = pop
    assert dimm.N_CHIPS == jdimm.N_CHIPS
    got = dimm.worst_case_cell(device="cpu")
    want = jdimm.worst_case_cell()
    assert [float(a) for a in got] == [float(b) for b in want]
    g, w = dimm.population_summary(cells), jdimm.population_summary(jcells)
    assert g.keys() == w.keys() and g["n"] == w["n"] == 115
    for k in g:
        assert g[k] == pytest.approx(w[k], rel=1e-6, abs=1e-7), k


# ---------------------------------------------------------------------------
# The three stacks
# ---------------------------------------------------------------------------
POINTS = ((55.0, 1.0), (85.0, 1.03))


@pytest.fixture(scope="module")
def jax_minima(pop):
    """The reference's full-model searches (``impl="ref"``) at POINTS, and
    its write test with tRAS untested at 55 °C, in one jitted call."""
    jcells = pop[0]

    def run(cells):
        out = {}
        for t, p in POINTS:
            out[f"individual {t} {p}"] = jprofiler.individual_min_timings(cells, t, p, impl="ref")
            out[f"write_mode {t} {p}"] = jprofiler.write_mode_min_timings(cells, t, p, impl="ref")
        out["untested"] = jprofiler.write_mode_min_timings(cells, 55.0, tras_mode="untested",
                                                           impl="ref")
        return out

    return {k: np.asarray(v) for k, v in jax.jit(run)(jcells).items()}


@pytest.mark.parametrize("temp,pattern", POINTS)
def test_individual_and_write_mode_exact(pop, jax_minima, temp, pattern):
    """The fused search's minima equal the reference's full-model search."""
    cells = pop[2]
    np.testing.assert_array_equal(profiler.individual_min_timings(cells, temp, pattern).numpy(),
                                  jax_minima[f"individual {temp} {pattern}"])
    np.testing.assert_array_equal(profiler.write_mode_min_timings(cells, temp, pattern).numpy(),
                                  jax_minima[f"write_mode {temp} {pattern}"])


def test_untested_sentinel_and_its_refusal(pop, jax_minima):
    cells = pop[2]
    got = profiler.write_mode_min_timings(cells, 55.0, tras_mode="untested")
    np.testing.assert_array_equal(got.numpy(), jax_minima["untested"])
    assert (got[:, 1] == profiler.WRITE_TRAS_UNTESTED_NS).all()
    assert profiler.WRITE_TRAS_UNTESTED_NS == jprofiler.WRITE_TRAS_UNTESTED_NS
    assert profiler.WRITE_TRAS_MODES == jprofiler.WRITE_TRAS_MODES
    with pytest.raises(ValueError, match="tras_mode must be one of"):
        profiler.write_mode_min_timings(cells, 55.0, tras_mode="assumed")
    sub = fleet.from_population(charge.CellParams(*(a[:6] for a in cells)))
    res = fleet.sweep(sub, (55.0,), (1.0,), write_tras="untested")
    assert (res.write[..., 1] == -1.0).all() and res.read.shape == (1, 1, 6, 4)
    with pytest.raises(ValueError, match=r"untested-tRAS sentinel \(-1\.0 ns\)"):
        res.write_timings()
    with pytest.raises(ValueError, match="untested-tRAS sentinel"):
        res.to_table()
    with pytest.raises(ValueError, match="write_tras must be one of"):
        fleet.sweep(sub, (55.0,), (1.0,), write_tras="assumed")


def test_regions_are_refused_naming_item_1(pop):
    """Regions (item 1) are ported: ``region_frac`` is the same search on the
    cells with ``r`` scaled by the region's factor, and ``profile`` with two
    regions gives a rank-5 table whose max-over-regions registers are the
    region-free profile (tests/test_torch_regions.py holds them against the
    reference)."""
    _, _, cells, _ = pop
    scaled = charge.CellParams(cells.r * charge.region_factor(0.5), cells.c, cells.leak)
    for fn in (profiler.individual_min_timings, profiler.write_mode_min_timings):
        assert torch.equal(fn(cells, 55.0, region_frac=0.5), fn(scaled, 55.0))
    two = DimmTimingTable.profile(cells, (55.0,), n_regions=2)
    assert two.n_regions == 2 and tuple(two.stack.shape) == (115, 1, 2, 2, 4)
    assert torch.equal(two.oblivious_stack(), DimmTimingTable.profile(cells, (55.0,)).stack)


def test_joint_on_the_paper_population(sweeps, pop):
    """The sweep's joint stack against the reference's under the one-tCK
    boundary rule, with no flip on this population; the stack is the same
    for every pattern."""
    want, got = sweeps
    jcells, _, cells, _ = pop
    raw = np.stack([_jax_joint_raw(jcells, t) for t in TEMPS])[:, None]
    n_flip, n_bad = chip_smoke.joint_mismatches(
        got.joint.numpy(), np.asarray(want.joint), np.broadcast_to(raw, got.joint.shape))
    print(f"joint entries one tCK apart at a cycle boundary: {n_flip}")
    assert (n_flip, n_bad) == (0, 0)
    assert torch.equal(got.joint[:, 0], got.joint[:, 1])
    np.testing.assert_allclose(profiler.joint_raw_timings(cells, 55.0).numpy(),
                               raw[1, 0], rtol=1e-6)


@pytest.mark.parametrize("scale", [1.0, 1.02])
def test_profile_joint_under_the_boundary_rule(scale):
    """``joint_min_timings`` on seeded cells and the JEDEC corner: entries
    equal the reference's or sit one tCK apart at a cycle boundary."""
    cells_np = _seeded_cells()
    jcells = jcharge.CellParams(*(jnp.asarray(a) for a in cells_np))
    cells = convert.cells_from_numpy(*cells_np, device="cpu")
    for temp in (45.0, 85.0):
        want = np.asarray(jprofiler.joint_min_timings(jcells, temp, scale))
        got = profiler.joint_min_timings(cells, temp, scale).numpy()
        n_flip, n_bad = chip_smoke.joint_mismatches(got, want,
                                                    _jax_joint_raw(jcells, temp, scale))
        print(f"joint at {temp} °C, restore scale {scale}: {n_flip} boundary flips")
        assert n_bad == 0
        prof = profiler.profile_joint(cells, temp, restore_scale=scale)
        np.testing.assert_array_equal(prof.timings["tras"].numpy(), got[:, 1])


def test_stack_reductions_and_latency_sums(sweeps, pop):
    want, got = sweeps
    for name in ("read", "write", "joint"):
        np.testing.assert_allclose(getattr(got, f"{name}_reductions").numpy(),
                                   np.asarray(getattr(want, f"{name}_reductions")),
                                   rtol=0, atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(profiler.stack_reductions(got.read).numpy(),
                                  got.read_reductions.numpy())
    # The reference's 55 °C profiles, from its sweep's guarantee pattern.
    window = jcharge.REFRESH_WINDOW_S
    jr = jprofiler._result(want.read[1, 0], 55.0, window)
    jw = jprofiler._result(want.write[1, 0], 55.0, window)
    cells = pop[2]
    r, w = profiler.profile_individual(cells, 55.0), profiler.profile_write_mode(cells, 55.0)
    for k, v in profiler.latency_sums(r, w).items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jprofiler.latency_sums(jr, jw)[k]))
    for got_d, want_d in ((r.mean_reductions(), jr.mean_reductions()),
                          (w.mean_reductions(), jw.mean_reductions())):
        for k in got_d:
            assert got_d[k] == pytest.approx(want_d[k], abs=1e-6), k
    assert r.min_max_reductions() == pytest.approx(jr.min_max_reductions(), abs=1e-7)


def test_fig2_summary_matches_reference(pop):
    jcells, _, cells, _ = pop
    want = jprofiler.fig2_summary(jcells, 55.0)
    got = profiler.fig2_summary(cells, 55.0)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k] == pytest.approx(want[k], abs=1e-6), k


def test_repeatability_on_the_reference_draws(pop):
    """Fed the reference's own noise draws, the port's verdicts are the
    reference's: the repeat fraction (a ratio of two counts) is equal, the
    ever-fail fraction (a float32 mean) within 1e-6; paper: > 95 % repeat."""
    jcells, _, cells, _ = pop
    key = jax.random.PRNGKey(1)
    want = jprofiler.repeatability(key, jcells, 55.0, n_trials=N_TRIALS)
    normals = np.stack([np.asarray(jax.random.normal(k, jcells.c.shape))
                        for k in jax.random.split(key, N_TRIALS)])
    got = profiler.repeatability_from_normals(torch.from_numpy(normals), cells, 55.0)
    assert got.keys() == want.keys()
    assert got["repeat_fraction"] == want["repeat_fraction"]
    assert got["n_trials"] == want["n_trials"] == N_TRIALS
    assert got["ever_fail_fraction"] == pytest.approx(want["ever_fail_fraction"], abs=1e-6)
    assert got["repeat_fraction"] > 0.95
    drawn = profiler.repeatability(torch.Generator().manual_seed(0), cells, 55.0)
    assert drawn["n_trials"] == N_TRIALS and 0.0 < drawn["repeat_fraction"] <= 1.0


# ---------------------------------------------------------------------------
# The sweep's views
# ---------------------------------------------------------------------------
def test_sweep_stacks_and_views(sweeps):
    want, got = sweeps
    np.testing.assert_array_equal(got.read.numpy(), np.asarray(want.read))
    np.testing.assert_array_equal(got.write.numpy(), np.asarray(want.write))
    assert got.joint.shape == got.read.shape == (3, 2, 115, 4)
    assert got.worst_pattern_idx() == want.worst_pattern_idx() == 0
    np.testing.assert_array_equal(got.stacked_timings().numpy(),
                                  np.asarray(want.stacked_timings()))
    gs, ws = got.summary(), want.summary()
    assert list(gs) == list(ws) == list(TEMPS)
    for t in TEMPS:
        for p in timing.PARAM_NAMES:
            np.testing.assert_allclose(gs[t][p], ws[t][p], rtol=0, atol=1e-6,
                                       err_msg=f"{p} at {t} °C")


def test_summary_55c_gate(sweeps):
    """The paper's first claim: the 55 °C means within 1e-6 of the
    reference's computed values and inside the paper's window."""
    want, got = sweeps
    gs, ws = got.summary()[55.0], want.summary()[55.0]
    for p, paper in PAPER_55C.items():
        assert gs[p][1] == pytest.approx(ws[p][1], abs=1e-6), p
        assert abs(gs[p][1] - paper) <= PAPER_TOL, (p, gs[p][1], paper)


def test_guarantee_pattern_refusal(pop):
    _, _, cells, _ = pop
    benign = fleet.sweep(charge.CellParams(*(a[:5] for a in cells)), (55.0,), (1.03, 1.08))
    assert benign.worst_pattern_idx() == 0
    for view in (benign.read_timings, benign.write_timings, benign.stacked_timings):
        with pytest.raises(ValueError, match="guarantee pattern"):
            view()


def test_sweep_loop_baseline_equals_sweep(pop):
    _, _, cells, vendor = pop
    sub = fleet.Fleet(cells, vendor).take(slice(0, 6))
    temps, patterns = (45.0, 85.0), (1.0, 1.03)
    fused = fleet.sweep(sub, temps, patterns)
    loop = fleet.sweep_loop_baseline(sub, temps, patterns)
    for name in ("read", "write", "joint"):
        assert torch.equal(getattr(loop, name), getattr(fused, name)), name
    assert loop.temps_exact == fused.temps_exact


def test_fleet_take_and_from_population(pop):
    jcells, jvendor, cells, vendor = pop
    jfl, fl = jfleet.Fleet(jcells, jvendor), fleet.Fleet(cells, vendor)
    idx = np.array([3, 0, 114, 57])
    for j_sel, sel in ((slice(10, 20), slice(10, 20)), (jnp.asarray(idx), torch.from_numpy(idx))):
        want, got = jfl.take(j_sel), fl.take(sel)
        assert got.n_dimms == want.n_dimms
        for a, b in zip(got.cells, want.cells):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(got.vendor.numpy(), np.asarray(want.vendor))
    wrapped = fleet.from_population(cells)
    assert wrapped.vendor.dtype == torch.int32 and not wrapped.vendor.any()
    assert fleet.from_population(cells, vendor).vendor is vendor


def test_sweep_threshold_rule(pop):
    """The card-vs-CPU rule of ``chip_smoke.sweep_mismatches`` on the CPU: a
    sweep of capacitances scaled by 1 + 1e-5 stands in for the card; each
    entry it moves is one grid step and is reproduced at δ ≤ 1e-5, and
    planted mismatches away from a threshold are refused."""
    _, _, cells, _ = pop
    big = charge.CellParams(*(a.repeat(40) * torch.linspace(0.999, 1.001, 4600) for a in cells))
    host = fleet.sweep(big, (45.0, 85.0), (1.0,))
    moved = fleet.sweep(charge.CellParams(big.r, big.c * (1.0 + 1e-5), big.leak),
                        (45.0, 85.0), (1.0,))
    n_moved = int((moved.read != host.read).sum() + (moved.write != host.write).sum())
    got = chip_smoke.sweep_mismatches(moved, host, big, rtol=1e-5)
    assert n_moved > 0 and got["read"][0] + got["write"][0] == n_moved
    assert got["read"][1] == got["write"][1] == 0
    planted = host.read.clone()
    planted[0, 0, 7, 0] += 2 * chip_smoke.TCK_NS       # two grid steps
    planted[1, 0, 9, 2] += chip_smoke.TCK_NS           # one step, no threshold near
    fake = host._replace(read=planted)
    got = chip_smoke.sweep_mismatches(fake, host, big)
    assert got["read"][:2] == (0, 2) and got["write"][:2] == (0, 0)
    assert len(got["read"][2]) == 2 and "δ = None" in got["read"][2][0]
