"""PyTorch port vs JAX reference: timing tables from sweeps, sets and JSON,
altune's fleet ingestion, and the Fig. 3 speedup report, on the CPU.

The reference's seed-0 115-DIMM population (its uniform draws fed to both
packages) is swept once by each package at the table bins. Tables must be
bitwise equal; JSON written by either package must load in the other to an
equal stack for every schema version (v1–v5, region-free); altune's
margins (float32 means) are held to 1e-6; the speedup report, whose IPC
comes from a 60-step float32 bisection on each backend, to 1e-5;
``time_in_bin`` exactly and ``realized_latency_reductions`` (float32 means)
to 1e-6 on a replay.
"""

import json

import jax
import numpy as np
import pytest
import torch

from repro.core import controller as jcontroller
from repro.core import fleet as jfleet
from repro.core import perfmodel as jperfmodel
from repro.core import refresh as jrefresh
from repro.core import timing as jtiming
from repro.core.altune.table import TimingTable as JTimingTable
from repro_torch.core import controller, fleet, perfmodel, refresh, timing
from repro_torch.core.altune.table import TimingTable
from repro_torch.core.controller import DimmTimingTable
from test_torch_profiler import reference_population

BINS = (45.0, 55.0, 70.0, 85.0)


@pytest.fixture(scope="module")
def tables():
    """``(reference table, port table, reference sweep, port sweep,
    population)``: each package's sweep of the same cells at BINS (the
    reference's ``impl="ref"``) and the table it programs."""
    jcells, jvendor, cells, vendor = reference_population()
    jres = jfleet.sweep(jfleet.Fleet(jcells, jvendor), BINS, (1.0,), impl="ref")
    res = fleet.sweep(fleet.Fleet(cells, vendor), BINS, (1.0,))
    return jres.to_table(), res.to_table(), jres, res, (jcells, jvendor, cells, vendor)


def _stack(table) -> np.ndarray:
    s = table.stack
    return s.numpy() if isinstance(s, torch.Tensor) else np.asarray(s)


def _as_tuples(sets):
    return [[tuple(map(tuple, a)) for a in per_dimm] for per_dimm in sets]


# ---------------------------------------------------------------------------
# Construction
# ---------------------------------------------------------------------------
def test_profile_equals_the_sweeps_table(tables):
    want, table, _, _, (_, _, cells, _) = tables
    profiled = DimmTimingTable.profile(cells, BINS)
    assert profiled == table
    assert profiled.temp_bins == want.temp_bins == BINS
    np.testing.assert_array_equal(_stack(profiled), _stack(want))
    with_policy = DimmTimingTable.profile(cells, BINS, refresh=refresh.DDR3_EXTENDED)
    assert with_policy.refresh == refresh.DDR3_EXTENDED and with_policy != table
    assert table != DimmTimingTable(BINS, table.stack + 1.25)
    assert table != "not a table"


@pytest.mark.parametrize("layout", ["merged", "split"])
def test_from_sets_matches_reference(tables, layout):
    """v1 merged ``TimingParams`` entries go into both access slots, split
    ``AccessTimings`` keep their sets; the port takes either package's
    timing classes."""
    want_table = tables[0]
    stack = _stack(want_table)[:7]
    if layout == "merged":
        jsets = [[jtiming.TimingParams(*map(float, blk.max(axis=0))) for blk in d] for d in stack]
    else:
        jsets = [[jtiming.AccessTimings(jtiming.TimingParams(*map(float, blk[0])),
                                        jtiming.TimingParams(*map(float, blk[1])))
                  for blk in d] for d in stack]
    want = jcontroller.DimmTimingTable.from_sets(BINS, jsets)
    got = DimmTimingTable.from_sets(BINS, jsets, device="cpu")
    np.testing.assert_array_equal(_stack(got), _stack(want))
    tsets = [[timing.AccessTimings(timing.TimingParams(*e.read), timing.TimingParams(*e.write))
              if hasattr(e, "read") else timing.TimingParams(*e) for e in d] for d in jsets]
    assert DimmTimingTable.from_sets(BINS, tsets, device="cpu") == got


def test_sets_view(tables):
    want, table = tables[:2]
    assert _as_tuples(table.sets) == _as_tuples(want.sets)
    assert tuple(map(tuple, table.sets[3][1])) == tuple(map(tuple, table.row(3, 1)))


# ---------------------------------------------------------------------------
# JSON persistence, both ways
# ---------------------------------------------------------------------------
def _legacy_json(table, version: int) -> str:
    """The reference's table written in schema ``version`` (v1–v4 layouts as
    the reference's own tests write them; v5 by its ``to_json``)."""
    stack = _stack(table)
    if version == 5:
        return table.to_json()
    if version == 1:
        return json.dumps({"temp_bins": list(table.temp_bins), "sets": [
            [dict(zip(timing.PARAM_NAMES, map(float, row))) for row in per_dimm]
            for per_dimm in stack.max(axis=2)]})
    obj = {"schema_version": version, "params": list(timing.PARAM_NAMES),
           "temp_bins": list(table.temp_bins)}
    if version == 2:
        return json.dumps(dict(obj, stack=stack.max(axis=2).tolist()))
    obj.update(access_types=list(timing.ACCESS_TYPES), stack=stack.tolist())
    if version == 4:
        r = table.refresh
        obj["refresh"] = None if r is None else {
            "boundaries": list(r.boundaries), "multipliers": list(r.multipliers),
            "trefi_base_ns": r.trefi_base_ns, "trfc_ns": r.trfc_ns}
    return json.dumps(obj)


@pytest.mark.parametrize("version", [1, 2, 3, 4, 5])
def test_reference_json_loads_in_the_port(tables, version):
    want = tables[0]
    if version >= 4:
        want = jcontroller.DimmTimingTable(want.temp_bins, want.stack,
                                           refresh=jrefresh.DDR3_EXTENDED_4X)
    text = _legacy_json(want, version)
    ref = jcontroller.DimmTimingTable.from_json(text)
    got = DimmTimingTable.from_json(text, device="cpu")
    np.testing.assert_array_equal(_stack(got), _stack(ref))
    assert got.temp_bins == ref.temp_bins
    if ref.refresh is None:
        assert got.refresh is None
    else:
        assert got.refresh == refresh.DDR3_EXTENDED_4X


@pytest.mark.parametrize("policy", [None, "ddr3"])
def test_port_json_loads_in_the_reference(tables, policy):
    table = tables[1]
    if policy:
        table = DimmTimingTable(table.temp_bins, table.stack, refresh=refresh.DDR3_EXTENDED)
    text = table.to_json()
    obj = json.loads(text)
    assert obj["schema_version"] == controller.TABLE_SCHEMA_VERSION == 5
    assert obj["n_regions"] == 1 and np.asarray(obj["stack"]).shape == (115, 4, 1, 2, 4)
    ref = jcontroller.DimmTimingTable.from_json(text)
    np.testing.assert_array_equal(_stack(ref), _stack(table))
    assert (ref.refresh == jrefresh.DDR3_EXTENDED) if policy else ref.refresh is None
    assert DimmTimingTable.from_json(text, device="cpu") == table
    assert text == jcontroller.DimmTimingTable(
        table.temp_bins, _stack(table),
        refresh=jrefresh.DDR3_EXTENDED if policy else None).to_json()


def test_json_refusals(tables):
    obj = json.loads(tables[1].to_json())
    two = dict(obj, n_regions=2, stack=np.repeat(np.asarray(obj["stack"]), 2, axis=2).tolist())
    loaded = DimmTimingTable.from_json(json.dumps(two), device="cpu")
    assert loaded.n_regions == 2 and tuple(loaded.stack.shape) == (115, 4, 2, 2, 4)
    assert torch.equal(loaded.oblivious_stack(), tables[1].stack)
    assert DimmTimingTable.from_json(loaded.to_json(), device="cpu") == loaded
    assert json.loads(loaded.to_json())["stack"] == two["stack"]
    with pytest.raises(ValueError, match="region axis"):
        DimmTimingTable.from_json(json.dumps(dict(obj, n_regions=2)), device="cpu")
    for bad, match in ((dict(obj, schema_version=99), "schema_version"),
                       (dict(obj, params=["tras", "trcd", "twr", "trp"]), "parameter order"),
                       (dict(obj, access_types=["write", "read"]), "access-type order")):
        with pytest.raises(ValueError, match=match):
            DimmTimingTable.from_json(json.dumps(bad), device="cpu")


# ---------------------------------------------------------------------------
# altune's fleet ingestion
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("with_vendor", [False, True])
def test_altune_from_fleet_matches_reference(tables, with_vendor):
    _, _, jres, res, (_, jvendor, _, vendor) = tables
    want = JTimingTable.from_fleet(jres, vendor=jvendor if with_vendor else None)
    got = TimingTable.from_fleet(res, vendor=vendor if with_vendor else None)
    assert list(got.entries) == list(want.entries)
    assert len(got.entries) == 115 * len(BINS) * 2
    for key, w in want.entries.items():
        g = got.entries[key]
        assert g["config"] == w["config"] and g["config_type"] == w["config_type"]
        assert g["margin"] == pytest.approx(w["margin"], abs=1e-6), key
    assert got.get("dram_timing", "dimm00007",
                   f"vendor{int(vendor[7]) if with_vendor else 0}", "T55:write") is not None


# ---------------------------------------------------------------------------
# The Fig. 3 report and the replay aggregates
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cfg", ["SINGLE_CORE", "MULTI_CORE"])
def test_speedup_report_matches_reference(cfg):
    want = jperfmodel.speedup_report(getattr(jperfmodel, cfg))
    got = perfmodel.speedup_report(getattr(perfmodel, cfg), device="cpu")
    assert got.keys() == want.keys()
    for k in got:
        assert got[k] == pytest.approx(want[k], abs=1e-5), k
    wl = jperfmodel.per_workload_speedups(getattr(jperfmodel, cfg))
    gl = perfmodel.per_workload_speedups(getattr(perfmodel, cfg), device="cpu")
    assert [n for n, _ in gl] == [n for n, _ in wl]
    np.testing.assert_allclose([v for _, v in gl], [v for _, v in wl], rtol=0, atol=1e-5)
    assert perfmodel.DEPLOYED_REDUCTIONS_55C == jperfmodel.DEPLOYED_REDUCTIONS_55C
    if cfg == "MULTI_CORE":   # the paper's +14 % memory-intensive claim
        assert abs(got["intensive_geomean"] - perfmodel.PAPER_CLAIM_SPEEDUP) < 0.01


def test_time_in_bin_and_realized_reductions_on_a_replay(tables):
    table = tables[1]
    n = 32
    small = DimmTimingTable(table.temp_bins, table.stack[:n])
    temps = torch.from_numpy(np.random.default_rng(3).uniform(20.0, 95.0, (64, n))
                             .astype(np.float32))
    rep = controller.replay(small, temps)
    bin_idx, rows = rep.bin_idx.numpy(), rep.timings.numpy()
    got = perfmodel.time_in_bin(rep.bin_idx, small.n_bins)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jperfmodel.time_in_bin(
        jax.numpy.asarray(bin_idx), small.n_bins)))
    assert got.sum(dim=1).sub(1.0).abs().max() < 1e-6 and (got[:, -1] > 0).any()
    for stack in (rows, rows.max(axis=2)):          # split, then legacy merged
        want = jperfmodel.realized_latency_reductions(stack)
        g = perfmodel.realized_latency_reductions(torch.from_numpy(stack))
        assert g.keys() == want.keys()
        for k in g:
            np.testing.assert_allclose(g[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-6,
                                       err_msg=k)
    with pytest.raises(ValueError, match="expected"):
        perfmodel.realized_latency_reductions(torch.zeros(4, 3, 3, 4))
