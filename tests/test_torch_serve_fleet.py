"""The port's slice as a whole vs the JAX reference, on the CPU.

The ``benchmarks/trace_eval.py --tiny`` configuration — 64 DIMMs × 512
steps, ``controller.DEFAULT_TEMP_BINS``, the reference's seed-0 fleet and
diurnal trace — goes, as numpy, through both the reference
``repro.core.stream.StreamingController`` and the port's
``FleetControllerService`` (which profiles its own table from the same
cells). The table must be bitwise equal, the partials bitwise equal, and
every score figure within atol 1e-5 (the 60-step float32 bisection may
differ in its last step between backends). The realized memory-intensive
speedup is also held to the committed ``trace_eval_tiny.json`` gate.
"""

import json
import os
import pathlib
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

from repro.core import controller as jcontroller
from repro.core import fleet as jfleet
from repro.core import stream as jstream
from repro.core import traces as jtraces
from repro_torch import convert
from repro_torch.core import controller, fleet, perfmodel, stream, traces
from repro_torch.launch import serve_fleet

BASELINE = (pathlib.Path(__file__).resolve().parents[1]
            / "benchmarks" / "baselines" / "trace_eval_tiny.json")
N_DIMMS, N_STEPS, CHUNK = 64, 512, 128
ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def tiny():
    """The --tiny configuration through both packages."""
    k_fleet, k_trace, _ = jax.random.split(jax.random.PRNGKey(0), 3)
    jfl = jfleet.synthesize(k_fleet, N_DIMMS)
    # A second, benign pattern exercises the pattern axis; the table takes
    # the guarantee pattern (1.0) and is the --tiny table.
    jsweep = jfleet.sweep(jfl, jcontroller.DEFAULT_TEMP_BINS, (1.0, 1.03), impl="ref")
    jtable = jsweep.to_table()
    trace = np.asarray(jtraces.generate("diurnal", k_trace, N_DIMMS, N_STEPS))
    jengine = jstream.StreamingController(jtable)
    for t, e in jstream.iter_chunks(trace, None, CHUNK):
        jengine.ingest(t, e)

    tfl = convert.fleet_from_numpy(*jfl.cells, jfl.vendor, device="cpu")
    tsweep = fleet.sweep(tfl, jcontroller.DEFAULT_TEMP_BINS, (1.0, 1.03))
    service = serve_fleet.FleetControllerService(tsweep.to_table())
    for t, e in jstream.iter_chunks(trace, None, CHUNK):
        service.submit(t, e)
    return dict(jsweep=jsweep, jtable=jtable, jengine=jengine, tsweep=tsweep,
                service=service, trace=trace)


def test_sweep_and_table_bitwise(tiny):
    np.testing.assert_array_equal(tiny["tsweep"].read.numpy(), np.asarray(tiny["jsweep"].read))
    np.testing.assert_array_equal(tiny["tsweep"].write.numpy(), np.asarray(tiny["jsweep"].write))
    table = tiny["service"].table
    np.testing.assert_array_equal(table.stack.numpy(), tiny["jtable"].stack)
    assert table.temp_bins == tiny["jtable"].temp_bins


def test_partials_bitwise_and_score_close(tiny):
    want = tiny["jengine"].partials._asdict()
    got = convert.partials_to_numpy(tiny["service"].engine.partials)
    for k in ("occupancy", "switches", "n_steps"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    np.testing.assert_array_equal(got["timing_sums"].view(np.int32),
                                  np.asarray(want["timing_sums"]).view(np.int32))
    assert int(got["n_steps"]) == N_STEPS
    want_state = tiny["jengine"].state._asdict()
    for k, v in convert.state_to_numpy(tiny["service"].engine.state).items():
        np.testing.assert_array_equal(v, np.asarray(want_state[k]), err_msg=k)
    want_score, got_score = tiny["jengine"].score(), tiny["service"].running_score()
    assert set(got_score) == set(want_score)
    for k, v in want_score.items():
        assert got_score[k] == pytest.approx(v, abs=1e-5), k


def test_finalize_and_materialized_score_from_reference_state(tiny):
    """The reference's own partials finalize through the port to the same
    score; a materialized reference replay scores the same through
    ``perfmodel.trace_score``; and a port engine resumed from the
    reference's state, table and partials continues like the reference."""
    jengine, jtable = tiny["jengine"], tiny["jtable"]
    table = convert.table_from_numpy(jtable.temp_bins, jtable.stack, device="cpu")
    partials = convert.partials_from_numpy(*jengine.partials, device="cpu")
    want = jengine.score()
    got = perfmodel.trace_score_finalize(partials, table.stack)
    res = jcontroller.replay(jtable, tiny["trace"])
    replay = types.SimpleNamespace(
        timings=torch.tensor(np.asarray(res.timings)),
        bin_idx=torch.tensor(np.asarray(res.bin_idx)),
        switched=torch.tensor(np.asarray(res.switched)))
    materialized = perfmodel.trace_score(table.stack, replay)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, abs=1e-5), k
        assert materialized[k] == pytest.approx(v, abs=1e-5), k
    resumed = stream.StreamingController(
        table, state=convert.state_from_numpy(*jengine.state, device="cpu"))
    resumed.ingest(tiny["trace"][:7])
    assert resumed.n_steps == 7
    assert convert.cells_to_numpy(convert.cells_from_numpy(
        *(np.ones(3, np.float32),) * 3, device="cpu"))["leak"].shape == (3,)
    assert convert.table_to_numpy(table)["stack"].shape == jtable.stack.shape


def test_tiny_realized_speedup_meets_baseline(tiny):
    """The port reproduces the reference's realized intensive speedup and
    so passes the committed regression gate (read, never written)."""
    base = json.loads(BASELINE.read_text())
    want = tiny["jengine"].score()["speedup_realized_intensive_mean"]
    got = tiny["service"].running_score()["speedup_realized_intensive_mean"]
    assert got == pytest.approx(want, abs=1e-5)
    assert got >= base["speedup_realized_intensive_mean"] - base["tolerance"]


def test_diurnal_matches_reference_with_shared_draws():
    """The port's diurnal trace from the reference's own draws (sin and
    cumsum orders differ, hence atol 1e-4 °C)."""
    n, s = 48, 300
    key = jax.random.PRNGKey(5)
    k_phase, k_skew, k_noise = jax.random.split(key, 3)
    draws = traces.DiurnalNoise(
        phase=torch.tensor(np.asarray(jax.random.normal(k_phase, (n,)))),
        skew=torch.tensor(np.asarray(jax.random.uniform(k_skew, (n,), minval=-1.0, maxval=1.0))),
        noise=torch.tensor(np.asarray(jax.random.normal(k_noise, (s, n)))),
    )
    got = traces.diurnal(None, n, s, draws=draws)
    want = np.asarray(jtraces.diurnal(key, n, s))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    # A trace that breaks the drift bound is clamped like the reference's.
    rough = np.cumsum(np.random.default_rng(0).normal(0, 4.0, (s, n)), axis=0).astype(np.float32)
    np.testing.assert_allclose(
        traces.enforce_drift_bound(torch.from_numpy(rough), 60.0).numpy(),
        np.asarray(jtraces.enforce_drift_bound(rough, 60.0)), rtol=0, atol=1e-4)


def test_serve_on_cpu_end_to_end():
    g = torch.Generator().manual_seed(1)
    err = traces.error_injections(g, 50, 64, 0.05, device="cpu")
    assert err.dtype == torch.bool and 0 < int(err.sum()) < err.numel()
    report = serve_fleet.serve(n_dimms=256, n_steps=300, chunk=128, error_rate=0.01,
                               device="cpu")
    assert report["n_chunks"] == 3 and report["peak_device_bytes"] is None
    assert all(np.isfinite(v) for v in report["score"].values())


def test_serve_traced_on_cpu(tmp_path):
    """``trace_path`` writes a Chrome trace of the streaming loop and
    summarizes it; tracing leaves the result unchanged."""
    kw = dict(n_dimms=64, n_steps=200, chunk=64, device="cpu")
    plain = serve_fleet.serve(**kw)
    path = tmp_path / "serve_trace.json"
    traced = serve_fleet.serve(**kw, trace_path=str(path))
    assert traced["score"] == plain["score"]
    assert json.loads(path.read_text())["traceEvents"]
    tr = traced["trace"]
    assert 0 < tr["loop_s"] and tr["device_busy_s"] == 0.0 and tr["device_s_by_name"] == {}
    assert tr["host_self_s_top"] and all(r["s"] >= 0 for r in tr["host_self_s_top"])


def test_entry_points_refuse_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        serve_fleet.serve(n_dimms=8, n_steps=4)
    with pytest.raises(RuntimeError, match="cuda"):
        fleet.synthesize(torch.Generator(), 8)


def test_unported_paths_raise():
    """Paths once unported now run: refresh policies, every scenario,
    rank-5 region tables (regions: item 1) and the decision-emitting path
    (item 5)."""
    from repro_torch.core import refresh

    stack = torch.full((2, 5, 2, 4), 10.0)
    table = controller.DimmTimingTable(jcontroller.DEFAULT_TEMP_BINS, stack,
                                       refresh=refresh.DDR3_EXTENDED)
    assert len(table.bin_refresh().occupancy) == 6
    two = controller.DimmTimingTable(jcontroller.DEFAULT_TEMP_BINS,
                                     stack[:, :, None].repeat(1, 1, 2, 1, 1))
    assert two.n_regions == 2 and torch.equal(two.oblivious_stack(), stack)
    hot = traces.generate("hvac_failure", torch.Generator(), 4, 4, device="cpu")
    assert tuple(hot.shape) == (4, 4) and bool(torch.isfinite(hot).all())
    resp = serve_fleet.FleetControllerService(
        controller.DimmTimingTable(jcontroller.DEFAULT_TEMP_BINS, stack)
    ).submit(np.zeros((1, 2), np.float32), decisions=True)
    assert tuple(resp["timings"].shape) == (1, 2, 2, 4)
    assert resp["bin_idx"].tolist() == [[4, 4]] and int(resp["total_switches"]) == 0


def test_port_imports_neither_jax_nor_the_reference():
    """Importing every module of the port loads no jax* and no repro.*."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15
