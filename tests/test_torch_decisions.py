"""PyTorch port vs JAX reference: the decision-emitting path, on the CPU.

The same numpy table, trace and error mask go through the reference's
``chunk_scan_emit``, ``StreamingController(...).ingest(...,
return_decisions=True)``, ``FleetControllerService.submit(decisions=True)``
and ``replay_stream``, and through the port's counterparts. The emitted
rows, switch flags and effective bins, the state and the partials must be
bitwise equal (the rows and the timing sums as float32 words), and the
switch totals equal. A handful of DIMMs and few distinct chunk lengths keep
the reference's jitted scans to a few compilations.
"""

import numpy as np
import pytest
import torch

from repro.core import controller as jcontroller
from repro.core import perfmodel as jperf
from repro.core import stream as jstream
from repro.kernels.replay_step import ref as jreplay_ref
from repro.launch import serve_fleet as jserve_fleet
from repro_torch import convert
from repro_torch.core import controller, perfmodel, stream
from repro_torch.kernels.replay_step import kernel as replay_kernel
from repro_torch.kernels.replay_step import ops, ref
from repro_torch.launch import serve_fleet

BINS = jcontroller.DEFAULT_TEMP_BINS
N_DIMMS = 11
SEED = 21
#: Ragged chunk lengths of the streamed tests (100 steps in all; lengths the
#: reference has compiled for the first test); errors arrive from the third
#: chunk on.
RAGGED = (9, 1) + (9,) * 10
ERRORS_FROM = 2


def _case(n: int = N_DIMMS, error_rate: float = 0.03):
    """Cycle-quantized registers non-decreasing over bins, the boundary
    ladder (three descending passes) then random temperatures, and errors."""
    rng = np.random.default_rng(SEED)
    stack = (np.sort(rng.integers(2, 29, (n, len(BINS), 2, 4)), axis=1) * 1.25).astype(np.float32)
    p = jcontroller.ControllerParams()
    ladder = []
    for e in BINS:
        g = e - p.guard_band_c
        ladder += [e, g, g - p.hysteresis_c,
                   float(np.nextafter(np.float32(g), np.float32(-np.inf)))]
    ladder = np.asarray(sorted(ladder, reverse=True) * 3, np.float32)
    rand = rng.uniform(20.0, 95.0, (100 - ladder.size, n)).astype(np.float32)
    temps = np.concatenate([np.repeat(ladder[:, None], n, axis=1), rand])
    errors = rng.random(temps.shape) < error_rate
    return stack, temps, errors


@pytest.fixture(scope="module")
def case():
    return _case()


def _words(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _equal(got, want, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_array_equal(_words(got), _words(want), err_msg=what)


def _equal_state_partials(state, partials, want_state, want_partials):
    for a, b, name in zip(state, want_state, ("bin_idx", "cool_streak", "fused")):
        _equal(a, b, name)
    for a, b, name in zip(partials, want_partials,
                          ("occupancy", "switches", "timing_sums", "n_steps")):
        _equal(a, b, name)


@pytest.mark.parametrize("chunk", [1, 9, 100])
def test_chunk_scan_emit_matches_reference(case, chunk):
    """The port's plain emit scan, chunk by chunk from the boot state, equals
    the reference's jitted ``chunk_scan_emit``: every chunk's rows, switch
    flags and bins, then the state and partials."""
    import jax.numpy as jnp

    stack, temps, errors = case
    n = stack.shape[0]
    jstate, jp = jcontroller.init_state(n, len(BINS)), jperf.trace_score_init(n, len(BINS))
    jedges = jnp.asarray(BINS, jnp.float32)
    jparams = jcontroller.ControllerParams(*(jnp.asarray(x)
                                             for x in jcontroller.ControllerParams()))
    st = controller.init_state(n, len(BINS), "cpu")
    p = tuple(perfmodel.trace_score_init(n, len(BINS), "cpu"))
    edges = torch.tensor(BINS, dtype=torch.float32)
    tstack = torch.from_numpy(stack)
    for s in range(0, temps.shape[0], chunk):
        tc, ec = temps[s:s + chunk], errors[s:s + chunk]
        want = jreplay_ref.chunk_scan_emit(jnp.asarray(stack), jedges, jparams, jstate, *jp,
                                           jnp.asarray(tc), jnp.asarray(ec))
        got = ref.chunk_scan_emit(tstack, edges, controller.ControllerParams(), st, *p,
                                  torch.from_numpy(tc), torch.from_numpy(ec))
        for a, b, name in zip(got[5:], want[5:], ("rows", "switched", "eff")):
            assert a.dtype == {"rows": torch.float32, "switched": torch.bool,
                               "eff": torch.int32}[name]
            _equal(a, b, f"{name}, chunk at step {s}")
        jstate, jp = want[0], jperf.ScorePartials(*want[1:5])
        st, p = got[0], got[1:5]
    _equal_state_partials(st, p, jstate, jp)
    assert int(np.asarray(jstate.fused).sum()) > 0 and int(np.asarray(jp.switches).sum()) > 0
    # The partials are the non-emitting scan's, bitwise.
    plain = ref.chunk_scan(tstack, edges, controller.ControllerParams(),
                           controller.init_state(n, len(BINS), "cpu"),
                           *perfmodel.trace_score_init(n, len(BINS), "cpu"),
                           torch.from_numpy(temps), torch.from_numpy(errors))
    _equal_state_partials(plain[0], plain[1:5], st, p)


def test_emit_plain_slot_major_matches_replay(case):
    """The kernel's plain version on the slot-major operands: its carry is
    the non-emitting entry's bitwise, and its rows, bins, switch and fuse
    flags are ``controller.replay``'s history on the CPU."""
    stack, temps, errors = case
    n = stack.shape[0]
    table = convert.table_from_numpy(BINS, stack, device="cpu")
    scal = ops.replay_scalars(BINS, controller.ControllerParams())
    st3 = ops.to_state3(controller.init_state(n, len(BINS), "cpu"))
    zero = ops.to_slot_partials(perfmodel.trace_score_init(n, len(BINS), "cpu"))
    args = (st3, *zero, ops.to_stack_t(table.stack), torch.from_numpy(temps),
            torch.from_numpy(errors).to(torch.uint8))
    *carry, dec = replay_kernel.replay_chunk_emit_plain(*args, scal)
    for a, b in zip(carry, replay_kernel.replay_chunk_plain(*args, scal)):
        _equal(a, b.numpy())
    res = controller.replay(table, temps, errors)
    for name, want in (("rows", res.timings), ("eff", res.bin_idx),
                       ("switched", res.switched), ("fused", res.fused)):
        _equal(getattr(dec, name), want.numpy(), name)
    # The ops dispatch keeps only the asked-for fields.
    *_, only = ops.chunk_scan_emit(*args, scal, fields=("eff",))
    assert only.rows is None and only.switched is None and only.fused is None
    assert torch.equal(only.eff, dec.eff)


def _chunks():
    s = 0
    for k, c in enumerate(RAGGED):
        yield k, s, s + c
        s += c


def test_ingest_decisions_match_reference(case):
    """``ingest(return_decisions=True)`` across ragged chunks, errors arriving
    mid-stream, against the reference engine; then the same stream with
    emitting and non-emitting chunks alternated carries the same partials."""
    stack, temps, errors = case
    jengine = jstream.StreamingController(jcontroller.DimmTimingTable(BINS, stack))
    engine = stream.StreamingController(convert.table_from_numpy(BINS, stack, device="cpu"))
    mixed = stream.StreamingController(convert.table_from_numpy(BINS, stack, device="cpu"))
    for k, s, e in _chunks():
        err = errors[s:e] if k >= ERRORS_FROM else None
        want = jengine.ingest(temps[s:e], err, return_decisions=True)
        got = engine.ingest(temps[s:e], err, return_decisions=True)
        assert len(got) == 3
        for a, b, name in zip(got, want, ("timings", "bin_idx", "switched")):
            assert tuple(a.shape) == np.asarray(b).shape, name
            _equal(a, b, f"{name}, chunk {k}")
        assert int(engine.total_switches) == jengine.total_switches
        assert engine.total_switches.dtype == torch.int64 and engine.total_switches.dim() == 0
        out = mixed.ingest(temps[s:e], err, return_decisions=k % 2 == 1)
        assert (out is None) == (k % 2 == 0)
    _equal_state_partials(engine.state, engine.partials, jengine.state, jengine.partials)
    _equal_state_partials(mixed.state, mixed.partials, engine.state, engine.partials)
    assert engine.errors_total == jengine.errors_total > 0
    assert engine.n_steps == jengine.n_steps == temps.shape[0]


def test_submit_decisions_matches_reference(case):
    """``submit(decisions=True)`` answers with the reference's keys; its
    ``total_switches`` and decisions equal the reference's."""
    stack, temps, errors = case
    jsvc = jserve_fleet.FleetControllerService(jcontroller.DimmTimingTable(BINS, stack))
    svc = serve_fleet.FleetControllerService(convert.table_from_numpy(BINS, stack, device="cpu"))
    for k, s, e in _chunks():
        decisions = k != 1
        want = jsvc.submit(temps[s:e], errors[s:e], decisions=decisions)
        got = svc.submit(temps[s:e], errors[s:e], decisions=decisions)
        assert set(got) == set(want)
        assert int(got["total_switches"]) == want["total_switches"]
        for key in ("n_steps", "n_chunks", "errors_total"):
            assert got[key] == want[key], key
        for key in ("timings", "bin_idx", "switched") if decisions else ():
            _equal(got[key], want[key], key)
    assert want["total_switches"] > 0


def test_stream_result_switch_counts_match_reference(case):
    stack, temps, errors = case
    want = jstream.replay_stream(jcontroller.DimmTimingTable(BINS, stack), temps, errors,
                                 chunk_steps=9)
    got = stream.replay_stream(convert.table_from_numpy(BINS, stack, device="cpu"), temps,
                               errors, chunk_steps=9)
    assert got.switch_counts.dtype == torch.int32
    _equal(got.switch_counts, want.switch_counts)
    assert got.total_switches == want.total_switches > 0
    assert isinstance(got.total_switches, int)


def test_serve_decisions_on_cpu(capsys):
    """``serve(decisions=True)`` prints DIMM 0's last read and write sets and
    bin, and scores exactly as ``decisions=False``."""
    kw = dict(n_dimms=48, n_steps=150, chunk=64, error_rate=0.01, device="cpu")
    plain = serve_fleet.serve(**kw)
    capsys.readouterr()
    dec = serve_fleet.serve(**kw, decisions=True)
    out = capsys.readouterr().out
    assert dec["score"] == plain["score"]
    assert dec["total_switches"] == plain["total_switches"] == plain["score"]["switches_total"]
    assert dec["decisions"] and not plain["decisions"]
    assert dec["loop_peak_device_bytes"] is None and dec["n_chunks"] == 3
    lines = [ln for ln in out.splitlines() if "DIMM 0 last" in ln]
    assert len(lines) == 3, out
    assert lines[0].startswith("[serve_fleet] DIMM 0 last read set (ns): trcd=")
    assert lines[1].startswith("[serve_fleet] DIMM 0 last write set (ns): trcd=")
    assert "JEDEC sentinel = 4" in lines[2]
    assert f"switches {dec['total_switches']}," in out
