"""PyTorch port vs JAX reference: the replay chunk scan, on the CPU.

The port's plain chunk scan (:mod:`repro_torch.kernels.replay_step.ref`,
the CUDA kernel's plain version) and its slot-major dispatch path are held
against :func:`repro.kernels.replay_step.ref.chunk_scan` on the same numpy
table, trace and error mask. State, occupancy and switch counts must be
exactly equal and the float32 timing sums bitwise equal, at chunkings
{1, ragged, n_steps}, through a ladder of boundary temperatures (each bin
edge, edge − guard band, edge − guard − hysteresis, and the float32 just
below edge − guard) and error injections. One small case runs the JAX
Pallas kernel in interpret mode.
"""

import numpy as np
import pytest
import torch

from repro.core import controller as jcontroller
from repro.core import perfmodel as jperf
from repro.kernels.replay_step import ops as jreplay_ops
from repro.kernels.replay_step import ref as jreplay_ref
from repro_torch import convert
from repro_torch.core import controller, perfmodel, stream
from repro_torch.kernels.replay_step import kernel as replay_kernel
from repro_torch.kernels.replay_step import ops, ref

BINS = jcontroller.DEFAULT_TEMP_BINS
N_DIMMS = 13
SEED = 7


def _table_np(n: int = N_DIMMS):
    """Cycle-quantized (N, B, 2, 4) registers, non-decreasing over bins."""
    rng = np.random.default_rng(SEED)
    k = np.sort(rng.integers(2, 29, (n, len(BINS), 2, 4)), axis=1)
    return (k * 1.25).astype(np.float32)


def _trace_np(n: int = N_DIMMS, error_rate: float = 0.02):
    """The boundary ladder (three descending passes, so hysteresis
    recoveries trip) followed by random temperatures, plus errors."""
    p = jcontroller.ControllerParams()
    ladder = []
    for e in BINS:
        g = e - p.guard_band_c
        ladder += [e, g, g - p.hysteresis_c,
                   float(np.nextafter(np.float32(g), np.float32(-np.inf)))]
    ladder = np.asarray(sorted(ladder, reverse=True) * 3, np.float32)
    rng = np.random.default_rng(SEED + 1)
    rand = rng.uniform(20.0, 95.0, (40, n)).astype(np.float32)
    temps = np.concatenate([np.repeat(ladder[:, None], n, axis=1), rand])
    errors = rng.random(temps.shape) < error_rate
    return temps, errors


def _jax_scan(stack, temps, errors, chunk):
    """The reference chunk scan, chunk by chunk, from the boot state."""
    import jax.numpy as jnp

    n = stack.shape[0]
    state = jcontroller.init_state(n, len(BINS))
    p = jperf.trace_score_init(n, len(BINS))
    edges = jnp.asarray(BINS, jnp.float32)
    params = jcontroller.ControllerParams(*(jnp.asarray(x) for x in jcontroller.ControllerParams()))
    out = None
    for s in range(0, temps.shape[0], chunk):
        out = jreplay_ref.chunk_scan(jnp.asarray(stack), edges, params, state, *p,
                                     jnp.asarray(temps[s:s + chunk]),
                                     jnp.asarray(errors[s:s + chunk]))
        state, p = out[0], jperf.ScorePartials(*out[1:5])
    return state, p


def _port_scan(stack, temps, errors, chunk):
    n = stack.shape[0]
    st = controller.init_state(n, len(BINS), "cpu")
    p = perfmodel.trace_score_init(n, len(BINS), "cpu")
    edges = torch.tensor(BINS, dtype=torch.float32)
    for s in range(0, temps.shape[0], chunk):
        st, *p = ref.chunk_scan(torch.from_numpy(stack), edges, controller.ControllerParams(),
                                st, *p, torch.from_numpy(temps[s:s + chunk]),
                                torch.from_numpy(errors[s:s + chunk]))
    return st, perfmodel.ScorePartials(*p)


def _assert_equal(state, partials, want_state, want_partials):
    for a, b in zip(state, want_state):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for name in ("occupancy", "switches", "n_steps"):
        np.testing.assert_array_equal(getattr(partials, name).numpy(),
                                      np.asarray(getattr(want_partials, name)), err_msg=name)
    # Bitwise, not numerically: compare the float32 words.
    np.testing.assert_array_equal(partials.timing_sums.numpy().view(np.int32),
                                  np.asarray(want_partials.timing_sums).view(np.int32))


@pytest.fixture(scope="module")
def case():
    return _table_np(), *_trace_np()


@pytest.mark.parametrize("chunk", [1, 9, 100])
def test_plain_chunk_scan_matches_reference(case, chunk):
    """Chunkings 1, ragged (9 over 100 steps) and the whole trace."""
    stack, temps, errors = case
    assert temps.shape[0] == 100
    want = _jax_scan(stack, temps, errors, chunk)
    _assert_equal(*_port_scan(stack, temps, errors, chunk), *want)
    assert int(np.asarray(want[0].fused).sum()) > 0      # errors fused some DIMMs
    assert int(np.asarray(want[1].switches).sum()) > 0   # the ladder switched bins


@pytest.mark.parametrize("chunk", [1, 9, 100])
def test_streaming_controller_matches_one_chunk_scan(case, chunk):
    """The streaming engine (slot-major dispatch path, host chunks, via
    ``replay_stream``) carries partials bitwise equal to one whole-trace
    chunk scan."""
    stack, temps, errors = case
    table = convert.table_from_numpy(BINS, stack, device="cpu")
    res = stream.replay_stream(table, temps, errors, chunk_steps=chunk)
    st, p = _port_scan(stack, temps, errors, temps.shape[0])
    _assert_equal(res.state, res.partials, st, p)
    assert res.errors_total == int(errors.sum()) and res.n_steps == temps.shape[0]
    assert res.n_chunks == -(-temps.shape[0] // chunk)
    assert res.score() == perfmodel.trace_score_finalize(p, table.stack)


def test_pallas_interpret_matches_port():
    """One small case through the JAX Pallas kernel in interpret mode."""
    import jax.numpy as jnp

    n, steps = 5, 24
    stack, (temps, errors) = _table_np(n), _trace_np(n, 0.05)
    temps, errors = temps[-steps:], errors[-steps:]
    params = jcontroller.ControllerParams()
    run = jreplay_ops.pallas_chunk_scan(BINS, params, interpret=True)
    p0 = jperf.trace_score_init(n, len(BINS))
    out = run(jnp.asarray(stack), jnp.asarray(BINS, jnp.float32), params,
              jcontroller.init_state(n, len(BINS)), *p0,
              jnp.asarray(temps), jnp.asarray(errors))
    _assert_equal(*_port_scan(stack, temps, errors, steps), out[0],
                  jperf.ScorePartials(*out[1:5]))


def test_scalars_and_layouts_roundtrip():
    scal = ops.replay_scalars((40.1, 55.0, 85.0), controller.ControllerParams(5.3, 2.0, 3))
    assert scal.edges[0] == float(np.float32(40.1)) and scal.guard_band_c == float(np.float32(5.3))
    assert scal.jedec == (13.75, 35.0, 15.0, 13.75) * 2
    stack = torch.from_numpy(_table_np())
    n = stack.shape[0]
    stack_t = ops.to_stack_t(stack)
    assert stack_t.shape == (len(BINS) * replay_kernel.ROW_SLOTS, n)
    torch.testing.assert_close(stack_t.t().reshape(stack.shape), stack, rtol=0, atol=0)
    p = perfmodel.ScorePartials(torch.arange(n * 6, dtype=torch.int32).reshape(n, 6),
                                torch.arange(n, dtype=torch.int32),
                                torch.rand(n, 2, 4), torch.tensor(4, dtype=torch.int32))
    back = ops.from_slot_partials(*ops.to_slot_partials(p), 4)
    for a, b in zip(back, p):
        assert torch.equal(a, b)


def test_cuda_wrapper_refuses_cpu_tensors():
    stack = torch.from_numpy(_table_np())
    n = stack.shape[0]
    scal = ops.replay_scalars(BINS, controller.ControllerParams())
    args = (ops.to_state3(controller.init_state(n, len(BINS), "cpu")),
            torch.zeros((len(BINS) + 1, n), dtype=torch.int32),
            torch.zeros(n, dtype=torch.int32), torch.zeros((8, n)), ops.to_stack_t(stack),
            torch.zeros((3, n)), torch.zeros((3, n), dtype=torch.uint8))
    with pytest.raises(ValueError, match="CUDA tensor"):
        replay_kernel.replay_chunk_cuda(*args, scal)
    with pytest.raises(ValueError, match="CUDA tensor"):
        replay_kernel.replay_chunk_emit_cuda(*args, scal)
    # The decision-emitting path runs its plain version on CPU tensors.
    rows, bins, switched = stream.StreamingController(
        convert.table_from_numpy(BINS, stack, "cpu")).ingest(
            np.zeros((2, n), np.float32), return_decisions=True)
    assert tuple(rows.shape) == (2, n, 2, 4) and rows.dtype == torch.float32
    assert bins.dtype == torch.int32 and switched.dtype == torch.bool
    assert tuple(bins.shape) == tuple(switched.shape) == (2, n)
