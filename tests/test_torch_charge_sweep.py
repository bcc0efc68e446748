"""PyTorch port vs JAX reference: population, charge-sweep invariants,
min-safe indices and the fleet sweep, on the CPU.

Both packages get the same float32 cells (numpy, fixed seed) and
temperatures. The JAX side runs its pure-jnp reference search
(``impl="ref"``). Decisions — the min-safe grid indices — must be exactly
equal, through both of the port's paths: the full-model reference search
(``ref.search_min_indices``) and the fused search on hoisted invariants
(``ops.sweep_min_indices``, whose CPU path is the CUDA kernel's plain
version). The fleet sweep and the table it programs are compared in
``tests/test_torch_serve_fleet.py``. The invariants themselves pass through ``exp``/``log``/``pow``,
which differ between torch and XLA by an ulp or two, so they are held to
rtol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from repro.core import charge as jcharge
from repro.core import controller as jcontroller
from repro.core import dimm as jdimm
from repro.core import fleet as jfleet
from repro.kernels.charge_sweep import ops as jops
from repro_torch import convert
from repro_torch.core import charge, dimm, fleet
from repro_torch.core.controller import DimmTimingTable
from repro_torch.kernels.charge_sweep import kernel as sweep_kernel
from repro_torch.kernels.charge_sweep import ops, ref

SEED = 20240612
TEMPS = (45.0, 55.0, 85.0, 95.0)


def _cells_np(n: int, seed: int = SEED):
    """Seeded cells over the process-corner box (slightly wider than the
    screened vendor population, so the corner itself is covered)."""
    rng = np.random.default_rng(seed)
    c = jcharge.DEFAULT_CONSTANTS
    return (
        rng.uniform(1.0, c.r_max, n).astype(np.float32),
        rng.uniform(c.c_min, 1.0, n).astype(np.float32),
        rng.uniform(0.4, 1.0, n).astype(np.float32),
    )


def _corner_np():
    c = jcharge.DEFAULT_CONSTANTS
    return tuple(np.asarray([v], np.float32) for v in (c.r_max, c.c_min, 1.0))


#: name -> (cells, temperatures): a seeded population, the exact JEDEC
#: corner (which sits ON every threshold at 85 °C), above-grid
#: temperatures where searches pin to the last index, and a cell count
#: that is no multiple of any tile.
CASES = {
    "seeded": (_cells_np(2048), TEMPS),
    "jedec_corner": (_corner_np(), (45.0, 85.0)),
    "above_grid": (_cells_np(64, SEED + 1), (95.0, 105.0)),
    "ragged": (_cells_np(1037, SEED + 2), (55.0,)),
}


def _flat_case(cells, temps):
    """Every (temperature, cell) pair of a case as 1-D float32 arrays."""
    t = np.repeat(np.asarray(temps, np.float32), len(cells[0]))
    return tuple(np.tile(a, len(temps)) for a in cells), t


def _flat_all():
    """All cases concatenated (one reference compile), with their offsets."""
    parts = [_flat_case(*CASES[name]) for name in sorted(CASES)]
    cells = tuple(np.concatenate([p[0][i] for p in parts]) for i in range(3))
    temps = np.concatenate([p[1] for p in parts])
    bounds = np.cumsum([0] + [len(p[1]) for p in parts])
    return cells, temps, dict(zip(sorted(CASES), zip(bounds[:-1], bounds[1:])))


def _jax_inputs(cells, temps):
    return jcharge.CellParams(*(jnp.asarray(a) for a in cells)), jnp.asarray(temps)


def _torch_inputs(cells, temps):
    return convert.cells_from_numpy(*cells, device="cpu"), torch.from_numpy(temps)


@pytest.fixture(scope="module")
def jax_indices():
    """The JAX reference search over all cases in one call, split per case:
    ``{case: (read (M, 4), write (M, 4))}``."""
    cells, temps, spans = _flat_all()
    idx = jops.sweep_min_indices(*_jax_inputs(cells, temps), impl="ref")
    read, write = np.asarray(idx.read), np.asarray(idx.write)
    return {name: (read[a:b], write[a:b]) for name, (a, b) in spans.items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_min_indices_exact(case, jax_indices):
    """Fused search (the kernel's plain version) and full-model reference
    search both reproduce the JAX reference indices exactly."""
    cells, temps = _flat_case(*CASES[case])
    want_read, want_write = jax_indices[case]
    fused = ops.sweep_min_indices(*_torch_inputs(cells, temps))
    np.testing.assert_array_equal(fused.read.numpy(), want_read)
    np.testing.assert_array_equal(fused.write.numpy(), want_write)
    full = ref.search_min_indices(*_torch_inputs(cells, temps))
    np.testing.assert_array_equal(full[..., list(ref.READ_STACK_SEARCHES)].numpy(), want_read)
    np.testing.assert_array_equal(full[..., list(ref.WRITE_STACK_SEARCHES)].numpy(), want_write)
    if case == "above_grid":  # some searches must pin to the JEDEC index
        assert (fused.read.numpy() == np.asarray(
            [ref.GRID_SIZES[p] - 1 for p in ("trcd", "tras", "twr", "trp")])).any()


def test_cell_invariants_match_reference():
    """Every hoisted invariant within rtol 1e-6 of JAX's (masks exactly)."""
    cells, temps = _flat_case(*CASES["seeded"])
    want = jops.cell_invariants(*_jax_inputs(cells, temps))
    got = ops.cell_invariants(*_torch_inputs(cells, temps))
    shape = temps.shape
    worst = 0
    for name, a, b in zip(sweep_kernel.INVARIANT_NAMES, want, got):
        a = np.broadcast_to(np.asarray(a), shape)
        b = np.broadcast_to(b.numpy(), shape)
        ulp = int(np.abs(a.view(np.int32).astype(np.int64)
                         - b.view(np.int32).astype(np.int64)).max())
        worst = max(worst, ulp)
        if name.startswith("m_"):
            np.testing.assert_array_equal(b, a, err_msg=name)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=0, err_msg=name)
    print(f"max invariant difference: {worst} ulp")


def test_kernel_scalars_are_float32_roundings():
    want = jops.kernel_scalars()
    got = ops.kernel_scalars()
    for f in ("tck", "ovh_rcd", "thr_sense", "one_minus_vrs", "v_over_minus_vrs"):
        assert getattr(got, f) == float(np.float32(getattr(want, f)))
    for f in ("tau_sa", "tau_restore", "tau_write", "tau_bl"):
        assert getattr(charge.DEFAULT_CONSTANTS, f) == float(
            np.asarray(getattr(jcharge.DEFAULT_CONSTANTS, f)))


def test_population_from_reference_draws():
    """The vendor population mapped from the reference's own uniform draws
    (threefry bits cannot be reproduced in torch, so they are fed in)."""
    key = jax.random.PRNGKey(0)
    n = 115
    want_cells, want_vendor = jdimm.sample_population(key, n)
    uniforms, k = [], key
    for n_v in jdimm.VENDOR_SPLIT:
        k, kr, kc, kl = jax.random.split(k, 4)
        uniforms.append(tuple(torch.tensor(np.asarray(jax.random.uniform(kk, (n_v,))))
                              for kk in (kr, kc, kl)))
    cells, vendor = dimm.population_from_uniforms(uniforms)
    np.testing.assert_array_equal(vendor.numpy(), np.asarray(want_vendor))
    for a, b in zip(cells, want_cells):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=0)


def test_sample_population_on_cpu_generator():
    g = torch.Generator().manual_seed(0)
    fl = fleet.synthesize(g, 1000, device="cpu")
    assert fl.cells.r.dtype == torch.float32 and fl.vendor.dtype == torch.int32
    assert tuple(int((fl.vendor == v).sum()) for v in range(3)) == fleet.vendor_split(1000)
    c = charge.DEFAULT_CONSTANTS
    assert bool(((fl.cells.r >= 1.0) & (fl.cells.r <= c.r_max)).all())


def test_cuda_wrapper_refuses_cpu_tensors():
    """The kernel's wrapper launches or raises: a CPU tensor is refused,
    never routed to the plain version behind the caller's back."""
    inv = torch.ones((sweep_kernel.N_INVARIANTS, 4), dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        sweep_kernel.charge_sweep_cuda(inv, ops.kernel_scalars())


def test_table_refuses_untested_entries():
    stack = torch.full((2, 5, 2, 4), 10.0)
    stack[1, 2, 1, 1] = -1.0
    with pytest.raises(ValueError, match="untested"):
        DimmTimingTable(jcontroller.DEFAULT_TEMP_BINS, stack)


def _all_invariants():
    cells, temps, _ = _flat_all()
    inv, _ = ops.stacked_invariants(*_torch_inputs(cells, temps))
    return inv, ops.kernel_scalars()


def _latched(scal):
    """The restore value of the read and the write tRAS search at the sense
    latch, as the CUDA kernel forms it: one float32 subtraction each."""
    return (float(np.float32(1.0) - np.float32(scal.one_minus_vrs)),
            float(np.float32(scal.v_over) - np.float32(scal.v_over_minus_vrs)))


def test_tras_latched_shortcut_is_bitwise():
    """Wherever a tRAS candidate's restore has not started (ta <= 0), the
    plain version's float32 restore value equals the constant the CUDA kernel
    compares there instead, bit for bit (``restored`` in
    csrc/charge_sweep.cu)."""
    inv, scal = _all_invariants()
    row = dict(zip(sweep_kernel.INVARIANT_NAMES, inv))
    latched_r, latched_w = _latched(scal)
    hits = 0
    for k in range(max(ref.SEARCH_GRID_SIZES)):
        t = torch.full_like(row["rts"], k + 1) * scal.tck
        # The plain version's expressions (kernel.charge_sweep_plain).
        ta_r = t - scal.ovh_ras - row["t_sense_r"]
        v_reached = 1.0 - scal.one_minus_vrs * torch.exp(
            -torch.clamp(ta_r, min=0.0) / row["rtr"])
        ta_w = t - scal.ovh_ras - row["t_sense_w"]
        v_row = scal.v_over - scal.v_over_minus_vrs * torch.exp(
            -torch.clamp(ta_w, min=0.0) / row["tau_wr"])
        for ta, v, latched in ((ta_r, v_reached, latched_r), (ta_w, v_row, latched_w)):
            at = ta <= 0.0
            hits += int(at.sum())
            want = torch.full((int(at.sum()),), latched, dtype=torch.float32)
            assert torch.equal(v[at].view(torch.int32), want.view(torch.int32)), k
    assert hits > 0


def _first_pass_walk(inv, scal, n_grid):
    """The CUDA kernel's control flow on the CPU: each search evaluates only
    the cells still searching, stops a cell at its first pass, never starts
    one whose mask is 0, ends before its own grid's last candidate, and
    compares the latched constant in the tRAS searches where ta <= 0."""
    row = dict(zip(sweep_kernel.INVARIANT_NAMES, inv))
    latched_r, latched_w = _latched(scal)

    def restored(ta, tau, v_top, v_span, latched, thr):
        full = v_top - v_span * torch.exp(-torch.clamp(ta, min=0.0) / tau) >= thr
        return torch.where(ta <= 0.0, latched >= thr, full)

    preds = (
        lambda c, t: row["dv0_r"][c] * torch.exp((t - scal.ovh_rcd) / row["rts"][c])
        >= scal.thr_sense,
        lambda c, t: restored(t - scal.ovh_ras - row["t_sense_r"][c], row["rtr"][c], 1.0,
                              scal.one_minus_vrs, latched_r, row["thr_rest"][c]),
        lambda c, t: scal.v_half * torch.exp(-(t - scal.ovh_rp) / row["rtb"][c])
        <= row["thr_trp"][c],
        lambda c, t: t >= row["thr_trcd_w"][c],
        lambda c, t: restored(t - scal.ovh_ras - row["t_sense_w"][c], row["tau_wr"][c],
                              scal.v_over, scal.v_over_minus_vrs, latched_w,
                              row["thr_rest"][c]),
        lambda c, t: scal.v_over * (1.0 - torch.exp(-(t - scal.ovh_wr) / row["tau_wr"][c]))
        >= row["thr_rest"][c],
        lambda c, t: t >= row["thr_trp_w"][c],
    )
    idx = torch.empty((len(preds), inv.shape[1]), dtype=torch.int32)
    for j, pred in enumerate(preds):
        idx[j] = n_grid[j] - 1
        live = torch.nonzero(inv[11 + j] > 0.5).flatten()
        for k in range(n_grid[j] - 1):  # the last candidate's index is the pin
            if live.numel() == 0:
                break
            ok = pred(live, torch.full((live.numel(),), k + 1, dtype=torch.float32) * scal.tck)
            idx[j, live[ok]] = k
            live = live[~ok]
    return idx


def test_first_pass_walk_matches_plain():
    """Stopping each search at its first pass, never starting a masked one
    and ending before its own grid's last candidate (the CUDA kernel's skip
    rule) gives the plain full walk's indices on every case, on the
    worst-case stack (no search passes) and with masks at 0 on every fifth
    cell."""
    inv, scal = _all_invariants()
    worst = chip_smoke.sweep_worst_case(inv)
    masked = chip_smoke.sweep_masks_off(inv)
    n_grid = ref.SEARCH_GRID_SIZES
    for stack in (inv, worst, masked):
        want = sweep_kernel.charge_sweep_plain(stack, scal, n_grid)
        assert torch.equal(_first_pass_walk(stack, scal, n_grid), want)
    pinned = torch.tensor(n_grid, dtype=torch.int32)[:, None] - 1
    assert torch.equal(sweep_kernel.charge_sweep_plain(worst, scal, n_grid),
                       pinned.expand(-1, worst.shape[1]))
