"""The port's refresh model vs the JAX reference, on the CPU.

``repro_torch.core.refresh`` must give exactly the reference's policy
constants, float32 multipliers and occupancies (a temperature on a
boundary belongs to the cooler side), per-bin refresh loads and
validation errors. The refresh terms of the performance model reduce
exactly to the refresh-free arithmetic at zero occupancy.
"""

import numpy as np
import pytest
import torch

from repro.core import controller as jcontroller
from repro.core import refresh as jrefresh
from repro_torch.core import controller, perfmodel, refresh
from repro_torch.core.timing import JEDEC_DDR3_1600

POLICIES = {"ddr3": (refresh.DDR3_EXTENDED, jrefresh.DDR3_EXTENDED),
            "ddr3_4x": (refresh.DDR3_EXTENDED_4X, jrefresh.DDR3_EXTENDED_4X)}
GRIDS = {"default": jcontroller.DEFAULT_TEMP_BINS,
         "hot": (45.0, 84.9, 85.0, 85.1, 95.0, 100.0)}


def test_constants_match_reference():
    assert refresh.TREFI_BASE_NS == jrefresh.TREFI_BASE_NS
    assert refresh.TRFC_NS == jrefresh.TRFC_NS
    for port, ref in POLICIES.values():
        assert (port.boundaries, port.multipliers, port.trefi_base_ns, port.trfc_ns) == (
            ref.boundaries, ref.multipliers, ref.trefi_base_ns, ref.trfc_ns)
        for m in ref.multipliers:
            assert port.occupancy_of(m) == ref.occupancy_of(m)


@pytest.mark.parametrize("name", sorted(POLICIES))
def test_multiplier_and_occupancy_at_boundaries(name):
    """84.9 / 85 / 85.1 °C (and 94.9 / 95 / 95.1 °C): 85.0 refreshes at 1×."""
    port, ref = POLICIES[name]
    temps = np.asarray([20.0, 84.9, 85.0, 85.1, 94.9, 95.0, 95.1, 120.0], np.float32)
    want = np.asarray(jrefresh.multiplier_at(ref, temps))
    got = refresh.multiplier_at(port, torch.from_numpy(temps)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32 and got[2] == 1.0 and got[3] == 2.0
    np.testing.assert_array_equal(refresh.occupancy_at(port, torch.from_numpy(temps)).numpy(),
                                  np.asarray(jrefresh.occupancy_at(ref, temps)))
    assert float(refresh.multiplier_at(port, 85.0)) == float(jrefresh.multiplier_at(ref, 85.0))


@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("name", sorted(POLICIES))
def test_bin_refresh_matches_reference(name, grid):
    port, ref = POLICIES[name]
    bins = GRIDS[grid]
    assert refresh.bin_multipliers(port, bins) == jrefresh.bin_multipliers(ref, bins)
    got, want = refresh.bin_refresh(port, bins), jrefresh.bin_refresh(ref, bins)
    assert got.occupancy == want.occupancy and got.trfc_ns == want.trfc_ns
    assert len(got.occupancy) == len(bins) + 1


def test_table_bin_refresh_matches_reference():
    stack = np.full((3, 5, 2, 4), 12.5, np.float32)
    for port, ref in POLICIES.values():
        got = controller.DimmTimingTable(jcontroller.DEFAULT_TEMP_BINS,
                                         torch.from_numpy(stack), refresh=port).bin_refresh()
        want = jcontroller.DimmTimingTable(jcontroller.DEFAULT_TEMP_BINS, stack,
                                           refresh=ref).bin_refresh()
        assert tuple(got) == tuple(want)
    assert controller.DimmTimingTable(jcontroller.DEFAULT_TEMP_BINS,
                                      torch.from_numpy(stack)).bin_refresh() is None
    with pytest.raises(TypeError, match="RefreshPolicy"):
        controller.DimmTimingTable(jcontroller.DEFAULT_TEMP_BINS, torch.from_numpy(stack),
                                   refresh=object())


@pytest.mark.parametrize("kw", [
    dict(boundaries=(85.0,), multipliers=(1.0,)),
    dict(boundaries=(95.0, 85.0), multipliers=(1.0, 2.0, 4.0)),
    dict(multipliers=(0.0, 2.0)),
    dict(multipliers=(2.0, 1.0)),
    dict(trfc_ns=0.0),
    dict(multipliers=(1.0, 40.0)),
])
def test_policy_validation_matches_reference(kw):
    with pytest.raises(ValueError) as want:
        jrefresh.RefreshPolicy(**kw)
    with pytest.raises(ValueError) as got:
        refresh.RefreshPolicy(**kw)
    assert str(got.value) == str(want.value)


def test_refresh_terms_vanish_at_zero_occupancy():
    """``refresh_occ = 0`` is bitwise the refresh-free model; a positive
    occupancy slows JEDEC and adapted rows alike and dilutes the speedup."""
    rows = torch.tensor([[list(JEDEC_DDR3_1600)] * 2,
                         [[10.0, 23.75, 7.5, 10.0], [8.75, 10.0, 8.75, 7.5]]])
    cfg = perfmodel.MULTI_CORE
    plain = perfmodel.evaluate_stack(rows, cfg)
    zero = perfmodel.evaluate_stack(rows, cfg, refresh_occ=torch.zeros(2), trfc_ns=260.0)
    assert torch.equal(plain, zero)
    occ = refresh.DDR3_EXTENDED.occupancy_of(2.0)
    hot = perfmodel.evaluate_stack(rows, cfg, refresh_occ=torch.full((2,), occ), trfc_ns=260.0)
    assert bool((hot < plain).all())
    sp = perfmodel.fleet_speedups(rows[1:], cfg)
    sp_hot = perfmodel.fleet_speedups(rows[1:], cfg, refresh_occ=torch.tensor([occ]),
                                      trfc_ns=260.0)
    assert 1.0 < float(sp_hot[0]) < float(sp[0])
