"""The port's DIMM-axis split (``repro_torch.core.shard``) against the
single-device port and the JAX reference, on four gloo ranks on the CPU.

One module-scoped :func:`shard.launch` of four ranks runs
``chip_smoke.shard_parity`` (a rank body that imports no JAX) at the
reference's fleet sizes 1, 3, 5, 8 and 11 — sizes 4 does not divide and
fleets smaller than the mesh, whose last ranks hold only padding — and
``trace_eval.run(sharded=True)`` at ``--tiny``. Each rank holds its sharded
results against the single-device port on the same inputs and the ranks'
mismatch counts are summed: map outputs (sweep and region-sweep stacks,
replay history, stream state, partials and decisions at chunkings 1, 37 and
whole, region counts) must be bitwise equal, switch totals exact, score
floats within 1e-5, and the streamed sharded score bitwise the materialized
sharded one.

While the ranks run, this process runs the JAX reference's own sharded
pipeline on its one-lane mesh (``fleet_mesh()``) from the same inputs of the
11-DIMM fleet: ``fleet.sweep(mesh=)``, ``controller.replay(mesh=)`` of its
table and ``trace_score(mesh=)`` of that replay. The ranks' gathered sharded
sweep and replay must equal them bitwise, and the sharded score must be
within 1e-5. The pure helpers run here without ranks.
"""

import concurrent.futures

import numpy as np
import pytest
import torch

import chip_smoke
from repro_torch.core import fleet, shard

SIZES = (1, 3, 5, 8, 11)
RANKS = 4
STEPS = 48
CHUNKINGS = (1, 37, None)
ERROR_RATE = 0.02
TINY_EVAL = dict(n_dimms=64, n_steps=512, baseline_dimms=8, baseline_steps=128)

#: Each map-like path and the mismatch counts ``shard_parity`` reports for it.
MAP_CHECKS = {
    "sweep": ("sweep",),
    "sweep_regions": ("sweep_regions",),
    "replay": ("replay", "replay_state", "replay_gathered"),
    **{f"stream_{c}": tuple(f"stream_{c}{k}" for k in ("", "_decisions", "_switch_total"))
       for c in ("1", "37", "whole")},
    "region_stream": ("region_counts", "region_partials"),
}


#: The size held against the JAX reference's sharded pipeline: each fleet
#: size compiles the reference's sharded sweep, replay and finalize anew
#: (~9 s on this CPU, run while the ranks run), so one size, the prime that
#: divides nothing, stands for the rest (which the single-device port holds,
#: and the port's single-device path is held to the reference elsewhere).
JAX_SIZE = 11


def _jax_reference(n):
    """The reference's sharded sweep, replay and latency-only score of the
    ``n``-DIMM fleet, from the inputs the ranks draw (``shard_inputs`` on
    the CPU), on its one-lane mesh. Latency-only: with a refresh policy the
    reference's sharded finalize does not finish within minutes on the CPU;
    the refresh figures add to the latency ones and leave them unchanged."""
    import jax.numpy as jnp

    from repro.core import charge as jcharge
    from repro.core import controller as jcontroller
    from repro.core import fleet as jfleet
    from repro.core import perfmodel as jperf
    from repro.core import shard as jshard

    fl, trace, errors, _ = chip_smoke.shard_inputs(torch.device("cpu"), n, STEPS, ERROR_RATE)
    mesh = jshard.fleet_mesh()
    jfl = jfleet.Fleet(jcharge.CellParams(*(jnp.asarray(a.numpy()) for a in fl.cells)),
                       jnp.asarray(fl.vendor.numpy()))
    sweep = jfleet.sweep(jfl, chip_smoke.SHARD_BINS, chip_smoke.SHARD_PATTERNS, impl="ref",
                         mesh=mesh)
    table = sweep.to_table()
    rep = jcontroller.replay(table, jnp.asarray(trace.numpy()), jnp.asarray(errors.numpy()),
                             mesh=mesh)
    score = jperf.trace_score(table.stack, rep, mesh=mesh)
    arrays = {k: np.asarray(getattr(sweep, k)) for k in ("read", "write", "joint")}
    arrays.update({k: np.asarray(getattr(rep, k))
                   for k in ("timings", "bin_idx", "switched", "fused")})
    arrays["state"] = tuple(np.asarray(a) for a in rep.state)
    return {"cells": fl.cells, "trace": trace, "errors": errors, "arrays": arrays,
            "score": {k: float(v) for k, v in score.items()}}


@pytest.fixture(scope="module")
def runs():
    """``(ranks, reference)``: rank 0's ``shard_parity`` results and the
    JAX reference's sharded pipeline, computed at the same time."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(shard.launch, chip_smoke.shard_parity, RANKS, "cpu", "cpu", SIZES,
                            STEPS, CHUNKINGS, ERROR_RATE, 0, TINY_EVAL, True)
        reference = _jax_reference(JAX_SIZE)
        return ranks.result(), reference


@pytest.fixture(scope="module")
def ranks(runs):
    return runs[0]


@pytest.mark.parametrize("path", sorted(MAP_CHECKS))
@pytest.mark.parametrize("n", SIZES)
def test_sharded_map_outputs_bitwise_equal_single_device(ranks, n, path):
    got = {k: ranks[n][k] for k in MAP_CHECKS[path]}
    assert all(v == 0 for v in got.values()), got


@pytest.mark.parametrize("n", SIZES)
def test_sharded_scores_match_single_device(ranks, n):
    r = ranks[n]
    assert r["switch_total"] == 0 and r["score_int"] == 0 and r["region_score_int"] == 0
    assert r["score_err"] <= chip_smoke.SHARD_SCORE_TOL
    assert r["region_score_err"] <= chip_smoke.SHARD_SCORE_TOL
    assert r["stream_score_vs_materialized"] == 0  # bitwise: the same finalize
    assert r["score"]["switches_total"] == float(r["sharded"]["switched"].sum())


def test_ranks_and_reference_draw_the_same_inputs(runs):
    ranks, ref = runs
    got = ranks[JAX_SIZE]["inputs"]
    assert all(torch.equal(a, b) for a, b in zip(got["cells"], ref["cells"]))
    assert torch.equal(got["trace"], ref["trace"]) and torch.equal(got["errors"], ref["errors"])


@pytest.mark.parametrize("part", ["sweep", "replay", "replay_state"])
def test_sharded_map_outputs_equal_jax_reference(runs, part):
    """The ranks' sharded sweep stacks, replay history and final state,
    gathered whole, bitwise the reference's sharded sweep and replay."""
    ranks, ref = runs
    keys = {"sweep": ("read", "write", "joint"),
            "replay": ("timings", "bin_idx", "switched", "fused"),
            "replay_state": ("state",)}[part]
    got = ranks[JAX_SIZE]["sharded"]
    for k in keys:
        a, b = got[k], ref["arrays"][k]
        for x, y in (zip(a, b) if k == "state" else [(a, b)]):
            np.testing.assert_array_equal(x.numpy(), y, err_msg=k)


def test_sharded_score_matches_jax_reference(runs):
    """The ranks' sharded score against the reference's
    ``trace_score(mesh=fleet_mesh())`` of its own sharded replay (the
    latency figures; see :func:`_jax_reference`)."""
    ranks, ref = runs
    got, want = ranks[JAX_SIZE]["score"], ref["score"]
    assert set(want) <= set(got)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-5, abs=1e-5), k


def test_ranks_import_neither_jax_nor_the_reference(ranks):
    assert ranks["foreign_modules"] == []


def test_sharded_trace_eval_replay_parity(ranks):
    rows = {name: value for name, value, _ in ranks["eval_rows"]}
    assert rows["trace/sharded_n_devices"] == RANKS
    assert rows["trace/sharded_replay_parity_exact"] == 1.0
    assert rows["trace/sharded_score_max_rel_err"] <= 1e-4


# ---------------------------------------------------------------------------
# The pure helpers, without ranks
# ---------------------------------------------------------------------------
class _Mesh:
    """The parts of a DeviceMesh the block helpers read: the axis names, the
    axis size and this process's coordinate on it."""

    def __init__(self, size, rank, names=(shard.DIMM_AXIS,)):
        self.mesh_dim_names, self._size, self._rank = names, size, rank

    def size(self, dim=0):
        return self._size

    def get_local_rank(self, name):
        return self._rank


@pytest.mark.parametrize("shards", [1, 2, 3, 4, 8])
def test_padded_size_and_mask(shards):
    for n in SIZES:
        p = shard.padded_size(n, shards)
        assert p % shards == 0 and n <= p < n + shards
        mask = shard.dimm_mask(n, p)
        assert mask.dtype == torch.bool and int(mask.sum()) == n and bool(mask[:n].all())
    with pytest.raises(ValueError):
        shard.padded_size(0, shards)
    with pytest.raises(ValueError):
        shard.padded_size(3, 0)


def test_pad_dimm_replicates_the_edge_and_slice_round_trips():
    cells = fleet.synthesize(torch.Generator().manual_seed(0), 5, device="cpu").cells
    padded = shard.pad_dimm(cells, 8)
    for a, b in zip(padded, cells):
        assert a.shape == (8,) and torch.equal(a[:5], b) and bool((a[5:] == b[4]).all())
    x = torch.arange(15.0).reshape(3, 5)
    px = shard.pad_dimm(x, 7, axis=1)
    assert torch.equal(px[:, 5:], x[:, 4:5].expand(3, 2))
    assert torch.equal(shard.slice_dimm(px, 5, axis=1), x)
    assert shard.pad_dimm(x, 5, axis=1) is x
    with pytest.raises(ValueError):
        shard.pad_dimm(x, 4, axis=1)


def test_padded_block_into_a_buffer_and_from_nothing():
    """The one block layout: columns ``lo:hi``, then the last column, written
    into a buffer of another dtype (the stream's pinned staging copy); an
    empty source pads with zeros (an empty rank's block before a gather)."""
    x = torch.tensor([[True, False, True], [False, True, False]])
    out = torch.full((2, 4), 7, dtype=torch.uint8)
    assert shard.padded_block(x, 1, 2, 4, axis=1, out=out) is out
    assert out.tolist() == [[0, 1, 1, 1], [1, 0, 0, 0]]
    assert torch.equal(shard.padded_block(x, 0, 2, 2, axis=1), x[:, :2])
    empty = shard.padded_block(torch.ones((0, 3)), 0, 0, 2)
    assert torch.equal(empty, torch.zeros((2, 3)))
    with pytest.raises(ValueError):
        shard.padded_block(x, 0, 3, 2, axis=1)


@pytest.mark.parametrize("shards", [1, 2, 3, 4, 8])
def test_local_ranges_and_blocks_tile_the_fleet(shards):
    for n in SIZES + (4099,):
        x = torch.arange(n * 2).reshape(2, n)
        padded = shard.pad_dimm(x, shard.padded_size(n, shards), axis=1)
        ranges, blocks = [], []
        for k in range(shards):
            mesh = _Mesh(shards, k)
            ranges.append(shard.local_range(n, mesh))
            blocks.append(shard.local_block(x, mesh, n, axis=1))
        assert ranges[0][0] == 0 and ranges[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        assert all(0 <= lo <= hi <= n for lo, hi in ranges)
        assert torch.equal(torch.cat(blocks, dim=1), padded)
        assert all(blk.is_contiguous() and blk.shape[1] == shard.block_size(n, _Mesh(shards, 0))
                   for blk in blocks)


def test_n_shards_needs_the_dimm_axis():
    assert shard.n_shards(_Mesh(3, 0)) == 3
    with pytest.raises(ValueError, match="dimm"):
        shard.n_shards(_Mesh(3, 0, names=("data",)))


def test_fleet_mesh_needs_a_process_group():
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="torchrun"):
        shard.fleet_mesh(device="cpu")


def test_sharded_dimm_map_checks_its_flags():
    with pytest.raises(ValueError):
        shard.sharded_dimm_map(lambda x: (x,), _Mesh(2, 0), (0,), (0, 0), 4,
                               gather=(True,))
    np.testing.assert_equal(shard.local_range(2, _Mesh(3, 2)), (2, 2))
