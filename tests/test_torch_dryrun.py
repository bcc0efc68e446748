"""The port's dry run (``launch/dryrun.py``) and hill climb
(``launch/hillclimb.py``) on the CPU.

* One reduced cell (llama3.2-3b cut to 1 layer, a train step of 8 × 64
  tokens) dry-run on a fake (2, 2) process group in a process of its own
  (``dryrun.run_cell``, once for the module): the step completes on fake
  tensors, the per-rank state bytes read from the local shards equal
  ``analytic.tree_device_bytes`` of the same policy's specs over a
  ``MeshShape`` (computed here, without a process group), the record has
  every field of the reference's (``memory_analysis`` → MemTracker's
  peak, ``cost_analysis`` → the executed FLOPs, bytes and collectives),
  the peak holds at least the state, and DTensor's sharding propagation
  runs in the first, unmeasured run of the step and not in the measured
  one.
* The same record's collectives: the FSDP traffic that DTensor runs
  inside its own dispatch (weights gathered over ``data`` for each use,
  gradients reduce-scattered back to their shards) is counted. Each
  gradient's reduce-scatter leaves the rank its shard in bfloat16, so the
  reduce-scatter bytes equal the local elements of the parameters sharded
  over ``data`` at 2 bytes (the replicated norms are all-reduced
  instead). The all-gathers and reduce-scatters together lie within
  0.5–1.5 of ``analytic.train_collectives``' FSDP term: that model charges
  each parameter gathered whole per pass (forward, its recompute,
  backward) and its gradient whole in bfloat16, the executed count each
  collective's result on this rank (a gather split over ``model`` still,
  and some weights gathered again for the ``model`` axis), the same order.
  A count that misses DTensor's own collectives sees only the explicit
  redistributions, the embedding table's gather among them (0.16 of the
  term).
* ``hillclimb.run_variant`` without the dry run: block-skip on
  llama3.2-3b × train_4k at the single-pod mesh never raises the bound.
"""

import dataclasses
import json

import pytest
import torch
from torch.distributed.tensor import Shard

import repro_torch.configs as C
from repro_torch.configs import ShapeCell
from repro_torch.launch import analytic, dryrun, hillclimb
from repro_torch.models import model as lm
from repro_torch.parallel import policies
from repro_torch.parallel.sharding import MeshShape, param_specs
from repro_torch.train.step import init_train_state
from repro_torch.tree import leaves

ARCH = "llama3.2-3b"
CELL = ShapeCell("train_8x64", 64, 8, "train")
MESH = (2, 2)
FIELDS = {"arch", "cell", "mesh", "chips", "ok", "policy_notes", "microbatches",
          "train_config", "roofline", "memory", "t_setup_s", "t_step_s", "executed",
          "analytic_memory", "retrace_first", "retrace"}
MEMORY = {"state_bytes_per_device", "state_bytes_analytic", "cache_bytes_per_device",
          "peak_bytes_per_device", "total_per_device_gb", "fits_80gb"}


def _cfg():
    return dataclasses.replace(C.reduced(ARCH), n_layers=1)


@pytest.fixture(scope="module")
def record():
    return dryrun.run_cell(ARCH, CELL, MESH, cfg=_cfg(), mesh_name="fake-2x2", timeout=300)


def _placed(cfg):
    """The policy's parameters, moments and placed specs over a
    ``MeshShape`` (no process group)."""
    mesh = MeshShape(("data", "model"), MESH)
    pol = policies.make_policy(mesh, cfg, "train", CELL.seq_len, CELL.global_batch)
    params, opt = init_train_state(torch.Generator().manual_seed(0), cfg, pol.train)
    placed = param_specs(lm.logical_specs(params, cfg), params, pol.sharding)
    return pol, params, opt, placed


def test_dry_run_of_a_reduced_cell_on_a_fake_group(record):
    r = record
    cfg = _cfg()
    assert r["ok"], r.get("traceback", r)
    assert FIELDS <= set(r) and MEMORY <= set(r["memory"]), sorted(r)
    assert r["chips"] == 4 and r["mesh"] == "fake-2x2" and r["cell"] == CELL.name
    json.dumps(r)  # the record is what the CLI writes

    # The same policy's specs, over a MeshShape (no process group).
    _, params, opt, placed = _placed(cfg)
    want = sum(analytic.tree_device_bytes(t, placed) for t in (params, opt["m"], opt["v"]))
    mem = r["memory"]
    assert mem["state_bytes_per_device"] == mem["state_bytes_analytic"] == want
    assert want < 3 * sum(t.numel() * t.element_size() for t in leaves(params))  # sharded
    assert mem["peak_bytes_per_device"] >= want and mem["fits_80gb"]
    ex = r["executed"]
    assert ex["flops_per_device"] > 0 and ex["bytes_per_device"] > 0
    assert r["roofline"]["chips"] == 4 and r["analytic_memory"]["state"] == want
    # The first run propagates each new op signature's sharding; the
    # measured run after it, the same step, propagates none.
    assert r["retrace_first"]["dtensor.sharding_prop"] > 0
    assert r["retrace"]["dtensor.sharding_prop"] == 0, r["retrace"]


def test_dry_run_counts_the_fsdp_collectives_of_dtensor(record):
    assert record["ok"], record.get("traceback", record)
    cfg = _cfg()
    pol, params, _, placed = _placed(cfg)
    coll = record["executed"]["collectives_bytes"]
    # Local elements of the parameters sharded over "data" (the mesh's first axis).
    sharded = sum(analytic.tree_device_bytes(t, p) // t.element_size()
                  for t, p in zip(leaves(params), leaves(placed))
                  if isinstance(p.placements[0], Shard))
    assert coll["reduce-scatter"] == 2 * sharded, (coll, sharded)
    flags = analytic.ExecFlags(remat=pol.train.remat, chunk_len=cfg.chunk_len)
    fsdp = analytic.train_collectives(cfg, CELL.global_batch, CELL.seq_len, pol.train,
                                      pol.sharding, flags)["fsdp"]
    assert 0.5 <= (coll["all-gather"] + coll["reduce-scatter"]) / fsdp <= 1.5, (coll, fsdp)


def test_hillclimb_block_skip_never_raises_the_bound():
    r = hillclimb.run_variant(ARCH, "train_4k", "single-pod-16x16", "block_skip", lower=False)
    d = r["delta"]
    assert d["lower_bound_speedup"] >= 1.0
    assert r["baseline"]["chips"] == r["optimized"]["chips"] == 256
    assert r["optimized"]["flops_exec"] < r["baseline"]["flops_exec"]
