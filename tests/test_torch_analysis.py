"""The port's runtime sanitizers (``repro_torch.analysis``) on the CPU, the
mirror of ``tests/test_sanitizers.py`` where a torch analogue exists, and
the slice's modules importing without JAX.

* ``sanitize()``'s plumbing: bad modes refused, the environment read, a
  disabled scope a no-op; the transfer guard maps onto
  ``torch.cuda.set_sync_debug_mode`` and is a no-op without a card.
* The guards guard: rank promotion raises (or warns) in scope and not
  outside it, rank-0 operands broadcast freely; a NaN is trapped at the op
  that makes it, named.
* ``RetraceCounter``: per-counter deltas over a scope, rows, a
  non-callable refused; and, in a process of its own with a fake process
  group of four ranks, DTensor's sharding propagation seen once for a new
  op signature and then not again (steady state).
* Every module of the slice (``configs``, ``launch/{costing, analytic,
  dryrun, hillclimb}``, ``core/altune/steptuner``, ``analysis``) imports
  with ``jax`` blocked in ``sys.modules`` and imports nothing of ``repro``
  (the same process).
"""

import json
import os
import pathlib
import subprocess
import sys
import textwrap
import warnings

import pytest
import torch

from repro_torch import analysis
from repro_torch.analysis import sanitizers

ROOT = pathlib.Path(__file__).resolve().parents[1]

SLICE = ("repro_torch.configs", "repro_torch.launch.costing", "repro_torch.launch.analytic",
         "repro_torch.launch.dryrun", "repro_torch.launch.hillclimb",
         "repro_torch.core.altune.steptuner", "repro_torch.analysis",
         "repro_torch.analysis.retrace", "repro_torch.analysis.sanitizers")

CHILD = textwrap.dedent('''
    import importlib, json, sys
    sys.modules["jax"] = None          # any import of jax now raises
    mods = %r
    for m in mods:
        importlib.import_module(m)
    leaked = sorted(m for m in sys.modules if m == "repro" or m.startswith("repro."))
    import torch, torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.analysis import RetraceCounter
    from repro_torch.launch.mesh import auto_mesh
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    mesh = auto_mesh((2, 2), ("data", "model"), "cpu")
    x = DTensor.from_local(torch.ones(3, 5), mesh, (Shard(0), Replicate()), run_check=False)
    deltas = []
    for shape in ((3, 5), (3, 5), (3, 7)):
        y = DTensor.from_local(torch.ones(shape), mesh, (Shard(0), Replicate()), run_check=False)
        with RetraceCounter() as rc:
            z = y * 2.0 + y
        deltas.append(rc.deltas["dtensor.sharding_prop"])
    dist.destroy_process_group()
    print("CHILD_JSON" + json.dumps({"leaked": leaked, "jax": sys.modules["jax"] is None,
                                     "deltas": deltas}))
''') % (SLICE,)


@pytest.fixture(scope="module")
def child():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    run = subprocess.run([sys.executable, "-c", CHILD], capture_output=True, text=True,
                         timeout=300, env=env)
    line = [ln for ln in run.stdout.splitlines() if ln.startswith("CHILD_JSON")]
    assert line, run.stdout[-1500:] + run.stderr[-3000:]
    return json.loads(line[0][len("CHILD_JSON"):])


def test_slice_imports_without_jax_or_the_reference(child):
    assert child["jax"] and child["leaked"] == []


def test_retrace_counter_sees_a_new_dtensor_signature_then_none(child):
    first, steady, new_shape = child["deltas"]
    assert first > 0 and steady == 0 and new_shape > 0, child["deltas"]


# ---------------------------------------------------------------------------
# sanitize(): config plumbing
# ---------------------------------------------------------------------------
def test_sanitize_rejects_bad_modes():
    with pytest.raises(ValueError):
        analysis.SanitizeConfig(transfer_guard="never")
    with pytest.raises(ValueError):
        analysis.SanitizeConfig(rank_promotion="explode")


def test_config_from_env(monkeypatch):
    monkeypatch.setenv("REPRO_SANITIZE", "0")
    monkeypatch.setenv("REPRO_TRANSFER_GUARD", "log")
    monkeypatch.setenv("REPRO_RANK_PROMOTION", "warn")
    monkeypatch.setenv("REPRO_DEBUG_NANS", "1")
    cfg = analysis.config_from_env()
    assert cfg == analysis.SanitizeConfig(
        transfer_guard="log", rank_promotion="warn",
        debug_nans=True, enabled=False,
    )


def test_sanitize_disabled_is_a_noop(monkeypatch):
    monkeypatch.setenv("REPRO_SANITIZE", "0")
    with analysis.sanitize(rank_promotion="raise") as cfg:
        assert not cfg.enabled
        assert (torch.ones((2, 3)) + torch.ones((3,))).shape == (2, 3)


@pytest.mark.parametrize("mode", ["allow", "log", "disallow", "log_explicit",
                                  "disallow_explicit"])
def test_transfer_guard_maps_to_sync_debug_mode(mode):
    assert sanitizers.SYNC_DEBUG_MODE[mode] == {"allow": 0, "log": "warn",
                                                "disallow": "error"}[mode.split("_")[0]]
    if not torch.cuda.is_available():  # no card: nothing to wait for, no-op
        with analysis.sanitize(transfer_guard=mode, rank_promotion="allow"):
            assert float(torch.ones(2).sum().item()) == 2.0


# ---------------------------------------------------------------------------
# sanitize(): the guards guard
# ---------------------------------------------------------------------------
def test_rank_promotion_raises_in_scope():
    with analysis.sanitize(rank_promotion="raise"):
        with pytest.raises(ValueError, match="could not be broadcast"):
            torch.ones((2, 3)) + torch.ones((3,))
        with pytest.raises(ValueError, match="could not be broadcast"):
            torch.ones((4, 2)).mul_(torch.ones((2,)))
        # Rank-0 operands and equal ranks broadcast freely, as in jax.
        assert (torch.ones((2, 3)) * torch.tensor(2.0)).shape == (2, 3)
        assert (torch.ones((2, 3)) + torch.ones((1, 3))).shape == (2, 3)
    assert (torch.ones((2, 3)) + torch.ones((3,))).shape == (2, 3)  # outside: allowed


def test_rank_promotion_warns():
    with analysis.sanitize(rank_promotion="warn"):
        with pytest.warns(RuntimeWarning, match="rank promotion"):
            torch.where(torch.ones((2, 3)) > 0, torch.ones((3,)), 0.0)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with analysis.sanitize(rank_promotion="allow"):
            torch.ones((2, 3)) + torch.ones((3,))


def test_debug_nans_traps_nan_birth_at_its_op():
    with analysis.sanitize(debug_nans=True, rank_promotion="allow"):
        x = torch.tensor([1.0, 4.0])
        assert torch.sqrt(x).tolist() == [1.0, 2.0]
        with pytest.raises(FloatingPointError, match="aten.log"):
            torch.log(torch.tensor([-1.0]))
    assert torch.isnan(torch.log(torch.tensor([-1.0]))).all()  # off again


# ---------------------------------------------------------------------------
# RetraceCounter
# ---------------------------------------------------------------------------
def test_retrace_counter_counts_new_builds():
    seen = {"n": 0}

    def build(shape, cache={}):
        if shape not in cache:
            seen["n"] += 1
            cache[shape] = True

    rc = analysis.RetraceCounter({"f": lambda: seen["n"]})
    with rc:
        build((3,))
        build((3,))
        build((4,))
    assert rc.deltas == {"f": 2} and rc.total() == 2
    with rc:
        build((3,))
    assert rc.deltas == {"f": 0}


def test_retrace_counter_rejects_a_non_counter():
    rc = analysis.RetraceCounter({"plain": 3})
    with pytest.raises(TypeError, match="counter"):
        rc.snapshot()


def test_retrace_rows_shape():
    rc = analysis.RetraceCounter({"g": lambda: 1})
    with rc:
        pass
    assert rc.rows(expected={"g": 0}) == (("lint/retrace_g", 0.0, 0.0),)


def test_default_runners():
    assert set(analysis.default_runners()) == {"kernels.build", "kernels.load",
                                               "dtensor.sharding_prop"}
    assert all(v >= 0 for v in analysis.RetraceCounter().snapshot().values())
