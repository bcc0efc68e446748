"""The port's fault tolerance and training entry point (``ft/``, ``launch/train.py``),
on the CPU: the checkpoint tests of ``tests/test_ft.py`` (roundtrip,
async/latest, CRC, prune, shape mismatch) over the port's tree, bfloat16
leaves and the in-place restore, the monitor, and the launcher's restart of
``tests/test_launch.py`` — here also held to an uninterrupted run.
"""

import json
import pathlib
import shutil
import threading

import numpy as np
import pytest
import torch

import repro_torch.configs as C
from repro_torch.core.altune.runtime import AdaptiveExecutor, ConditionBins
from repro_torch.ft import checkpoint as ckpt
from repro_torch.ft.monitor import FleetMonitor
from repro_torch.launch.train import train
from repro_torch.models import model as lm
from repro_torch.tree import leaves, tree_map


@pytest.fixture()
def state():
    cfg = C.reduced("smollm-135m")
    params = lm.init_params(torch.Generator().manual_seed(0), cfg)
    return {"params": params, "step_scalar": torch.tensor(3, dtype=torch.int32),
            "half": torch.randn((5, 7), generator=torch.Generator().manual_seed(1)).bfloat16()}


def _zeros_like(state):
    return tree_map(torch.zeros_like, state)


def test_roundtrip(tmp_path, state):
    ckpt.save(tmp_path, 11, state)
    target = _zeros_like(state)
    restored, step = ckpt.restore(tmp_path, target)
    assert step == 11 and restored is target
    for a, b in zip(leaves(state), leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    man = json.loads((tmp_path / "step_0000000011" / "manifest.json").read_text())
    assert man["files"]["half"]["dtype"] == "bfloat16"
    assert man["files"]["params/stack/3/attn/wq"]["shape"] == [96, 96]


#: Seconds a test waits for the writer thread before it fails (a write of
#: the reduced state takes milliseconds).
WAIT_S = 120.0


def test_async_and_latest(tmp_path, state):
    ckpt.save_async(tmp_path, 1, state).result(timeout=WAIT_S)
    ckpt.save_async(tmp_path, 2, state).result(timeout=WAIT_S)
    assert ckpt.latest_step(tmp_path) == 2


def test_async_save_holds_the_state_of_its_call(tmp_path, state, monkeypatch):
    """The state is copied when ``save_async`` is called: an in-place update
    made before the write (as the next train step makes) is not in the
    checkpoint. The writer's one thread is held busy until after the update."""
    pool = ckpt.cf.ThreadPoolExecutor(max_workers=1)
    monkeypatch.setattr(ckpt, "_POOL", pool)
    release = threading.Event()
    pool.submit(release.wait, WAIT_S)
    before = tree_map(torch.clone, state)
    try:
        fut = ckpt.save_async(tmp_path, 4, state)
        with torch.no_grad():
            for t in leaves(state):
                t.add_(1)
    finally:
        release.set()
    fut.result(timeout=WAIT_S)
    pool.shutdown()
    restored, step = ckpt.restore(tmp_path, _zeros_like(state))
    assert step == 4
    for a, b in zip(leaves(before), leaves(restored)):
        assert torch.equal(a, b)


def test_crc_detects_corruption(tmp_path, state):
    path = ckpt.save(tmp_path, 5, state)
    man = json.loads((path / "manifest.json").read_text())
    fname = next(iter(man["files"].values()))["file"]
    arr = np.load(path / fname)
    arr.flat[0] = arr.flat[0] + 1
    np.save(path / fname, arr)
    target = _zeros_like(state)
    with pytest.raises(IOError):
        ckpt.restore(tmp_path, target)
    # Nothing was written: every leaf is checked before any is restored.
    assert all(not t.any() for t in leaves(target))


def test_prune_keeps_recent(tmp_path, state):
    for s in range(6):
        ckpt.save(tmp_path, s, state, keep=3)
    dirs = sorted(p.name for p in pathlib.Path(tmp_path).iterdir())
    assert len(dirs) == 3 and dirs[-1] == "step_0000000005"


def test_shape_mismatch_rejected(tmp_path, state):
    ckpt.save(tmp_path, 1, state)
    bad = dict(state, step_scalar=torch.zeros((2,), dtype=torch.int32))
    with pytest.raises((ValueError, KeyError)):
        ckpt.restore(tmp_path, bad)


def test_elastic_restore_waits_for_sharded_training(tmp_path, state):
    """``restore(shardings=)`` returns a new tree and leaves ``state_like``
    as it was; with no leaf placed (no mesh) every leaf is restored as
    without it. Placement under a mesh: tests/test_torch_sharded_train.py."""
    ckpt.save(tmp_path, 1, state)
    like = tree_map(lambda t: torch.zeros_like(t) if isinstance(t, torch.Tensor) else t, state)
    got, step = ckpt.restore(tmp_path, like, shardings={})
    assert step == 1 and got is not like
    for a, b, z in zip(leaves(got), leaves(state), leaves(like)):
        if isinstance(b, torch.Tensor):
            assert torch.equal(a, b) and not z.any()


def test_monitor_straggler_and_plan():
    mon = FleetMonitor(straggler_factor=1.3, patience=3)
    for _ in range(5):
        for h in ("h0", "h1", "h2"):
            mon.record_step(h, 1.0, now=100.0)
        mon.record_step("h3", 2.0, now=100.0)
    assert mon.stragglers() == ["h3"]
    mon.record_error("h1")
    plan = mon.plan(now=100.0 + 301)
    assert plan["restore"] == ["h1"] and sorted(plan["evict"]) == ["h0", "h1", "h2", "h3"]
    ex = AdaptiveExecutor(configs_by_bin=["fast", "fast", "safe"], worst_case="safe",
                          bins=ConditionBins(edges=(1.1, 1.3)))
    assert ex.observe("h3", mon.load_of("h3")) == "safe"


def test_train_launcher_checkpoint_restart(tmp_path):
    kw = dict(batch=4, seq=32, ckpt_every=3, log_every=100, device="cpu")
    _, _, losses1 = train("smollm-135m", steps=6, ckpt_dir=str(tmp_path), **kw)
    # Restart: resumes from step 6's checkpoint and continues.
    _, opt, losses2 = train("smollm-135m", steps=9, ckpt_dir=str(tmp_path), **kw)
    assert len(losses1) == 6 and len(losses2) == 3  # only steps 6..8 ran
    assert int(opt["step"]) == 9 and np.isfinite(losses2).all()


def test_train_resume_replays_the_run(tmp_path):
    """A run resumed from its step-6 checkpoint takes the same steps 6..8 as
    the run that went on: the state is restored bitwise and the data is a
    function of the step."""
    kw = dict(steps=9, batch=4, seq=32, ckpt_dir=str(tmp_path), ckpt_every=3, log_every=100,
              device="cpu")
    full_params, _, full_losses = train("smollm-135m", **kw)
    shutil.rmtree(tmp_path / "step_0000000009")
    params, _, losses = train("smollm-135m", **kw)
    assert losses == full_losses[6:]
    for a, b in zip(leaves(params), leaves(full_params)):
        assert torch.equal(a, b)


def test_train_launcher_refuses_a_mesh():
    """``train(mesh=)`` takes a DeviceMesh (tests/test_torch_sharded_train.py
    trains on one); a mesh without devices, the rule-work ``MeshShape``, is
    refused."""
    from repro_torch.parallel.sharding import MeshShape

    with pytest.raises(TypeError, match="DeviceMesh"):
        train("smollm-135m", steps=1, mesh=MeshShape(("data",), (1,)), device="cpu")
