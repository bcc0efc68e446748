"""The port's cost model (``launch/analytic.py``, ``launch/costing.py``), its
step tuner (``core/altune/steptuner.py``) and the shape cells against the
JAX reference, on the CPU.

* Analytic parity: for every arch × ``applicable_cells`` × the production
  (16, 16) and (2, 16, 16) meshes, under ``make_policy``'s policy and the
  default and block-skip execution flags, the port's ``fwd_flops``
  (executed and useful), ``train_bytes`` / ``prefill_bytes`` /
  ``decode_bytes``, ``train_collectives`` / ``serve_collectives``, the
  memory models (the same state and cache bytes given to both) and
  ``cell_roofline`` equal the reference's within 1e-12 relative (decode
  cells at the default flags only: block-skip changes no decode formula).
  Times are compared as totals over the constants (``t_compute`` × chips ×
  peak FLOP/s, and so on), and the bottleneck not at all, since the port's
  constants are an H100's on purpose. The reference's side comes from one
  subprocess on 512 XLA host devices (``tests/test_launch.py``'s setting)
  that prints JSON; it takes
  each config's parameter counts from the port's (its ``param_count``
  traces ``init_params`` at every call; the counts' parity is tested in
  ``test_torch_lm_families.py`` and ``test_torch_moe.py``).
* Step-tuner parity: ``tune_train_cell`` at ``hbm_budget`` = 16 GiB picks
  the reference's candidate for every train cell, with the reference's
  constants put into the port's analytic model for the comparison (the
  ranking depends on the constants' ratios); its bound times the
  constants' ratio equals the reference's.
* FLOPs against executed code, the mirror of
  ``tests/test_analytic.py::test_analytic_flops_match_hlo``: for the same
  four (arch, layer) pairs the analytic one-layer FLOPs over
  ``FlopCounterMode``'s count of the port's layer forward on fake tensors
  at full width (B 1, S 512, one attention chunk) lie in 0.85–1.15.
* ``configs.SHAPES`` and ``applicable_cells`` equal the reference's;
  ``HBM_BUDGET`` is the card's 79 GiB.
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest
import torch

import repro_torch.configs as C
from repro_torch.core.altune import steptuner
from repro_torch.launch import analytic, costing
from repro_torch.parallel import policies
from repro_torch.parallel.sharding import MeshShape

ROOT = pathlib.Path(__file__).resolve().parents[1]
REL = 1e-12
MESHES = {"single": (("data", "model"), (16, 16)),
          "multi": (("pod", "data", "model"), (2, 16, 16))}
GIB16 = 16 * 2**30
#: Cells of all ten archs: 10 × (train, prefill) + 9 causal decodes + 3
#: subquadratic long decodes.
N_CELLS = 31
#: Grid entries a mesh: every cell at the default flags, the 20 train and
#: prefill cells also at block-skip.
N_ENTRIES = N_CELLS + 20

#: The grid both sides walk; ``analytic``, ``policies``, the configs
#: module and the two meshes are each side's own. The state bytes are the
#: fully sharded float32 state (12 B a parameter over the mesh), the cache
#: bytes 1 GiB: the same numbers on both sides.
GRID = textwrap.dedent('''
    def grid(C, analytic, policies, meshes, tune, budget):
        import dataclasses
        out, tuned = {}, {}
        for mname, mesh in meshes.items():
            chips = 1
            for v in mesh.shape.values():
                chips *= v
            for arch in C.ARCH_IDS:
                cfg = C.get(arch)
                state = int(cfg.param_count() * 12 // chips)
                for cname in C.applicable_cells(arch):
                    cell = C.SHAPES[cname]
                    b, s, kind = cell.global_batch, cell.seq_len, cell.kind
                    pa = policies.make_policy(mesh, cfg, kind, s, b)
                    pol, tc = pa.sharding, pa.train
                    # Block-skip changes no decode formula.
                    flag_sets = [("base", {})] + ([] if kind == "decode" else
                                                  [("skip", {"causal_block_skip": True})])
                    for fname, extra in flag_sets:
                        flags = analytic.ExecFlags(remat=(kind == "train" and tc.remat),
                                                   chunk_len=cfg.chunk_len, **extra)
                        cfg1 = dataclasses.replace(cfg, attn_block_skip=bool(extra))
                        r = {}
                        q = 1 if kind == "decode" else s
                        r["fwd_exec"] = analytic.fwd_flops(cfg1, b, q, s, flags, useful=False)
                        r["fwd_useful"] = analytic.fwd_flops(cfg1, b, q, s, flags, useful=True)
                        if kind == "train":
                            r["bytes"] = analytic.train_bytes(cfg1, b, s, tc, flags)
                            r["coll"] = analytic.train_collectives(cfg1, b, s, tc, pol, flags)
                            m = analytic.train_memory_model(cfg1, b, s, tc, pol, mesh, state)
                        else:
                            r["bytes"] = (analytic.prefill_bytes(cfg1, b, s, flags)
                                          if kind == "prefill"
                                          else analytic.decode_bytes(cfg1, b, s, tc))
                            r["coll"] = analytic.serve_collectives(cfg1, b, s, pol, flags,
                                                                   decode=kind == "decode")
                            m = analytic.serve_memory_model(cfg1, b, s, kind, pol, mesh,
                                                            state, 2**30)
                        r["memory"] = {k: v for k, v in m.items() if not k.startswith("fits")}
                        roof = analytic.cell_roofline(cfg1, arch, cname, kind, b, s, pol, tc,
                                                      flags, chips, mname).as_dict()
                        r["roof"] = {k: v for k, v in roof.items()
                                     if not k.startswith("t_") and k != "bottleneck"}
                        r["roof_totals"] = [roof["t_compute"] * chips * analytic.PEAK_FLOPS,
                                            roof["t_memory"] * chips * analytic.HBM_BW,
                                            roof["t_collective"] * chips * analytic.ICI_BW]
                        out[f"{arch}|{cname}|{mname}|{fname}"] = r
                    if kind == "train":
                        t = tune(cfg, b, s, pa, mesh, state, hbm_budget=budget)
                        tuned[f"{arch}|{mname}"] = [t.candidate.describe(), t.bound_s,
                                                    t.feasible, t.baseline_bound_s]
        return out, tuned
''')

REFERENCE = GRID + textwrap.dedent('''
    import json, os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import sys
    import repro.configs as C
    from repro.models import model as jlm
    # The reference counts parameters by tracing init_params (eval_shape) at
    # every call, a second a config; take each whole config's counts (total,
    # active) from the port's instead, which equal the reference's
    # (test_torch_lm_families.py and test_torch_moe.py hold them so).
    _count, _given = jlm.count_params_analytic, json.loads(sys.argv[1])
    def _counted(cfg, active_only=False):
        got = _given.get(cfg.name)
        if got is None or got[0] != cfg.n_layers:
            return _count(cfg, active_only=active_only)
        return got[2 if active_only else 1]
    jlm.count_params_analytic = _counted
    from repro.core.altune.steptuner import tune_train_cell
    from repro.launch import analytic
    from repro.launch.mesh import make_production_mesh
    from repro.parallel import policies
    meshes = {"single": make_production_mesh(multi_pod=False),
              "multi": make_production_mesh(multi_pod=True)}
    out, tuned = grid(C, analytic, policies, meshes, tune_train_cell, 16 * 2**30)
    print("REF_JSON" + json.dumps({"grid": out, "tuned": tuned,
                                   "constants": [analytic.PEAK_FLOPS, analytic.HBM_BW,
                                                 analytic.ICI_BW],
                                   "shapes": {k: list(v.__dict__.values())
                                              for k, v in C.SHAPES.items()},
                                   "cells": {a: list(C.applicable_cells(a))
                                             for a in C.ARCH_IDS}}))
''')


def _port_grid():
    scope = {}
    exec(GRID, scope)
    meshes = {k: MeshShape(*v) for k, v in MESHES.items()}
    return scope["grid"](C, analytic, policies, meshes, steptuner.tune_train_cell, GIB16)


@pytest.fixture(scope="module")
def ref():
    counts = {c.name: [c.n_layers, c.param_count(), c.active_param_count()]
              for c in map(C.get, C.ARCH_IDS)}
    run = subprocess.run([sys.executable, "-c", REFERENCE, json.dumps(counts)],
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    line = [ln for ln in run.stdout.splitlines() if ln.startswith("REF_JSON")]
    assert line, run.stdout[-1500:] + run.stderr[-3000:]
    return json.loads(line[0][len("REF_JSON"):])


@pytest.fixture(scope="module")
def port():
    return _port_grid()


def _close(a, b, where):
    if isinstance(a, dict):
        assert set(a) == set(b), (where, sorted(a), sorted(b))
        for k in a:
            _close(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{where}/{i}")
    elif isinstance(a, (int, float)) and not isinstance(a, bool):
        assert abs(a - b) <= REL * max(abs(a), abs(b)), (where, a, b)
    else:
        assert a == b, (where, a, b)


def test_shape_cells_match_reference(ref):
    assert {k: [v.name, v.seq_len, v.global_batch, v.kind] for k, v in C.SHAPES.items()} \
        == ref["shapes"]
    assert {a: list(C.applicable_cells(a)) for a in C.ARCH_IDS} == ref["cells"]
    assert sum(len(v) for v in ref["cells"].values()) == N_CELLS


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_analytic_matches_reference(ref, port, mesh):
    keys = [k for k in ref["grid"] if k.split("|")[2] == mesh]
    assert len(keys) == N_ENTRIES
    grid, _ = port
    for k in keys:
        _close(grid[k], ref["grid"][k], k)


def test_steptuner_picks_the_references_candidate(ref, monkeypatch):
    peak, hbm, ici = ref["constants"]
    for name, v in (("PEAK_FLOPS", peak), ("HBM_BW", hbm), ("ICI_BW", ici)):
        monkeypatch.setattr(analytic, name, v)
    _, tuned = _port_grid()
    assert len(tuned) == 20 and set(tuned) == set(ref["tuned"])
    for k, (cand, bound, feasible, base) in ref["tuned"].items():
        assert tuned[k][0] == cand and tuned[k][2] == feasible, (k, tuned[k], cand)
        _close(tuned[k][1], bound, k)
        _close(tuned[k][3], base, k)


def test_steptuner_at_the_cards_constants_never_worse(port):
    """At the H100's constants and budget the tuner's AL-DRAM guarantee
    holds for every train cell: the selection's bound is no larger than the
    baseline's."""
    meshes = {k: MeshShape(*v) for k, v in MESHES.items()}
    for mname, mesh in meshes.items():
        for arch in C.ARCH_IDS:
            cfg = C.get(arch)
            pa = policies.make_policy(mesh, cfg, "train", 4096, 256)
            t = steptuner.tune_train_cell(cfg, 256, 4096, pa, mesh,
                                          int(cfg.param_count() * 12 // 256))
            assert t.bound_s <= t.baseline_bound_s * (1 + 1e-12), (arch, mname)
            assert t.speedup >= 1.0 - 1e-12


def test_constants_are_the_h100s():
    assert (costing.PEAK_FLOPS, costing.HBM_BW, costing.ICI_BW) == (989e12, 3.35e12, 450e9)
    assert steptuner.HBM_BUDGET == analytic.HBM_BYTES == 79 * 2**30


B, S = 1, 512
FLOP_CASES = [("llama3.2-3b", 0), ("deepseek-moe-16b", 2), ("recurrentgemma-9b", 0),
              ("xlstm-125m", 0)]


@pytest.mark.parametrize("arch,layer", FLOP_CASES)
def test_analytic_flops_match_executed_layer(arch, layer):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.models import stack
    from repro_torch.models.rope import default_positions

    cfg = dataclasses.replace(C.get(arch), chunk_len=S)
    kind, use_moe = cfg.mixer_of(layer), cfg.uses_moe(layer)
    with FakeTensorMode():
        p = stack.init_layer(torch.Generator().manual_seed(0), cfg, layer, torch.bfloat16)
        x = torch.zeros((B, S, cfg.d_model), dtype=torch.bfloat16)
        pos = default_positions(cfg, B, S)
        with torch.no_grad(), FlopCounterMode(display=False) as fc:
            stack.apply_layer(p, x, cfg, kind, use_moe, pos)
    executed = fc.get_total_flops()
    flags = analytic.ExecFlags(chunk_len=S)
    ana = analytic._mixer_flops(cfg, kind, B, S, S, flags, useful=False)
    if cfg.ffn_variant != "none" and kind not in ("mlstm", "slstm"):
        ana += (analytic._moe_flops(cfg, B, S, flags, useful=False) if use_moe
                else analytic._ffn_flops(cfg, B, S))
    assert 0.85 <= ana / executed <= 1.15, (arch, kind, ana / executed)
