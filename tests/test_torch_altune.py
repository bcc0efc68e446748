"""The port's altune (cost model, profiler, table, runtime, margin harvest)
vs the JAX reference, on the CPU.

* The cost model's operation and byte counts are the reference's tiling
  analysis line for line: equal for every reference candidate and shape.
  With the port's card constants patched to the reference's TPU constants
  (and its tile budget opened up, since the reference gates on VMEM) the
  times and bounds are equal too.
* The card gate refuses TPU tilings that cannot exist as one thread block
  on an SM and admits every tile the CUDA kernels are instantiated for.
* ``select``/``margin`` and ``profile_kernel``'s verdicts agree with the
  reference's on the same entries and stub kernels; timing tables cross
  between the packages as JSON; the adaptive executor follows the same
  trace.
* ``launch.altune_margin`` runs end to end on the CPU (the reference's
  scheme: plain versions validated at the small shapes, the cost model at
  the production shapes) in a subprocess that loads no JAX module.
"""

import dataclasses
import math
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import altune_margin as jbench
from repro.core import altune as jaltune
from repro.core.altune import costmodel as jcm
from repro.kernels.flash_decode import ops as jfd_ops
from repro.kernels.latency_matmul import ops as jmm_ops
from repro.kernels.rglru_scan import ops as jsc_ops
from repro_torch.core import altune
from repro_torch.core.altune import costmodel as cm
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.kernels.latency_matmul import ops as mm_ops
from repro_torch.kernels.rglru_scan import ops as sc_ops

ROOT = pathlib.Path(__file__).resolve().parents[1]
PROD = 4096


def _estimate_pairs():
    """(reference Estimate, port Estimate) for every reference candidate at
    the reference's shapes, and every port candidate."""
    port = lambda cls, c: cls(**dataclasses.asdict(c))  # noqa: E731
    mm = list(jmm_ops.CANDIDATES) + [jmm_ops.MMConfig(*dataclasses.astuple(c))
                                     for c in mm_ops.CANDIDATES]
    fa = list(jbench.FA_CANDS) + [jbench.FA_WC.__class__(*dataclasses.astuple(c))
                                  for c in fa_ops.CANDIDATES]
    sc = list(jsc_ops.CANDIDATES) + [jsc_ops.ScanConfig(*dataclasses.astuple(c))
                                     for c in sc_ops.CANDIDATES]
    fd = list(jfd_ops.CANDIDATES) + [jfd_ops.FDConfig(c.bk) for c in fd_ops.CANDIDATES]
    for c in mm:
        for m, k, n, ib in ((PROD, PROD, PROD, 2), (1024, 2048, 512, 4)):
            yield (jcm.matmul_estimate(m, k, n, c, in_bytes=ib),
                   cm.matmul_estimate(m, k, n, port(mm_ops.MMConfig, c), in_bytes=ib))
    for c in fa:
        for causal in (True, False):
            yield (jcm.flash_estimate(8, PROD, PROD, 32, 8, 128, c, causal=causal),
                   cm.flash_estimate(8, PROD, PROD, 32, 8, 128, port(fa_ops.FAConfig, c),
                                     causal=causal))
    for c in sc:
        yield (jcm.scan_estimate(8, PROD, 4096, c), cm.scan_estimate(8, PROD, 4096,
                                                                     port(sc_ops.ScanConfig, c)))
    for c in fd:
        yield (jcm.flash_estimate(8, 1, 32768, 64, 8, 128, jbench.cfg_shim(c), causal=False),
               cm.flash_estimate(8, 1, 32768, 64, 8, 128, fd_ops.FDConfig(c.bk), causal=False,
                                 in_bytes=2))


def test_costmodel_counts_equal_the_reference():
    pairs = list(_estimate_pairs())
    for ref, got in pairs:
        assert ref.feasible
        assert (got.flops, got.hbm_bytes) == (ref.flops, ref.hbm_bytes)


def test_costmodel_times_equal_the_reference_with_its_constants(monkeypatch):
    for name, value in (("FP32_FLOPS", jcm.PEAK_FLOPS), ("HBM_BW", jcm.HBM_BW),
                        ("LAUNCH_OVERHEAD_S", jcm.GRID_OVERHEAD_S),
                        ("STEP_OVERHEAD_S", jcm.STEP_OVERHEAD_S), ("N_SMS", 1),
                        ("SMEM_PER_BLOCK", math.inf), ("REGS_PER_BLOCK", math.inf),
                        ("MAX_REGS_PER_THREAD", math.inf), ("MAX_THREADS_PER_BLOCK", math.inf)):
        monkeypatch.setattr(cm, name, value)
    for ref, got in _estimate_pairs():
        assert got.feasible and got.t_seconds == ref.t_seconds and got.bound == ref.bound


def test_card_gate_refuses_tpu_tiles_and_admits_instantiated_ones():
    refused = [cm.matmul_estimate(PROD, PROD, PROD, mm_ops.MMConfig(512, 512, 1024)),
               cm.matmul_estimate(PROD, PROD, PROD, mm_ops.MMConfig(256, 256, 256)),
               cm.scan_estimate(8, PROD, 4096, sc_ops.ScanConfig(256, 128)),
               cm.flash_estimate(8, PROD, PROD, 32, 8, 128, fa_ops.FAConfig(128, 128))]
    for est in refused:
        assert not est.feasible and est.bound == "infeasible" and est.t_seconds == math.inf
    assert "shared memory" in refused[0].note and refused[1].smem_bytes > cm.SMEM_PER_BLOCK
    admitted = ([cm.matmul_estimate(PROD, PROD, PROD, c) for c in mm_ops.CANDIDATES]
                + [cm.scan_estimate(8, PROD, 4096, c) for c in sc_ops.CANDIDATES]
                + [cm.flash_estimate(8, 1, 32768, 64, 8, dh, c, causal=False)
                   for c in fd_ops.CANDIDATES for dh in (64, 128)]
                + [cm.flash_estimate(8, PROD, PROD, 32, 8, dh, c)
                   for c in fa_ops.CANDIDATES for dh in (32, 64, 128)])
    assert all(e.feasible and 0 < e.t_seconds < math.inf for e in admitted)
    assert fa_ops.WORST_CASE.smem_bytes(128) == 115712  # the .cu's smem_bytes<64, 64, 128>()


def _entries(mod, rows):
    return [mod.ProfileEntry(*r) for r in rows]


@pytest.mark.parametrize("rows", [
    [("wc", True, True, 4.0, "memory"), ("a", True, True, 1.0, "compute"),
     ("b", True, False, 0.5, "compute", "zeros"), ("c", False, False, math.inf, "infeasible")],
    [("wc", True, False, 4.0, "memory", "random"), ("a", True, True, 3.0, "memory", None, False)],
    [("a", True, True, 2.0, "memory"), ("b", True, True, 1.0, "memory")],
])
def test_select_margin_and_fallback_equal_the_reference(rows):
    ref = jaltune.ProfileResult("k", "s", _entries(jaltune.profiler, rows), "wc")
    got = altune.ProfileResult("k", "s", _entries(altune.profiler, rows), "wc")
    assert got.select() == ref.select() and got.margin() == ref.margin()


def test_profile_kernel_verdicts_equal_the_reference():
    def run(x, cfg):
        if cfg == "raises":
            raise ValueError("not instantiated")
        if cfg == "zero-fault" and float(abs(x).max()) == 0.0:
            return x + 1.0
        return x * 1.0

    def results(pkg, est_cls, dev_kw):
        def estimate(cfg):
            return est_cls(cfg != "infeasible", 1e-3 if cfg != "infeasible" else math.inf,
                           1.0, 2.0, 0)
        return pkg.profile_kernel("stub", run_fn=run, ref_fn=lambda x: x,
                                  make_inputs=lambda a: (a,), estimate_fn=estimate,
                                  candidates=("ok", "raises", "zero-fault", "infeasible"),
                                  worst_case="ok", input_shape=(8, 8), **dev_kw)

    ref = results(jaltune, jcm.Estimate, {})
    got = results(altune, cm.Estimate, {"device": "cpu"})
    fields = ("config", "feasible", "validated", "t_seconds", "bound", "fail_pattern",
              "repeat_ok")
    assert [[getattr(e, f) for f in fields] for e in got.entries] == \
        [[getattr(e, f) for f in fields] for e in ref.entries]
    assert got.entries[1].fail_pattern == "random" and got.entries[2].fail_pattern == "zeros"
    assert got.shape_key == ref.shape_key and got.select() == ref.select() == "ok"


def test_patterns_zeros_ones_alternating_equal_the_reference():
    import jax

    ref = dict(jaltune.profiler._patterns(jax.random.PRNGKey(0), (3, 5), jnp.float32))
    got = dict(altune.profiler._patterns(torch.Generator().manual_seed(0), (3, 5),
                                         torch.float32, "cpu"))
    assert list(got) == list(ref)
    for name in ("zeros", "ones", "alternating"):
        assert np.array_equal(got[name].numpy(), np.asarray(ref[name]))


def test_timing_table_json_crosses_both_ways(tmp_path):
    t = altune.TimingTable()
    t.put("latency_matmul", "4096x4096", "h100", "default", mm_ops.MMConfig(128, 128, 16), 0.4)
    t.save(tmp_path / "port.json")
    back = jaltune.TimingTable.load(tmp_path / "port.json")
    assert back.get("latency_matmul", "4096x4096", "h100") == {
        "config": {"bm": 128, "bn": 128, "bk": 16}, "config_type": "MMConfig", "margin": 0.4}
    r = jaltune.TimingTable()
    r.put("flash_decode", "65536", "v5e", "T55", jfd_ops.FDConfig(1024), 0.25)
    r.save(tmp_path / "ref.json")
    got = altune.TimingTable.load(tmp_path / "ref.json")
    assert got.entries == r.entries and got.get("flash_decode", "65536", "v5e", "T55")["margin"] == 0.25
    same = jaltune.TimingTable()
    same.put("latency_matmul", "4096x4096", "h100", "default", jmm_ops.MMConfig(128, 128, 16),
             0.4)
    same.save(tmp_path / "same.json")
    assert (tmp_path / "port.json").read_text() == (tmp_path / "same.json").read_text()
    # A table ingested from a fleet sweep crosses too (its parity with the
    # reference's from_fleet is in tests/test_torch_tables.py).
    from repro_torch.core import fleet

    fl = fleet.synthesize(torch.Generator().manual_seed(0), 3, device="cpu")
    swept = altune.TimingTable.from_fleet(fleet.sweep(fl, (55.0,), (1.0,)), vendor=fl.vendor)
    swept.save(tmp_path / "fleet.json")
    assert jaltune.TimingTable.load(tmp_path / "fleet.json").entries == swept.entries
    assert len(swept.entries) == 3 * 2


def test_adaptive_executor_follows_the_reference():
    loads = [1.0, 1.3, 1.0, 1.0, 1.0, 1.0, 0.9, 1.6, 1.1, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0]
    ref = jaltune.AdaptiveExecutor(["fast", "mid", "slow"], "worst")
    got = altune.AdaptiveExecutor(["fast", "mid", "slow"], "worst")
    for i, load in enumerate(loads):
        for ex in (ref, got):
            if i == 12:
                ex.report_error("u1")
        assert [got.observe(u, load) for u in ("u0", "u1")] == \
            [ref.observe(u, load) for u in ("u0", "u1")]
    assert (got.switches, got.fallbacks) == (ref.switches, ref.fallbacks)
    assert altune.ConditionBins().bin_of(1.1) == jaltune.ConditionBins().bin_of(1.1)


def test_margin_cli_on_the_cpu_end_to_end_without_jax(tmp_path):
    out = tmp_path / "table.json"
    code = (
        "import runpy, sys\n"
        f"sys.argv = ['altune_margin', '--device', 'cpu', '--out', {str(out)!r}]\n"
        "runpy.run_module('repro_torch.launch.altune_margin', run_name='__main__')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, timeout=120)
    assert res.returncode == 0, res.stderr
    rows = dict(line.split(",", 1) for line in res.stdout.splitlines()
                if line.startswith("altune/"))
    n_cands = {"latency_matmul": len(mm_ops.CANDIDATES),
               "flash_attention": len(fa_ops.CANDIDATES),
               "rglru_scan": len(sc_ops.CANDIDATES), "flash_decode": len(fd_ops.CANDIDATES)}
    assert list(rows) == [f"altune/{k}/{r}" for k in n_cands
                          for r in ("margin", "validated_configs")]
    for kernel, n in n_cands.items():
        assert rows[f"altune/{kernel}/validated_configs"] == f"{n},{n}"
        assert 0.0 <= float(rows[f"altune/{kernel}/margin"].rstrip(",")) < 1.0
    table = altune.TimingTable.load(out)
    assert {k[0] for k in table.entries} == set(n_cands)
    assert {k[2] for k in table.entries} == {"h100"}
    fastest = min(fa_ops.CANDIDATES, key=lambda c: cm.flash_estimate(
        8, PROD, PROD, 32, 8, 128, c, in_bytes=4).t_seconds)  # the CPU scheme's latencies
    assert table.get("flash_attention", "65536", "h100")["config"] == dataclasses.asdict(fastest)


def test_entry_points_default_to_the_card():
    from repro_torch.launch import altune_margin

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        altune_margin.run()
    with pytest.raises(RuntimeError, match="cuda"):
        altune.profile_kernel("k", None, None, None, None, (), None, (1,))
