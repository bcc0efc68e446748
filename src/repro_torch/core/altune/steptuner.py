"""Step-level auto-tuner: the §Perf hillclimb as an algorithm.

For a (arch × shape × mesh) cell this enumerates execution-parameter
candidates — microbatch count, remat/offload mode, attention block-skip,
KV chunk — exactly the knobs a human tuned in EXPERIMENTS.md §Perf, and
selects automatically the AL-DRAM way:

1. **feasibility gate** (the timing-violation analogue): the analytic
   per-device memory model must fit the HBM budget; infeasible candidates
   are never ranked, however fast;
2. **rank** by the roofline step lower bound max(t_comp, t_mem, t_coll);
3. **fallback**: the baseline (worst-case-safe) configuration is always a
   candidate, so selection can never do worse than the conservative
   default.

`benchmarks/steptuner_bench.py` runs it over every train cell and shows it
re-discovering the manual §Perf moves (offload+micro↓ for the 1T MoE,
block-skip everywhere it pays).

The port of ``src/repro/core/altune/steptuner.py``, candidate for
candidate, over the port's :mod:`repro_torch.launch.analytic` (its H100
constants) and a mesh that is a ``DeviceMesh`` or a
``parallel.sharding.MeshShape``. The budget is one H100's
(:data:`HBM_BUDGET`); ``hbm_budget`` takes another, as the reference's
16 GiB for a parity check.

The feasibility gate is the reference's analytic memory model, which
counts no gradients and no compute-dtype copies of the parameters, so on
the card it reads low: 42.76 GiB modelled against a measured 55.76 GiB peak
(0.7668) for Llama-3.2-3B's 2 × 1,024 step on one NVIDIA H100 80GB HBM3 at
700.00 W (``chip_smoke.py`` phase 22(b)). A candidate modelled above about
0.77 of the budget (~61 GiB of 79) can pass the gate and still run out of
memory; the dry run's MemTracker peak (``launch.dryrun``: 0.9772 of the
measured peak in the same run) is the closer check.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Tuple

from repro_torch.launch import analytic
from repro_torch.models.config import ModelConfig
from repro_torch.parallel.policies import CellPolicy
from repro_torch.parallel.sharding import axis_sizes, mesh_size

#: One NVIDIA H100 80GB HBM3's budget: 79 GiB (``analytic.HBM_BYTES``: the
#: card's 79.18 GiB total as ``torch.cuda.mem_get_info`` reports it,
#: ``chip_smoke.TRAIN_PEAK_GIB``).
HBM_BUDGET = analytic.HBM_BYTES


@dataclasses.dataclass(frozen=True)
class StepCandidate:
    microbatches: int
    remat_offload: bool
    block_skip: bool
    chunk_len: int

    def describe(self) -> str:
        bits = [f"micro={self.microbatches}", f"chunk={self.chunk_len}"]
        if self.remat_offload:
            bits.append("offload")
        if self.block_skip:
            bits.append("block-skip")
        return "+".join(bits)


@dataclasses.dataclass
class TunedCell:
    candidate: StepCandidate
    bound_s: float
    bottleneck: str
    mem_gb: float
    feasible: bool
    baseline_bound_s: float

    @property
    def speedup(self) -> float:
        return self.baseline_bound_s / self.bound_s if self.bound_s else 1.0


def _evaluate(
    cfg: ModelConfig, b: int, s: int, cand: StepCandidate,
    pol: CellPolicy, mesh, state_bytes: int,
) -> Tuple[float, str, Dict]:
    tc = dataclasses.replace(
        pol.train, microbatches=cand.microbatches,
        remat_offload=cand.remat_offload,
    )
    flags = analytic.ExecFlags(
        causal_block_skip=cand.block_skip,
        remat=tc.remat,
        chunk_len=cand.chunk_len,
    )
    cfg1 = dataclasses.replace(
        cfg, attn_block_skip=cand.block_skip, chunk_len=cand.chunk_len
    )
    roof = analytic.cell_roofline(
        cfg1, cfg.name, "train_4k", "train", b, s,
        pol.sharding, tc, flags, chips=mesh_size(mesh), mesh_desc="tuner",
    )
    mem = analytic.train_memory_model(
        cfg1, b, s, tc, pol.sharding, mesh, state_bytes
    )
    bound = max(roof.t_compute, roof.t_memory, roof.t_collective)
    return bound, roof.bottleneck, mem


def tune_train_cell(
    cfg: ModelConfig, b: int, s: int, pol: CellPolicy, mesh,
    state_bytes: int,
    micro_options: Optional[List[int]] = None,
    hbm_budget: int = HBM_BUDGET,
) -> TunedCell:
    shape = axis_sizes(mesh)
    dp = 1
    for a in pol.sharding.rules.get("batch", ()):
        dp *= shape.get(a, 1)
    b_local = max(b // dp, 1)
    if micro_options is None:
        micro_options = [m for m in (1, 2, 4, 8, 16, 32) if m <= b_local]

    baseline = StepCandidate(
        microbatches=pol.train.microbatches, remat_offload=False,
        block_skip=False, chunk_len=cfg.chunk_len,
    )
    base_bound, _, base_mem = _evaluate(cfg, b, s, baseline, pol, mesh, state_bytes)

    best: Optional[TunedCell] = None
    for micro, offload, skip, chunk in itertools.product(
        micro_options, (False, True), (False, True), (256, 512)
    ):
        cand = StepCandidate(micro, offload, skip, chunk)
        bound, bottleneck, mem = _evaluate(cfg, b, s, cand, pol, mesh, state_bytes)
        feasible = mem["total"] <= hbm_budget
        if not feasible:
            continue
        cell = TunedCell(cand, bound, bottleneck, mem["total_gb"], True, base_bound)
        if best is None or cell.bound_s < best.bound_s:
            best = cell
    if best is None:  # nothing fits — fall back to the conservative baseline
        return TunedCell(
            baseline, base_bound, "infeasible", base_mem["total_gb"],
            False, base_bound,
        )
    return best
