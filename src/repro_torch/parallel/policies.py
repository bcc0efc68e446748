"""Per-(arch × shape) parallelism policy selection.

The port of ``src/repro/parallel/policies.py``, rule for rule. The policy
decides how logical axes map onto the (pod, data, model) mesh, plus the
execution parameters (microbatches, dtypes) of the training step. This is
the worst-case-safe baseline table — the AL-DRAM-style tuner (altune) then
selects faster validated variants per condition bin.

Heuristics (the reference's DESIGN.md §5):
* small models (<1B params): no TP — the model axis joins data parallelism
  (batch over all axes), parameters FSDP over ``data``;
* mid/large dense: Megatron TP over ``model`` + FSDP over ``data``;
* ≥60B and MoE giants: FSDP additionally over ``pod`` when present;
* MoE: experts over ``model`` (EP), capacity rows over ``data``;
* long-context prefill with batch < data-axis: sequence over ``data`` (SP).

The mesh is a ``DeviceMesh`` or a :class:`~.sharding.MeshShape` (no
process group: the rule work at the production meshes).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from repro_torch.models.config import ModelConfig
from repro_torch.optim.adamw import OptConfig
from repro_torch.parallel.sharding import DEFAULT_RULES, ShardingPolicy, axis_names, axis_sizes
from repro_torch.train.step import TrainConfig

#: Parameters at or above this shard over ``pod`` too.
_BIG = 60e9


@dataclasses.dataclass(frozen=True)
class CellPolicy:
    sharding: ShardingPolicy
    train: TrainConfig
    notes: Tuple[str, ...] = ()


def make_policy(mesh, cfg: ModelConfig, cell_kind: str,
                seq_len: int = 4096, global_batch: int = 256) -> CellPolicy:
    n_params = cfg.param_count()
    rules: Dict[str, Tuple[str, ...]] = dict(DEFAULT_RULES)
    notes = []
    names, shape = axis_names(mesh), axis_sizes(mesh)

    small = n_params < 1.0e9
    huge = n_params >= _BIG
    has_pod = "pod" in names

    if small:
        # Pure DP: mesh axes carry batch (as far as the batch divides);
        # params replicated per-chip except FSDP over data.
        rules["batch"] = _fit_batch_axes(mesh, ("pod", "data", "model"), global_batch)
        for k in ("heads", "kv_heads", "ff", "vocab", "experts", "state"):
            rules[k] = ()
        rules["fsdp"] = ("data",)
        notes.append(f"small-arch: DP over {rules['batch']}, FSDP(data), no TP")
    else:
        rules["batch"] = _fit_batch_axes(mesh, ("pod", "data"), global_batch)
        rules["fsdp"] = ("pod", "data") if (huge and has_pod) else ("data",)
        if huge and has_pod:
            notes.append("huge-arch: FSDP over (pod, data)")

    # Sequence parallelism for long prefill when batch underfills data axis.
    data_size = shape.get("data", 1) * shape.get("pod", 1)
    if cell_kind == "prefill" and global_batch < data_size and not small:
        rules["seq"] = ("data",)
        notes.append("SP: sequence over data axis (batch underfills)")

    sharding = ShardingPolicy(mesh=mesh, rules=rules)

    # Execution parameters (the conservative, always-fits set).
    if cell_kind == "train":
        micro = _default_microbatches(cfg, seq_len, global_batch, mesh)
        opt_dtype = "bfloat16" if n_params > 200e9 else "float32"
        param_dtype = "bfloat16" if n_params > 200e9 else "float32"
        accum_dtype = "bfloat16" if n_params > 200e9 else "float32"
        if param_dtype == "bfloat16":
            notes.append("bf16 params+opt+grad-accum (trillion-scale memory)")
        tc = TrainConfig(microbatches=micro, param_dtype=param_dtype,
                         accum_dtype=accum_dtype, opt=OptConfig(state_dtype=opt_dtype))
    else:
        tc = TrainConfig(microbatches=1)
    return CellPolicy(sharding=sharding, train=tc, notes=tuple(notes))


def _fit_batch_axes(mesh, pref: Tuple[str, ...], global_batch: int) -> Tuple[str, ...]:
    """Greedily take mesh axes (in preference order) while the batch still
    divides their product — a 256-batch on a 512-chip mesh must not degrade
    to a replicated batch."""
    names, shape = axis_names(mesh), axis_sizes(mesh)
    axes, prod = [], 1
    for a in pref:
        size = shape.get(a, 1)
        if a in names and global_batch % (prod * size) == 0:
            axes.append(a)
            prod *= size
    return tuple(axes)


def _est_state_bytes(cfg: ModelConfig) -> float:
    return cfg.param_count() * 12.0  # fp32 params + m + v


def _default_microbatches(cfg: ModelConfig, seq_len: int, global_batch: int, mesh) -> int:
    """Conservative: the dominant live set under per-layer remat is the
    layer-boundary residual saves — n_layers × B_micro_local × S × d × 2 B
    — plus a ~4× working set for the active layer. Keep it under ~1.5
    GB/device."""
    shape = axis_sizes(mesh)
    dp = shape.get("pod", 1) * shape.get("data", 1)
    b_local = max(global_batch // dp, 1)
    per_seq_boundary = cfg.n_layers * seq_len * cfg.d_model * 2
    per_seq_working = 4 * seq_len * cfg.d_model * 2
    micro = 1
    while (b_local // micro > 1
           and (b_local // micro) * (per_seq_boundary + per_seq_working) > 1.5e9):
        micro *= 2
    return min(micro, b_local)
