"""First-principles roofline terms per (arch × shape × policy).

Why analytic: XLA's ``cost_analysis`` counts every ``scan``/while body once
(verified — DESIGN.md §6), and our stacks are scans of scans (layer groups
× microbatches × attention KV chunks), so raw HLO numbers undercount by
data-dependent trip products. Instead we enumerate the executed operations
from the config — every matmul/recurrence/collective with its exact shape —
and cross-validate the per-group-body slice against the compiled HLO
(launch/dryrun.py prints both; they agree to within the fudge-free terms).

Two FLOP counts are reported:
* ``flops_exec``  — what the implementation executes (includes causal-mask
  waste in chunked attention, MoE capacity padding, remat recompute);
* ``flops_model`` — 6·N·D (dense) / 6·N_active·D (MoE) useful-work floor.

Their ratio is the §Roofline "useful fraction"; §Perf iterations close the
gap (block-skip causal attention, tighter capacity factor, …).

All byte/flop totals are GLOBAL; roofline terms divide by chip count per
the brief's formulas.

The port of ``src/repro/launch/analytic.py``: pure arithmetic on a config,
copied formula for formula, with the port's H100 constants
(:mod:`.costing`). Where the reference reads a JAX mesh's ``shape`` the
port reads ``parallel.sharding.axis_sizes`` of a ``DeviceMesh`` or of a
``MeshShape`` (no process group), so the hill climb and the step tuner
run on a laptop at the production meshes; :func:`tree_device_bytes`
reads DTensor placements or the ``Placed`` leaves of ``param_specs``. The
memory models report ``fits_80gb`` (:data:`HBM_BYTES`) where the
reference reports its 16 GiB chip's fit.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.launch.costing import HBM_BW, ICI_BW, PEAK_FLOPS
from repro_torch.models.config import ModelConfig
from repro_torch.parallel.sharding import axis_sizes
from repro_torch.train.step import TrainConfig

BF16 = 2
F32 = 4
#: The memory a step may take on one NVIDIA H100 80GB HBM3: 79 GiB of the
#: 79.18 GiB that ``torch.cuda.mem_get_info`` reports as the card's total,
#: the limit ``chip_smoke.TRAIN_PEAK_GIB`` holds the card's training runs
#: to.
HBM_BYTES = 79 * 2**30


@dataclasses.dataclass(frozen=True)
class ExecFlags:
    """Execution-parameter knobs the §Perf loop tunes (the AL-DRAM
    "timing parameters" of the compiled step)."""

    causal_block_skip: bool = False   # skip fully-masked KV chunks
    remat: bool = True                # full per-group remat
    capacity_factor: Optional[float] = None  # override MoE capacity
    chunk_len: int = 256
    compress_pod_grads: bool = False  # int8 over the pod axis


def _attn_flops(cfg, b, s, skv, kind, flags: ExecFlags, useful: bool) -> float:
    h, dh, hk, d = cfg.n_heads, cfg.d_head, cfg.n_kv_heads, cfg.d_model
    proj = 2 * b * s * d * (h + 2 * hk) * dh + 2 * b * s * h * dh * d
    skv_eff = min(skv, cfg.window) if (kind == "local" and cfg.window) else skv
    if useful and cfg.causal and s > 1:
        pair = s * skv_eff / 2
    elif flags.causal_block_skip and cfg.causal and s > 1:
        pair = s * skv_eff / 2 + s * flags.chunk_len / 2  # block-diagonal edge
    else:
        pair = s * skv_eff
    core = 2 * 2 * b * h * dh * pair
    return proj + core


def _ffn_flops(cfg, b, s) -> float:
    mats = 2 if cfg.ffn_variant == "gelu" else 3
    return 2 * b * s * cfg.d_model * cfg.d_ff * mats


def _moe_flops(cfg, b, s, flags: ExecFlags, useful: bool) -> float:
    moe = cfg.moe
    d, fe = cfg.d_model, moe.d_ff_expert
    router = 2 * b * s * d * moe.n_experts
    cf = 1.0 if useful else (flags.capacity_factor or moe.capacity_factor)
    routed = 2 * b * s * moe.top_k * cf * d * fe * 3
    shared = 2 * b * s * d * (moe.n_shared * fe) * 3
    return router + routed + shared


def _mixer_flops(cfg, kind, b, s, skv, flags, useful) -> float:
    d = cfg.d_model
    if kind in ("global", "local"):
        return _attn_flops(cfg, b, s, skv, kind, flags, useful)
    if kind == "mlstm":
        di = int(d * cfg.mlstm_proj_factor)
        h = cfg.n_heads
        dh = di // h
        lc = min(flags.chunk_len, s)
        proj = 2 * b * s * (d * 2 * di + 3 * di * di + di * d)
        quad = 2 * 2 * b * h * s * lc * dh        # intra-chunk scores+av
        state = 2 * 3 * b * h * s * dh * dh       # inter-chunk C q / C update
        conv = 2 * b * s * di * cfg.conv_width
        return proj + quad + state + conv
    if kind == "slstm":
        h = cfg.n_heads
        dh = d // h
        dff = int(d * cfg.slstm_proj_factor)
        wx = 2 * b * s * d * 4 * d
        rec = 2 * b * s * h * dh * 4 * dh
        mlp = 2 * b * s * d * 2 * dff + 2 * b * s * dff * d
        return wx + rec + mlp + 20 * b * s * d
    if kind == "rglru":
        dr = d
        h = cfg.n_heads
        drh = dr // h
        branches = 2 * b * s * d * dr * 2 + 2 * b * s * dr * d
        gates = 2 * 2 * b * s * h * drh * drh
        scan = 12 * b * s * dr
        conv = 2 * b * s * dr * cfg.conv_width
        return branches + gates + scan + conv
    raise ValueError(kind)


def _layer_kinds(cfg: ModelConfig):
    for i in range(cfg.n_layers):
        yield i, cfg.mixer_of(i), cfg.uses_moe(i)


def fwd_flops(cfg: ModelConfig, b: int, s: int, skv: int,
              flags: ExecFlags, useful: bool, with_head: bool = True) -> float:
    total = 0.0
    for _, kind, is_moe in _layer_kinds(cfg):
        total += _mixer_flops(cfg, kind, b, s, skv, flags, useful)
        if cfg.ffn_variant != "none" and kind not in ("mlstm", "slstm"):
            total += _moe_flops(cfg, b, s, flags, useful) if is_moe \
                else _ffn_flops(cfg, b, s)
    if with_head:
        total += 2 * b * s * cfg.d_model * cfg.vocab_size
    return total


# ---------------------------------------------------------------------------
# Bytes (HBM traffic, global)
# ---------------------------------------------------------------------------
def _attn_stream_bytes(cfg: ModelConfig, kind: str, b: int, s: int, skv: int,
                       flags: ExecFlags) -> float:
    """Per-layer attention HBM traffic (fwd), both execution paths.

    Generic chunked path (blocks.chunked_attention): the KV-chunk scan
    re-reads the full fp32 query and round-trips the S-sized (m, l, acc)
    carries once per KV chunk; KV streams once.

    Block-skip path (chunked_attention_skip): accumulators live per query
    chunk (no S-sized carries); KV streams once per *visible* range of
    each query chunk — Σ visible ≈ S·Skv/(2c) for causal, S·(W+c)/c for
    local windows.
    """
    h, dh = cfg.n_heads, cfg.d_head
    c = min(flags.chunk_len, skv)
    if flags.causal_block_skip:
        if kind == "local" and cfg.window:
            sum_vis = (s / c) * min(cfg.window + c, skv)
        elif cfg.causal and s > 1:
            sum_vis = s * skv / (2 * c)
        else:
            sum_vis = (s / c) * skv
        kv_stream = sum_vis * b * h * dh * BF16 * 2  # K and V tiles
        q_once = b * h * s * dh * F32
        return kv_stream + q_once
    trips = max(skv // c, 1)
    q_reread = trips * b * h * s * dh * F32
    carries = trips * b * h * s * (dh + 2) * F32 * 2
    kv_once = 2 * b * h * skv * dh * BF16
    return q_reread + carries + kv_once


def _attn_bytes_total(cfg, b, s, skv, flags, passes: int) -> float:
    total = 0.0
    for _, kind, _ in _layer_kinds(cfg):
        if kind in ("global", "local"):
            total += passes * _attn_stream_bytes(cfg, kind, b, s, skv, flags)
    return total


def train_bytes(cfg: ModelConfig, b: int, s: int, tc: TrainConfig,
                flags: ExecFlags) -> float:
    n = cfg.param_count()
    pb = n * (BF16 if tc.param_dtype == "bfloat16" else F32)
    ob = n * (BF16 if tc.opt.state_dtype == "bfloat16" else F32)
    micro = tc.microbatches
    # Param reads: fwd + bwd (+ remat refwd) per microbatch, in bf16.
    reads = (3 if flags.remat else 2) * micro * n * BF16
    grads = 2 * n * F32  # accumulate write+read
    opt = 2 * pb + 4 * ob  # param rd+wr, m/v rd+wr
    # Activations: residual stream + per-layer internals (~8 tensors of
    # B·S·d per layer fwd; bwd reads them again) + logits.
    act = cfg.n_layers * 10 * b * s * cfg.d_model * BF16
    # Attention streaming: fwd + remat-refwd + bwd ≈ 3 passes (2 w/o remat).
    attn = _attn_bytes_total(cfg, b, s, s, flags, 3 if flags.remat else 2)
    logits = 3 * b * s * cfg.vocab_size * F32  # fwd write, bwd read, grad
    return reads + grads + opt + act + attn + logits


def decode_bytes(cfg: ModelConfig, b: int, cache_len: int, tc: TrainConfig) -> float:
    n = cfg.param_count() if cfg.moe is None else cfg.active_param_count()
    pb = n * BF16
    kv = 0.0
    for _, kind, _ in _layer_kinds(cfg):
        if kind in ("global", "local"):
            length = min(cache_len, cfg.window) if kind == "local" else cache_len
            kv += 2 * b * length * cfg.n_kv_heads * cfg.d_head * BF16
        elif kind == "mlstm":
            di = int(cfg.d_model * cfg.mlstm_proj_factor)
            dh = di // cfg.n_heads
            kv += 2 * b * cfg.n_heads * dh * dh * F32
        elif kind == "rglru":
            kv += 2 * b * cfg.d_model * F32
        elif kind == "slstm":
            kv += 8 * b * cfg.d_model * F32
    logits = b * cfg.vocab_size * F32
    return pb + kv + logits


def prefill_bytes(cfg: ModelConfig, b: int, s: int, flags: ExecFlags) -> float:
    n = cfg.param_count() if cfg.moe is None else cfg.active_param_count()
    pb = n * BF16
    act = cfg.n_layers * 10 * b * s * cfg.d_model * BF16
    attn = _attn_bytes_total(cfg, b, s, s, flags, 1)
    return pb + act + attn + b * s * cfg.vocab_size * BF16


# ---------------------------------------------------------------------------
# Collectives (global bytes per step, by mesh-axis kind)
# ---------------------------------------------------------------------------
def train_collectives(cfg: ModelConfig, b: int, s: int, tc: TrainConfig,
                      policy, flags: ExecFlags) -> Dict[str, float]:
    """Keys: "tp" (ICI all-reduce of activations), "fsdp" (param
    all-gather + grad reduce-scatter), "ep" (MoE all-to-all), "dp_pod"
    (gradient reduce over DCN)."""
    rules = policy.rules
    names, shape = policy.axis_names, policy.shape
    out = {"tp": 0.0, "fsdp": 0.0, "ep": 0.0, "dp_pod": 0.0}
    n = cfg.param_count()
    tp_active = any(
        a in names for a in rules.get("heads", ())
    ) and shape.get("model", 1) > 1
    micro = tc.microbatches

    if tp_active:
        # Megatron: 1 all-reduce (B·S·d) per sublayer fwd, 1 bwd (+1 remat).
        # MoE layers cost the same one psum as an FFN sublayer: under the
        # replicated-activation EP design (models/moe.py) there is NO
        # all-to-all — the combine IS the TP psum.
        subl = sum(
            (2 if (cfg.ffn_variant != "none" and k not in ("mlstm", "slstm")) else 1)
            for _, k, _ in _layer_kinds(cfg)
        )
        out["tp"] = (3 if flags.remat else 2) * subl * b * s * cfg.d_model * BF16

    # Only axes of more than one device move bytes: the reference counts the
    # gathers over an FSDP axis of size 1 (a one-card (1, 1) mesh) too.
    fsdp_axes = [a for a in rules.get("fsdp", ()) if shape.get(a, 1) > 1]
    if fsdp_axes:
        # Parameters are cast to the compute dtype BEFORE use (train/step.py),
        # so FSDP all-gathers and grad reduce-scatters move bf16, not the
        # fp32 master copies.
        gather = (3 if flags.remat else 2) * micro * n * BF16
        scatter = n * (1 if flags.compress_pod_grads else BF16)
        out["fsdp"] = gather + scatter

    # ep = 0 by design (see tp comment); kept as a key so §Perf can compare
    # against an all-to-all EP variant.

    if shape.get("pod", 1) > 1 and "pod" not in fsdp_axes:
        out["dp_pod"] = n * (1 if flags.compress_pod_grads else F32)
    return out


def serve_collectives(cfg: ModelConfig, b: int, s: int, policy,
                      flags: ExecFlags, decode: bool) -> Dict[str, float]:
    rules = policy.rules
    names, shape = policy.axis_names, policy.shape
    out = {"tp": 0.0, "fsdp": 0.0, "ep": 0.0, "dp_pod": 0.0}
    tp_active = any(
        a in names for a in rules.get("heads", ())
    ) and shape.get("model", 1) > 1
    tokens = b * (1 if decode else s)
    if tp_active:
        subl = sum(
            (2 if (cfg.ffn_variant != "none" and k not in ("mlstm", "slstm")) else 1)
            for _, k, _ in _layer_kinds(cfg)
        )
        out["tp"] = subl * tokens * cfg.d_model * BF16
    # ep = 0: replicated-activation EP folds the combine into the TP psum.
    return out


# ---------------------------------------------------------------------------
# Per-device memory model (the reference's; the dry run holds it beside
# MemTracker's peak of the executed step, chip_smoke beside the card's)
# ---------------------------------------------------------------------------
def tree_device_bytes(shapes, shardings=None) -> int:
    """Exact per-device bytes of a sharded tree: each leaf's elements over
    the sizes of the mesh axes that shard it (rounded down, as the
    reference), times its item size. ``shardings``: a tree of the same
    structure of ``parallel.sharding.Placed`` leaves (``param_specs`` over a
    ``DeviceMesh`` or a ``MeshShape``); None: the leaves of ``shapes`` are
    DTensors and their own placements count (a plain tensor is whole)."""
    from torch.distributed.tensor import Shard

    from repro_torch.parallel.sharding import is_dtensor
    from repro_torch.tree import leaves

    shape_leaves = list(leaves(shapes))
    if shardings is None:
        placed = [(tuple(t.device_mesh.mesh.shape), t.placements) if is_dtensor(t)
                  else ((), ()) for t in shape_leaves]
    else:
        placed = [(tuple(axis_sizes(p.mesh).values()), p.placements)
                  for p in leaves(shardings)]
        if len(placed) != len(shape_leaves):
            raise ValueError(f"{len(shape_leaves)} leaves vs {len(placed)} placements")
    total = 0
    for leaf, (sizes, placements) in zip(shape_leaves, placed):
        n = 1
        for d in leaf.shape:
            n *= int(d)
        denom = 1
        for size, p in zip(sizes, placements):
            if isinstance(p, Shard):
                denom *= int(size)
        total += (n // max(denom, 1)) * leaf.dtype.itemsize
    return total


def train_memory_model(
    cfg: ModelConfig, b: int, s: int, tc: TrainConfig, policy, mesh,
    state_bytes_per_device: int,
) -> Dict[str, float]:
    """Per-device training-step memory (bytes). ``state_bytes_per_device``
    comes from the real param/opt shardings (tree_device_bytes)."""
    shape = axis_sizes(mesh)
    dp = 1
    for a in policy.rules.get("batch", ()):
        dp *= shape.get(a, 1)
    tp = shape.get("model", 1) if "model" in policy.rules.get("heads", ()) else 1
    b_micro_local = max(b // (tc.microbatches * dp), 1)
    pbytes = BF16 if tc.param_dtype == "bfloat16" else F32
    abytes = BF16 if tc.accum_dtype == "bfloat16" else F32

    boundary = cfg.n_layers * b_micro_local * s * cfg.d_model * BF16
    boundary_host = 0
    if getattr(tc, "remat_offload", False):
        boundary_host, boundary = boundary, 0  # parked in pinned host memory
    accum = (cfg.param_count() // max(
        _fsdp_size(policy, mesh) * _tp_param_factor(cfg, policy, mesh), 1
    )) * abytes if tc.microbatches > 1 else 0
    h_loc = max(cfg.n_heads // tp, 1)
    working = (
        8 * b_micro_local * s * cfg.d_model * BF16
        + b_micro_local * h_loc * s * min(cfg.chunk_len, s) * F32
        + b_micro_local * h_loc * s * (cfg.d_head + 2) * F32
    )
    v_loc = cfg.vocab_size // (
        shape.get("model", 1) if "model" in policy.rules.get("vocab", ()) else 1
    )
    logits = 2 * b_micro_local * s * v_loc * F32
    total = state_bytes_per_device + boundary + accum + working + logits
    return {
        "state": state_bytes_per_device,
        "boundary_saves": boundary,
        "boundary_saves_host": boundary_host,
        "grad_accum": accum,
        "working_set": working,
        "logits": logits,
        "total": total,
        "total_gb": round(total / 2**30, 2),
        "fits_80gb": total <= HBM_BYTES,
        "param_bytes_each": pbytes,
    }


def _fsdp_size(policy, mesh) -> int:
    n = 1
    for a in policy.rules.get("fsdp", ()):
        n *= axis_sizes(mesh).get(a, 1)
    return n


def _tp_param_factor(cfg, policy, mesh) -> int:
    return axis_sizes(mesh).get("model", 1) if "model" in policy.rules.get("heads", ()) else 1


def serve_memory_model(
    cfg: ModelConfig, b: int, s: int, kind: str, policy, mesh,
    state_bytes_per_device: int, cache_bytes_per_device: int = 0,
) -> Dict[str, float]:
    shape = axis_sizes(mesh)
    dp = 1
    for a in policy.rules.get("batch", ()):
        dp *= shape.get(a, 1)
    tp = shape.get("model", 1) if "model" in policy.rules.get("heads", ()) else 1
    b_loc = max(b // dp, 1)
    h_loc = max(cfg.n_heads // tp, 1)
    if kind == "prefill":
        working = (
            8 * b_loc * s * cfg.d_model * BF16
            + b_loc * h_loc * s * min(cfg.chunk_len, s) * F32
            + b_loc * h_loc * s * (cfg.d_head + 2) * F32
        )
    else:
        working = 4 * b_loc * cfg.d_model * F32 + b_loc * h_loc * s * F32
    v_loc = cfg.vocab_size // (
        shape.get("model", 1) if "model" in policy.rules.get("vocab", ()) else 1
    )
    logits = b_loc * (s if kind == "prefill" else 1) * v_loc * F32
    total = state_bytes_per_device + cache_bytes_per_device + working + logits
    return {
        "state": state_bytes_per_device,
        "cache": cache_bytes_per_device,
        "working_set": working,
        "logits": logits,
        "total": total,
        "total_gb": round(total / 2**30, 2),
        "fits_80gb": total <= HBM_BYTES,
    }



# ---------------------------------------------------------------------------
# Cell roofline
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class CellRoofline:
    arch: str
    cell: str
    mesh_desc: str
    chips: int
    flops_exec: float
    flops_model: float
    bytes_hbm: float
    coll: Dict[str, float]
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    useful_ratio: float

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


def cell_roofline(
    cfg: ModelConfig, arch: str, cell_name: str, kind: str,
    b: int, s: int, policy, tc: TrainConfig, flags: ExecFlags, chips: int,
    mesh_desc: str,
) -> CellRoofline:
    n_active = cfg.active_param_count()
    if kind == "train":
        fwd = fwd_flops(cfg, b, s, s, flags, useful=False)
        refwd = fwd if flags.remat else 0.0
        flops_exec = fwd + 2 * fwd + refwd + 12.0 * cfg.param_count()
        flops_model = 6.0 * n_active * b * s
        bts = train_bytes(cfg, b, s, tc, flags)
        coll = train_collectives(cfg, b, s, tc, policy, flags)
    elif kind == "prefill":
        flops_exec = fwd_flops(cfg, b, s, s, flags, useful=False)
        flops_model = 2.0 * n_active * b * s
        bts = prefill_bytes(cfg, b, s, flags)
        coll = serve_collectives(cfg, b, s, policy, flags, decode=False)
    else:  # decode: one token against a cache of length s
        flops_exec = fwd_flops(cfg, b, 1, s, flags, useful=False)
        flops_model = 2.0 * n_active * b
        bts = decode_bytes(cfg, b, s, tc)
        coll = serve_collectives(cfg, b, s, policy, flags, decode=True)

    t_c = flops_exec / (chips * PEAK_FLOPS)
    t_m = bts / (chips * HBM_BW)
    t_x = sum(coll.values()) / (chips * ICI_BW)
    bott = max(
        ("compute", t_c), ("memory", t_m), ("collective", t_x), key=lambda kv: kv[1]
    )[0]
    return CellRoofline(
        arch=arch, cell=cell_name, mesh_desc=mesh_desc, chips=chips,
        flops_exec=flops_exec, flops_model=flops_model, bytes_hbm=bts,
        coll=coll, t_compute=t_c, t_memory=t_m, t_collective=t_x,
        bottleneck=bott, useful_ratio=flops_model / max(flops_exec, 1.0),
    )
