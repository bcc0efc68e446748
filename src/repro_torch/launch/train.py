"""End-to-end training entry point.

The counterpart of the reference's ``repro.launch.train``: config registry
→ deterministic data pipeline → microbatched train step → async
checkpoints → fleet monitor and the AL-DRAM adaptive fallback loop. It runs
on the card unless the caller asks for the CPU, and never falls back.
Weights are random, drawn from seed 0 on the device; a checkpoint in
``ckpt_dir`` resumes the run.

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch smollm-135m --steps 20 --batch 8 --seq 128
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m --full \\
      --steps 50 --batch 8 --seq 1024 --microbatches 2

``train(mesh=)`` trains on the ranks of a ``DeviceMesh`` (every rank calls
it; start them with ``torchrun`` or ``repro_torch.core.shard.launch``):
``parallel.policies.make_policy(mesh, cfg, "train", seq, batch)`` chooses
the placements, the parameters and moments are DTensors placed by
``param_specs``, each step takes the reference's single-host global batch
placed by ``data.pipeline.shard_batch``, and the loop runs under
``use_policy``. Rank 0 alone prints and writes checkpoints (every rank
gathers them).
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import time
from typing import Optional

import torch

import repro_torch.configs as C
from repro_torch import resolve_device
from repro_torch.core.altune.runtime import AdaptiveExecutor, ConditionBins
from repro_torch.data.pipeline import (DataConfig, _process, batch_for_step, shard_batch,
                                       to_device)
from repro_torch.ft import checkpoint as ckpt
from repro_torch.ft.monitor import FleetMonitor
from repro_torch.launch.serve import FLIP_EPS
from repro_torch.models import model as lm
from repro_torch.models import moe
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw
from repro_torch.optim.adamw import OptConfig
from repro_torch.parallel import policies
from repro_torch.parallel.sharding import ShardingPolicy, distribute, param_specs, use_policy
from repro_torch.tree import leaves, tree_map
from repro_torch.train.step import TrainConfig, init_train_state, make_train_step

#: How far one training step may move from another computation of the same
#: step (the reference's, or the port's on another device), by compute
#: dtype, each relative: ``loss``, ``grad_norm``; ``params`` ‖p − p_other‖ /
#: ‖p_other‖ over the whole tree; ``moments`` the largest over leaves of the
#: same for the first moment (after one step, 0.1 × the clipped gradient);
#: ``update`` ‖Δ − Δ_other‖ / ‖Δ_other‖ over the tree, Δ the step's change.
#: In float32 the gradients differ by float32 sums in another order (~1e-6
#: of a leaf); AdamW's first step, g / (|g| + ε) an entry, turns an error δ
#: in an entry with |g| near ε into a change of ~δ / ε in its step, so the
#: update is held to 1e-3 and the parameters, whose norm the step barely
#: moves, to 1e-5. In bfloat16 the activations round at other places (the
#: reference's XLA fusions skip roundings that eager ops take; cuBLAS sums
#: in another order), which moves the loss by ~1e-4, each gradient by ~1e-2
#: of its norm and the global norm by up to ~5e-3 (where an expert routing
#: flips at a near-tie), and an entry whose gradient is inside that noise
#: steps either way (~lr · sign(g) an entry): ``update`` is held to 0.3.
STEP_TOL = {
    "float32": {"loss": 1e-5, "grad_norm": 1e-5, "params": 1e-5, "moments": 1e-5,
                "update": 1e-3},
    "bfloat16": {"loss": 1e-3, "grad_norm": 1e-2, "update": 0.3},
}
#: A token routed to other experts on the card than on the CPU is admitted
#: where the CPU's k-th and (k + 1)-th router probabilities lie within this
#: of each other: ``serve.FLIP_EPS`` in float32; in bfloat16 a bfloat16 ulp
#: at 1, the size of the activations' rounding differences.
STEP_FLIP_EPS = {"float32": FLIP_EPS, "bfloat16": 2.0 ** -7}


def train(arch: str, steps: int = 200, batch: int = 8, seq: int = 128, reduced: bool = True,
          ckpt_dir: Optional[str] = None, ckpt_every: int = 100, lr: float = 1e-3,
          microbatches: int = 1, mesh=None, log_every: int = 10,
          device: str | torch.device = "cuda", n_layers: Optional[int] = None,
          train_config: Optional[TrainConfig] = None, return_report: bool = False,
          cfg: Optional[ModelConfig] = None):
    """Train ``arch`` (the reduced config unless ``reduced`` is False, or
    ``cfg`` where given; ``n_layers`` cuts its depth) for ``steps`` steps
    of ``batch`` × ``seq`` tokens. ``train_config``: the reference's
    default ``TrainConfig`` with ``microbatches`` and a warmup-then-cosine
    schedule to ``lr`` over the run, unless given. Returns (params,
    opt_state, losses) — with ``return_report`` also a report: each step's
    milliseconds (host clock around the step, data included, ending when
    its loss is read), the skipped steps, the device and its peak bytes
    (None on the CPU).

    ``mesh``: a ``DeviceMesh`` of the ranks that call this together (see
    the module docstring); the parameters and moments come back as
    DTensors, and the report's peak is the largest over the ranks
    (``peak_device_bytes_by_rank`` each rank's), taken over the whole call,
    the placement of the state included; ``placed_device_bytes_by_rank``
    is each rank's peak up to the end of the placement."""
    if mesh is not None and not hasattr(mesh, "mesh_dim_names"):
        raise TypeError(f"train(mesh=): a torch.distributed DeviceMesh, not {type(mesh)}")
    dev = resolve_device(device)
    cfg = cfg or (C.reduced(arch) if reduced else C.get(arch))
    cfg = dataclasses.replace(cfg, n_layers=n_layers or cfg.n_layers)
    tc = train_config or TrainConfig(
        microbatches=microbatches,
        opt=OptConfig(peak_lr=lr, warmup_steps=max(steps // 10, 1), total_steps=steps))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    gen = torch.Generator(device=dev).manual_seed(0)
    pol = None
    if mesh is None:
        params, opt_state = init_train_state(gen, cfg, tc)
    else:
        pol = policies.make_policy(mesh, cfg, "train", seq, batch).sharding
        params, opt_state = placed_state(gen, cfg, tc, pol)
    placed_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    state = {"params": params, "opt": opt_state}
    rank0 = _process()[0] == 0
    start_step = 0
    # Under a process group every rank takes rank 0's view of ckpt_dir.
    if ckpt_dir and (last := ckpt.agreed_latest_step(ckpt_dir)) is not None:
        _, start_step = ckpt.restore(ckpt_dir, state, step=last)
        if rank0:
            print(f"[train] resumed from step {start_step}")

    step_fn = make_train_step(cfg, tc)
    dc = DataConfig(seq_len=seq, global_batch=batch)
    monitor = FleetMonitor()
    host = f"host{_process()[0]}"
    # AL-DRAM loop: healthy bins run the tuned step; sustained slowness or
    # an error fuse selects the conservative path (here: the same step —
    # the hook is where kernel/config swaps land).
    executor = AdaptiveExecutor(configs_by_bin=["tuned", "tuned", "conservative"],
                                worst_case="conservative", bins=ConditionBins(edges=(1.1, 1.3)))

    pending_ckpt = None
    losses, step_ms, skipped = [], [], []
    for step in range(start_step, steps):
        t0 = time.perf_counter()
        if pol is None:
            data = to_device(batch_for_step(cfg, dc, step), dev)
        else:  # the global batch, each rank's rows placed
            data = shard_batch(batch_for_step(cfg, dc, step, process=(0, 1)), pol, dev)
        with use_policy(pol):
            state["params"], state["opt"], metrics = step_fn(state["params"], state["opt"],
                                                             data)
        # One wait for the device a step: the loss and the fuse together.
        loss, skip = torch.stack([metrics["loss"], metrics["skipped"]]).tolist()
        dt = time.perf_counter() - t0
        step_ms.append(dt * 1e3)
        monitor.record_step(host, dt)
        mode = executor.observe(host, monitor.load_of(host))

        if skip > 0:
            # Non-finite grads: fuse + restore (the paper's error fallback).
            skipped.append(step)
            monitor.record_error(host)
            executor.report_error(host)
            if ckpt_dir and pending_ckpt is not None:
                pending_ckpt.result()  # rank 0's write, before any rank looks
                pending_ckpt = None
            if ckpt_dir and (last := ckpt.agreed_latest_step(ckpt_dir)) is not None:
                ckpt.restore(ckpt_dir, state, step=last)
                if rank0:
                    print(f"[train] step {step}: non-finite grads — restored step {last}")
                continue

        losses.append(loss)
        if rank0 and step % log_every == 0:
            print(f"[train] step {step:5d} loss {loss:8.4f} "
                  f"gnorm {float(metrics['grad_norm']):8.3f} "
                  f"lr {float(metrics['lr']):.2e} {dt * 1e3:7.1f} ms mode={mode}", flush=True)
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            if pending_ckpt is not None:
                pending_ckpt.result()
            pending_ckpt = ckpt.save_async(ckpt_dir, step + 1, state,
                                           {"arch": cfg.name, "loss": loss})
    if pending_ckpt is not None:
        pending_ckpt.result()
    if not return_report:
        return state["params"], state["opt"], losses
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    report = {"device": str(dev), "step_ms": step_ms, "skipped": skipped,
              "peak_device_bytes": peak}
    if mesh is not None:
        by_rank = [None] * mesh.size()
        torch.distributed.all_gather_object(by_rank, (peak, placed_peak))
        report["peak_device_bytes_by_rank"] = [p for p, _ in by_rank]
        report["placed_device_bytes_by_rank"] = [p for _, p in by_rank]
        report["peak_device_bytes"] = None if peak is None else max(p for p, _ in by_rank)
    return state["params"], state["opt"], losses, report


def placed_params(gen: torch.Generator, cfg, dtype, policy: ShardingPolicy):
    """Parameters drawn from ``gen`` (the same draws on every rank, and as
    ``init_params``'), placed under ``policy`` by ``param_specs`` over
    ``logical_specs`` part by part as they are drawn (the embedding, each
    layer, the final norm, the head: only one part is ever whole on a
    device, every rank keeping its shards)."""
    def place(part):
        return distribute(part, param_specs(lm.logical_specs(part, cfg), part, policy))

    return lm.init_params(gen, cfg, dtype, place=place)


def placed_state(gen: torch.Generator, cfg, tc: TrainConfig, policy: ShardingPolicy):
    """:func:`placed_params` at ``tc``'s parameter dtype (as
    ``init_train_state``'s draws) and zero moments placed alike."""
    placed = placed_params(gen, cfg, getattr(torch, tc.param_dtype), policy)
    return placed, adamw.init_opt_state(placed, tc.opt)


def _rel(pairs) -> float:
    """‖a − b‖ / ‖b‖ over ``(a, b)`` pairs of tensors taken as one vector,
    in float64 on ``a``'s device, one pair at a time (a full-width tree is
    never copied whole)."""
    num = den = 0.0
    for a, b in pairs:
        a = a.detach().double()
        b = b.detach().to(a.device).double()
        num += float(torch.sum((a - b) ** 2))
        den += float(torch.sum(b * b))
    return math.sqrt(num) / max(math.sqrt(den), 1e-300)


def _route_flips(out: dict, got, want, cfg, compute_dtype: str) -> None:
    """Count into ``out`` the tokens whose expert set differs between the
    routings ``got`` and ``want`` (lists of (experts, probs), call by call),
    and those of them away from a near-tie of ``want``'s probabilities."""
    for (ic, _), (ih, ph) in zip(got, want):
        flip = (ic.to(ih.device).sort(-1).values != ih.sort(-1).values).any(-1)
        top = ph.detach().sort(-1, descending=True).values
        gap = top[:, cfg.moe.top_k - 1] - top[:, cfg.moe.top_k]
        out["route_flips"] += int(flip.sum())
        out["flips_not_near_tie"] += int((flip & (gap > STEP_FLIP_EPS[compute_dtype])).sum())
        if flip.any():
            out["max_flip_gap"] = max(out["max_flip_gap"], float(gap[flip].max()))


def compare_card_to_cpu(arch: str, device: str | torch.device = "cuda",
                        compute_dtype: str = "float32", batch: int = 4, seq: int = 64,
                        seed: int = 0, reduced: bool = True,
                        n_layers: Optional[int] = None) -> dict:
    """One training step of ``arch`` (the reduced config unless ``reduced``
    is False; ``n_layers`` cuts its depth) on ``device`` and on the CPU
    from the same state (drawn on the CPU, copied to the card) and batch
    (step 0 of the data pipeline), at ``compute_dtype``. Returns the card's
    ``loss`` and the relative differences of :data:`STEP_TOL`'s quantities
    (``loss_err``, ``grad_norm_err``, ``params``, ``moments`` with the leaf
    that gives it in ``moments_leaf``, ``update``), and the experts'
    routing: ``moe_calls``, ``route_flips`` (tokens whose expert set
    differs) and ``flips_not_near_tie`` (of those, the ones whose CPU gap
    between the k-th and (k + 1)-th probability exceeds
    :data:`STEP_FLIP_EPS`; ``max_flip_gap``, the largest such gap of a
    flipped token, 0 without a flip). A flip changes that token's gradients: the
    parameters, moments and update are compared only without one
    (``compared``)."""
    dev = resolve_device(device)
    cfg, tc = _compare_config(arch, compute_dtype, reduced, n_layers)
    host_p, host_o = init_train_state(torch.Generator().manual_seed(seed), cfg, tc)
    card_p, card_o = (tree_map(lambda t: t.to(dev, copy=True), x) for x in (host_p, host_o))
    before = [t.clone() for t in leaves(host_p)]
    data = batch_for_step(cfg, DataConfig(seq_len=seq, global_batch=batch), 0)
    step = make_train_step(cfg, tc)
    with moe.recording_routes() as rc:
        card_p, card_o, mc = step(card_p, card_o, to_device(data, dev))
    with moe.recording_routes() as rh:
        host_p, host_o, mh = step(host_p, host_o, to_device(data, "cpu"))
    out = {"loss": float(mc["loss"]), "loss_err": _rel([(mc["loss"], mh["loss"])]),
           "grad_norm_err": _rel([(mc["grad_norm"], mh["grad_norm"])]),
           "skipped": float(mc["skipped"]) + float(mh["skipped"]),
           "moe_calls": len(rh), "route_flips": 0, "flips_not_near_tie": 0,
           "max_flip_gap": 0.0}
    _route_flips(out, rc, rh, cfg, compute_dtype)
    out["compared"] = out["route_flips"] == 0
    pc, ph_ = list(leaves(card_p)), list(leaves(host_p))
    out["params"] = _rel(zip(pc, ph_))
    moments = [(_rel([(a, b)]), i) for i, (a, b) in
               enumerate(zip(leaves(card_o["m"]), leaves(host_o["m"])))]
    out["moments"], worst = max(moments)
    out["moments_leaf"] = worst
    out["update"] = _rel((c.detach().cpu().double() - b0.double(), h.double() - b0.double())
                         for c, h, b0 in zip(pc, ph_, before))
    return out


def _compare_config(arch: str, compute_dtype: str, reduced: bool, n_layers: Optional[int],
                    microbatches: int = 1):
    cfg = C.reduced(arch) if reduced else C.get(arch)
    cfg = dataclasses.replace(cfg, n_layers=n_layers or cfg.n_layers)
    tc = TrainConfig(compute_dtype=compute_dtype, microbatches=microbatches,
                     opt=OptConfig(peak_lr=1e-3, warmup_steps=1, total_steps=10))
    return cfg, tc


def within_tolerance(r: dict, compute_dtype: str) -> bool:
    """Whether :func:`compare_card_to_cpu`'s result ``r`` is within
    :data:`STEP_TOL`: loss and grad norm always, the rest where compared."""
    tol = STEP_TOL[compute_dtype]
    keys = list(tol) if r["compared"] else ["loss", "grad_norm"]
    got = {**r, "loss": r["loss_err"], "grad_norm": r["grad_norm_err"]}
    return not r["skipped"] and not r["flips_not_near_tie"] and all(
        got[k] <= tol[k] for k in keys)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full", action="store_true",
                    help="the published config (default: the reduced one)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the config to its first N layers (default: all)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    _, _, losses = train(args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
                         reduced=not args.full, ckpt_dir=args.ckpt_dir, lr=args.lr,
                         microbatches=args.microbatches, device=args.device,
                         n_layers=args.layers)
    print(f"final loss: {losses[-1]:.4f} (start {losses[0]:.4f})")


if __name__ == "__main__":
    main()
