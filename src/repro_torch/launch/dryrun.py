"""Dry run: one step of every (arch × shape × mesh) cell on fake tensors.

The port of ``src/repro/launch/dryrun.py``. The reference lowers and
compiles each cell's step on 512 placeholder host devices and records
``memory_analysis()``, ``cost_analysis()``, the HLO's collectives and the
analytic roofline. The port has no compiler to ask; it runs the cell's
step — the port's own train step, prefill or decode, one call — on fake
tensors (``FakeTensorMode``: shapes and dtypes, no storage) placed as the
policy says, as rank 0 of a ``"fake"`` process group of the mesh's world
size (``torch.testing._internal.distributed.fake_pg``: collectives return
at once and move nothing). :func:`run_cell` runs each cell so in a process
of its own, so the fake group never meets a caller's. It records:

* ``memory``: the per-rank state bytes from the local shards (parameters
  and both moments; parameters when serving, the caches apart), beside
  ``analytic.tree_device_bytes`` of the same policy's specs over a
  ``MeshShape`` (:func:`state_bytes`: no process group), and the
  step's peak from ``torch.distributed._tools.mem_tracker.MemTracker``
  under the fake mode — the analogue of ``memory_analysis()``. MemTracker
  counts the storages the step's tensors hold, live at once; a card's
  ``max_memory_allocated`` is the caching allocator's, which rounds each
  block up (to 512 B, large ones to 2 MiB segments), keeps freed blocks of
  other sizes and holds cuBLAS's workspace and collective buffers, so the
  card's peak lies above this one;
* ``executed``: one rank's FLOPs, bytes and collective bytes by kind of the
  step as run (``costing.cost_of``; per rank from the local shards, see
  its docstring);
* ``analytic_memory`` and ``roofline``: the reference's memory models and
  ``cell_roofline`` at the H100's constants;
* ``retrace_first`` and ``retrace``: ``analysis.RetraceCounter``'s deltas
  over a first, unmeasured run of the step (DTensor sharding propagations:
  one a new op signature) and over the measured run after it (0 in steady
  state). The first run keeps the propagations' global-shape fake tensors
  out of the memory count (:func:`_warm`).

With ``--sampled`` a train step of more than two microbatches runs as its
first microbatch and its first two, and the counts are extrapolated (see
:func:`run_cell`).

A cell whose step raises (the port runs prefill and decode unsharded: a
sharded prefill with caches or a sharded decode raises) is recorded
``ok: false`` with its error, its analytic fields kept. Nothing runs on a
device: the dry run takes no ``--device``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m --cell train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh single|multi|both]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-3b --cell train_4k \\
      --mesh single --reduced    # the CPU-test-sized config

Results land in artifacts/dryrun_torch/<mesh>/<arch>__<cell>.json; the
command exits 1 if any cell failed.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import json
import math
import multiprocessing
import pathlib
import time
import traceback
from typing import Optional, Sequence, Tuple, Union

import torch

import repro_torch.configs as C
from repro_torch.configs import ShapeCell
from repro_torch.launch import analytic, costing
from repro_torch.launch.costing import Cost
from repro_torch.models.config import ModelConfig
from repro_torch.train.step import TrainConfig

ART = pathlib.Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"

#: ``--mesh`` → (name, shape): the reference's production meshes (axes from
#: :func:`mesh_axes`).
MESHES = {
    "single": ("single-pod-16x16", (16, 16)),
    "multi": ("multi-pod-2x16x16", (2, 16, 16)),
}


def mesh_axes(shape: Sequence[int]) -> Tuple[str, ...]:
    """The axis names of a mesh shape: (data, model), or (pod, data,
    model) for three axes."""
    if len(shape) not in (2, 3):
        raise ValueError(f"a mesh of 2 or 3 axes, not {tuple(shape)}")
    return ("pod", "data", "model")[-len(shape):]


def run_cell(arch: str, cell: Union[str, ShapeCell], mesh_shape: Sequence[int],
             cfg: Optional[ModelConfig] = None, train_config: Optional[TrainConfig] = None,
             mesh_name: Optional[str] = None, reduced: bool = False, sampled: bool = False,
             timeout: Optional[float] = None) -> dict:
    """Dry-run one cell in a process of its own (start method ``spawn``) and
    return its record. ``cell``: a name of ``configs.SHAPES`` or a
    ``ShapeCell``; ``mesh_shape``: e.g. (16, 16) or (2, 16, 16) (axes from
    :func:`mesh_axes`); ``cfg``: the model config (default
    ``configs.get(arch)``, or ``configs.reduced(arch)`` with ``reduced``);
    ``train_config``: the train step's (default the policy's); ``sampled``:
    a train step of more than two microbatches runs as its first one and its
    first two (the cell's microbatch shape), the record's ``executed``
    extrapolated to all of them and its peak the two's (a fake-tensor
    microbatch of a full-size model takes a minute of one CPU core). A
    failing step does not raise: the record says ``ok: false``."""
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(1, mp_context=ctx) as pool:
        return pool.submit(_run_cell_here, arch, cell, tuple(mesh_shape), cfg, train_config,
                           mesh_name, reduced, sampled).result(timeout=timeout)


def state_bytes(cfg: ModelConfig, cell: ShapeCell, mesh_shape: Sequence[int],
                train_config: Optional[TrainConfig] = None) -> int:
    """The per-rank state bytes that ``analytic.tree_device_bytes`` gives
    for ``make_policy``'s specs of the cell over a ``MeshShape`` — no
    process group, no DTensor: parameters (and, training, both moments at
    the optimizer's state dtype; serving, parameters in bfloat16) as fake
    tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models import model as lm
    from repro_torch.optim import adamw
    from repro_torch.parallel import policies
    from repro_torch.parallel.sharding import MeshShape, param_specs

    mesh = MeshShape(mesh_axes(mesh_shape), tuple(mesh_shape))
    pol = policies.make_policy(mesh, cfg, cell.kind, seq_len=cell.seq_len,
                               global_batch=cell.global_batch)
    tc = train_config or pol.train
    with FakeTensorMode():
        dtype = getattr(torch, tc.param_dtype) if cell.kind == "train" else torch.bfloat16
        params = lm.init_params(torch.Generator().manual_seed(0), cfg, dtype)
        placed = param_specs(lm.logical_specs(params, cfg), params, pol.sharding)
        trees = [params]
        if cell.kind == "train":
            opt = adamw.init_opt_state(params, tc.opt)
            trees += [opt["m"], opt["v"]]
        return sum(analytic.tree_device_bytes(t, placed) for t in trees)


def _run_cell_here(arch, cell, mesh_shape, cfg, train_config, mesh_name, reduced,
                   sampled) -> dict:
    """:func:`run_cell`'s body, in the child: the fake group, the mesh, the
    step."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import auto_mesh

    cell = C.SHAPES[cell] if isinstance(cell, str) else cell
    cfg = cfg or (C.reduced(arch) if reduced else C.get(arch))
    mesh_name = mesh_name or "x".join(map(str, mesh_shape))
    out = {"arch": arch, "cell": cell.name, "mesh": mesh_name, "chips": math.prod(mesh_shape),
           "shape": list(mesh_shape), "ok": False}
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(mesh_shape))
    try:
        mesh = auto_mesh(mesh_shape, mesh_axes(mesh_shape), "cpu")
        _cell(out, mesh, arch, cfg, cell, train_config, sampled)
        out["ok"] = True
    except Exception as e:  # noqa: BLE001 — recorded, as the reference records a failed cell
        out["error"] = f"{type(e).__name__}: {e}"
        out["traceback"] = traceback.format_exc()[-4000:]
    finally:
        dist.destroy_process_group()
    return out


def _fake_batch(cfg: ModelConfig, b: int, s: int, kind: str, pol) -> dict:
    """The step's batch as fake tensors placed under ``pol`` (``input_specs``'
    shapes and dtypes; positions where M-RoPE needs them)."""
    from repro_torch.data.pipeline import BATCH_SPECS, input_specs
    from repro_torch.parallel.sharding import from_whole

    specs = input_specs(cfg, s, b, "train" if kind == "train" else "prefill")
    if kind == "prefill":
        specs.pop("labels")
    out = {}
    for k, m in specs.items():
        if m.dtype.is_floating_point:
            t = torch.randn(m.shape, dtype=m.dtype)
        else:
            t = torch.randint(0, cfg.vocab_size, m.shape, dtype=m.dtype)
        out[k] = from_whole(t, pol.mesh, pol.placements(pol.fit(t.shape, BATCH_SPECS[k])))
    return out


def _local_bytes(tree) -> int:
    from repro_torch.parallel.sharding import is_dtensor
    from repro_torch.tree import leaves

    total = 0
    for t in leaves(tree):
        if isinstance(t, torch.Tensor):
            t = t.to_local() if is_dtensor(t) else t
            total += t.numel() * t.element_size()
    return total


def _warm(step, args, pol) -> dict:
    """Run ``step(*args)`` once outside the counters; its retrace deltas.
    DTensor propagates the sharding of each op signature it has not seen by
    running the op on fake tensors of the global shapes, which MemTracker
    would take for the rank's own (a Llama-3.2-3B × train_4k microbatch's
    global logits alone are tens of GiB), so the measured run comes after
    this one."""
    from repro_torch.analysis import RetraceCounter
    from repro_torch.parallel.sharding import use_policy

    with use_policy(pol), RetraceCounter() as rc:
        step(*args)
    return rc.deltas


def _executed(step, args, pol, track: bool):
    """Run ``step(*args)`` once under ``pol`` and the cost mode (and, with
    ``track``, MemTracker): (cost, peak bytes or None, retrace deltas)."""
    from torch.distributed._tools.mem_tracker import MemTracker

    from repro_torch.analysis import RetraceCounter
    from repro_torch.parallel.sharding import use_policy
    from repro_torch.tree import leaves

    mt = MemTracker() if track else contextlib.nullcontext()
    if track:
        mt.track_external(*[t for t in leaves(args) if isinstance(t, torch.Tensor)])
    with mt, use_policy(pol), RetraceCounter() as rc:
        cost, _ = costing.cost_of(step, *args)
    peak = max((d["Total"] for d in mt.get_tracker_snapshot("peak").values()),
               default=0) if track else None
    return cost, peak, rc.deltas


def _cell(out: dict, mesh, arch: str, cfg: ModelConfig, cell: ShapeCell,
          train_config: Optional[TrainConfig], sampled: bool = False) -> None:
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.train import placed_params, placed_state
    from repro_torch.models import model as lm
    from repro_torch.parallel import policies
    from repro_torch.parallel.sharding import param_specs
    from repro_torch.train import serve as serving
    from repro_torch.train.step import make_train_step

    t0 = time.perf_counter()
    b, s = cell.global_batch, cell.seq_len
    pol_all = policies.make_policy(mesh, cfg, cell.kind, seq_len=s, global_batch=b)
    pol = pol_all.sharding
    tc = train_config or pol_all.train
    flags = analytic.ExecFlags(remat=(cell.kind == "train" and tc.remat),
                               causal_block_skip=cfg.attn_block_skip, chunk_len=cfg.chunk_len)
    roof = analytic.cell_roofline(cfg, arch, cell.name, cell.kind, b, s, pol, tc, flags,
                                  chips=out["chips"], mesh_desc=out["mesh"])
    out.update(policy_notes=list(pol_all.notes), microbatches=tc.microbatches,
               train_config=dataclasses.asdict(tc) if cell.kind == "train" else None,
               roofline=roof.as_dict())

    with FakeTensorMode(allow_non_fake_inputs=True):
        if cell.kind == "train":
            params, opt = placed_state(torch.Generator().manual_seed(0), cfg, tc, pol)
            state = {"params": params, "m": opt["m"], "v": opt["v"]}
            m = tc.microbatches
            # (microbatches, global batch) of each run: the step, or its
            # first one and two microbatches at the cell's microbatch shape.
            plan = [(1, b // m), (2, 2 * b // m)] if sampled and m > 2 else [(m, b)]
            runs = [(make_train_step(cfg, dataclasses.replace(tc, microbatches=mm)),
                     (params, opt, _fake_batch(cfg, bb, s, "train", pol))) for mm, bb in plan]
            cache_bytes = 0
        else:
            params = placed_params(torch.Generator().manual_seed(0), cfg, torch.bfloat16, pol)
            state = {"params": params}
            sc = serving.ServeConfig(max_len=s)
            if cell.kind == "prefill":
                runs = [(serving.make_prefill_step(cfg, sc),
                         (params, _fake_batch(cfg, b, s, "prefill", pol)))]
                cache_bytes = 0
            else:
                from repro_torch.parallel.sharding import distribute, from_whole

                caches = serving.init_serve_cache(cfg, sc, b, device="cpu")
                caches = distribute(caches, param_specs(lm.cache_logical_specs(caches, cfg),
                                                        caches, pol))
                cache_bytes = _local_bytes(caches)
                toks = torch.randint(0, cfg.vocab_size, (b, 1), dtype=torch.int32)
                toks = from_whole(toks, pol.mesh, pol.placements(pol.fit(toks.shape,
                                                                         ("batch", None))))
                runs = [(serving.make_decode_step(cfg, sc), (params, caches, toks, s - 1))]
        state_analytic = state_bytes(cfg, cell, out["shape"], train_config)
        out["memory"] = {"state_bytes_per_device": _local_bytes(state),
                         "state_bytes_analytic": state_analytic,
                         "cache_bytes_per_device": cache_bytes}
        t_setup = time.perf_counter() - t0
        out["retrace_first"] = _warm(*runs[-1], pol)
        done = [_executed(step, args, pol, track=i == len(runs) - 1)
                for i, (step, args) in enumerate(runs)]
    cost, peak, out["retrace"] = done[-1]
    if len(done) == 2:
        # The first microbatch's step and the first two's: each further
        # microbatch adds the difference (its forward, backward and
        # accumulation); the peak is the two-microbatch step's, as every
        # microbatch after the first repeats the second's live set.
        c1, c2 = done[0][0], done[1][0]
        per = Cost(c2.flops - c1.flops, c2.bytes - c1.bytes,
                   {k: v - c1.coll.get(k, 0.0) for k, v in c2.coll.items()})
        cost = c2 + per.scaled(tc.microbatches - 2)
        out["microbatches_run"] = [1, 2]
        out["executed_runs"] = {str(i + 1): {"flops_per_device": c.flops,
                                            "bytes_per_device": c.bytes,
                                            "collectives_bytes": c.coll}
                                for i, (c, _, _) in enumerate(done)}
    out["t_setup_s"] = round(t_setup, 2)
    out["t_step_s"] = round(time.perf_counter() - t0 - t_setup, 2)
    out["memory"].update(peak_bytes_per_device=peak,
                         total_per_device_gb=round(peak / 2**30, 3),
                         fits_80gb=peak <= analytic.HBM_BYTES)
    out["executed"] = {"flops_per_device": cost.flops, "bytes_per_device": cost.bytes,
                       "collectives_bytes": cost.coll,
                       **costing.roofline_terms(cost)}
    if cell.kind == "train":
        amem = analytic.train_memory_model(cfg, b, s, tc, pol, mesh, state_analytic)
    else:
        amem = analytic.serve_memory_model(cfg, b, s, cell.kind, pol, mesh, state_analytic,
                                           cache_bytes)
    out["analytic_memory"] = amem


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--cell", default=None)
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--reduced", action="store_true",
                    help="the CPU-test-sized config of each arch")
    ap.add_argument("--sampled", action="store_true",
                    help="run a train step of many microbatches as its first one and two")
    args = ap.parse_args(argv)

    meshes = [MESHES[m] for m in (("single", "multi") if args.mesh == "both" else (args.mesh,))]
    archs = C.ARCH_IDS if (args.all or args.arch is None) else (args.arch,)
    n_ok = n_fail = 0
    for mesh_name, shape in meshes:
        outdir = ART / mesh_name
        outdir.mkdir(parents=True, exist_ok=True)
        for arch in archs:
            cells = [c for c in C.applicable_cells(arch) if args.cell in (None, c)]
            for cell in cells:
                tag = f"{arch}__{cell}"
                res = run_cell(arch, cell, shape, mesh_name=mesh_name, reduced=args.reduced,
                               sampled=args.sampled)
                if res["ok"]:
                    n_ok += 1
                    roof = res["roofline"]
                    print(f"[OK]   {mesh_name:18s} {tag:38s} "
                          f"peak/dev={res['memory']['total_per_device_gb']:7.2f}GB "
                          f"bottleneck={roof['bottleneck']:10s} "
                          f"t=({roof['t_compute']:.2e},{roof['t_memory']:.2e},"
                          f"{roof['t_collective']:.2e})s step={res['t_step_s']:.1f}s", flush=True)
                else:
                    n_fail += 1
                    print(f"[FAIL] {mesh_name:18s} {tag:38s} {res['error'][:200]}", flush=True)
                (outdir / f"{tag}.json").write_text(json.dumps(res, indent=1))
    print(f"\ndry-run complete: {n_ok} ok, {n_fail} failed")
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
