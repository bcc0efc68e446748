"""§Perf hill climb: one execution-parameter variant of a cell at a time.

``--recompute``: refresh the roofline fields of every artifacts/dryrun_torch
JSON from the current analytic model (no new dry run — the executed
records are unchanged).

``--cell arch:cell[:mesh]``: run one hypothesis iteration — compute
baseline and candidate-variant roofline terms, and RE-LOWER the optimized
variant to prove it compiles and to capture the real memory delta. Results
land in artifacts/perf/<arch>__<cell>__<variant>.json; EXPERIMENTS.md §Perf
cites them.

Variants (the AL-DRAM execution-parameter moves):
  block_skip    — chunked_attention_skip (halves causal attention FLOPs,
                  removes S-sized scan-carry HBM traffic)
  cap_tight     — MoE capacity_factor → 1.0 (drops padding FLOPs)
  no_remat      — remat off (trades memory for 1/3 less compute+gathers)
  compress_pod  — int8 error-feedback grads over the pod/DCN axis
  chunk512      — attention chunk 256 → 512 (fewer, larger KV tiles)

The port of ``src/repro/launch/hillclimb.py`` over the port's analytic
model (H100 constants) and dry run. The meshes are
``parallel.sharding.MeshShape`` records, so the roofline terms need no
process group; ``lower=True`` dry-runs the variant (``dryrun.run_cell`` in a
process of its own, on fake tensors) with its config and ``TrainConfig``
handed over as arguments, where the reference patches ``configs.get`` and
``policies.make_policy`` around its lowering. Results land in
artifacts/perf_torch/<arch>__<cell>__<variant>.json; ``--recompute``
refreshes artifacts/dryrun_torch.
"""

import argparse
import dataclasses
import json
import pathlib

import repro_torch.configs as C
from repro_torch.launch import analytic
from repro_torch.parallel import policies
from repro_torch.parallel.sharding import MeshShape, mesh_size

ART = pathlib.Path(__file__).resolve().parents[3] / "artifacts"


def _terms(cfg, arch, cell_name, mesh_name, chips, flags, tc, pol):
    cell = C.SHAPES[cell_name]
    return analytic.cell_roofline(
        cfg, arch, cell_name, cell.kind, cell.global_batch, cell.seq_len,
        pol, tc, flags, chips=chips, mesh_desc=mesh_name,
    )


def recompute_all():
    meshes = {
        "single-pod-16x16": _make_mesh("single-pod-16x16", 1),
        "multi-pod-2x16x16": _make_mesh("multi-pod-2x16x16", 1),
    }
    for mesh_name, mesh in meshes.items():
        d = ART / "dryrun_torch" / mesh_name
        for f in sorted(d.glob("*.json")):
            r = json.loads(f.read_text())
            if not r.get("ok"):
                continue
            arch, cell_name = r["arch"], r["cell"]
            cfg = C.get(arch)
            cell = C.SHAPES[cell_name]
            pol_all = policies.make_policy(
                mesh, cfg, cell.kind, cell.seq_len, cell.global_batch
            )
            flags = analytic.ExecFlags(
                remat=(cell.kind == "train" and pol_all.train.remat),
                chunk_len=cfg.chunk_len,
            )
            roof = _terms(cfg, arch, cell_name, mesh_name, mesh_size(mesh), flags,
                          pol_all.train, pol_all.sharding)
            r["roofline"] = roof.as_dict()
            f.write_text(json.dumps(r, indent=1))
            print(f"recomputed {mesh_name}/{arch}__{cell_name}: "
                  f"bottleneck={roof.bottleneck}")


VARIANTS = {
    "block_skip": dict(
        cfg_repl={"attn_block_skip": True},
        flag_repl={"causal_block_skip": True},
    ),
    "cap_tight": dict(cfg_repl={}, flag_repl={"capacity_factor": 1.0}),
    "no_remat": dict(cfg_repl={}, flag_repl={"remat": False}, tc_repl={"remat": False}),
    "compress_pod": dict(cfg_repl={}, flag_repl={"compress_pod_grads": True},
                         tc_repl={"compress_grads": True}),
    "chunk512": dict(cfg_repl={"chunk_len": 512}, flag_repl={"chunk_len": 512}),
    # EXPERIMENTS §Perf cell 2 iterations 3/4: host-offloaded boundary
    # saves unlock fewer microbatches (= fewer FSDP gathers). For the
    # 4-pod run pass --pods 4.
    "offload_micro2": dict(
        cfg_repl={"attn_block_skip": True},
        flag_repl={"causal_block_skip": True},
        tc_repl={"microbatches": 2, "remat_offload": True},
    ),
}


def _make_mesh(mesh_name: str, pods: int) -> MeshShape:
    if pods > 2:
        return MeshShape(("pod", "data", "model"), (pods, 16, 16))
    if mesh_name.startswith("multi"):
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def run_variant(arch: str, cell_name: str, mesh_name: str, variant: str,
                lower: bool = True, pods: int = 1):
    from repro_torch.launch import dryrun

    mesh = _make_mesh(mesh_name, pods)
    cfg0 = C.get(arch)
    cell = C.SHAPES[cell_name]
    pol_all = policies.make_policy(mesh, cfg0, cell.kind, cell.seq_len,
                                   cell.global_batch)
    v = VARIANTS[variant]

    base_flags = analytic.ExecFlags(
        remat=(cell.kind == "train" and pol_all.train.remat),
        chunk_len=cfg0.chunk_len,
    )
    base = _terms(cfg0, arch, cell_name, mesh_name, mesh_size(mesh), base_flags,
                  pol_all.train, pol_all.sharding)

    cfg1 = dataclasses.replace(cfg0, **v["cfg_repl"])
    flags1 = dataclasses.replace(base_flags, **v["flag_repl"])
    tc1 = dataclasses.replace(pol_all.train, **v.get("tc_repl", {}))
    opt = _terms(cfg1, arch, cell_name, mesh_name, mesh_size(mesh), flags1,
                 tc1, pol_all.sharding)

    result = {
        "arch": arch, "cell": cell_name, "mesh": mesh_name,
        "variant": variant,
        "baseline": base.as_dict(),
        "optimized": opt.as_dict(),
        "delta": {
            "t_compute": base.t_compute - opt.t_compute,
            "t_memory": base.t_memory - opt.t_memory,
            "t_collective": base.t_collective - opt.t_collective,
            "dominant_before": base.bottleneck,
            "dominant_after": opt.bottleneck,
            "lower_bound_speedup": (
                max(base.t_compute, base.t_memory, base.t_collective)
                / max(opt.t_compute, opt.t_memory, opt.t_collective)
            ),
        },
    }
    if lower:
        # Prove the optimized variant runs under the production mesh and
        # capture its per-device memory: the dry run takes the variant's
        # config and TrainConfig as arguments.
        res = dryrun.run_cell(arch, cell_name, tuple(mesh.sizes), cfg=cfg1,
                              train_config=tc1 if cell.kind == "train" else None,
                              mesh_name=mesh_name)
        if res["ok"]:
            result["optimized_compile"] = {
                "ok": True,
                "memory": res["memory"],
                "analytic_memory": res["analytic_memory"],
                "t_step_s": res["t_step_s"],
            }
        else:
            result["optimized_compile"] = {"ok": False, "error": res["error"]}
    out = ART / "perf_torch"
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"{arch}__{cell_name}__{variant}.json"
    path.write_text(json.dumps(result, indent=1))
    d = result["delta"]
    print(f"{arch}/{cell_name} [{variant}]: "
          f"lower-bound speedup ×{d['lower_bound_speedup']:.2f} "
          f"({d['dominant_before']}→{d['dominant_after']})")
    return result


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--recompute", action="store_true")
    ap.add_argument("--cell", default=None, help="arch:cell[:mesh]")
    ap.add_argument("--variant", default="block_skip")
    ap.add_argument("--no-lower", action="store_true")
    ap.add_argument("--pods", type=int, default=1)
    args = ap.parse_args()
    if args.recompute:
        recompute_all()
        return
    if args.cell:
        parts = args.cell.split(":")
        arch, cell = parts[0], parts[1]
        mesh = parts[2] if len(parts) > 2 else "single-pod-16x16"
        run_variant(arch, cell, mesh, args.variant, lower=not args.no_lower,
                    pods=args.pods)


if __name__ == "__main__":
    main()
