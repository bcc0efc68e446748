#!/usr/bin/env python3
"""Time the latency-matmul and flash-attention CUDA kernels by tile on one
card, for this tree or an older one, and for design alternatives of their
sources.

    python3 tools/kernel_variants.py [--src DIR] [--variants] [--clocks] [--sass] [--out FILE]

Builds ``csrc/latency_matmul.cu`` and ``csrc/flash_attention.cu`` of the
tree whose ``src`` directory is ``--src`` (default: this checkout's), so an
unpacked older tree can be timed in the same call. Every tile is checked
against its plain version on small ragged cases, then timed with
``chip_smoke.cuda_ms``: the matmul at 4096³ float32 (the best tile also on
rows that are not 16-byte aligned, the kernel's register path), attention
at ``chip_smoke``'s serve and altune shapes. The library calls and bounds
at those shapes are ``chip_smoke.py``'s.

``--variants`` also builds each source with one design alternative edited
in (``VARIANTS``: text replacements applied to a copy of the source under
``build/variants``), checks and times it the same way, then times the
unedited build again. ``--clocks`` samples the SM clock and power draw
(``nvidia-smi -lms 100``) while the best matmul tile, ``torch.matmul`` and
the best attention tile at altune's shape each run for about two seconds.
``--sass`` adds each kernel's opcode counts (``cuobjdump -sass``). Prints
one JSON line (also to ``--out``).
"""

from __future__ import annotations

import argparse
import ctypes
import inspect
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (stdlib imports only at module level)

MM = 4096
_MM_K_LOOP = ("for (int kk = 0; kk < BK; kk += 2) {", "float a[8][2];",
              "const float2 v = *reinterpret_cast<const float2*>",
              "a[i][0] = v.x, a[i][1] = v.y;", "for (int j = 0; j < 2; ++j) {")
#: label -> [(text of the source, its replacement), ...]; every text must
#: occur in the source (all occurrences are replaced).
VARIANTS = {
    "latency_matmul": {
        "ring of 2 stages": [("kMaxStages = 4;", "kMaxStages = 2;")],
        "ring of 3 stages": [("kMaxStages = 4;", "kMaxStages = 3;")],
        "x 4 k a load": list(zip(_MM_K_LOOP, (
            "for (int kk = 0; kk < BK; kk += 4) {", "float a[8][4];",
            "const float4 v = *reinterpret_cast<const float4*>",
            "a[i][0] = v.x, a[i][1] = v.y, a[i][2] = v.z, a[i][3] = v.w;",
            "for (int j = 0; j < 4; ++j) {"))),
        "k loop not unrolled": [("#pragma unroll\n    for (int kk = 0;",
                                 "#pragma unroll 1\n    for (int kk = 0;")],
        "one masked copy path": [("if (full) {  // straight-line", "if (false) {  // straight-line")],
        "row-major block order": [(
            "  const int first = bid / (kGroup * gn) * kGroup, rows = min(gm - first, kGroup);\n"
            "  const int bm_i = first + bid % (kGroup * gn) % rows, bn_i = bid % (kGroup * gn) / rows;",
            "  const int bm_i = bid / gn, bn_i = bid % gn;")],
    },
    "flash_attention": {
        "wait on each copy": [
            ("// V(t): in flight during S and the softmax\n    cp_async_commit();",
             "// V(t)\n    cp_async_commit();\n    cp_async_wait_all();"),
            ("// K(t + 1): in flight during P V\n      cp_async_commit();",
             "// K(t + 1)\n      cp_async_commit();\n      cp_async_wait_all();")],
        "16 scores a thread": [("kScores = 32;", "kScores = 16;")],
        "unroll 1": [("#pragma unroll 4\n", "#pragma unroll 1\n")],
        "unroll 8": [("#pragma unroll 4\n", "#pragma unroll 8\n")],
    },
}


def build_variants(_build) -> dict:
    """Every variant of ``VARIANTS`` built, one ``nvcc`` each, all started
    together: (name, label) -> loaded library."""
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, variants in VARIANTS.items():
        base = (_build.CSRC_DIR / f"{name}.cu").read_text()
        for i, (label, edits) in enumerate(variants.items()):
            src = base
            for old, new in edits:
                if old not in src:
                    sys.exit(f"kernel_variants: {name} variant {label!r}: {old!r} not in the source")
                src = src.replace(old, new)
            path = out_dir / f"{name}_{i}.cu"
            path.write_text(src)
            target = path.with_suffix(".so")
            procs[name, label] = (subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(target), str(path)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), target)
    libs = {}
    for key, (proc, target) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            sys.exit(f"kernel_variants: nvcc failed for {key}:\n{log}")
        libs[key] = ctypes.CDLL(str(target))
        libs[key].error_string.argtypes = [ctypes.c_int]
        libs[key].error_string.restype = ctypes.c_char_p
    return libs


def use_lib(module, lib) -> None:
    """Point ``module``'s wrapper at ``lib`` (argtypes copied from its own)."""
    own = module._lib()
    for fn in ("latency_matmul_launch", "flash_attention_launch"):
        if hasattr(own, fn):
            getattr(lib, fn).argtypes = getattr(own, fn).argtypes
            getattr(lib, fn).restype = getattr(own, fn).restype
    module._lib = lambda: lib


def sass_mix(_build, name: str) -> dict:
    """The 12 commonest opcodes, and the total, of every kernel in
    ``csrc/<name>.cu``'s build."""
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", str(_build.library_path(name))],
                          capture_output=True, text=True, check=True).stdout
    mix, fn = {}, None
    for ln in text.splitlines():
        if "Function :" in ln:
            fn = ln.split("Function :")[1].strip()
            mix[fn] = {}
        elif fn and ln.strip().startswith("/*") and "*/" in ln:
            body = ln.split("*/", 1)[1].strip()
            if body and not body.startswith("/*"):
                op = body.split()[1] if body.startswith("@") else body.split()[0]
                op = op.split(".")[0].rstrip(";")
                mix[fn][op] = mix[fn].get(op, 0) + 1
    return {f: dict(sorted(c.items(), key=lambda kv: -kv[1])[:12]) | {"total": sum(c.values())}
            for f, c in mix.items()}


def under_load(torch, fn, seconds: float = 2.0) -> dict:
    """Median SM clock (MHz) and power draw (W) that nvidia-smi reports while
    ``fn`` runs back to back for about ``seconds``."""
    reps = max(1, int(seconds / (chip_smoke.cuda_ms(torch, fn, 1) * 1e-3)))
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "100"],
                           stdout=subprocess.PIPE, text=True)
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    smi.terminate()
    rows = [ln.split(",") for ln in smi.communicate()[0].splitlines() if "," in ln]
    rows = rows[len(rows) // 4:] or rows  # drop the ramp
    med = lambda col: sorted(float(r[col]) for r in rows)[len(rows) // 2]  # noqa: E731
    return {"sm_mhz": med(0), "power_w": med(1), "samples": len(rows)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--clocks", action="store_true")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    import torch

    if not torch.cuda.is_available():
        sys.exit("kernel_variants: needs an NVIDIA GPU")
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as fa_k
    from repro_torch.kernels.latency_matmul import kernel as mm_k

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    _build.build(["latency_matmul", "flash_attention"])
    # A tree from before attention had several tiles has one and no ``tile``.
    fa_tiles = getattr(fa_k, "TILES", ((64, 64),))
    has_tile = "tile" in inspect.signature(fa_k.flash_attention_cuda).parameters

    def fa(q, k, v, tile, causal=True, window=0):
        kw = {"tile": tile} if has_tile else {}
        return fa_k.flash_attention_cuda(q, k, v, causal=causal, window=window, **kw)

    def rand(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    mm_cases = [(rand(1000, 3000), rand(3000, 700)),
                (rand(1000, 3000, dtype=torch.bfloat16), rand(3000, 700, dtype=torch.bfloat16)),
                (rand(257, 520)[:, :517], rand(517, 300))]
    fa_cases = []
    for b, sq, skv, h, hk, dh, causal, window in (
            (2, 200, 200, 24, 8, 128, True, 0), (1, 300, 300, 8, 4, 64, True, 100),
            (2, 130, 77, 9, 3, 64, False, 0), (2, 97, 97, 4, 4, 32, True, 0)):
        qkv = rand(b, max(sq, skv), h + 2 * hk, dh)  # strided views of one tensor
        fa_cases.append((qkv[:, :sq, :h], qkv[:, :skv, h:h + hk], qkv[:, :skv, h + hk:],
                         causal, window))

    def check(label: str) -> float:
        worst = 0.0
        for x, y in mm_cases:
            want = mm_k.matmul_plain(x, y)
            for t in mm_k.TILES:
                err = float((mm_k.matmul_cuda(x, y, *t).float() - want.float()).abs().max())
                if not err <= mm_k.tolerance(want):
                    sys.exit(f"{label}: latency matmul {t} wrong on {tuple(x.shape)}: {err}")
                worst = max(worst, err)
        for q, k, v, causal, window in fa_cases:
            want = fa_k.flash_attention_plain(q, k, v, causal=causal, window=window)
            for t in fa_tiles:
                err = float((fa(q, k, v, t, causal, window) - want).abs().max())
                if not err <= fa_k.tolerance(want):
                    sys.exit(f"{label}: flash attention {t} wrong on {tuple(q.shape)}: {err}")
                worst = max(worst, err)
        return worst

    x, y = rand(MM, MM), rand(MM, MM)
    xu, yu = rand(MM, MM + 1)[:, :MM], rand(MM, MM + 1)[:, :MM]
    shapes = {}
    for label, (b, s, h, hk, dh) in (("serve", chip_smoke.FA_SERVE_SHAPE),
                                     ("altune", chip_smoke.FA_ALTUNE_SHAPE)):
        shapes[label] = (rand(b, s, h, dh), rand(b, s, hk, dh), rand(b, s, hk, dh))

    def timed(label: str) -> dict:
        """Every tile's ms at the production shapes, after the checks."""
        out = {"max_abs_err": check(label)}
        for t in mm_k.TILES:
            out[f"matmul {t}"] = chip_smoke.cuda_ms(torch, lambda t=t: mm_k.matmul_cuda(x, y, *t), 10)
        best = min(mm_k.TILES, key=lambda t: out[f"matmul {t}"])
        out[f"matmul {best} unaligned rows"] = chip_smoke.cuda_ms(
            torch, lambda: mm_k.matmul_cuda(xu, yu, *best), 3)
        for shape, (q, k, v) in shapes.items():
            for t in fa_tiles:
                out[f"attention {shape} {t}"] = chip_smoke.cuda_ms(
                    torch, lambda t=t: fa(q, k, v, t), 20 if shape == "serve" else 3)
        return out

    res = {"card": chip_smoke.nvidia_smi(), "src": os.path.abspath(args.src),
           "ms": timed("default build")}
    if args.sass:
        res["sass"] = {name: sass_mix(_build, name) for name in VARIANTS}
    if args.variants:
        libs = build_variants(_build)
        res["variants_ms"] = {}
        for (name, label), lib in libs.items():
            module = mm_k if name == "latency_matmul" else fa_k
            own = module._lib
            use_lib(module, lib)
            res["variants_ms"][f"{name}: {label}"] = timed(f"{name} variant {label!r}")
            module._lib = own
        res["default_again_ms"] = timed("default build again")
    if args.clocks:
        best_mm = min(mm_k.TILES, key=lambda t: res["ms"][f"matmul {t}"])
        best_fa = min(fa_tiles, key=lambda t: res["ms"][f"attention altune {t}"])
        q, k, v = shapes["altune"]
        res["clocks"] = {
            f"matmul {best_mm}": under_load(torch, lambda: mm_k.matmul_cuda(x, y, *best_mm)),
            "torch.matmul": under_load(torch, lambda: torch.matmul(x, y)),
            f"attention altune {best_fa}": under_load(torch, lambda: fa(q, k, v, best_fa))}
    line = json.dumps(res)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
