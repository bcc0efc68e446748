#!/usr/bin/env python3
"""Time five of the port's CUDA kernels by tile on one card, for this tree or
an older one, and for design alternatives of their sources.

    python3 tools/kernel_variants.py [--kernels K,...] [--src DIR] [--variants]
                                     [--clocks] [--sass] [--out FILE]

``--kernels`` picks among ``latency_matmul``, ``flash_attention``,
``flash_decode``, ``replay_step`` and ``charge_sweep`` (default: all five).
Builds their ``csrc/<name>.cu`` of the tree whose ``src`` directory is ``--src``
(default: this checkout's), so an unpacked older tree can be timed in the
same call. Every kernel is first checked against its plain version on small
ragged cases (the replay chunk bitwise, at 4,099 and 4,112 DIMMs and chunks
1, 37, 160 and 256; decode at lengths on its step and split edges and on
bfloat16 rows on 8-byte boundaries), then timed with ``chip_smoke.cuda_ms``:
the matmul at 4096³ float32 (the best tile also on rows that are not
16-byte aligned, the kernel's register path), attention at ``chip_smoke``'s
serve and altune shapes, decode at altune's production shape (every tile in
float32, the best in bfloat16), the replay chunk at the serve shape
(1,048,576 DIMMs × 256 steps, and 1,048,573 DIMMs for the unaligned copy
path) and at trace-eval's chunk 1 × 65,536 DIMMs, there as device time per
launch from ``torch.profiler`` (``chip_smoke.device_ms``); the charge sweep,
checked bitwise on every stack, at the boot shape (a seed-0 fleet of
1,048,576 DIMMs × 4 boot bins) and on its worst-case stack, where every
search walks its whole grid (``chip_smoke.sweep_worst_case``), and checked on
100,003 mixed lanes (``chip_smoke.sweep_mixed_lanes``).

``--variants`` also builds each source with one design alternative edited
in (``VARIANTS``: text replacements applied to a copy of the source under
``build/variants``), checks and times it the same way, then times the
unedited build again. ``--clocks`` samples the SM clock and power draw
(``nvidia-smi -lms 100``) while the best matmul tile, ``torch.matmul`` and
the best attention tile at altune's shape each run for about two seconds.
``--sass`` adds each kernel's opcode counts (``cuobjdump -sass``; with
``--variants``, the variants' too). Prints one JSON line (also to
``--out``).
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
#: Decode's production shape (altune's): B, L, H, Hk, dh.
FD_SHAPE = (8, 32768, 64, 8, 128)
#: The replay chunk's timing shapes: the serve path's (DIMMs, steps, bins),
#: the same on a fleet whose rows a 16-byte copy cannot take, and
#: trace-eval's chunk 1 (timed as device time over REPLAY_STEP1_LAUNCHES).
REPLAY_SERVE = (1 << 20, 256, 4)
REPLAY_UNALIGNED = ((1 << 20) - 3, 256, 4)
REPLAY_STEP1 = (65536, 1, 5)
REPLAY_STEP1_LAUNCHES = 200
_MM_K_LOOP = ("for (int kk = 0; kk < BK; kk += 2) {", "float a[8][2];",
              "const float2 v = *reinterpret_cast<const float2*>",
              "a[i][0] = v.x, a[i][1] = v.y;", "for (int j = 0; j < 2; ++j) {")
_FD_K_ONCE = ("      const float4 kk = ld4(ks + (sub * RL + r) * DH + c4);\n#pragma unroll\n"
              "      for (int g = 0; g < kMaxG; ++g) {\n")
_REPLAY_STEP = "step(tt[r * kThreads], te[r * kErrRow + off] != 0);"
_REPLAY_SUMS = ("#pragma unroll\n"
                "    for (int j = 0; j < kSlots; ++j) sums[j] = sums[j] + rp[j * kRowStride];\n")
_SWEEP_FIRST_PASS = ("  if (mask) {\n"
                     "    float kf = 1.0f;\n"
                     "    for (int32_t k = 0; k < n_grid - 1; ++k, kf += 1.0f) {\n"
                     "      if (pass(kf * tck)) return k;\n"
                     "    }\n"
                     "  }\n"
                     "  return n_grid - 1;\n")
#: The 28-candidate walk of every search (the longest grid), no early exit.
_SWEEP_NO_GUARDS = ("  int32_t idx = n_grid - 1;\n"
                    "  bool found = false;\n"
                    "  for (int32_t k = 0; k < 28; ++k) {\n"
                    "    const bool ok =\n"
                    "        pass(static_cast<float>(k + 1) * tck) & mask & (k < n_grid);\n"
                    "    if (ok && !found) idx = k;\n"
                    "    found = found || ok;\n"
                    "  }\n"
                    "  return idx;\n")
_SWEEP_SHORTCUT = "  if (ta <= 0.0f) return latched >= thr;\n"
_SWEEP_OUT = "  int32_t* out = idx_out + c;\n"
#: Design (i): one candidate loop over all seven searches, each guarded by its
#: own done flag; the warp leaves once every lane is done. Lanes past n stay
#: in the loop as done (a full-mask vote), reading a live cell, storing nothing.
_SWEEP_ONE_LOOP = """\
  int32_t idx[kSearches];
  bool done[kSearches];
  bool all_done = true;
#pragma unroll
  for (int j = 0; j < kSearches; ++j) {
    idx[j] = p.n_grid[j] - 1;
    done[j] = !(live && mask[j]);
    all_done = all_done && done[j];
  }
  float kf = 1.0f;
  for (int32_t k = 0; !__all_sync(0xffffffffu, all_done); ++k, kf += 1.0f) {
    const float t = kf * p.tck;
    bool pass[kSearches] = {false, false, false, false, false, false, false};
    if (!done[0]) pass[0] = dv0_r * expf((t - p.ovh_rcd) / rts) >= p.thr_sense;
    if (!done[1])
      pass[1] = restored(t - p.ovh_ras - t_sense_r, rtr, 1.0f, p.one_minus_vrs, latched_r,
                         thr_rest);
    if (!done[2]) pass[2] = p.v_half * expf(-(t - p.ovh_rp) / rtb) <= thr_trp;
    pass[3] = t >= thr_trcd_w;
    if (!done[4])
      pass[4] = restored(t - p.ovh_ras - t_sense_w, tau_wr, p.v_over, p.v_over_minus_vrs,
                         latched_w, thr_rest);
    if (!done[5]) pass[5] = p.v_over * (1.0f - expf(-(t - p.ovh_wr) / tau_wr)) >= thr_rest;
    pass[6] = t >= thr_trp_w;
    all_done = true;
#pragma unroll
    for (int j = 0; j < kSearches; ++j) {
      if (!done[j] && pass[j]) idx[j] = k;
      done[j] = done[j] || pass[j] || k + 2 >= p.n_grid[j];
      all_done = all_done && done[j];
    }
  }
  if (live) {
#pragma unroll
    for (int j = 0; j < kSearches; ++j) idx_out[j * n + c] = idx[j];
  }
  return;
"""
#: Two cells a thread, c and c + kThreads of a block of 2 * kThreads cells:
#: each search's loop evaluates both cells' candidates side by side (their
#: expf and division independent, for instruction-level parallelism) until
#: both are done.
_SWEEP_TWO_CELLS = """\
template <class Pass>
__device__ __forceinline__ void first_pass2(const bool* mask, int32_t n_grid, float tck,
                                            int32_t* idx, Pass pass) {
  bool left0 = mask[0], left1 = mask[1];
  idx[0] = idx[1] = n_grid - 1;
  float kf = 1.0f;
  for (int32_t k = 0; k < n_grid - 1 && (left0 || left1); ++k, kf += 1.0f) {
    const float t = kf * tck;
    const bool p0 = pass(0, t), p1 = pass(1, t);
    if (left0 && p0) idx[0] = k, left0 = false;
    if (left1 && p1) idx[1] = k, left1 = false;
  }
}

__global__ void __launch_bounds__(kThreads)
charge_sweep_kernel2(const float* __restrict__ inv, int32_t* __restrict__ idx_out,
                     int64_t n, SweepParams p) {
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * 2 * kThreads + threadIdx.x;
  float dv0_r[2], rts[2], t_sense_r[2], thr_rest[2], rtr[2], rtb[2], thr_trp[2], tau_wr[2],
      t_sense_w[2], thr_trcd_w[2], thr_trp_w[2];
  bool mask[kSearches][2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool live = c0 + i * kThreads < n;
    const int64_t c = live ? c0 + i * kThreads : n - 1;  // a lane past n reads a live cell
    dv0_r[i] = inv[0 * n + c];
    rts[i] = inv[1 * n + c];
    t_sense_r[i] = inv[2 * n + c];
    thr_rest[i] = inv[3 * n + c];
    rtr[i] = inv[4 * n + c];
    rtb[i] = inv[5 * n + c];
    thr_trp[i] = inv[6 * n + c];
    tau_wr[i] = inv[7 * n + c];
    t_sense_w[i] = inv[8 * n + c];
    thr_trcd_w[i] = inv[9 * n + c];
    thr_trp_w[i] = inv[10 * n + c];
#pragma unroll
    for (int j = 0; j < kSearches; ++j) mask[j][i] = live && inv[(11 + j) * n + c] > 0.5f;
  }
  const float latched_r = 1.0f - p.one_minus_vrs;
  const float latched_w = p.v_over - p.v_over_minus_vrs;
  int32_t idx[kSearches][2];
  first_pass2(mask[0], p.n_grid[0], p.tck, idx[0], [&](int i, float t) {
    return dv0_r[i] * expf((t - p.ovh_rcd) / rts[i]) >= p.thr_sense;
  });
  first_pass2(mask[1], p.n_grid[1], p.tck, idx[1], [&](int i, float t) {
    return restored(t - p.ovh_ras - t_sense_r[i], rtr[i], 1.0f, p.one_minus_vrs, latched_r,
                    thr_rest[i]);
  });
  first_pass2(mask[2], p.n_grid[2], p.tck, idx[2], [&](int i, float t) {
    return p.v_half * expf(-(t - p.ovh_rp) / rtb[i]) <= thr_trp[i];
  });
  first_pass2(mask[3], p.n_grid[3], p.tck, idx[3],
              [&](int i, float t) { return t >= thr_trcd_w[i]; });
  first_pass2(mask[4], p.n_grid[4], p.tck, idx[4], [&](int i, float t) {
    return restored(t - p.ovh_ras - t_sense_w[i], tau_wr[i], p.v_over, p.v_over_minus_vrs,
                    latched_w, thr_rest[i]);
  });
  first_pass2(mask[5], p.n_grid[5], p.tck, idx[5], [&](int i, float t) {
    return p.v_over * (1.0f - expf(-(t - p.ovh_wr) / tau_wr[i])) >= thr_rest[i];
  });
  first_pass2(mask[6], p.n_grid[6], p.tck, idx[6],
              [&](int i, float t) { return t >= thr_trp_w[i]; });
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (c0 + i * kThreads < n) {
#pragma unroll
      for (int j = 0; j < kSearches; ++j) idx_out[j * n + c0 + i * kThreads] = idx[j][i];
    }
  }
}

}  // namespace
"""
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
    "flash_decode": {
        "ring of 2 stages": [("kStages = 4;", "kStages = 2;")],
        "ring of 3 stages": [("kStages = 4;", "kStages = 3;")],
        "ring of 6 stages": [("kStages = 4;", "kStages = 6;"), ("kMinBlocks = 3;", "kMinBlocks = 2;")],
        "wait on every copy": [("cp_async_wait<kStages - 2>();", "cp_async_wait<0>();")],
        # A K row reloaded from shared memory for every head of the group: the
        # offset g * (group >> 8) is 0 at run time, unknown to the compiler.
        "K read once per head": [(_FD_K_ONCE, (
            "#pragma unroll\n      for (int g = 0; g < kMaxG; ++g) {\n"
            "        const float4 kk = ld4(ks + (sub * RL + r) * DH + c4 + g * (a.group >> 8));\n"))],
        "8 warps a block": [("kWarps = 4;", "kWarps = 8;"), ("kMinBlocks = 3;", "kMinBlocks = 1;")],
    },
    "replay_step": {
        "ring of 3 stages": [("kStages = 2;", "kStages = 3;")],
        "ring of 4 stages": [("kStages = 2;", "kStages = 4;")],
        "tiles of 4 steps, ring of 4": [("kSteps = 8;", "kSteps = 4;"), ("kStages = 2;", "kStages = 4;")],
        "direct loads": [("if (s < n_tiles) {", "if (false) {"), (_REPLAY_STEP, (
            "step(temps[static_cast<int64_t>(k0 + r) * n + i], "
            "errs[static_cast<int64_t>(k0 + r) * n + i] != 0);"))],
        "narrow copies at every n": [("return n % 16 == 0 &&", "return false &&")],
        "staged kernel at chunk 1": [("if (chunk < kSteps) {", "if (false) {")],
        "row cached until the bin changes": [
            ("  int32_t bin = 0, streak = 0, sw = 0;\n",
             "  int32_t bin = 0, streak = 0, sw = 0, cur = -1;\n  float row[kSlots] = {};\n"),
            (_REPLAY_SUMS, "    if (eff_bin != cur) {\n" + _REPLAY_SUMS.replace(
                "sums[j] = sums[j] + rp[j * kRowStride];", "row[j] = rp[j * kRowStride];")
             + "      cur = eff_bin;\n    }\n" + _REPLAY_SUMS.replace("rp[j * kRowStride]", "row[j]"))],
        "select chain every step": [(_REPLAY_SUMS, (
            "    for (int j = 0; j < kSlots; ++j) {\n"
            "      float row = s_rows[j * kRowStride + NB * kThreads + tid];\n"
            "#pragma unroll\n"
            "      for (int b = NB - 1; b >= 0; --b)\n"
            "        row = eff_bin == b ? s_rows[j * kRowStride + b * kThreads + tid] : row;\n"
            "      sums[j] = sums[j] + row;\n"
            "    }\n"))],
    },
    "charge_sweep": {
        "(i) one candidate loop": [
            ("  if (c >= n) return;\n",
             "  const bool live = c < n;\n  const int64_t cl = live ? c : n - 1;\n"),
            ("* n + c]", "* n + cl]"), (_SWEEP_OUT, _SWEEP_ONE_LOOP + _SWEEP_OUT)],
        "tRAS shortcut off": [(_SWEEP_SHORTCUT, "")],
        "last candidate evaluated": [("k < n_grid - 1; ++k", "k < n_grid; ++k")],
        "candidate converted from k each time": [
            ("if (pass(kf * tck))", "if (pass(static_cast<float>(k + 1) * tck))")],
        "search loops unrolled by 2": [(
            "    for (int32_t k = 0; k < n_grid - 1; ++k, kf += 1.0f) {\n",
            "#pragma unroll 2\n    for (int32_t k = 0; k < n_grid - 1; ++k, kf += 1.0f) {\n")],
        "guards off (every search walks 28 candidates)": [(_SWEEP_FIRST_PASS, _SWEEP_NO_GUARDS)],
        "guards and tRAS shortcut off": [(_SWEEP_FIRST_PASS, _SWEEP_NO_GUARDS),
                                         (_SWEEP_SHORTCUT, "")],
        "two cells a thread": [
            ("}  // namespace\n", _SWEEP_TWO_CELLS),
            ("charge_sweep_kernel<<<", "charge_sweep_kernel2<<<"),
            ("(n + kThreads - 1) / kThreads", "(n + 2 * kThreads - 1) / (2 * kThreads)")],
        "128 threads a block": [("kThreads = 256;", "kThreads = 128;")],
        "512 threads a block": [("kThreads = 256;", "kThreads = 512;")],
    },
}
#: The C launchers whose ctypes signatures a variant's library copies.
LAUNCHERS = ("latency_matmul_launch", "flash_attention_launch", "flash_decode_launch",
             "replay_chunk_launch", "replay_max_bins", "charge_sweep_launch")


def build_variants(_build, names) -> dict:
    """Every variant of ``VARIANTS`` of the named sources built, one ``nvcc``
    each, all started together: (name, label) -> (loaded library, path)."""
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        base = (_build.CSRC_DIR / f"{name}.cu").read_text()
        for i, (label, edits) in enumerate(VARIANTS[name].items()):
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
        lib = ctypes.CDLL(str(target))
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        libs[key] = (lib, target)
    return libs


def use_lib(module, lib) -> None:
    """Point ``module``'s wrapper at ``lib`` (argtypes copied from its own)."""
    own = module._lib()
    for fn in LAUNCHERS:
        if hasattr(own, fn):
            getattr(lib, fn).argtypes = getattr(own, fn).argtypes
            getattr(lib, fn).restype = getattr(own, fn).restype
    module._lib = lambda: lib


#: Opcodes always reported by ``--sass``, beside the commonest.
SASS_KEYS = ("FFMA", "FADD", "LDS", "LDG", "LDGSTS", "SHFL", "SEL", "FSEL", "ISETP", "FSETP",
             "MUFU", "FCHK", "BRA", "VOTE")


def sass_mix(_build, lib_path) -> dict:
    """The 12 commonest opcodes, ``SASS_KEYS`` and the total, of every kernel
    in the library at ``lib_path``."""
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", str(lib_path)],
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
    return {f: dict(sorted(c.items(), key=lambda kv: -kv[1])[:12])
            | {k: c.get(k, 0) for k in SASS_KEYS} | {"total": sum(c.values())}
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


# One suite a kernel: ``check(label)`` holds every tile against the plain
# version on small cases (exits on a miss; returns the largest error),
# ``timed()`` returns ms at the production shapes, and ``module`` is the
# wrapper module whose ``_lib`` a variant replaces.
class MatmulSuite:
    def __init__(self, torch, rand):
        from repro_torch.kernels.latency_matmul import kernel as mm_k
        self.torch, self.module = torch, mm_k
        self.cases = [(rand(1000, 3000), rand(3000, 700)),
                      (rand(1000, 3000, dtype=torch.bfloat16),
                       rand(3000, 700, dtype=torch.bfloat16)),
                      (rand(257, 520)[:, :517], rand(517, 300))]
        self.x, self.y = rand(MM, MM), rand(MM, MM)
        self.xu, self.yu = rand(MM, MM + 1)[:, :MM], rand(MM, MM + 1)[:, :MM]

    def check(self, label):
        mm_k, worst = self.module, 0.0
        for x, y in self.cases:
            want = mm_k.matmul_plain(x, y)
            for t in mm_k.TILES:
                err = float((mm_k.matmul_cuda(x, y, *t).float() - want.float()).abs().max())
                if not err <= mm_k.tolerance(want):
                    sys.exit(f"{label}: latency matmul {t} wrong on {tuple(x.shape)}: {err}")
                worst = max(worst, err)
        return worst

    def timed(self):
        mm_k, out = self.module, {}
        for t in mm_k.TILES:
            out[f"matmul {t}"] = chip_smoke.cuda_ms(
                self.torch, lambda t=t: mm_k.matmul_cuda(self.x, self.y, *t), 10)
        best = min(mm_k.TILES, key=lambda t: out[f"matmul {t}"])
        out[f"matmul {best} unaligned rows"] = chip_smoke.cuda_ms(
            self.torch, lambda: mm_k.matmul_cuda(self.xu, self.yu, *best), 3)
        return out


class AttentionSuite:
    def __init__(self, torch, rand):
        from repro_torch.kernels.flash_attention import kernel as fa_k
        self.torch, self.module = torch, fa_k
        # A tree from before attention had several tiles has one and no ``tile``.
        self.tiles = getattr(fa_k, "TILES", ((64, 64),))
        self.has_tile = "tile" in inspect.signature(fa_k.flash_attention_cuda).parameters
        self.cases = []
        for b, sq, skv, h, hk, dh, causal, window in (
                (2, 200, 200, 24, 8, 128, True, 0), (1, 300, 300, 8, 4, 64, True, 100),
                (2, 130, 77, 9, 3, 64, False, 0), (2, 97, 97, 4, 4, 32, True, 0)):
            qkv = rand(b, max(sq, skv), h + 2 * hk, dh)  # strided views of one tensor
            self.cases.append((qkv[:, :sq, :h], qkv[:, :skv, h:h + hk],
                               qkv[:, :skv, h + hk:], causal, window))
        self.shapes = {}
        for label, (b, s, h, hk, dh) in (("serve", chip_smoke.FA_SERVE_SHAPE),
                                         ("altune", chip_smoke.FA_ALTUNE_SHAPE)):
            self.shapes[label] = (rand(b, s, h, dh), rand(b, s, hk, dh), rand(b, s, hk, dh))

    def run(self, q, k, v, tile, causal=True, window=0):
        kw = {"tile": tile} if self.has_tile else {}
        return self.module.flash_attention_cuda(q, k, v, causal=causal, window=window, **kw)

    def check(self, label):
        fa_k, worst = self.module, 0.0
        for q, k, v, causal, window in self.cases:
            want = fa_k.flash_attention_plain(q, k, v, causal=causal, window=window)
            for t in self.tiles:
                err = float((self.run(q, k, v, t, causal, window) - want).abs().max())
                if not err <= fa_k.tolerance(want):
                    sys.exit(f"{label}: flash attention {t} wrong on {tuple(q.shape)}: {err}")
                worst = max(worst, err)
        return worst

    def timed(self):
        out = {}
        for shape, (q, k, v) in self.shapes.items():
            for t in self.tiles:
                out[f"attention {shape} {t}"] = chip_smoke.cuda_ms(
                    self.torch, lambda t=t: self.run(q, k, v, t), 20 if shape == "serve" else 3)
        return out


class DecodeSuite:
    LENGTHS = (0, 1, 3, 4, 5, 15, 16, 17, 255, 256, 257, 511, 512, 513, 1099, 1100)

    def __init__(self, torch, rand):
        from repro_torch.kernels.flash_decode import kernel as fd_k
        self.torch, self.module = torch, fd_k
        self.cases = []
        for dtype in (torch.float32, torch.bfloat16):
            for group, dh in ((1, 64), (8, 128)):
                q = rand(2, 2 * group, dh, dtype=dtype)
                kv = rand(2, 1100, 2, dh + 4, dtype=dtype)  # rows on 4-element boundaries
                self.cases.append((q, rand(2, 1100, 2, dh, dtype=dtype),
                                   rand(2, 1100, 2, dh, dtype=dtype)))
                self.cases.append((q, kv[..., :dh], kv[..., 4:]))
        b, n, h, hk, dh = FD_SHAPE
        self.prod = {dt: (rand(b, h, dh, dtype=dt), rand(b, n, hk, dh, dtype=dt),
                          rand(b, n, hk, dh, dtype=dt))
                     for dt in (torch.float32, torch.bfloat16)}

    def check(self, label):
        fd_k, worst = self.module, 0.0
        for q, k, v in self.cases:
            for length in self.LENGTHS:
                want = fd_k.flash_decode_plain(q, k, v, length)
                for bk in fd_k.TILES:
                    got = fd_k.flash_decode_cuda(q, k, v, length, bk)
                    err = float((got.float() - want.float()).abs().max())
                    if not (err <= fd_k.tolerance(want) and bool(self.torch.isfinite(got).all())):
                        sys.exit(f"{label}: flash decode bk {bk} wrong on {tuple(k.shape)} "
                                 f"{q.dtype} length {length}: {err}")
                    worst = max(worst, err)
        return worst

    def timed(self):
        fd_k, out = self.module, {}
        length = FD_SHAPE[1]
        q, k, v = self.prod[self.torch.float32]
        for bk in fd_k.TILES:
            out[f"decode float32 bk {bk}"] = chip_smoke.cuda_ms(
                self.torch, lambda bk=bk: fd_k.flash_decode_cuda(q, k, v, length, bk), 20)
        best = min(fd_k.TILES, key=lambda t: out[f"decode float32 bk {t}"])
        q, k, v = self.prod[self.torch.bfloat16]
        out[f"decode bfloat16 bk {best}"] = chip_smoke.cuda_ms(
            self.torch, lambda: fd_k.flash_decode_cuda(q, k, v, length, best), 20)
        return out


class ReplaySuite:
    def __init__(self, torch, rand, dev, gen):
        from repro_torch.core import controller
        from repro_torch.kernels.replay_step import kernel as rk
        from repro_torch.kernels.replay_step import ops as rops
        self.torch, self.module = torch, rk
        params = controller.ControllerParams()

        def operands(n, steps, bins, hot):
            """A table of cycle-quantized rows over ``bins`` edges, the boot
            state, and ``steps`` readings of uniform temperatures."""
            edges = controller.DEFAULT_TEMP_BINS[:bins] if bins == 5 else chip_smoke.BOOT_BINS
            stack = torch.randint(8, 29, (n, bins, 2, 4), generator=gen, device=dev,
                                  dtype=torch.int32).to(torch.float32) * 1.25
            st = (rops.to_state3(controller.init_state(n, bins, dev)),
                  torch.zeros((bins + 1, n), dtype=torch.int32, device=dev),
                  torch.zeros(n, dtype=torch.int32, device=dev),
                  torch.zeros((8, n), dtype=torch.float32, device=dev))
            temps = torch.rand((steps, n), generator=gen, device=dev) * hot[0] + hot[1]
            errs = (torch.rand((steps, n), generator=gen, device=dev) < hot[2]).to(torch.uint8)
            return st, rops.to_stack_t(stack), temps, errs, rops.replay_scalars(edges, params)

        self.small = [operands(n, 300, 5, (75.0, 20.0, 1e-3)) for n in (4099, 4112)]
        # The serve shapes as chip_smoke times them (25-45 degC, no errors).
        self.shapes = {f"replay {n:,} x {steps}": operands(n, steps, bins, (20.0, 25.0, 0.0))
                       for n, steps, bins in (REPLAY_SERVE, REPLAY_UNALIGNED)}
        n, steps, bins = REPLAY_STEP1
        self.step1 = operands(n, steps, bins, (75.0, 20.0, 1e-3))

    def check(self, label):
        rk = self.module
        words = lambda t: t.view(self.torch.int32) if t.dtype == self.torch.float32 else t  # noqa: E731
        for st, stack_t, temps, errs, scal in self.small:
            for chunk in (1, 37, 160, 256):
                x = y = st
                for s in range(0, temps.shape[0], chunk):
                    tc, ec = temps[s:s + chunk], errs[s:s + chunk]
                    x = rk.replay_chunk_cuda(*x, stack_t, tc, ec, scal)
                    y = rk.replay_chunk_plain(*y, stack_t, tc, ec, scal)
                mism = sum(int((words(a) != words(b)).sum()) for a, b in zip(x, y))
                if mism:
                    sys.exit(f"{label}: replay chunk {chunk} at {temps.shape[1]} DIMMs: "
                             f"{mism} mismatching words")
        return 0.0

    def timed(self):
        rk, out = self.module, {}
        for key, (st, stack_t, temps, errs, scal) in self.shapes.items():
            out[key] = chip_smoke.cuda_ms(
                self.torch, lambda: rk.replay_chunk_cuda(*st, stack_t, temps, errs, scal), 10)
        st, stack_t, temps, errs, scal = self.step1
        out["replay 65,536 x 1 (device)"] = chip_smoke.device_ms(
            self.torch, lambda: rk.replay_chunk_cuda(*st, stack_t, temps, errs, scal),
            REPLAY_STEP1_LAUNCHES, "replay_")
        return out


class SweepSuite:
    def __init__(self, torch, dev):
        from repro_torch.core import charge, fleet
        from repro_torch.kernels.charge_sweep import kernel as sk
        from repro_torch.kernels.charge_sweep import ops
        self.torch, self.module = torch, sk
        gen = torch.Generator(device=dev).manual_seed(0)
        fl = fleet.synthesize(gen, chip_smoke.FULL_DIMMS, device=dev)
        cells = charge.CellParams(*(a[None, None, :] for a in fl.cells))
        boot, _ = ops.stacked_invariants(
            cells, torch.tensor(chip_smoke.BOOT_BINS, device=dev)[:, None, None])
        hot, _ = ops.stacked_invariants(cells, torch.tensor(95.0, device=dev))
        worst = chip_smoke.sweep_worst_case(boot)
        self.timed_stacks = {"boot": boot, "worst case": worst}
        self.stacks = self.timed_stacks | {"mixed lanes": chip_smoke.sweep_mixed_lanes(
            boot, hot, worst, chip_smoke.MIXED_CELLS)}
        self.scal = ops.kernel_scalars()
        self.want = {k: sk.charge_sweep_plain(inv, self.scal) for k, inv in self.stacks.items()}

    def check(self, label):
        for key, inv in self.stacks.items():
            mism = int((self.module.charge_sweep_cuda(inv, self.scal) != self.want[key]).sum())
            if mism:
                sys.exit(f"{label}: charge sweep, {key} stack: {mism} mismatching indices")
        return 0.0

    def timed(self):
        return {f"charge sweep {key}": chip_smoke.cuda_ms(
            self.torch, lambda inv=inv: self.module.charge_sweep_cuda(inv, self.scal), 20)
            for key, inv in self.timed_stacks.items()}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels", default=",".join(VARIANTS))
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--clocks", action="store_true")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args()
    names = [k for k in args.kernels.split(",") if k]
    if not set(names) <= set(VARIANTS):
        sys.exit(f"kernel_variants: --kernels takes {list(VARIANTS)}, got {names}")
    sys.path.insert(0, os.path.abspath(args.src))
    import torch

    if not torch.cuda.is_available():
        sys.exit("kernel_variants: needs an NVIDIA GPU")
    from repro_torch.kernels import _build

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    _build.build(names)

    def rand(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    make = {"latency_matmul": lambda: MatmulSuite(torch, rand),
            "flash_attention": lambda: AttentionSuite(torch, rand),
            "flash_decode": lambda: DecodeSuite(torch, rand),
            "replay_step": lambda: ReplaySuite(torch, rand, dev, gen),
            "charge_sweep": lambda: SweepSuite(torch, dev)}
    suites = {name: make[name]() for name in names}

    def timed(label: str, which=names) -> dict:
        """The named kernels' checks, then their ms at the production shapes."""
        out = {"max_abs_err": max(suites[n].check(label) for n in which)}
        for n in which:
            out.update(suites[n].timed())
        return out

    res = {"card": chip_smoke.nvidia_smi(), "src": os.path.abspath(args.src),
           "ms": timed("default build")}
    if args.sass:
        res["sass"] = {name: sass_mix(_build, _build.library_path(name)) for name in names}
    if args.variants:
        libs = build_variants(_build, names)
        res["variants_ms"] = {}
        for (name, label), (lib, path) in libs.items():
            module = suites[name].module
            own = module._lib
            use_lib(module, lib)
            res["variants_ms"][f"{name}: {label}"] = timed(f"{name} variant {label!r}", [name])
            module._lib = own
            if args.sass:
                res["sass"][f"{name}: {label}"] = {
                    f: {k: c[k] for k in ("total",) + SASS_KEYS}
                    for f, c in sass_mix(_build, path).items()}
        res["default_again_ms"] = timed("default build again")
    if args.clocks and {"latency_matmul", "flash_attention"} <= set(names):
        mm, fa = suites["latency_matmul"], suites["flash_attention"]
        best_mm = min(mm.module.TILES, key=lambda t: res["ms"][f"matmul {t}"])
        best_fa = min(fa.tiles, key=lambda t: res["ms"][f"attention altune {t}"])
        q, k, v = fa.shapes["altune"]
        res["clocks"] = {
            f"matmul {best_mm}": under_load(torch, lambda: mm.module.matmul_cuda(mm.x, mm.y, *best_mm)),
            "torch.matmul": under_load(torch, lambda: torch.matmul(mm.x, mm.y)),
            f"attention altune {best_fa}": under_load(torch, lambda: fa.run(q, k, v, best_fa))}
    line = json.dumps(res)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
