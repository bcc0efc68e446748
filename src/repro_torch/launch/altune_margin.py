"""Kernel margin harvest: the paper's Fig. 2 experiment, transplanted.

The counterpart of ``benchmarks/altune_margin.py``. Profiles every card
candidate tile of four kernels — the latency-tuned matmul, flash attention,
the RG-LRU scan and flash decode — validates each against its oracle on the
reference's adversarial patterns, and reports the latency margin the
adaptive selection harvests over the worst-case tile, the analogue of the
paper's 17–55 % timing reductions. The selections go into a
:class:`~repro_torch.core.altune.TimingTable` under device bin ``"h100"``.

* On a card (``--device cuda``, the default) every candidate is validated
  and timed (CUDA events, backend ``wallclock``) at the reference's
  production shapes: matmul 4096³ float32; flash attention B 8, S 4,096,
  H 32, Hk 8, dh 128, causal; scan (8, 4096, 4096); decode B 8, L 32,768,
  H 64, Hk 8, dh 128. The cost model's estimate is kept beside each time.
* On the CPU (``--device cpu``) it follows the reference's scheme: the
  plain versions are validated at the reference's small shapes (VAL = 256)
  and each candidate's latency is the cost model's estimate at the
  production shapes.

  PYTHONPATH=src python -m repro_torch.launch.altune_margin --device cpu
  PYTHONPATH=src python -m repro_torch.launch.altune_margin --out table.json

Rows print as ``name,value,reference`` lines, as the reference's do; the
table is written only where ``--out`` says.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable, List, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.core import altune
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.kernels.flash_decode import ref as fd_ref
from repro_torch.kernels.latency_matmul import ops as mm_ops
from repro_torch.kernels.latency_matmul import ref as mm_ref
from repro_torch.kernels.rglru_scan import ops as sc_ops
from repro_torch.kernels.rglru_scan import ref as sc_ref

#: Validation size of the CPU scheme, and the production size of the cost
#: model (and of validation on a card).
VAL, PROD = 256, 4096
DEVICE_BIN = "h100"


@dataclasses.dataclass(frozen=True)
class Shapes:
    """One scheme's input shapes: matmul n; attention (b, s, h, hk, dh);
    scan (b, s, d); decode (b, l, h, hk, dh)."""

    mm: int
    fa: Tuple[int, int, int, int, int]
    scan: Tuple[int, int, int]
    decode: Tuple[int, int, int, int, int]


#: The reference's validation shapes (benchmarks/altune_margin.py).
CPU_SHAPES = Shapes(mm=VAL, fa=(1, VAL, 2, 1, 64), scan=(2, VAL, 256),
                    decode=(1, 1024, 2, 1, 64))
#: The reference's production shapes: those of its cost-model estimates.
CARD_SHAPES = Shapes(mm=PROD, fa=(8, PROD, 32, 8, 128), scan=(8, PROD, 4096),
                     decode=(8, 32768, 64, 8, 128))


def _by_batch(fn: Callable[..., torch.Tensor]) -> Callable[..., torch.Tensor]:
    """``fn`` applied to one batch row at a time and concatenated: the same
    function with 1/B of its intermediates (the oracles materialize
    (H, S, S) scores or head-repeated caches)."""
    def run(*args):
        b = args[0].shape[0]
        return torch.cat([fn(*(a[i:i + 1] if torch.is_tensor(a) else a for a in args))
                          for i in range(b)])
    return run


def _matmul_margin(sh: Shapes, **kw):
    return altune.profile_kernel(
        "latency_matmul",
        run_fn=lambda x, y, cfg: mm_ops.matmul(x, y, cfg),
        ref_fn=mm_ref.matmul_plain,
        make_inputs=lambda arr: (arr, arr),
        estimate_fn=lambda cfg: altune.matmul_estimate(PROD, PROD, PROD, cfg, in_bytes=4),
        candidates=mm_ops.CANDIDATES, worst_case=mm_ops.WORST_CASE,
        input_shape=(sh.mm, sh.mm), rtol=1e-3, **kw,
    )


def _flash_margin(sh: Shapes, **kw):
    b, s, h, hk, dh = sh.fa
    p_b, p_s, p_h, p_hk, p_dh = CARD_SHAPES.fa

    def mk(arr):
        q = arr.reshape(b, s, h, dh * 2)[..., :dh]
        kv = arr.reshape(b, s, h, dh * 2)[..., dh:]
        k = kv[:, :, :hk]
        return q, k, k * 0.5

    naive = _by_batch(lambda q, k, v: fa_ref.naive_attention(q, k, v, causal=True))
    return altune.profile_kernel(
        "flash_attention",
        run_fn=lambda q, k, v, cfg: fa_ops.flash_attention(q, k, v, causal=True, config=cfg),
        ref_fn=naive,
        make_inputs=mk,
        estimate_fn=lambda cfg: altune.flash_estimate(p_b, p_s, p_s, p_h, p_hk, p_dh, cfg,
                                                      in_bytes=4),
        candidates=fa_ops.CANDIDATES, worst_case=fa_ops.WORST_CASE,
        input_shape=(b * s * h * dh * 2,), rtol=2e-3, **kw,
    )


def _scan_margin(sh: Shapes, **kw):
    b, s, d = sh.scan
    p_b, p_s, p_d = CARD_SHAPES.scan

    def mk(arr):
        a = torch.clamp(torch.remainder(arr.reshape(b, s, d).abs(), 1.0), 0.5, 0.999)
        bb = arr.reshape(b, s, d) * 0.1
        return a, bb, torch.zeros((b, d), dtype=arr.dtype, device=arr.device)

    return altune.profile_kernel(
        "rglru_scan",
        run_fn=lambda a, bb, h0, cfg: sc_ops.rglru_scan(a, bb, h0, cfg),
        ref_fn=sc_ref.rglru_scan_plain,
        make_inputs=mk,
        estimate_fn=lambda cfg: altune.scan_estimate(p_b, p_s, p_d, cfg),
        candidates=sc_ops.CANDIDATES, worst_case=sc_ops.WORST_CASE,
        input_shape=(b * s * d,), rtol=1e-3, **kw,
    )


def _decode_margin(sh: Shapes, **kw):
    b, n, h, hk, dh = sh.decode
    p_b, p_n, p_h, p_hk, p_dh = CARD_SHAPES.decode

    def mk(arr):
        flat = arr.reshape(-1)
        q = flat[: b * h * dh].reshape(b, h, dh)
        k = flat[: b * n * hk * dh].reshape(b, n, hk, dh)
        return q, k, k * 0.5, n

    def ref_fd(q, k, v, length):
        g = q.shape[1] // k.shape[2]
        return fd_ref.decode_attention(q, fd_ref.repeat_kv(k, g), fd_ref.repeat_kv(v, g),
                                       length)

    # cost model: decode over the 32k cell's cache (FDConfig reads as a
    # query tile of one row).
    return altune.profile_kernel(
        "flash_decode",
        run_fn=lambda q, k, v, length, cfg: fd_ops.flash_decode(q, k, v, length, cfg),
        ref_fn=_by_batch(ref_fd), make_inputs=mk,
        estimate_fn=lambda cfg: altune.flash_estimate(p_b, 1, p_n, p_h, p_hk, p_dh, cfg,
                                                      causal=False, in_bytes=4),
        candidates=fd_ops.CANDIDATES, worst_case=fd_ops.WORST_CASE,
        input_shape=(b * n * hk * dh,), rtol=2e-3, **kw,
    )


def _describe(res: altune.ProfileResult, measured: bool, seconds: float) -> List[str]:
    lines = []
    for e in res.entries:
        verdict = ("infeasible" if not e.feasible else
                   "validated" if e.validated and e.repeat_ok else
                   f"not validated ({e.fail_pattern or 'repeat'})")
        t = (f"measured {e.t_seconds * 1e3:.4f} ms, " if measured and e.feasible else "")
        lines.append(f"[altune] {res.kernel} {e.config}: {verdict}; {t}estimate "
                     f"{e.estimate_s * 1e3:.4f} ms ({e.bound})")
    lines.append(f"[altune] {res.kernel}: selected {res.select()}, margin "
                 f"{res.margin():.6f} vs {res.worst_case}; profiled in {seconds:.3f} s")
    return lines


def run(device: str | torch.device = "cuda", out: Optional[str] = None, seed: int = 0,
        return_results: bool = False, shapes: Optional[Shapes] = None):
    """Profile the four kernels; returns the reference's rows
    ``(name, value, reference)`` (and the four ``ProfileResult`` when
    ``return_results``). Writes the timing table to ``out`` if given.
    ``shapes`` replaces the device's validation shapes (the estimates stay
    at the production shapes)."""
    dev = resolve_device(device)
    card = dev.type == "cuda"
    sh = shapes or (CARD_SHAPES if card else CPU_SHAPES)
    kw = dict(backend="wallclock" if card else "costmodel", seed=seed, device=dev)
    rows, results = [], []
    table = altune.TimingTable()
    for margin_fn in (_matmul_margin, _flash_margin, _scan_margin, _decode_margin):
        t0 = time.perf_counter()
        res = margin_fn(sh, **kw)
        if card:
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
        seconds = time.perf_counter() - t0
        results.append(res)
        best = res.select()
        table.put(res.kernel, res.shape_key, DEVICE_BIN, "default", best, res.margin())
        rows.append((f"altune/{res.kernel}/margin", res.margin(), ""))
        n_ok = sum(1 for e in res.entries if e.validated and e.repeat_ok)
        rows.append((f"altune/{res.kernel}/validated_configs", n_ok, len(res.entries)))
        print("\n".join(_describe(res, card, seconds)), flush=True)
    if out is not None:
        table.save(out)
    return (rows, results) if return_results else rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="write the timing table (JSON) here")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    for name, value, ref in run(device=args.device, out=args.out, seed=args.seed):
        print(f"{name},{value},{ref}")


if __name__ == "__main__":
    main()
