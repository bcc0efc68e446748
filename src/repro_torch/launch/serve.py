"""Batched LM serving entry point: prefill once, decode autoregressively.

The counterpart of the reference's ``repro.launch.serve``, with the same
arguments and defaults plus ``device`` (the card unless the caller asks for
the CPU) and ``attn_impl``: ``"pallas"`` (default) runs the prefill's
attention through the flash-attention kernel on a card (its plain version
on the CPU), ``"chunked"`` through the plain chunked attention, the
reference's default arm. Weights are random, drawn from ``seed``, unless
``params`` (e.g. the reference's, through ``convert.lm_params_from_numpy``)
and ``prompts`` are given.

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --arch llama3.2-3b --batch 2 --prompt-len 16 --gen 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b --full \\
      --batch 4 --prompt-len 1024 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch kimi-k2-1t-a32b --full \\
      --layers 2 --batch 2 --prompt-len 256 --gen 32
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import torch

import repro_torch.configs as C
from repro_torch import resolve_device
from repro_torch.models import model as lm
from repro_torch.models import moe
from repro_torch.models import stack as lm_stack
from repro_torch.train.serve import ServeConfig, make_decode_step, make_prefill_step
from repro_torch.tree import tree_map

#: A token routed to other experts on the card than on the CPU (a "flip")
#: is admitted only where the CPU's k-th and (k + 1)-th largest router
#: probabilities lie within ``FLIP_EPS`` of each other: the router's
#: float32 product, and every layer before it, sum in another order on the
#: card, which moves a probability by ~1e-7 at the reduced and 2-layer
#: full-width configs' depths.
FLIP_EPS = 1e-5


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(arch: str, batch: int = 4, prompt_len: int = 32, gen: int = 32,
          reduced: bool = True, temperature: float = 0.0, seed: int = 0,
          device: str | torch.device = "cuda", attn_impl: str = "pallas",
          params=None, prompts=None, return_report: bool = False,
          n_layers: Optional[int] = None):
    """Serve ``batch`` prompts of ``prompt_len`` tokens for ``gen`` new tokens.

    Given ``prompts`` (B, S) ids, their shape sets ``batch`` and
    ``prompt_len``. ``n_layers`` cuts the config's depth to its first
    layers (a model too large for one card, at full width). Returns the
    generated ids (B, gen) int32 on the device, or with ``return_report``
    the pair (ids, report): prefill seconds,
    decode seconds per token, peak device bytes (None on the CPU), whether
    the last step's logits were finite, and the device."""
    dev = resolve_device(device)
    cfg = C.reduced(arch) if reduced else C.get(arch)
    if not cfg.causal:
        raise ValueError(f"{arch} is encoder-only (no autoregressive serving)")
    if attn_impl not in ("pallas", "chunked"):
        raise ValueError(f"attn_impl must be 'pallas' or 'chunked', got {attn_impl!r}")
    cfg = dataclasses.replace(cfg, attn_impl=attn_impl, n_layers=n_layers or cfg.n_layers)
    if prompts is not None:
        batch, prompt_len = prompts.shape
    sc = ServeConfig(max_len=prompt_len + gen, temperature=temperature,
                     cache_dtype="float32")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    if params is None:
        params = lm.init_params(torch.Generator(device=dev).manual_seed(seed), cfg)
    if prompts is None:
        prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len), dtype=torch.int32,
                                generator=torch.Generator(device=dev).manual_seed(seed + 1),
                                device=dev)
    prompts = prompts.to(dev)
    sampler = torch.Generator(device=dev).manual_seed(seed + 100)

    prefill = make_prefill_step(cfg, sc)
    decode = make_decode_step(cfg, sc)

    _sync(dev)
    t0 = time.perf_counter()
    last_logits, caches = prefill(params, {"tokens": prompts})
    nxt = torch.argmax(last_logits.to(torch.float32), dim=-1)[:, None].to(torch.int32)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    out_tokens = [nxt]
    lf = last_logits
    t0 = time.perf_counter()
    for i in range(gen - 1):
        nxt, lf, caches = decode(params, caches, nxt, prompt_len + i, sampler)
        out_tokens.append(nxt)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    gen_ids = torch.cat(out_tokens, dim=1)
    print(f"[serve] {arch}: batch={batch} prompt={prompt_len} gen={gen} | "
          f"prefill {t_prefill * 1e3:.1f} ms, decode {t_decode / max(gen - 1, 1) * 1e3:.2f} "
          f"ms/tok")
    if not return_report:
        return gen_ids
    report = {
        "device": str(dev), "prefill_s": t_prefill,
        "decode_s_per_token": t_decode / max(gen - 1, 1),
        "peak_device_bytes": (torch.cuda.max_memory_allocated(dev)
                              if dev.type == "cuda" else None),
        "logits_finite": bool(torch.isfinite(lf).all()),
    }
    return gen_ids, report


def mrope_positions(batch: int, seq: int, device=None) -> torch.Tensor:
    """M-RoPE's (3, B, S) temporal / height / width streams for a sequence
    laid out as frames of an 8-wide patch grid: t = s // 64, y = s // 8 % 8,
    x = s % 8 (three streams that differ, unlike text positions)."""
    s = torch.arange(seq, dtype=torch.int32, device=device)
    return torch.stack([s // 64, s // 8 % 8, s % 8])[:, None].expand(3, batch, seq)


def cache_tensors(cache) -> list:
    """A layer cache's tensors in field order (an ``MLSTMCache``'s state first)."""
    if isinstance(cache, torch.Tensor):
        return [cache]
    return [t for f in cache for t in cache_tensors(f)]


def max_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a − b| over entries, equal entries (equal infinities too) 0."""
    d = torch.where(a == b, torch.zeros((), dtype=a.dtype), (a - b).abs())
    return float(d.max()) if d.numel() else 0.0


def compare_card_to_cpu(arch: str, device: str | torch.device = "cuda", batch: int = 2,
                        prompt_len: int = 40, steps: int = 8, tol: float = 1e-4,
                        seed: int = 0, reduced: bool = True,
                        n_layers: Optional[int] = None) -> dict:
    """Serve ``arch`` (the reduced config unless ``reduced`` is False;
    ``n_layers`` cuts its depth) on ``device`` (prefill attention through
    the flash-attention kernel) and on the CPU (plain versions) with the
    same weights and inputs: the prefill, then ``steps`` decode steps
    teacher-forced with the CPU's greedy ids. A config with embedding inputs
    is fed random embeddings (and, with M-RoPE, :func:`mrope_positions`); an
    encoder-only one runs one forward and no decode, every position's logits
    compared. Reduced weights go to the card through ``convert``; full-width
    ones are drawn on the card and copied to the host.

    Returns ``logit_err`` (the largest logit difference over the rows
    compared: the last position of the prefill and every step, or every
    position of a forward), ``cache_err`` (the prefill's caches), ``sure``
    (rows whose CPU top-2 logit gap exceeds ``2 * tol``), ``agree`` (how
    many of those have equal greedy ids on both), ``attn_layers`` and the
    flash-attention launches of the card's prefill and of its decode steps.

    With experts, each call's routes are compared too, layer by layer:
    ``moe_calls`` (routings compared), ``route_flips`` (tokens whose expert
    set differs), ``flips_not_near_tie`` (of those, the ones whose CPU gap
    between the k-th and (k + 1)-th probability exceeds :data:`FLIP_EPS`),
    ``flip_max_gap``. A flip changes the token's output and, through the
    capacity, other tokens' of the batch, and every later call through the
    caches: from the first call with a flip on, later routings are not
    compared and its logit rows are left out (``excluded_rows``), as are
    the caches when the flip is in the prefill (``cache_compared``)."""
    from repro_torch import convert
    from repro_torch.kernels.flash_attention import kernel as fa_kernel

    dev = resolve_device(device)
    cfg = C.reduced(arch) if reduced else C.get(arch)
    cfg = dataclasses.replace(cfg, attn_impl="pallas", n_layers=n_layers or cfg.n_layers)
    if reduced:
        host = lm.init_params(torch.Generator().manual_seed(seed), cfg)
        card = convert.lm_params_from_numpy(convert.lm_params_to_numpy(host, cfg), cfg,
                                            device=dev)
    else:
        card = lm.init_params(torch.Generator(device=dev).manual_seed(seed), cfg)
        host = tree_map(lambda t: t.cpu(), card)
    gen = torch.Generator().manual_seed(seed + 1)
    if cfg.embeds_input:
        inputs = {"embeds": torch.randn((batch, prompt_len, cfg.d_model), generator=gen)}
        if cfg.rope_variant == "mrope":
            inputs["positions"] = mrope_positions(batch, prompt_len)
    else:
        inputs = {"tokens": torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                                          dtype=torch.int32, generator=gen)}
    card_inputs = {k: t.to(dev) for k, t in inputs.items()}
    out = {"n_layers": cfg.n_layers, "d_model": cfg.d_model, "d_head": cfg.d_head,
           "attn_layers": lm_stack.attention_layers(cfg), "logit_err": 0.0, "cache_err": 0.0,
           "sure": 0, "agree": 0, "decode_launches": 0, "moe_calls": 0, "route_flips": 0,
           "flips_not_near_tie": 0, "flip_max_gap": 0.0, "excluded_rows": 0,
           "cache_compared": True}
    diverged = False

    def compare(lc: torch.Tensor, lh: torch.Tensor) -> None:
        lc, lh = lc.cpu().reshape(-1, lh.shape[-1]), lh.reshape(-1, lh.shape[-1])
        if diverged:
            out["excluded_rows"] += lh.shape[0]
            return
        out["logit_err"] = max(out["logit_err"], float((lc - lh).abs().max()))
        top2 = torch.topk(lh, 2, dim=-1).values
        gap = (top2[:, 0] - top2[:, 1]) > 2 * tol
        out["sure"] += int(gap.sum())
        out["agree"] += int((torch.argmax(lc, -1) == torch.argmax(lh, -1))[gap].sum())

    def run(fn, *args):
        """``fn(*args)`` with its routes recorded."""
        with moe.recording_routes() as routes:
            return fn(*args), routes

    def routes_agree(card_routes, host_routes) -> bool:
        """Compare one call's routings in layer order up to the first with a
        flip; False if there is one."""
        if diverged:
            return False
        for (ic, _), (ih, ph) in zip(card_routes, host_routes):
            out["moe_calls"] += 1
            flip = (ic.cpu().sort(-1).values != ih.sort(-1).values).any(-1)
            if bool(flip.any()):
                k = ih.shape[-1]
                top = ph[flip].sort(-1, descending=True).values
                gap = top[:, k - 1] - top[:, k]
                out["route_flips"] += int(flip.sum())
                out["flips_not_near_tie"] += int((gap > FLIP_EPS).sum())
                out["flip_max_gap"] = max(out["flip_max_gap"], float(gap.max()))
                return False
        return True

    before = fa_kernel.flash_attention_cuda.launches
    if not cfg.causal:
        (lc, _, _), rc = run(lambda: lm.forward(card, cfg, **card_inputs))
        out["prefill_launches"] = fa_kernel.flash_attention_cuda.launches - before
        (lh, _, _), rh = run(lambda: lm.forward(host, cfg, **inputs))
        diverged = not routes_agree(rc, rh)
        compare(lc, lh)
        return out
    sc = ServeConfig(max_len=prompt_len + steps, cache_dtype="float32")
    prefill, decode = make_prefill_step(cfg, sc), make_decode_step(cfg, sc)
    (lc, cc), rc = run(prefill, card, card_inputs)
    out["prefill_launches"] = fa_kernel.flash_attention_cuda.launches - before
    (lh, ch), rh = run(prefill, host, inputs)
    diverged = not routes_agree(rc, rh)
    out["cache_compared"] = not diverged
    if not diverged:
        out["cache_err"] = max(max_diff(a.cpu(), b) for x, y in zip(cc, ch)
                               for a, b in zip(cache_tensors(x), cache_tensors(y)))
    nxt = torch.argmax(lh, -1)[:, None].to(torch.int32)
    before = fa_kernel.flash_attention_cuda.launches
    for i in range(steps + 1):
        compare(lc, lh)
        if i == steps:
            break
        (_, lc, cc), rc = run(decode, card, cc, nxt.to(dev), prompt_len + i)
        (nxt, lh, ch), rh = run(decode, host, ch, nxt, prompt_len + i)
        diverged = not routes_agree(rc, rh)
    out["decode_launches"] = fa_kernel.flash_attention_cuda.launches - before
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--full", action="store_true",
                    help="the published config (default: the reduced one)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--attn-impl", default="pallas", choices=("pallas", "chunked"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the config to its first N layers (default: all)")
    args = ap.parse_args()
    ids = serve(args.arch, args.batch, args.prompt_len, args.gen, reduced=not args.full,
                temperature=args.temperature, seed=args.seed, device=args.device,
                attn_impl=args.attn_impl, n_layers=args.layers)
    print("generated ids[0,:16]:", ids[0, :16].tolist())


if __name__ == "__main__":
    main()
