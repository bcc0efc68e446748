"""Language model: embed → layer stack → norm → head, and serving caches.

The port of ``src/repro/models/model.py``'s serving surface: parameters are
a plain dictionary (``embed``, ``stack`` — a list of per-layer
dictionaries, ``ln_f``, and ``head`` unless the embeddings are tied),
drawn with the reference's distributions and scales from a
``torch.Generator`` on the device. :func:`lm_loss` is the training loss,
differentiated by autograd. The reference's logical sharding specs
(``logical_specs``, ``cache_logical_specs``) wait for ROADMAP item 9h, with
the dry run and the sharded policies that read them.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.models import blocks, rglru, stack, xlstm
from repro_torch.models.config import ModelConfig
from repro_torch.models.rope import default_positions


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------
def init_params(gen: torch.Generator, cfg: ModelConfig,
                dtype=torch.float32) -> Dict[str, Any]:
    """Random parameters on ``gen.device``: the embedding and head are
    Normal · d_model^-0.5, the stack as :func:`.stack.init_stack` draws it,
    norm scales zero (the norm multiplies by 1 + scale)."""
    p: Dict[str, Any] = {
        "embed": blocks.init_dense(gen, (cfg.vocab_size, cfg.d_model),
                                   cfg.d_model ** -0.5, dtype),
        "stack": stack.init_stack(gen, cfg, dtype),
        "ln_f": blocks.init_rmsnorm(cfg.d_model, gen.device),
    }
    if not cfg.tie_embeddings:
        p["head"] = blocks.init_dense(gen, (cfg.d_model, cfg.vocab_size),
                                      cfg.d_model ** -0.5, dtype)
    return p


# ---------------------------------------------------------------------------
# Forward / prefill / decode
# ---------------------------------------------------------------------------
def forward(params: Dict[str, Any], cfg: ModelConfig,
            tokens: Optional[torch.Tensor] = None, embeds: Optional[torch.Tensor] = None,
            positions=None, mode: str = "forward",
            caches: Optional[List[Any]] = None, pos: int = 0,
            cache_len: int = 0, last_logits: bool = False,
            remat=True) -> Tuple[torch.Tensor, torch.Tensor, Optional[List[Any]]]:
    """Returns (logits, aux_loss, caches_out); aux_loss is the experts'
    load-balance losses summed over layers (0 without experts).
    ``last_logits``: the head at the last position only, logits (B, 1, V).
    ``remat``: as in :func:`.stack.apply_stack` (forward mode under
    autograd only)."""
    if embeds is not None:
        x = embeds.to(params["embed"].dtype)
        b, s = x.shape[:2]
    else:
        x = params["embed"][tokens]
        b, s = tokens.shape
    if cfg.scale_embed:
        x = x * torch.full((), cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)
    if positions is None:
        offset = pos if mode == "decode" else 0
        positions = default_positions(cfg, b, s, offset, device=x.device)
    x, aux, caches_out = stack.apply_stack(params["stack"], x, cfg, positions, mode=mode,
                                           caches=caches, pos=pos, cache_len=cache_len,
                                           remat=remat)
    if last_logits:
        x = x[:, -1:]
    x = blocks.rmsnorm(params["ln_f"], x, cfg.norm_eps)
    head = params["embed"].t() if cfg.tie_embeddings else params["head"]
    logits = blocks.mm(x, head)
    return logits, aux, caches_out


def prefill(params, cfg: ModelConfig, cache_len: int, tokens=None, embeds=None,
            positions=None, last_logits: bool = False):
    """Full-sequence forward that also builds serving caches. ``positions``:
    (B, S), or M-RoPE's (3, B, S) streams (default: text positions);
    ``last_logits`` as in :func:`forward`."""
    return forward(params, cfg, tokens=tokens, embeds=embeds, positions=positions,
                   mode="prefill", cache_len=cache_len, last_logits=last_logits)


def decode_step(params, cfg: ModelConfig, caches: List[Any], tokens: torch.Tensor,
                pos: int):
    """One-token step. tokens: (B, 1) int; pos: the number of tokens already
    in the cache (a Python int). Returns (logits (B,1,V), caches): KV caches
    updated in place, recurrent states replaced."""
    logits, _, caches_out = forward(params, cfg, tokens=tokens, mode="decode",
                                    caches=caches, pos=pos)
    return logits, caches_out


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
               device=None) -> List[Any]:
    return stack.init_stack_cache(cfg, batch, max_len, dtype, device)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------
def lm_loss(params: Dict[str, Any], cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            aux_coef: float = 0.01, z_coef: float = 1e-4,
            remat=True) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross entropy (float32) + MoE aux + z-loss.

    batch: {"tokens" | "embeds", "labels", optional "positions"}; labels
    < 0 are masked out. The label's logit is picked with a ``gather``: the
    reference sums a (B, S, V) masked copy of the logits, whose sum is the
    same single value (a sum of one value and zeros is exact) and whose
    temporaries a vocabulary of 128k does not need. Returns (loss, {"ce",
    "aux", "z", "tokens"})."""
    logits, aux, _ = forward(params, cfg, tokens=batch.get("tokens"),
                             embeds=batch.get("embeds"), positions=batch.get("positions"),
                             remat=remat)
    labels = batch["labels"]
    valid = (labels >= 0).to(torch.float32)
    lab = torch.clamp_min(labels, 0).to(torch.int64)

    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    picked = torch.gather(lf, -1, lab[..., None])[..., 0]
    ce = (lse - picked) * valid
    n = torch.clamp_min(valid.sum(), 1.0)
    ce_mean = ce.sum() / n
    z_loss = z_coef * ((lse * valid) ** 2).sum() / n
    loss = ce_mean + aux_coef * aux + z_loss
    return loss, {"ce": ce_mean, "aux": aux, "z": z_loss, "tokens": n}


# ---------------------------------------------------------------------------
# Parameter counting
# ---------------------------------------------------------------------------
def _mixer_params(cfg: ModelConfig, kind: str) -> int:
    """Parameters of one token mixer (the block under ``attn``, ``rglru``,
    ``mlstm`` or ``slstm``), from the shapes its init draws."""
    d, h, hk, dh, w = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.conv_width
    if kind in stack.ATTN_KINDS:
        return d * h * dh + 2 * d * hk * dh + h * dh * d + (2 * dh if cfg.qk_norm else 0)
    if kind == "rglru":
        dr = rglru._d_rnn(cfg)
        # branches, conv, w_a / w_i (block-diagonal), b_a / b_i / lam, w_out
        return 2 * d * dr + w * dr + 2 * dr * (dr // h) + 3 * dr + dr * d
    if kind == "mlstm":
        di = xlstm._d_inner_m(cfg)
        # w_up, conv, wq / wk / wv, w_gates, b_gates, skip, w_down
        return d * 2 * di + w * di + 3 * di * di + di * 2 * h + 2 * h + di + di * d
    ds, dff = xlstm._d_inner_s(cfg), xlstm._d_ff_s(cfg)
    # w_x, r (per head), b, gn, w_up, w_down
    return ds * 4 * ds + 4 * ds * (ds // h) + 4 * ds + ds + d * 2 * dff + dff * d


def count_params_analytic(cfg: ModelConfig, active_only: bool = False) -> int:
    """Exact parameter count from the shapes :func:`init_params` draws.
    ``active_only``: the routed experts' weights counted at ``top_k /
    n_experts``, rounded down over the whole model, as the reference's."""
    d = cfg.d_model
    matrices = 2 if cfg.ffn_variant == "gelu" else 3
    total = cfg.vocab_size * d + d  # embed, ln_f
    if not cfg.tie_embeddings:
        total += d * cfg.vocab_size
    routed = 0
    for i in range(cfg.n_layers):
        kind = cfg.mixer_of(i)
        total += d + _mixer_params(cfg, kind)  # ln1, the mixer
        if kind in ("mlstm", "slstm") or cfg.ffn_variant == "none":
            continue
        total += d  # ln2
        if cfg.uses_moe(i):
            m = cfg.moe
            experts = 3 * m.n_experts * d * m.d_ff_expert  # w_gate, w_up, w_down
            routed += experts
            total += d * m.n_experts + experts  # router
            if m.n_shared > 0:
                total += matrices * d * m.n_shared * m.d_ff_expert
        else:
            total += matrices * d * cfg.d_ff
    if active_only and cfg.moe is not None:
        total = total - routed + int(routed * cfg.moe.top_k / cfg.moe.n_experts)
    return total
