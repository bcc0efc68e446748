"""Language model: embed → layer stack → norm → head, and serving caches.

The port of ``src/repro/models/model.py``'s serving surface: parameters are
a plain dictionary (``embed``, ``stack`` — a list of per-layer
dictionaries, ``ln_f``, and ``head`` unless the embeddings are tied),
drawn with the reference's distributions and scales from a
``torch.Generator`` on the device. :func:`lm_loss` is the training loss,
differentiated by autograd. :func:`logical_specs` and
:func:`cache_logical_specs` give each parameter and cache leaf the
reference's logical sharding spec (:mod:`repro_torch.parallel.sharding`
maps them onto a mesh); under an active policy :func:`forward` constrains
the embeddings and the logits where the reference does.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.models import blocks, rglru, stack, xlstm
from repro_torch.models.config import ModelConfig
from repro_torch.models.rope import default_positions
from repro_torch.parallel.sharding import constrain, grad_placed, is_dtensor, replicated_like
from repro_torch.tree import tree_map


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------
def init_params(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
                place=None) -> Dict[str, Any]:
    """Random parameters on ``gen.device``: the embedding and head are
    Normal · d_model^-0.5, the stack as :func:`.stack.init_stack` draws it,
    norm scales zero (the norm multiplies by 1 + scale).

    ``place``: called on each part as soon as it is drawn — ``{"embed":
    ...}``, each layer's dictionary, ``{"ln_f": ...}``, ``{"head": ...}`` —
    and its result kept in the part's stead, so that a caller placing the
    state under a mesh never holds more than one part whole. The draws are
    the same with or without it."""
    part = place or (lambda tree: tree)
    p: Dict[str, Any] = part({"embed": blocks.init_dense(
        gen, (cfg.vocab_size, cfg.d_model), cfg.d_model ** -0.5, dtype)})
    p["stack"] = [part(stack.init_layer(gen, cfg, i, dtype)) for i in range(cfg.n_layers)]
    p.update(part({"ln_f": blocks.init_rmsnorm(cfg.d_model, gen.device)}))
    if not cfg.tie_embeddings:
        p.update(part({"head": blocks.init_dense(gen, (cfg.d_model, cfg.vocab_size),
                                                 cfg.d_model ** -0.5, dtype)}))
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
        x = _lookup(grad_placed(params["embed"]), tokens)
        b, s = tokens.shape
    if cfg.scale_embed:
        x = x * torch.full((), cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)
    x = constrain(x, ("batch", None, None))
    if positions is None:
        offset = pos if mode == "decode" else 0
        positions = default_positions(cfg, b, s, offset, device=x.device)
    x, aux, caches_out = stack.apply_stack(params["stack"], x, cfg, positions, mode=mode,
                                           caches=caches, pos=pos, cache_len=cache_len,
                                           remat=remat)
    if last_logits:
        x = x[:, -1:]
    x = blocks.rmsnorm(params["ln_f"], x, cfg.norm_eps)
    head = grad_placed(params["embed"]).t() if cfg.tie_embeddings else params["head"]
    logits = constrain(blocks.mm(x, head), ("batch", None, "vocab"))
    return logits, aux, caches_out


def _lookup(embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``embed[tokens]``. On DTensor tokens, each rank looks up its own
    token rows in the whole table (gathered): DTensor's rule for indexing
    refuses tokens whose batch spans several mesh axes on torch 2.11. The
    table's gradient is a partial sum over the axes that split the tokens."""
    if not is_dtensor(tokens):
        return embed[tokens]
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh, t_pl = tokens.device_mesh, tuple(tokens.placements)
    e_grad = tuple(Partial() if isinstance(p, Shard) else Replicate() for p in t_pl)
    fn = local_map(lambda e, t: (e[t],), out_placements=(t_pl,),
                   in_placements=((Replicate(),) * mesh.ndim, t_pl),
                   in_grad_placements=(e_grad, t_pl), device_mesh=mesh,
                   redistribute_inputs=True)
    return fn(embed, tokens)[0]


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
    temporaries a vocabulary of 128k does not need. On DTensor logits
    (under a sharding policy) the port takes the reference's masked sum,
    which keeps the vocabulary sharded. Returns (loss, {"ce",
    "aux", "z", "tokens"})."""
    logits, aux, _ = forward(params, cfg, tokens=batch.get("tokens"),
                             embeds=batch.get("embeds"), positions=batch.get("positions"),
                             remat=remat)
    labels = batch["labels"]
    valid = (labels >= 0).to(torch.float32)
    lab = torch.clamp_min(labels, 0).to(torch.int64)

    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    if is_dtensor(lf):
        # The reference's masked reduction: the vocabulary stays sharded
        # and each rank sums its slice (a DTensor gather along a sharded
        # dimension is not supported).
        vocab_iota = replicated_like(
            torch.arange(lf.shape[-1], dtype=lab.dtype, device=lab.device), lf)
        picked = torch.where(vocab_iota == lab[..., None], lf, 0.0).sum(-1)
    else:
        picked = torch.gather(lf, -1, lab[..., None])[..., 0]
    ce = (lse - picked) * valid
    n = torch.clamp_min(valid.sum(), 1.0)
    ce_mean = ce.sum() / n
    z_loss = z_coef * ((lse * valid) ** 2).sum() / n
    loss = ce_mean + aux_coef * aux + z_loss
    return loss, {"ce": ce_mean, "aux": aux, "z": z_loss, "tokens": n}


# ---------------------------------------------------------------------------
# Logical sharding specs
# ---------------------------------------------------------------------------
_RULES_2D = {
    "wq": ("fsdp", "heads"), "wk": ("fsdp", "heads"), "wv": ("fsdp", "heads"),
    "wo": ("heads", "fsdp"),
    "w_gate": ("fsdp", "ff"), "w_up": ("fsdp", "ff"), "w_down": ("ff", "fsdp"),
    "router": ("fsdp", None),
    "w_gates": ("fsdp", None),
    "w_x": ("fsdp", None),
    "w_x_branch": ("fsdp", "state"), "w_gate_branch": ("fsdp", "state"),
    "w_out": ("state", "fsdp"),
    "conv": (None, "state"),
    "embed": ("vocab", "fsdp"),
    "head": ("fsdp", "vocab"),
}
_RULES_3D = {
    "w_gate": ("experts", "fsdp", None),
    "w_up": ("experts", "fsdp", None),
    "w_down": ("experts", None, "fsdp"),
    "r": ("heads", None, None),
    "w_a": ("heads", None, None), "w_i": ("heads", None, None),
}
_RULES_1D = {
    "lam": ("state",), "b_a": ("state",), "b_i": ("state",), "skip": ("ff",),
}


def _rule_for(name: str, base_ndim: int) -> Tuple:
    if base_ndim >= 3 and name in _RULES_3D:
        return _RULES_3D[name]
    if base_ndim == 2 and name in _RULES_2D:
        return _RULES_2D[name]
    if base_ndim == 1 and name in _RULES_1D:
        return _RULES_1D[name]
    return (None,) * base_ndim  # replicated (norm scales, biases, …)


def _named_walk(tree, path: Tuple = ()):
    """(path, leaf) pairs with a named tuple's field names in its path (the
    names the reference's caches carry)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named_walk(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        names = getattr(tree, "_fields", range(len(tree)))
        for k, v in zip(names, tree):
            yield from _named_walk(v, path + (k,))
    else:
        yield path, tree


def _spec_tree(tree, rule):
    """A tree of ``tree``'s structure whose leaves are ``rule(name,
    leaf)``, ``name`` the leaf's last key or field name."""
    flat = iter([rule(path[-1], leaf) for path, leaf in _named_walk(tree)])
    return tree_map(lambda _: next(flat), tree)


def logical_specs(params: Dict[str, Any], cfg: ModelConfig) -> Dict[str, Any]:
    """The parameter tree's logical sharding specs, a tuple a leaf. The
    port's stack is a list of per-layer dictionaries, so each leaf has the
    reference's rule for its own rank: the reference's spec of the same
    leaf, less the leading ``None`` of its stacked group axis."""
    return _spec_tree(params, lambda name, leaf: _rule_for(name, leaf.dim()))


#: Decode cache leaves, keyed by (field name, base ndim). KV caches try
#: kv_heads first; when the kv-head count doesn't divide the TP axis the
#: head_dim picks it up (``physical`` assigns each mesh axis at most once).
_CACHE_RULES = {
    ("k", 4): ("batch", None, "kv_heads", "head_dim"),
    ("v", 4): ("batch", None, "kv_heads", "head_dim"),
    ("c", 4): ("batch", "heads", None, None),   # mLSTM matrix memory
    ("n", 3): ("batch", "heads", None),
    ("m", 2): ("batch", "heads"),
    ("c", 3): ("batch", "heads", None),         # sLSTM scalar state
    ("h", 3): ("batch", "heads", None),
    ("m", 3): ("batch", "heads", None),
    ("conv", 3): ("batch", None, "state"),
    ("h", 2): ("batch", "state"),               # RG-LRU state
}


def cache_logical_specs(caches: List[Any], cfg: ModelConfig) -> List[Any]:
    """The serving caches' logical specs, keyed by the field names of the
    cache types (those of ``convert.lm_cache_to_numpy``)."""
    return _spec_tree(caches, lambda name, leaf: _CACHE_RULES.get((name, leaf.dim()),
                                                                  (None,) * leaf.dim()))


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
