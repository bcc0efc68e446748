"""The layer stack: one parameter dictionary per layer, applied in order.

The reference groups layers into ``prefix`` / ``groups`` (stacked over the
repeats of ``layer_pattern`` for its ``lax.scan``) / ``suffix``; the port
runs eagerly, so it keeps a plain list of per-layer dictionaries and a list
of per-layer caches. :mod:`repro_torch.convert` maps between the two.

Three execution modes share the layer dispatch, as in the reference:
  forward  — full sequence, no cache.
  prefill  — full sequence, emits per-layer caches (serving).
  decode   — one token against per-layer caches.

Every token mixer is ported: attention (``global`` / ``local``, a KV
cache written in place in decode), ``rglru`` (an :class:`RGLRUCache`),
``mlstm`` (an :class:`MLSTMCache`) and ``slstm`` (an :class:`SLSTMState`);
the recurrent caches are replaced by new ones each step. The mLSTM and
sLSTM blocks own their projections and have no FFN sublayer. The channel
mixer of the other layers is a dense FFN or, from layer ``first_k_dense``
of a config with ``moe``, the experts (:mod:`.moe`), whose load-balance
losses the stack sums, as the reference's scan carry does.

Training differentiates the forward mode with autograd; ``remat`` in
:func:`apply_stack` recomputes each layer in the backward pass instead of
keeping its activations.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.models import blocks, moe, rglru, xlstm
from repro_torch.models.config import ModelConfig
from repro_torch.parallel.sharding import constrain, current_policy, use_policy
from repro_torch.tree import leaves

ATTN_KINDS = ("global", "local")


def attention_layers(cfg: ModelConfig) -> int:
    """Layers whose token mixer is attention (one flash-attention call each
    in a prefill through the kernel)."""
    return sum(cfg.mixer_of(i) in ATTN_KINDS for i in range(cfg.n_layers))


# ---------------------------------------------------------------------------
# Per-layer init / apply
# ---------------------------------------------------------------------------
def init_layer(gen: torch.Generator, cfg: ModelConfig, layer_idx: int,
               dtype=torch.float32) -> Dict[str, Any]:
    kind = cfg.mixer_of(layer_idx)
    p: Dict[str, Any] = {"ln1": blocks.init_rmsnorm(cfg.d_model, gen.device)}
    if kind in ATTN_KINDS:
        p["attn"] = blocks.init_attention(gen, cfg, dtype)
    elif kind == "mlstm":
        p["mlstm"] = xlstm.init_mlstm_block(gen, cfg, dtype)
        return p  # self-contained block, no separate channel mixer
    elif kind == "slstm":
        p["slstm"] = xlstm.init_slstm_block(gen, cfg, dtype)
        return p
    else:
        p["rglru"] = rglru.init_rglru_block(gen, cfg, dtype)
    if cfg.ffn_variant != "none":
        p["ln2"] = blocks.init_rmsnorm(cfg.d_model, gen.device)
        if cfg.uses_moe(layer_idx):
            p["mix"] = moe.init_moe(gen, cfg, dtype)
        else:
            p["mix"] = blocks.init_ffn(gen, cfg, cfg.d_ff, dtype)
    return p


def init_layer_cache(cfg: ModelConfig, layer_idx: int, batch: int, max_len: int,
                     dtype, device=None):
    kind = cfg.mixer_of(layer_idx)
    if kind in ATTN_KINDS:
        return blocks.init_kv_cache(cfg, kind, batch, max_len, dtype, device)
    if kind == "mlstm":
        return xlstm.init_mlstm_cache(cfg, batch, dtype, device)
    if kind == "slstm":
        di = xlstm._d_inner_s(cfg)
        return xlstm.slstm_zero_state(batch, cfg.n_heads, di // cfg.n_heads, device)
    return rglru.init_rglru_cache(cfg, batch, dtype, device)


def apply_layer(p: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig, kind: str,
                use_moe: bool, positions, mode: str = "forward", cache=None, pos: int = 0,
                cache_len: int = 0) -> Tuple[torch.Tensor, Optional[torch.Tensor], Any]:
    """Returns (x, aux_loss, new_cache): aux_loss the experts' load-balance
    loss (None for a layer without experts), new_cache None in forward
    mode."""
    if mode not in ("forward", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    new_cache = None
    h = blocks.rmsnorm(p["ln1"], x, cfg.norm_eps)
    if kind in ATTN_KINDS:
        if mode == "decode":
            y, new_cache = blocks.decode_attention(p["attn"], h, cache, pos, cfg, kind)
        elif mode == "prefill":
            y, new_cache = blocks.attention_forward(p["attn"], h, cfg, kind, positions,
                                                    cache_len=cache_len)
        else:
            y = blocks.attention_forward(p["attn"], h, cfg, kind, positions)
    elif kind == "mlstm":
        if mode == "decode":
            y, new_cache = xlstm.mlstm_block_step(p["mlstm"], h, cfg, cache)
        elif mode == "prefill":
            y, new_cache = xlstm.mlstm_block_forward(p["mlstm"], h, cfg, return_cache=True)
        else:
            y = xlstm.mlstm_block_forward(p["mlstm"], h, cfg)
        return x + y, None, new_cache
    elif kind == "slstm":
        if mode == "forward":
            y = xlstm.slstm_block_forward(p["slstm"], h, cfg)
        else:
            y, new_cache = xlstm.slstm_block_forward(
                p["slstm"], h, cfg, state=cache if mode == "decode" else None,
                return_cache=True)
        return x + y, None, new_cache
    elif kind == "rglru":
        if mode == "decode":
            y, new_cache = rglru.rglru_block_step(p["rglru"], h, cfg, cache)
        elif mode == "prefill":
            y, new_cache = rglru.rglru_block_forward(p["rglru"], h, cfg, return_cache=True)
        else:
            y = rglru.rglru_block_forward(p["rglru"], h, cfg)
    else:
        raise ValueError(f"unknown mixer kind {kind!r}")
    x = constrain(x + y, ("batch", None, None))
    aux = None
    if "mix" in p:
        h2 = blocks.rmsnorm(p["ln2"], x, cfg.norm_eps)
        if use_moe:
            y2, aux = moe.moe_forward(p["mix"], h2, cfg)
        else:
            y2 = blocks.ffn_forward(p["mix"], h2, cfg)
        x = constrain(x + y2, ("batch", None, None))
    return x, aux, new_cache


# ---------------------------------------------------------------------------
# Stack
# ---------------------------------------------------------------------------
def init_stack(gen: torch.Generator, cfg: ModelConfig,
               dtype=torch.float32) -> List[Dict[str, Any]]:
    return [init_layer(gen, cfg, i, dtype) for i in range(cfg.n_layers)]


def init_stack_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                     device=None) -> List[Any]:
    return [init_layer_cache(cfg, i, batch, max_len, dtype, device)
            for i in range(cfg.n_layers)]


@contextlib.contextmanager
def _recompute(policy):
    with use_policy(policy), moe.routes_paused():
        yield


def _recompute_context():
    """``checkpoint``'s (forward, recompute) contexts: the recompute in the
    backward pass records no routes (each routing is logged once) and runs
    under the forward's sharding policy (the backward pass may run on
    another thread, outside the caller's block)."""
    return contextlib.nullcontext(), _recompute(current_policy())


def apply_stack(params: List[Dict[str, Any]], x: torch.Tensor, cfg: ModelConfig,
                positions, mode: str = "forward", caches: Optional[List[Any]] = None,
                pos: int = 0, cache_len: int = 0, remat=True
                ) -> Tuple[torch.Tensor, torch.Tensor, Optional[List[Any]]]:
    """Run the full stack. Returns (x, total_aux, new_caches | None):
    total_aux the sum of the expert layers' losses, in layer order (0 with
    none).

    ``remat`` applies in forward mode while autograd records the stack
    (grad mode on, parameters that require grad): ``True``
    checkpoints each layer (``torch.utils.checkpoint``, non-reentrant: a
    layer keeps only its input for the backward pass and runs again
    there; the reference checkpoints each layer group, the same values);
    ``"offload"`` also parks those inputs in pinned host memory
    (``save_on_cpu``); ``False`` keeps every activation."""
    total_aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_caches = []
    if not (mode == "forward" and torch.is_grad_enabled()
            and any(t.requires_grad for t in leaves(params))):
        remat = False
    saves = (torch.autograd.graph.save_on_cpu(pin_memory=True) if remat == "offload"
             else contextlib.nullcontext())
    with saves:
        for i, p in enumerate(params):
            kind, use_moe = cfg.mixer_of(i), cfg.uses_moe(i)
            if remat:
                def layer(x, p=p, kind=kind, use_moe=use_moe):
                    return apply_layer(p, x, cfg, kind, use_moe, positions)[:2]

                # No layer draws random numbers: no RNG state to keep.
                x, aux = torch.utils.checkpoint.checkpoint(
                    layer, x, use_reentrant=False, preserve_rng_state=False,
                    context_fn=_recompute_context)
                nc = None
            else:
                x, aux, nc = apply_layer(p, x, cfg, kind, use_moe, positions, mode=mode,
                                         cache=caches[i] if caches is not None else None,
                                         pos=pos, cache_len=cache_len)
            if aux is not None:
                total_aux = total_aux + aux
            new_caches.append(nc)
    return x, total_aux, (new_caches if mode != "forward" else None)
