"""The layer stack: one parameter dictionary per layer, applied in order.

The reference groups layers into ``prefix`` / ``groups`` (stacked over the
repeats of ``layer_pattern`` for its ``lax.scan``) / ``suffix``; the port
runs eagerly, so it keeps a plain list of per-layer dictionaries and a list
of per-layer caches. :mod:`repro_torch.convert` maps between the two.

Three execution modes share the layer dispatch, as in the reference:
  forward  — full sequence, no cache.
  prefill  — full sequence, emits per-layer caches (serving).
  decode   — one token against per-layer caches (updated in place).

This slice ports the attention layers (``global`` / ``local``) with a
dense FFN; the recurrent mixers and experts raise ``NotImplementedError``
naming their ROADMAP items.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.models import blocks
from repro_torch.models.config import ModelConfig

ATTN_KINDS = ("global", "local")

#: Layer kinds and channel mixers not ported yet → their ROADMAP items.
UNPORTED = {
    "mlstm": "queue 1 item 9b (xLSTM)",
    "slstm": "queue 1 item 9b (xLSTM)",
    "rglru": "queue 1 item 9c (RG-LRU)",
    "moe": "queue 1 item 9a (experts)",
}


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} layers are not ported yet: ROADMAP {UNPORTED[what]}")


def _check_layer(cfg: ModelConfig, layer_idx: int) -> str:
    kind = cfg.mixer_of(layer_idx)
    if kind not in ATTN_KINDS:
        raise _unported(kind)
    if cfg.uses_moe(layer_idx) and cfg.ffn_variant != "none":
        raise _unported("moe")
    return kind


# ---------------------------------------------------------------------------
# Per-layer init / apply
# ---------------------------------------------------------------------------
def init_layer(gen: torch.Generator, cfg: ModelConfig, layer_idx: int,
               dtype=torch.float32) -> Dict[str, Any]:
    _check_layer(cfg, layer_idx)
    p: Dict[str, Any] = {"ln1": blocks.init_rmsnorm(cfg.d_model, gen.device),
                         "attn": blocks.init_attention(gen, cfg, dtype)}
    if cfg.ffn_variant != "none":
        p["ln2"] = blocks.init_rmsnorm(cfg.d_model, gen.device)
        p["mix"] = blocks.init_ffn(gen, cfg, cfg.d_ff, dtype)
    return p


def init_layer_cache(cfg: ModelConfig, layer_idx: int, batch: int, max_len: int,
                     dtype, device=None) -> blocks.KVCache:
    kind = _check_layer(cfg, layer_idx)
    return blocks.init_kv_cache(cfg, kind, batch, max_len, dtype, device)


def apply_layer(p: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig, kind: str,
                positions, mode: str = "forward", cache=None, pos: int = 0,
                cache_len: int = 0) -> Tuple[torch.Tensor, Optional[blocks.KVCache]]:
    """Returns (x, new_cache). new_cache is None in forward mode."""
    if kind not in ATTN_KINDS:
        raise _unported(kind)
    new_cache = None
    h = blocks.rmsnorm(p["ln1"], x, cfg.norm_eps)
    if mode == "decode":
        y, new_cache = blocks.decode_attention(p["attn"], h, cache, pos, cfg, kind)
    elif mode == "prefill":
        y, new_cache = blocks.attention_forward(p["attn"], h, cfg, kind, positions,
                                                cache_len=cache_len)
    elif mode == "forward":
        y = blocks.attention_forward(p["attn"], h, cfg, kind, positions)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    x = x + y
    if "mix" in p:
        h2 = blocks.rmsnorm(p["ln2"], x, cfg.norm_eps)
        x = x + blocks.ffn_forward(p["mix"], h2, cfg)
    return x, new_cache


# ---------------------------------------------------------------------------
# Stack
# ---------------------------------------------------------------------------
def init_stack(gen: torch.Generator, cfg: ModelConfig,
               dtype=torch.float32) -> List[Dict[str, Any]]:
    return [init_layer(gen, cfg, i, dtype) for i in range(cfg.n_layers)]


def init_stack_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                     device=None) -> List[blocks.KVCache]:
    return [init_layer_cache(cfg, i, batch, max_len, dtype, device)
            for i in range(cfg.n_layers)]


def apply_stack(params: List[Dict[str, Any]], x: torch.Tensor, cfg: ModelConfig,
                positions, mode: str = "forward",
                caches: Optional[List[blocks.KVCache]] = None, pos: int = 0,
                cache_len: int = 0) -> Tuple[torch.Tensor, Optional[List[blocks.KVCache]]]:
    """Run the full stack. Returns (x, new_caches | None)."""
    new_caches = []
    for i, p in enumerate(params):
        x, nc = apply_layer(p, x, cfg, cfg.mixer_of(i), positions, mode=mode,
                            cache=caches[i] if caches is not None else None,
                            pos=pos, cache_len=cache_len)
        new_caches.append(nc)
    return x, (new_caches if mode != "forward" else None)
