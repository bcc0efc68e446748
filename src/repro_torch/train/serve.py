"""Serving steps: batched prefill and single-token decode.

``make_prefill_step`` / ``make_decode_step`` return plain callables (the
port runs eagerly; the reference returns functions for ``jax.jit``).
Sampling is greedy (``argmax`` of the float32 logits) or, with a
temperature, categorical from a ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.models import model as lm
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_len: int = 4096
    temperature: float = 0.0  # 0 → greedy
    cache_dtype: str = "bfloat16"


def make_prefill_step(cfg: ModelConfig, sc: ServeConfig):
    def prefill_step(params, batch: Dict[str, torch.Tensor]):
        """batch: ``tokens`` (B, S) or ``embeds`` (B, S, d), and optionally
        ``positions`` (B, S) or M-RoPE's (3, B, S). Returns (last-position
        logits (B, V), caches). The head runs at the last position only:
        a long prompt's (B, S, V) float32 logits are GiBs that serving never
        reads."""
        logits, _, caches = lm.prefill(params, cfg, cache_len=sc.max_len,
                                       tokens=batch.get("tokens"),
                                       embeds=batch.get("embeds"),
                                       positions=batch.get("positions"), last_logits=True)
        return logits[:, -1], caches

    return prefill_step


def make_decode_step(cfg: ModelConfig, sc: ServeConfig):
    def decode_step(params, caches, tokens: torch.Tensor, pos: int,
                    generator: Optional[torch.Generator] = None):
        """tokens: (B, 1) int; pos: tokens already in the cache (a Python
        int). Returns (next_token (B, 1) int32, logits (B, V) float32,
        caches)."""
        logits, caches = lm.decode_step(params, cfg, caches, tokens, pos)
        lf = logits[:, -1].to(torch.float32)
        if sc.temperature > 0.0 and generator is not None:
            probs = torch.softmax(lf / sc.temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
        else:
            nxt = torch.argmax(lf, dim=-1)
        return nxt[:, None].to(torch.int32), lf, caches

    return decode_step


def init_serve_cache(cfg: ModelConfig, sc: ServeConfig, batch: int, device=None):
    return lm.init_cache(cfg, batch, sc.max_len, getattr(torch, sc.cache_dtype), device)
