"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427).

The port of ``src/repro/models/rglru.py``. The Real-Gated Linear Recurrent
Unit:

    r_t = σ(block_diag(W_a) x_t + b_a)          recurrence gate
    i_t = σ(block_diag(W_x) x_t + b_x)          input gate
    a_t = exp(−c · softplus(Λ) · r_t)           per-channel decay ∈ (0,1)
    h_t = a_t ⊙ h_{t−1} + √(1 − a_t²) ⊙ (i_t ⊙ x_t)

Prefill runs the recurrence as a log-depth scan over the affine maps
(a_t, b_t) where the reference calls ``jax.lax.associative_scan``: ⌈log₂ S⌉
doubling passes in plain torch, each combining every position with the one
2ᵏ before it, with no loop over time. Decode is the one-step update. Gate
matrices are block-diagonal with ``n_heads`` blocks. (The CUDA
``rglru_scan`` kernel of ``kernels/`` computes the same recurrence from
given a and b; it belongs to altune and this block does not call it.)

Block structure: pre-norm → dual linear branches (recurrent branch: causal
depthwise conv4 → RG-LRU; gate branch: GeLU) → elementwise product → out
projection. The channel mixer (FFN) is a separate sublayer (stack.py).
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import blocks
from repro_torch.models.config import ModelConfig
from repro_torch.models.xlstm import _causal_conv, trailing_conv_inputs
from repro_torch.parallel.sharding import replicated_like

Params = Dict[str, torch.Tensor]


class RGLRUCache(NamedTuple):
    h: torch.Tensor     # (B, dr) recurrent state (float32)
    conv: torch.Tensor  # (B, W-1, dr) trailing conv inputs


def _d_rnn(cfg: ModelConfig) -> int:
    return cfg.d_model


def init_rglru_block(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32) -> Params:
    d, dr, h = cfg.d_model, _d_rnn(cfg), cfg.n_heads
    drh = dr // h
    s_in = d ** -0.5
    dev = gen.device
    # Λ so that the decays a^c span (0.9, 0.999), as in Griffin.
    lam = torch.log(torch.expm1(-torch.log(
        torch.linspace(0.9, 0.999, dr, dtype=torch.float32, device=dev)) / cfg.rglru_c))
    return {
        "w_x_branch": blocks.init_dense(gen, (d, dr), s_in, dtype),
        "w_gate_branch": blocks.init_dense(gen, (d, dr), s_in, dtype),
        "conv": blocks.init_dense(gen, (cfg.conv_width, dr), 0.2, dtype),
        "w_a": blocks.init_dense(gen, (h, drh, drh), drh ** -0.5),
        "b_a": torch.zeros((dr,), dtype=torch.float32, device=dev),
        "w_i": blocks.init_dense(gen, (h, drh, drh), drh ** -0.5),
        "b_i": torch.zeros((dr,), dtype=torch.float32, device=dev),
        "lam": lam,
        "w_out": blocks.init_dense(gen, (dr, d), dr ** -0.5 / (2.0 * cfg.n_layers) ** 0.5,
                                   dtype),
    }


def _block_diag_linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                       n_heads: int) -> torch.Tensor:
    """x: (..., dr), w: (H, drh, drh) → (..., dr), float32."""
    shape = x.shape
    drh = w.shape[1]
    xh = x.to(torch.float32).reshape(shape[:-1] + (n_heads, drh))
    y = torch.einsum("...hd,hde->...he", xh, w.to(torch.float32))
    return y.reshape(shape[:-1] + (n_heads * drh,)) + b


def _gates(p: Params, x: torch.Tensor, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """(a, β · i · x): the decay and the input term of the recurrence, with
    √(1 − a²) computed from log a as the reference does."""
    r = torch.sigmoid(_block_diag_linear(x, p["w_a"], p["b_a"], cfg.n_heads))
    i = torch.sigmoid(_block_diag_linear(x, p["w_i"], p["b_i"], cfg.n_heads))
    log_a = -cfg.rglru_c * F.softplus(p["lam"]) * r
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp_min(-torch.expm1(2.0 * log_a), 1e-12))
    return a, beta * (i * x.to(torch.float32))


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t−1} + b_t over dim 1 from h_{−1} = 0, in ⌈log₂ S⌉
    doubling passes: after the pass with offset d, (a_t, b_t) is the
    composition of the maps d·2 − 1 … 0 steps back, combined as the
    reference's ``combine`` (``a_p · a_c``, ``b_p · a_c + b_c``)."""
    s = a.shape[1]
    for k in range(math.ceil(math.log2(s)) if s > 1 else 0):
        d = 1 << k
        b = torch.cat([b[:, :d], b[:, :-d] * a[:, d:] + b[:, d:]], dim=1)
        if d * 2 < s:  # the last pass needs no decay products
            a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
    return b


def rglru_scan(p: Params, x: torch.Tensor, cfg: ModelConfig,
               h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrence over a sequence. x: (B,S,dr) conv output; h0: (B,dr)
    float32. Returns (h (B,S,dr) in x's dtype, final state (B,dr) float32)."""
    a, b = _gates(p, x, cfg)
    b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)  # fold h0 in
    h = linear_scan(a, b)
    return h.to(x.dtype), h[:, -1]


def rglru_step(p: Params, x1: torch.Tensor, cfg: ModelConfig,
               h_prev: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token update. x1: (B, dr); h_prev: (B, dr) float32."""
    a, bx = _gates(p, x1, cfg)
    h_new = a * h_prev + bx
    return h_new.to(x1.dtype), h_new


def rglru_block_forward(p: Params, x: torch.Tensor, cfg: ModelConfig,
                        cache: Optional[RGLRUCache] = None, return_cache: bool = False):
    """Full-sequence forward. x: (B,S,d)."""
    b = x.shape[0]
    xb = blocks.mm(x, p["w_x_branch"])
    gate = F.gelu(blocks.mm(x, p["w_gate_branch"]), approximate="tanh")
    conv_prev = cache.conv if cache is not None else None
    xc = _causal_conv(xb, p["conv"], conv_prev)
    h0 = cache.h if cache is not None else replicated_like(torch.zeros(
        (b, _d_rnn(cfg)), dtype=torch.float32, device=x.device), x)
    hseq, h_final = rglru_scan(p, xc, cfg, h0)
    out = blocks.mm(hseq * gate, p["w_out"])
    if return_cache:
        return out, RGLRUCache(h=h_final, conv=trailing_conv_inputs(conv_prev, xb,
                                                                      cfg.conv_width))
    return out


def rglru_block_step(p: Params, x1: torch.Tensor, cfg: ModelConfig,
                     cache: RGLRUCache) -> Tuple[torch.Tensor, RGLRUCache]:
    """One-token decode. x1: (B, 1, d)."""
    xb = blocks.mm(x1, p["w_x_branch"])  # (B,1,dr)
    gate = F.gelu(blocks.mm(x1, p["w_gate_branch"]), approximate="tanh")
    window = torch.cat([cache.conv, xb.to(cache.conv.dtype)], dim=1)  # (B, W, dr)
    w = p["conv"]
    xc = sum(window[:, i] * w[i] for i in range(w.shape[0]))  # (B,dr)
    h1, h_new = rglru_step(p, xc, cfg, cache.h)
    out = blocks.mm(h1[:, None] * gate, p["w_out"])
    return out, RGLRUCache(h=h_new, conv=window[:, 1:])


def init_rglru_cache(cfg: ModelConfig, batch: int, dtype, device=None) -> RGLRUCache:
    dr = _d_rnn(cfg)
    return RGLRUCache(h=torch.zeros((batch, dr), dtype=torch.float32, device=device),
                      conv=torch.zeros((batch, cfg.conv_width - 1, dr), dtype=dtype,
                                       device=device))
