"""Transformer building blocks: RMSNorm, GQA attention, gated FFNs.

Attention comes in three executable forms, as in the reference
(``src/repro/models/blocks.py``):

* ``attn_impl == "pallas"`` — :func:`repro_torch.kernels.flash_attention.ops.flash_attention`:
  the CUDA kernel on a card, its plain version on the CPU.
* :func:`chunked_attention` — online softmax over KV chunks in plain torch
  (a Python loop over chunks where the reference scans), and
  :func:`chunked_attention_skip` (``attn_block_skip``), which visits only
  the KV chunks each query chunk can see.
* :func:`decode_attention` — one-token step over a (possibly rolling) KV
  cache, plain torch.

All softmax/accumulation is float32 regardless of the compute dtype.
Parameters are plain dictionaries of tensors with the reference's names.
Unlike the reference, the decode step writes the new token's K/V into the
cache in place (no copy of the cache per step) and returns the same cache.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention.ops import flash_attention, worst_case
from repro_torch.models.config import ModelConfig
from repro_torch.models.rope import apply_rope
from repro_torch.parallel.sharding import (constrain, current_policy, from_whole, is_dtensor,
                                           reshape, use_policy)

NEG_INF = -1e30

Params = Dict[str, torch.Tensor]


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with the reference's type promotion: operands of two float
    dtypes are both cast to the wider first, as ``jnp.matmul`` does (torch
    refuses the mix). Training's bfloat16 compute copies meet float32
    activations there: the float32 gate and router inputs, and the xLSTM
    blocks' float32 residual stream."""
    if a.dtype != b.dtype:
        t = torch.promote_types(a.dtype, b.dtype)
        a, b = a.to(t), b.to(t)
    return a @ b


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: x · sigmoid(x). Below float32 it takes the
    reference's steps, 1 / (1 + exp(−x)) and the product, each rounded in
    x's dtype, where torch's fused kernel rounds once; in float32 it is the
    fused kernel."""
    if x.dtype == torch.float32:
        return F.silu(x)
    return x * torch.reciprocal(torch.exp(-x) + 1)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def init_rmsnorm(d: int, device=None) -> Params:
    return {"scale": torch.zeros((d,), dtype=torch.float32, device=device)}


def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * (1.0 + params["scale"])
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------
def init_dense(gen: torch.Generator, shape: Tuple[int, ...], scale: float,
               dtype=torch.float32) -> torch.Tensor:
    """Normal(0, 1) · scale, drawn in float32 on the generator's device."""
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return w.mul_(scale).to(dtype)


def init_attention(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32) -> Params:
    d, h, hk, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    scale_in = d ** -0.5
    scale_out = (h * dh) ** -0.5 / (2.0 * cfg.n_layers) ** 0.5
    p = {
        "wq": init_dense(gen, (d, h * dh), scale_in, dtype),
        "wk": init_dense(gen, (d, hk * dh), scale_in, dtype),
        "wv": init_dense(gen, (d, hk * dh), scale_in, dtype),
        "wo": init_dense(gen, (h * dh, d), scale_out, dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = init_rmsnorm(dh, gen.device)
        p["k_norm"] = init_rmsnorm(dh, gen.device)
    return p


def _theta(cfg: ModelConfig, kind: str) -> float:
    if kind == "global" and cfg.rope_theta_global > 0:
        return cfg.rope_theta_global
    return cfg.rope_theta


def _project(p: Params, x: torch.Tensor, cfg: ModelConfig):
    """q (B,S,H,dh), k/v (B,S,Hk,dh): the projections, qk-norm applied."""
    b, s, _ = x.shape
    q = reshape(mm(x, p["wq"]), (b, s, cfg.n_heads, cfg.d_head))
    k = reshape(mm(x, p["wk"]), (b, s, cfg.n_kv_heads, cfg.d_head))
    v = reshape(mm(x, p["wv"]), (b, s, cfg.n_kv_heads, cfg.d_head))
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    return q, k, v


def _qkv(p: Params, x: torch.Tensor, cfg: ModelConfig, positions, theta: float):
    """Project + rope. Returns q (B,S,H,dh), k/v (B,S,Hk,dh)."""
    q, k, v = _project(p, x, cfg)
    return apply_rope(q, positions, cfg, theta), apply_rope(k, positions, cfg, theta), v


def _sharded_heads(fn, q, k, v, positions):
    """``fn(q, k, v, positions)`` — rope and an attention core — on each
    rank's local rows and heads of the DTensors ``q``, ``k``, ``v``: the
    batch sharded as the policy's ``batch`` rule, q's heads as ``heads``
    where they divide its axes (else replicated: every rank computes all
    heads). Each rank gathers k and v over the head axes and keeps the KV
    heads of its query heads (or, where the KV heads do not divide the
    axes, repeats them to full heads first). The loop over KV chunks runs
    on local tensors (``local_map``): what GSPMD shards over (batch, heads),
    without a DTensor dispatch per op."""
    import math

    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    pol = current_policy()
    mesh = q.device_mesh
    q_pl = pol.placements(pol.fit(q.shape, ("batch", None, "heads", None)))
    heads = [i for i, p in enumerate(q_pl) if isinstance(p, Shard) and p.dim == 2]
    kv_pl = tuple(Replicate() if i in heads else p for i, p in enumerate(q_pl))
    kv_grad = tuple(Partial() if i in heads else p for i, p in enumerate(q_pl))
    pos_spec = (None, "batch", None) if positions.dim() == 3 else ("batch", None)
    pos_pl = pol.placements(pol.fit(positions.shape, pos_spec))
    if not is_dtensor(positions):
        positions = from_whole(positions, mesh, pos_pl, q.to_local().device)
    h, hk = q.shape[2], k.shape[2]
    g = h // hk
    n = math.prod(mesh.size(i) for i in heads)
    h_loc = h // n

    def local_fn(q, k, v, pos):
        off = 0
        for i in heads:  # the rank's index along the head axes, outer first
            off = off * mesh.size(i) + mesh.get_local_rank(i)
        off *= h_loc
        if hk % n == 0:
            k, v = k[:, :, off // g:(off + h_loc) // g], v[:, :, off // g:(off + h_loc) // g]
        else:
            k = k.repeat_interleave(g, dim=2)[:, :, off:off + h_loc]
            v = v.repeat_interleave(g, dim=2)[:, :, off:off + h_loc]
        with use_policy(None):
            return (fn(q, k, v, pos),)

    return local_map(local_fn, out_placements=(q_pl,),
                     in_placements=(q_pl, kv_pl, kv_pl, pos_pl),
                     in_grad_placements=(q_pl, kv_grad, kv_grad, pos_pl), device_mesh=mesh,
                     redistribute_inputs=True)(q, k, v, positions)[0]


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      q_offset: int = 0, causal: bool = True, window: int = 0,
                      chunk: int = 256) -> torch.Tensor:
    """Online-softmax attention over KV chunks.

    q: (B, Sq, H, dh); k, v: (B, Skv, Hk, dh) with H = G·Hk (GQA).
    ``window > 0`` restricts to a sliding causal window.
    Returns (B, Sq, H, dh).
    """
    b, sq, h, dh = q.shape
    skv, hk = k.shape[1], k.shape[2]
    g = h // hk
    chunk = min(chunk, skv)
    if skv % chunk:  # pad KV to a chunk multiple; pads masked out below
        pad = chunk - skv % chunk
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    nck = k.shape[1] // chunk
    scale = dh ** -0.5
    if g > 1:
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    qh = constrain(q.to(torch.float32).transpose(1, 2),   # (B,H,Sq,dh)
                   ("batch", "heads", None, None))
    kt = constrain(k.transpose(1, 2), ("batch", "heads", None, None))  # (B,H,Skv,dh)
    vt = constrain(v.transpose(1, 2), ("batch", "heads", None, None))
    dev = q.device
    q_pos = torch.arange(sq, dtype=torch.int32, device=dev) + q_offset

    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, h, sq, dh), dtype=torch.float32, device=dev)
    for ci in range(nck):
        k_i = kt[:, :, ci * chunk:(ci + 1) * chunk].to(torch.float32)
        v_i = vt[:, :, ci * chunk:(ci + 1) * chunk].to(torch.float32)
        k_pos = ci * chunk + torch.arange(chunk, dtype=torch.int32, device=dev)
        s = torch.einsum("bhqd,bhcd->bhqc", qh, k_i) * scale
        dpos = q_pos[:, None] - k_pos[None, :]
        mask = (k_pos < skv)[None, :]
        if causal:
            mask = mask & (dpos >= 0)
        if window > 0:
            mask = mask & (dpos < window)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhqc,bhcd->bhqd", p, v_i)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def chunked_attention_skip(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                           q_offset: int = 0, causal: bool = True, window: int = 0,
                           chunk: int = 256, static: bool = False) -> torch.Tensor:
    """Block-skipping online-softmax attention.

    For each query chunk, online softmax over only the KV chunks it can see
    (the causal upper bound, the sliding window's lower bound), with the
    (m, l, acc) accumulators at query-chunk size. ``static`` is the
    reference's differentiable form (each query chunk's KV range sliced
    once, then its chunks in order); the default its prefill form (each KV
    chunk sliced where it is visited). Both compute the same values.
    Falls back to :func:`chunked_attention` unless ``chunk`` divides Sq and
    Skv. Shapes as :func:`chunked_attention`.
    """
    b, sq, h, dh = q.shape
    skv, hk = k.shape[1], k.shape[2]
    g = h // hk
    if sq % chunk or skv % chunk:
        return chunked_attention(q, k, v, q_offset=q_offset, causal=causal, window=window,
                                 chunk=chunk)
    nq, nkv = sq // chunk, skv // chunk
    scale = dh ** -0.5
    if g > 1:
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    qh = constrain(q.to(torch.float32).transpose(1, 2),   # (B,H,Sq,dh)
                   ("batch", "heads", None, None))
    kt = constrain(k.transpose(1, 2), ("batch", "heads", None, None))
    vt = constrain(v.transpose(1, 2), ("batch", "heads", None, None))
    dev = q.device
    offs = torch.arange(chunk, dtype=torch.int32, device=dev)

    def kv_update(carry, q_blk, q_pos, k_j, v_j, k_pos):
        m, l, acc = carry
        s = torch.einsum("bhqd,bhcd->bhqc", q_blk, k_j) * scale
        dpos = q_pos[:, None] - k_pos[None, :]
        mask = torch.ones_like(dpos, dtype=torch.bool)
        if causal:
            mask = mask & (dpos >= 0)
        if window > 0:
            mask = mask & (dpos < window)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        return (m_new, l * corr + p.sum(dim=-1),
                acc * corr[..., None] + torch.einsum("bhqc,bhcd->bhqd", p, v_j))

    o_blocks = []
    for qi in range(nq):
        hi = min((q_offset + (qi + 1) * chunk + chunk - 1) // chunk, nkv) if causal else nkv
        lo = max((q_offset + qi * chunk - window + 1) // chunk, 0) if window > 0 else 0
        q_blk = qh[:, :, qi * chunk:(qi + 1) * chunk]
        q_pos = q_offset + qi * chunk + offs
        carry = (torch.full((b, h, chunk), NEG_INF, dtype=torch.float32, device=dev),
                 torch.zeros((b, h, chunk), dtype=torch.float32, device=dev),
                 torch.zeros((b, h, chunk, dh), dtype=torch.float32, device=dev))
        if static:
            kc = kt[:, :, lo * chunk:hi * chunk].to(torch.float32).reshape(b, h, hi - lo, chunk, dh)
            vc = vt[:, :, lo * chunk:hi * chunk].to(torch.float32).reshape(b, h, hi - lo, chunk, dh)
            for j in range(hi - lo):
                carry = kv_update(carry, q_blk, q_pos, kc[:, :, j], vc[:, :, j],
                                  (lo + j) * chunk + offs)
        else:
            for j in range(lo, hi):
                carry = kv_update(carry, q_blk, q_pos,
                                  kt[:, :, j * chunk:(j + 1) * chunk].to(torch.float32),
                                  vt[:, :, j * chunk:(j + 1) * chunk].to(torch.float32),
                                  j * chunk + offs)
        _, l, acc = carry
        o_blocks.append((acc / torch.clamp_min(l, 1e-30)[..., None]).to(q.dtype))
    return torch.cat(o_blocks, dim=2).transpose(1, 2)


class KVCache(NamedTuple):
    """Per-layer KV cache. For ``local`` layers the buffer is the window
    (rolling index, slot = pos % window); for ``global`` it is the maximum
    context (slot = pos)."""

    k: torch.Tensor  # (B, L, Hk, dh)
    v: torch.Tensor


def attention_forward(p: Params, x: torch.Tensor, cfg: ModelConfig, kind: str,
                      positions, cache_len: int = 0):
    """Full-sequence attention sublayer body (no residual/norm).

    ``cache_len > 0``: additionally return a KVCache of that length
    (prefill). Local layers store the trailing window at rolling slots."""
    theta = _theta(cfg, kind)
    window = cfg.window if kind == "local" else 0

    def core(q, k, v):
        if cfg.attn_impl == "pallas":
            # The smallest tile instantiated at this head width, as the
            # reference calls its WORST_CASE config.
            return flash_attention(q, k, v, causal=cfg.causal, window=window,
                                   config=worst_case(cfg.d_head))
        if cfg.attn_block_skip and (cfg.causal or window > 0):
            # The reference's training form (static KV bounds) without a
            # cache, its prefill form with one.
            return chunked_attention_skip(q, k, v, causal=cfg.causal, window=window,
                                          chunk=cfg.chunk_len, static=(cache_len == 0))
        return chunked_attention(q, k, v, causal=cfg.causal, window=window,
                                 chunk=cfg.chunk_len)

    if is_dtensor(x):
        if cache_len:
            raise NotImplementedError("a prefill that builds caches runs unsharded")
        q, k, v = _project(p, x, cfg)
        out = _sharded_heads(lambda q, k, v, pos: core(apply_rope(q, pos, cfg, theta),
                                                       apply_rope(k, pos, cfg, theta), v),
                             q, k, v, positions)
    else:
        q, k, v = _qkv(p, x, cfg, positions, theta)
        out = core(q, k, v)
    b, s = x.shape[:2]
    y = mm(reshape(out, (b, s, cfg.n_heads * cfg.d_head)), p["wo"])
    if cache_len == 0:
        return y
    length = min(cache_len, cfg.window) if kind == "local" else cache_len
    buf_k = torch.zeros((b, length, cfg.n_kv_heads, cfg.d_head), dtype=k.dtype,
                        device=k.device)
    buf_v = torch.zeros_like(buf_k)
    if kind == "local" and s > length:
        tail_idx = torch.arange(s - length, s, device=k.device) % length
        buf_k[:, tail_idx] = k[:, s - length:]
        buf_v[:, tail_idx] = v[:, s - length:]
    else:
        n = min(s, length)
        buf_k[:, :n] = k[:, :n]
        buf_v[:, :n] = v[:, :n]
    return y, KVCache(k=buf_k, v=buf_v)


def init_kv_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int, dtype,
                  device=None) -> KVCache:
    length = min(max_len, cfg.window) if kind == "local" else max_len
    shape = (batch, length, cfg.n_kv_heads, cfg.d_head)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def decode_attention(p: Params, x: torch.Tensor, cache: KVCache, pos: int,
                     cfg: ModelConfig, kind: str) -> Tuple[torch.Tensor, KVCache]:
    """One-token attention step. x: (B, 1, d); pos: the number of tokens
    already in the cache, a Python int (the host knows it; nothing is read
    back from the device). Writes the token's K/V into ``cache`` in place.
    Returns (y (B,1,d), cache)."""
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    if cfg.rope_variant == "mrope":
        positions = positions[None].expand(3, b, 1)
    q, k1, v1 = _qkv(p, x, cfg, positions, _theta(cfg, kind))

    length = cache.k.shape[1]
    slot = pos % length if kind == "local" else pos
    cache.k[:, slot] = k1[:, 0].to(cache.k.dtype)
    cache.v[:, slot] = v1[:, 0].to(cache.v.dtype)

    g = cfg.n_heads // cfg.n_kv_heads
    k_use, v_use = cache.k, cache.v
    if g > 1:  # repeat KV heads to full heads, as the reference does
        k_use = k_use.repeat_interleave(g, dim=2)
        v_use = v_use.repeat_interleave(g, dim=2)
    qh = constrain(q.to(torch.float32).reshape(b, cfg.n_heads, cfg.d_head),
                   ("batch", "heads", None))
    s = torch.einsum("bhd,blhd->bhl", qh, k_use.to(torch.float32)) * (cfg.d_head ** -0.5)

    idx = torch.arange(length, dtype=torch.int32, device=x.device)
    if kind == "local":
        # Rolling buffer: valid slots are the last min(pos+1, L) writes.
        age = (slot - idx) % length
        valid = age <= min(pos, length - 1)
    else:
        valid = idx <= pos
    s = torch.where(valid, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhl,blhd->bhd", w, v_use.to(torch.float32))
    out = out.reshape(b, 1, cfg.n_heads * cfg.d_head).to(x.dtype)
    return mm(out, p["wo"]), cache


# ---------------------------------------------------------------------------
# Gated FFN (SwiGLU / GeGLU) and the classic GELU FFN
# ---------------------------------------------------------------------------
def init_ffn(gen: torch.Generator, cfg: ModelConfig, d_ff: int,
             dtype=torch.float32) -> Params:
    d = cfg.d_model
    scale_in = d ** -0.5
    scale_out = d_ff ** -0.5 / (2.0 * cfg.n_layers) ** 0.5
    p = {}
    if cfg.ffn_variant != "gelu":  # gated variants need the third matrix
        p["w_gate"] = init_dense(gen, (d, d_ff), scale_in, dtype)
    p["w_up"] = init_dense(gen, (d, d_ff), scale_in, dtype)
    p["w_down"] = init_dense(gen, (d_ff, d), scale_out, dtype)
    return p


def ffn_forward(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.ffn_variant == "gelu":  # classic 2-matrix FFN (BERT/HuBERT)
        return mm(F.gelu(mm(x, p["w_up"]), approximate="tanh"), p["w_down"])
    if cfg.ffn_variant == "swiglu":
        act = silu(mm(x, p["w_gate"]))
    else:
        act = F.gelu(mm(x, p["w_gate"]), approximate="tanh")
    return mm(act * mm(x, p["w_up"]), p["w_down"])
