"""xLSTM blocks: chunkwise-parallel mLSTM and sequential sLSTM.

The port of ``src/repro/models/xlstm.py``. mLSTM (matrix memory,
exponential gating — arXiv:2405.04517):

    C_t = f_t·C_{t−1} + i_t·k_t v_tᵀ      n_t = f_t·n_{t−1} + i_t·k_t
    h_t = o_t ⊙ (C_tᵀ q_t) / max(|n_tᵀ q_t|, exp(−m_t))

computed in the chunkwise form: within a chunk of ``cfg.chunk_len`` the
quadratic form with log-space gate decays, between chunks a carried
(C, n, m) state (a Python loop over chunks where the reference scans).
:func:`mlstm_step` is the sequential step (the decode path).

sLSTM (scalar memory, recurrent R per head) is sequential: a Python loop
over time with the exponential-gate stabilizer m_t, as the reference's
``lax.scan``.

The stabilizers start at −inf (:func:`mlstm_zero_state`,
:func:`slstm_zero_state`); the reference's operation order is kept
(``max(f + m, i)`` first, then ``exp(f + m − m_new)``), so the first step's
forget weight is ``exp(−inf) = 0`` and no ``−inf − −inf`` is formed.

Block wrappers follow the xLSTM paper: the mLSTM block is a gated
up/down-projection sandwich (pf=2) with a causal conv4 front; the sLSTM
block is followed by a gated MLP (pf=4/3). ``d_ff = 0`` in the arch config:
these blocks own their projections.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import blocks
from repro_torch.models.config import ModelConfig
from repro_torch.parallel.sharding import current_policy, is_dtensor, replicated_like, reshape

NEG_INF = -1e30

Params = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# mLSTM core
# ---------------------------------------------------------------------------
class MLSTMState(NamedTuple):
    c: torch.Tensor  # (B, H, dh, dh) matrix memory
    n: torch.Tensor  # (B, H, dh)     normalizer
    m: torch.Tensor  # (B, H)         log-space stabilizer


def mlstm_zero_state(b: int, h: int, dh: int, device=None) -> MLSTMState:
    return MLSTMState(
        c=torch.zeros((b, h, dh, dh), dtype=torch.float32, device=device),
        n=torch.zeros((b, h, dh), dtype=torch.float32, device=device),
        m=torch.full((b, h), float("-inf"), dtype=torch.float32, device=device),
    )


def mlstm_step(state: MLSTMState, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               i_log: torch.Tensor, f_log: torch.Tensor) -> Tuple[MLSTMState, torch.Tensor]:
    """Sequential step (also the decode path). q/k/v: (B,H,dh); i_log/f_log:
    (B,H) log input gate / log forget gate."""
    c, n, m = state
    m_new = torch.maximum(f_log + m, i_log)
    f_s = torch.exp(f_log + m - m_new)[..., None]
    i_s = torch.exp(i_log - m_new)[..., None]
    c_new = f_s[..., None] * c + (i_s * k)[..., :, None] * v[..., None, :]
    n_new = f_s * n + i_s * k
    num = torch.einsum("bhde,bhd->bhe", c_new, q)
    den = torch.abs(torch.einsum("bhd,bhd->bh", n_new, q))
    h = num / torch.maximum(den, torch.exp(-m_new))[..., None]
    return MLSTMState(c_new, n_new, m_new), h


def mlstm_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, i_log: torch.Tensor,
                  f_log: torch.Tensor, state: MLSTMState,
                  chunk: int) -> Tuple[torch.Tensor, MLSTMState]:
    """Chunkwise-parallel mLSTM. q/k/v: (B,S,H,dh) — k pre-scaled by the
    caller; gates (B,S,H). Returns (h (B,S,H,dh), final state)."""
    b, s, h, dh = q.shape
    chunk = min(chunk, s)
    s_orig = s
    if s % chunk:
        # Pad with identity gates: f=1 (log 0) keeps the state, i=0 (log
        # −inf) adds nothing; padded outputs are sliced off below.
        pad = chunk - s % chunk
        q, k, v = (F.pad(z, (0, 0, 0, 0, 0, pad)) for z in (q, k, v))
        i_log = F.pad(i_log, (0, 0, 0, pad), value=NEG_INF)
        f_log = F.pad(f_log, (0, 0, 0, pad))
        s = s + pad
    nc = s // chunk
    dev = q.device
    tri = replicated_like(torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=dev)),
                          q)

    def chunk_of(x: torch.Tensor, ci: int) -> torch.Tensor:
        """(B, S, H, ...) → chunk ci as (B, H, L, ...)."""
        return x[:, ci * chunk:(ci + 1) * chunk].movedim(2, 1)

    c_prev, n_prev, m_prev = state
    outs = []
    for ci in range(nc):
        qi, ki, vi = (chunk_of(z, ci).to(torch.float32) for z in (q, k, v))
        ii, fi = chunk_of(i_log, ci), chunk_of(f_log, ci)  # (B,H,L)
        bcum = torch.cumsum(fi, dim=-1)  # inclusive Σ log f
        total_f = bcum[..., -1]

        # Intra-chunk log decay matrix: D[i,j] = b_i − b_j + log i_j, j ≤ i.
        log_d = bcum[..., :, None] - bcum[..., None, :] + ii[..., None, :]
        log_d = torch.where(tri, log_d, NEG_INF)

        # Inter-chunk contribution decays by b_i from the carried state.
        inter_log = bcum + m_prev[..., None]  # (B,H,L)
        m_row = torch.maximum(log_d.amax(dim=-1), inter_log)

        d = torch.exp(log_d - m_row[..., None])
        scores = torch.einsum("bhld,bhmd->bhlm", qi, ki) * d
        inter_w = torch.exp(inter_log - m_row)[..., None]  # (B,H,L,1)

        num = (torch.einsum("bhlm,bhmd->bhld", scores, vi)
               + inter_w * torch.einsum("bhde,bhld->bhle", c_prev, qi))
        den = torch.abs(scores.sum(dim=-1)
                        + inter_w[..., 0] * torch.einsum("bhd,bhld->bhl", n_prev, qi))
        outs.append(num / torch.maximum(den, torch.exp(-m_row))[..., None])

        # State update to end of chunk.
        upd_log = total_f[..., None] - bcum + ii  # (B,H,L)
        m_new = torch.maximum(total_f + m_prev, upd_log.amax(dim=-1))
        carry_w = torch.exp(total_f + m_prev - m_new)
        upd_w = torch.exp(upd_log - m_new[..., None])
        c_prev = carry_w[..., None, None] * c_prev + torch.einsum(
            "bhld,bhle,bhl->bhde", ki, vi, upd_w)
        n_prev = carry_w[..., None] * n_prev + torch.einsum("bhld,bhl->bhd", ki, upd_w)
        m_prev = m_new
    h_out = torch.cat(outs, dim=2).movedim(1, 2)[:, :s_orig]  # (B,S,H,dh)
    return h_out.to(q.dtype), MLSTMState(c_prev, n_prev, m_prev)


# ---------------------------------------------------------------------------
# mLSTM block (pf=2 up/down sandwich, conv4, per-head gates)
# ---------------------------------------------------------------------------
class MLSTMCache(NamedTuple):
    state: MLSTMState
    conv: torch.Tensor  # (B, conv_width-1, d_inner) trailing inputs


def _d_inner_m(cfg: ModelConfig) -> int:
    return int(cfg.d_model * cfg.mlstm_proj_factor)


def init_mlstm_block(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32) -> Params:
    d, di, h = cfg.d_model, _d_inner_m(cfg), cfg.n_heads
    s_in, s_i = d ** -0.5, di ** -0.5
    dev = gen.device
    return {
        "w_up": blocks.init_dense(gen, (d, 2 * di), s_in, dtype),
        "conv": blocks.init_dense(gen, (cfg.conv_width, di), 0.2, dtype),
        "wq": blocks.init_dense(gen, (di, di), s_i, dtype),
        "wk": blocks.init_dense(gen, (di, di), s_i, dtype),
        "wv": blocks.init_dense(gen, (di, di), s_i, dtype),
        "w_gates": blocks.init_dense(gen, (di, 2 * h), s_i),
        "b_gates": torch.cat([torch.zeros((h,), dtype=torch.float32, device=dev),
                              3.0 + torch.arange(h, dtype=torch.float32, device=dev) / h]),
        "skip": torch.ones((di,), dtype=dtype, device=dev),
        "w_down": blocks.init_dense(gen, (di, d), s_i / (2.0 * cfg.n_layers) ** 0.5, dtype),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 prev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv. x: (B,S,di), w: (W,di); prev: (B,W-1,di)."""
    width = w.shape[0]
    pad = prev if prev is not None else replicated_like(torch.zeros(
        (x.shape[0], width - 1, x.shape[2]), dtype=x.dtype, device=x.device), x)
    xp = torch.cat([pad, x], dim=1)
    return sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(width))


def trailing_conv_inputs(conv_prev: Optional[torch.Tensor], x: torch.Tensor,
                         width: int) -> torch.Tensor:
    """The last ``width - 1`` conv inputs after ``x`` (B,S,di), left-padded
    with zeros where the sequence is shorter than the window."""
    seq = torch.cat([conv_prev, x], dim=1) if conv_prev is not None else x
    tail = seq[:, -(width - 1):]
    pad = width - 1 - tail.shape[1]
    return F.pad(tail, (0, 0, pad, 0)) if pad > 0 else tail


def _mlstm_gate_inputs(p: Params, xc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Log input gates and forget-gate pre-activations (… , H) from the conv
    output."""
    gates = blocks.mm(xc.to(torch.float32), p["w_gates"]) + p["b_gates"]
    i_log, f_raw = gates.chunk(2, dim=-1)
    return i_log, f_raw


def _mlstm_gates(p: Params, xc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Log input and log forget gates (… , H) from the conv output."""
    i_log, f_raw = _mlstm_gate_inputs(p, xc)
    return i_log, F.logsigmoid(f_raw)


def _head_placements(x: torch.Tensor, heads_dim: int):
    """The active policy's placements of the DTensor ``x`` whose dimension 0
    is the batch and ``heads_dim`` the heads (each as the policy's rule where
    it divides the mesh axes, else replicated), and the mesh dimensions that
    shard the batch and the heads."""
    from torch.distributed.tensor import Shard

    pol = current_policy()
    spec = tuple("batch" if d == 0 else "heads" if d == heads_dim else None
                 for d in range(x.dim()))
    pl = pol.placements(pol.fit(x.shape, spec))
    batch = [i for i, p in enumerate(pl) if isinstance(p, Shard) and p.dim == 0]
    heads = [i for i, p in enumerate(pl) if isinstance(p, Shard) and p.dim == heads_dim]
    return pl, batch, heads


def _placed(n_mesh: int, batch, heads, heads_dim: int) -> tuple:
    """Placements over ``n_mesh`` mesh dimensions: ``Shard(0)`` on the batch
    ones, ``Shard(heads_dim)`` on the head ones, ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    return tuple(Shard(0) if i in batch else Shard(heads_dim) if i in heads
                 else Replicate() for i in range(n_mesh))


def _mlstm_core(q, k, v, i_log, f_raw, state: Optional[MLSTMState],
                chunk: int) -> Tuple[torch.Tensor, MLSTMState]:
    """:func:`mlstm_chunked` from the forget gates' pre-activations, from
    the zero state where ``state`` is None. On DTensors (under a sharding
    policy) it runs on each rank's local rows and heads (``local_map``),
    what GSPMD shards the reference's scan over: the gates' ``log_sigmoid``
    (DTensor has no rule for its backward) and the masked chunk products
    see plain tensors only."""
    b, _, h, dh = q.shape
    if not is_dtensor(q):
        st = state if state is not None else mlstm_zero_state(b, h, dh, q.device)
        return mlstm_chunked(q, k, v, i_log, F.logsigmoid(f_raw), st, chunk)
    from torch.distributed.tensor.experimental import local_map

    pl, batch, heads = _head_placements(q, 2)
    n = q.device_mesh.ndim
    g_pl = _placed(n, batch, heads, 2)                      # (B, S, H) gates
    st_pl = (_placed(n, batch, heads, 1),) * 3            # c, n, m: (B, H, ...)

    def local_fn(q, k, v, i_log, f_raw, *st):
        st = MLSTMState(*st) if st else mlstm_zero_state(q.shape[0], q.shape[2], dh, q.device)
        hseq, final = mlstm_chunked(q, k, v, i_log, F.logsigmoid(f_raw), st, chunk)
        return (hseq, *final)

    args = (q, k, v, i_log, f_raw) + (tuple(state) if state is not None else ())
    in_pl = (pl,) * 3 + (g_pl,) * 2 + (st_pl if state is not None else ())
    out = local_map(local_fn, out_placements=(pl,) + st_pl, in_placements=in_pl,
                    in_grad_placements=in_pl, device_mesh=q.device_mesh,
                    redistribute_inputs=True)(*args)
    return out[0], MLSTMState(*out[1:])


def mlstm_block_forward(p: Params, x: torch.Tensor, cfg: ModelConfig,
                        cache: Optional[MLSTMCache] = None, return_cache: bool = False):
    b, s, _ = x.shape
    di, h = _d_inner_m(cfg), cfg.n_heads
    dh = di // h
    xm, gate = blocks.mm(x, p["w_up"]).chunk(2, dim=-1)
    conv_prev = cache.conv if cache is not None else None
    xc = F.silu(_causal_conv(xm, p["conv"], conv_prev))

    q = reshape(blocks.mm(xc, p["wq"]), (b, s, h, dh))
    k = reshape(blocks.mm(xc, p["wk"]), (b, s, h, dh)) * (dh ** -0.5)
    v = reshape(blocks.mm(xm, p["wv"]), (b, s, h, dh))
    i_log, f_raw = _mlstm_gate_inputs(p, xc)

    hseq, final = _mlstm_core(q, k, v, i_log, f_raw,
                              cache.state if cache is not None else None, cfg.chunk_len)
    hflat = reshape(hseq, (b, s, di)) + p["skip"] * xc
    out = blocks.mm(hflat * F.silu(gate), p["w_down"])
    if return_cache:
        conv = trailing_conv_inputs(conv_prev, xm, cfg.conv_width)
        return out, MLSTMCache(state=final, conv=conv)
    return out


def mlstm_block_step(p: Params, x1: torch.Tensor, cfg: ModelConfig,
                     cache: MLSTMCache) -> Tuple[torch.Tensor, MLSTMCache]:
    """One-token mLSTM via the sequential step (the reference's
    ``stack._mlstm_decode``). x1: (B, 1, d)."""
    b = x1.shape[0]
    di, nh = _d_inner_m(cfg), cfg.n_heads
    dh = di // nh
    xm, gate = blocks.mm(x1, p["w_up"]).chunk(2, dim=-1)  # (B,1,di)
    window = torch.cat([cache.conv, xm.to(cache.conv.dtype)], dim=1)  # (B,W,di)
    w = p["conv"]
    xc = F.silu(sum(window[:, i] * w[i] for i in range(w.shape[0])))
    q = blocks.mm(xc, p["wq"]).reshape(b, nh, dh)
    k = blocks.mm(xc, p["wk"]).reshape(b, nh, dh) * (dh ** -0.5)
    v = blocks.mm(xm[:, 0], p["wv"]).reshape(b, nh, dh)
    i_log, f_log = _mlstm_gates(p, xc)
    state, hv = mlstm_step(cache.state, q, k, v, i_log, f_log)
    hflat = hv.reshape(b, 1, di).to(x1.dtype) + p["skip"] * xc[:, None]
    out = blocks.mm(hflat * F.silu(gate), p["w_down"])
    return out, MLSTMCache(state=state, conv=window[:, 1:])


def init_mlstm_cache(cfg: ModelConfig, batch: int, dtype, device=None) -> MLSTMCache:
    di, h = _d_inner_m(cfg), cfg.n_heads
    return MLSTMCache(state=mlstm_zero_state(batch, h, di // h, device),
                      conv=torch.zeros((batch, cfg.conv_width - 1, di), dtype=dtype,
                                       device=device))


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------
class SLSTMState(NamedTuple):
    c: torch.Tensor  # (B, H, dh)
    n: torch.Tensor
    h: torch.Tensor
    m: torch.Tensor  # (B, H, dh) stabilizer


def _d_inner_s(cfg: ModelConfig) -> int:
    return cfg.d_model


def _d_ff_s(cfg: ModelConfig) -> int:
    return int(cfg.d_model * cfg.slstm_proj_factor)


def init_slstm_block(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32) -> Params:
    d, h = _d_inner_s(cfg), cfg.n_heads
    dh, dff = d // h, _d_ff_s(cfg)
    s_in = d ** -0.5
    return {
        "w_x": blocks.init_dense(gen, (d, 4 * d), s_in, dtype),
        "r": blocks.init_dense(gen, (h, dh, 4 * dh), dh ** -0.5, dtype),
        "b": torch.zeros((4 * d,), dtype=torch.float32, device=gen.device),
        "gn": blocks.init_rmsnorm(d, gen.device),
        "w_up": blocks.init_dense(gen, (d, 2 * dff), s_in, dtype),
        "w_down": blocks.init_dense(gen, (dff, d), dff ** -0.5 / (2.0 * cfg.n_layers) ** 0.5,
                                    dtype),
    }


def slstm_zero_state(b: int, h: int, dh: int, device=None) -> SLSTMState:
    def z():
        return torch.zeros((b, h, dh), dtype=torch.float32, device=device)

    return SLSTMState(c=z(), n=z(), h=z(),
                      m=torch.full((b, h, dh), float("-inf"), dtype=torch.float32,
                                   device=device))


def slstm_scan(p: Params, x: torch.Tensor, cfg: ModelConfig,
               state: Optional[SLSTMState]) -> Tuple[torch.Tensor, SLSTMState]:
    """x: (B,S,d) pre-activation inputs; ``state`` None: the zero state. A
    Python loop over time. On DTensors (under a sharding policy) the loop
    runs on each rank's local rows and heads (``local_map``; the recurrent
    weights of its heads), as GSPMD shards the reference's scan, not a
    DTensor dispatch per op of every step."""
    b, s, d = x.shape
    h = cfg.n_heads
    dh = d // h
    zx = reshape((blocks.mm(x, p["w_x"]) + p["b"]).to(torch.float32), (b, s, 4, h, dh))
    if not is_dtensor(zx):
        y, final = _slstm_loop(zx, p["r"], state)
        return y.to(x.dtype), final
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    z_pl, batch, heads = _head_placements(zx, 3)
    n = zx.device_mesh.ndim
    r_pl = tuple(Shard(0) if i in heads else Replicate() for i in range(n))
    # Each rank's gradient of its heads' weights sums over its rows only.
    r_grad = tuple(Partial() if i in batch else r_pl[i] for i in range(n))
    st_pl = (_placed(n, batch, heads, 1),) * 4
    out_pl = _placed(n, batch, heads, 2)                    # (B, S, H, dh)

    def local_fn(zx, r, *st):
        y, final = _slstm_loop(zx, r, SLSTMState(*st) if st else None)
        return (y.reshape(zx.shape[0], s, -1, dh), *final)

    args = (zx, p["r"]) + (tuple(state) if state is not None else ())
    in_pl = (z_pl, r_pl) + (st_pl if state is not None else ())
    grad_pl = (z_pl, r_grad) + (st_pl if state is not None else ())
    out = local_map(local_fn, out_placements=(out_pl,) + st_pl, in_placements=in_pl,
                    in_grad_placements=grad_pl, device_mesh=zx.device_mesh,
                    redistribute_inputs=True)(*args)
    return reshape(out[0], (b, s, d)).to(x.dtype), SLSTMState(*out[1:])


def _slstm_loop(zx: torch.Tensor, r: torch.Tensor,
                state: Optional[SLSTMState]) -> Tuple[torch.Tensor, SLSTMState]:
    """The sLSTM recurrence over ``zx`` (B,S,4,H,dh) float32 with the
    recurrent weights ``r`` (H,dh,4dh), from ``state`` (None: zero). Returns
    (h (B,S,H·dh) float32, final state)."""
    b, s, _, h, dh = zx.shape
    zx = zx.movedim(1, 0)                                    # (S,B,4,H,dh)
    r = r.to(torch.float32)
    if state is None:
        state = slstm_zero_state(b, h, dh, zx.device)
    # torch.maximum, not clamp_min: at a tie (n is exactly 1 after the
    # first step) it halves the gradient, as the reference's jnp.maximum.
    one = torch.ones((), dtype=torch.float32, device=zx.device)
    st = state
    hs = []
    for t in range(s):
        rec = torch.einsum("bhd,hde->bhe", st.h, r).reshape(b, h, 4, dh).movedim(2, 1)
        z_t = zx[t]
        zi, zf, zz, zo = (z_t[:, i] + rec[:, i] for i in range(4))
        m_new = torch.maximum(zf + st.m, zi)
        i_s = torch.exp(zi - m_new)
        f_s = torch.exp(zf + st.m - m_new)
        c_new = f_s * st.c + i_s * torch.tanh(zz)
        n_new = f_s * st.n + i_s
        h_new = torch.sigmoid(zo) * c_new / torch.maximum(n_new, one)
        st = SLSTMState(c_new, n_new, h_new, m_new)
        hs.append(h_new)
    return torch.stack(hs, dim=1).reshape(b, s, h * dh), st


def slstm_block_forward(p: Params, x: torch.Tensor, cfg: ModelConfig,
                        state: Optional[SLSTMState] = None, return_cache: bool = False):
    y, final = slstm_scan(p, x, cfg, state)
    y = blocks.rmsnorm(p["gn"], y, cfg.norm_eps)
    up_gate, up = blocks.mm(y, p["w_up"]).chunk(2, dim=-1)
    out = blocks.mm(F.gelu(up_gate, approximate="tanh") * up, p["w_down"])
    if return_cache:
        return out, final
    return out
