"""Mixture-of-Experts channel mixer (DeepSeekMoE-style fine-grained experts).

The port of ``src/repro/models/moe.py``: shared experts plus routed top-k
with the reference's capacity-bounded, sort-based dispatch, step for step:

1. router (float32) → softmax → each token's top-k experts, exact ties to
   the lower expert index as ``jax.lax.top_k`` orders them (a stable
   descending sort), the k weights renormalized;
2. the (token, k) assignments flattened in token order and stably sorted
   by expert;
3. each assignment's position in its expert from the sorted prefix; those
   at or past the capacity ``C = max(round_up(int(T·k/E · cf), 8), 8)``
   are dropped (a dropped token keeps the shared experts and its
   residual);
4. token ids and weights written into (E, C) tables, activations gathered
   to (E, C, d), one batched product per weight matrix (``torch.matmul``:
   cuBLAS on a card, float32), and the weighted rows added back to their
   tokens (``index_add_``). Empty slots gather token 0 with weight 0.

The reference writes the tables with ``.at[e, pos].set(..., mode="drop")``,
which drops both the overflow column ``C`` and the out-of-range row
``E``; torch has no drop mode, so the port writes into a table one row and
one column larger and slices them off.

The shared experts are one dense FFN of width ``n_shared · d_ff_expert``
(the same as summing them). The router also returns the load-balance
loss ``E · Σ_e f_e · P_e`` (Switch/GShard), which :mod:`.stack` sums over
layers.

Every (E, C) slot is multiplied whether it holds a token or not, so a
decode step (T = batch) reads every expert's weights, at C ≥ 8 rows each:
the reference's semantics, kept.

Under a ``parallel.sharding`` policy on a DeviceMesh, :func:`moe_forward`
takes the reference's expert-parallel branch exactly where the reference
does (:func:`expert_parallel`: a ``model`` axis larger than one that the
``experts`` rule names and that divides E). It is the reference's
``shard_map`` as ``local_map``: activations are replicated over
``model``, so each ``model`` rank ``m`` owns experts ``[m·E_loc,
(m+1)·E_loc)`` and runs the dispatch on its *data-local* tokens — the
capacity from the local token count, as under ``shard_map`` — and the
partial outputs are summed over ``model`` (a ``Partial`` placement made
``Replicate``). The load-balance loss is each data shard's, averaged over
the shards (the reference's ``pmean``). The sort, top-k, table writes,
gathers and ``index_add_`` run on local tensors inside ``local_map``
(DTensor refuses a plain index tensor beside a DTensor operand). Other
policies (no ``model`` axis, or an ``experts`` rule without it) run the
reference's global dispatch: every rank gathers all tokens and the
experts' weights and computes the layer whole, a replicated copy, as
GSPMD's sharding of the global program gives the same values.

The steps are the module's functions ``_route`` (1), ``_tables`` (2–3),
``_gather``, ``_experts`` and ``_combine`` (4), called through the module,
so a caller can time each or read the routes (:func:`recording_routes`).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import blocks
from repro_torch.models.config import ModelConfig, MoEConfig
from repro_torch.parallel.sharding import constrain, current_policy, is_dtensor

Params = Dict[str, object]

#: While :func:`recording_routes` is open: each routing's (experts, probs).
_route_log: Optional[List[Tuple[torch.Tensor, torch.Tensor]]] = None


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def capacity(n_tokens: int, cfg: ModelConfig) -> int:
    """The reference's ``capacity`` (a multiple of 128; the dispatch uses
    its own multiple of 8, as the reference's does)."""
    moe = cfg.moe
    c = int(n_tokens * moe.top_k / moe.n_experts * moe.capacity_factor)
    return max(_round_up(c, 128), 128)


def init_moe(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32) -> Params:
    """Router (d, E) float32, ``w_gate`` / ``w_up`` (E, d, f), ``w_down`` (E,
    f, d) and, with shared experts, ``shared`` (an FFN of width ``n_shared ·
    f``), each Normal · its reference scale, drawn in place on
    ``gen.device`` (an expert tensor has no temporary copy)."""
    moe = cfg.moe
    d, f, e = cfg.d_model, moe.d_ff_expert, moe.n_experts
    scale_in = d ** -0.5
    scale_out = f ** -0.5 / (2.0 * cfg.n_layers) ** 0.5
    p: Params = {
        "router": blocks.init_dense(gen, (d, e), scale_in, torch.float32),
        "w_gate": blocks.init_dense(gen, (e, d, f), scale_in, dtype),
        "w_up": blocks.init_dense(gen, (e, d, f), scale_in, dtype),
        "w_down": blocks.init_dense(gen, (e, f, d), scale_out, dtype),
    }
    if moe.n_shared > 0:
        p["shared"] = blocks.init_ffn(gen, cfg, moe.n_shared * f, dtype)
    return p


@contextlib.contextmanager
def recording_routes() -> Iterator[List[Tuple[torch.Tensor, torch.Tensor]]]:
    """Within the block, every routing appends its experts (T, k) and
    probabilities (T, E) to the list it yields, in call order."""
    global _route_log
    outer, _route_log = _route_log, []
    try:
        yield _route_log
    finally:
        _route_log = outer


@contextlib.contextmanager
def routes_paused() -> Iterator[None]:
    """Within the block, routings are not recorded (a layer run again for
    its backward pass routes the same tokens a second time)."""
    global _route_log
    outer, _route_log = _route_log, None
    try:
        yield
    finally:
        _route_log = outer


def _counts(index: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """How often each of 0..n-1 occurs in ``index``: an ``index_add_`` of
    ones (``bincount`` on a card reads the maximum back to the host)."""
    ones = torch.ones((), dtype=dtype, device=index.device).expand(index.numel())
    return torch.zeros((n,), dtype=dtype, device=index.device).index_add_(0, index, ones)


def _route(router: torch.Tensor, x_flat: torch.Tensor, moe: MoEConfig):
    """Top-k routing: (weights (T, k) float32, experts (T, k) int64, probs
    (T, E) float32, aux scalar)."""
    logits = blocks.mm(x_flat.to(torch.float32), router)
    probs = torch.softmax(logits, dim=-1)
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = top[:, :moe.top_k], idx[:, :moe.top_k]
    w = w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-9)
    e = moe.n_experts
    occupancy = _counts(idx.reshape(-1), e, torch.float32)
    frac = occupancy / torch.clamp_min(occupancy.sum(), 1.0)
    aux = e * torch.sum(frac * probs.mean(0))
    if _route_log is not None:
        _route_log.append((idx, probs))
    return w, idx, probs, aux


def route(p: Params, x_flat: torch.Tensor, cfg: ModelConfig):
    """Top-k routing. Returns (weights (T, k) float32, experts (T, k) int64,
    aux_loss scalar)."""
    w, idx, _, aux = _route(p["router"], x_flat, cfg.moe)
    return w, idx, aux


def _tables(e_flat: torch.Tensor, tok_flat: torch.Tensor, w_flat: torch.Tensor,
            e_count: int, cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each expert's first ``cap`` assignments in token order: token ids
    (E_loc, C) int64 and weights (E_loc, C) float32, 0 in empty slots.
    ``e_flat == e_count`` is the bucket of assignments outside the range."""
    n, dev = e_flat.numel(), e_flat.device
    order = torch.argsort(e_flat, stable=True)
    e_sorted, tok_sorted, w_sorted = e_flat[order], tok_flat[order], w_flat[order]
    counts = _counts(e_flat, e_count + 1, torch.int64)
    starts = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(n, device=dev) - starts[e_sorted]
    # Row e_count and column cap take what the reference's mode="drop" drops.
    oob = torch.where((pos_in_e < cap) & (e_sorted < e_count), pos_in_e, cap)
    tok_table = torch.zeros((e_count + 1, cap + 1), dtype=torch.int64, device=dev)
    w_table = torch.zeros((e_count + 1, cap + 1), dtype=torch.float32, device=dev)
    tok_table[e_sorted, oob] = tok_sorted
    w_table[e_sorted, oob] = w_sorted
    return tok_table[:e_count, :cap], w_table[:e_count, :cap]


def _gather(x_flat: torch.Tensor, tok_table: torch.Tensor) -> torch.Tensor:
    return x_flat[tok_table]  # (E_loc, C, d)


def _experts(gathered: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
             w_down: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The grouped GEMM: (E_loc, C, d) → (E_loc, C, d) through each expert's
    gated FFN, three batched products."""
    h = blocks.mm(gathered, w_gate)
    h = blocks.silu(h) if cfg.ffn_variant == "swiglu" else F.gelu(h, approximate="tanh")
    return blocks.mm(h * blocks.mm(gathered, w_up), w_down)


def _combine(out: torch.Tensor, tok_table: torch.Tensor, w_table: torch.Tensor,
             n_tokens: int) -> torch.Tensor:
    """Each slot's row times its weight, added to its token's row."""
    d = out.shape[-1]
    y = torch.zeros((n_tokens, d), dtype=out.dtype, device=out.device)
    return y.index_add_(0, tok_table.reshape(-1),
                        out.reshape(-1, d) * w_table.reshape(-1, 1).to(out.dtype))


def _dispatch_compute_combine(p_router, w_gate, w_up, w_down, x_flat: torch.Tensor,
                              cfg: ModelConfig, e_lo: int,
                              e_count: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity-bounded dispatch → grouped GEMM → weighted combine for the
    expert range [e_lo, e_lo + e_count) (``w_*`` that range's experts).
    Local computation; returns (y_partial (T, d), aux)."""
    moe = cfg.moe
    t = x_flat.shape[0]
    k = moe.top_k
    w, idx, _, aux = _route(p_router, x_flat, moe)

    # Keep only assignments to this range's experts; e_count is a drop bucket.
    rel = idx - e_lo
    in_range = (rel >= 0) & (rel < e_count)
    e_flat = torch.where(in_range, rel, e_count).reshape(t * k)
    tok_flat = torch.arange(t * k, device=x_flat.device) // k
    w_flat = torch.where(in_range, w, 0.0).reshape(t * k)

    cap = max(_round_up(int(t * k / moe.n_experts * moe.capacity_factor), 8), 8)
    tok_table, w_table = _tables(e_flat, tok_flat, w_flat, e_count, cap)
    out = _experts(_gather(x_flat, tok_table), w_gate, w_up, w_down, cfg)
    return _combine(out, tok_table, w_table, t), aux


def expert_parallel(pol, moe: MoEConfig) -> bool:
    """The reference's test for its expert-parallel branch."""
    return (pol is not None
            and pol.shape.get("model", 1) > 1
            and "model" in pol.rules.get("experts", ())
            and moe.n_experts % pol.shape["model"] == 0)


def _local_dispatch(p: Params, x: torch.Tensor, cfg: ModelConfig, e_lo: int,
                    e_count: int, w) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S, d) local rows → (partial y (B, S, d), aux) for experts
    [e_lo, e_lo + e_count), ``w`` the (w_gate, w_up, w_down) of that range."""
    b, s, d = x.shape
    y, aux = _dispatch_compute_combine(p["router"], *w, x.reshape(b * s, d), cfg, e_lo, e_count)
    return y.reshape(b, s, d), aux


def _expert_parallel(p: Params, x, cfg: ModelConfig, pol):
    """The reference's ``shard_map`` branch over the DTensor ``x``."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    names = tuple(mesh.mesh_dim_names)
    world = mesh.size()
    e_loc = cfg.moe.n_experts // pol.shape["model"]
    x_pl = pol.placements(pol.fit(x.shape, ("batch", None, None)))
    rep = (Replicate(),) * len(names)
    part = (Partial(),) * len(names)
    w_pl = tuple(Shard(0) if a == "model" else Replicate() for a in names)
    w_grad = tuple(Shard(0) if a == "model" else Partial() for a in names)
    # The model ranks of a data shard hold the same tokens and sum their
    # partial outputs: over model, x's gradient and y are partial sums.
    x_grad = tuple(Partial() if isinstance(pl, Replicate) else pl for pl in x_pl)
    y_pl = tuple(Partial() if a == "model" else pl for a, pl in zip(names, x_pl))

    def local_fn(router, wg, wu, wd, x_loc):
        m = mesh.get_local_rank("model")
        y, aux = _local_dispatch({"router": router}, x_loc, cfg, m * e_loc, e_loc,
                                 (wg, wu, wd))
        # Every rank's share of the mean over data shards (the model ranks
        # of a shard compute the same aux): a Partial sum over all axes.
        return y, aux / world

    fn = local_map(local_fn, out_placements=(y_pl, part),
                   in_placements=(rep, w_pl, w_pl, w_pl, x_pl),
                   in_grad_placements=(part, w_grad, w_grad, w_grad, x_grad),
                   device_mesh=mesh, redistribute_inputs=True)
    y, aux = fn(p["router"], p["w_gate"], p["w_up"], p["w_down"], x)
    return y, aux.redistribute(mesh, rep)


def _replicated(p: Params, x, cfg: ModelConfig):
    """The global dispatch over the DTensor ``x`` on every rank: all tokens
    and the experts' weights gathered (a replicated copy of the layer)."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    rep = (Replicate(),) * mesh.ndim
    fn = local_map(lambda router, wg, wu, wd, x_loc: _local_dispatch(
                       {"router": router}, x_loc, cfg, 0, cfg.moe.n_experts, (wg, wu, wd)),
                   out_placements=(rep, rep), in_placements=(rep,) * 5,
                   device_mesh=mesh, redistribute_inputs=True)
    return fn(p["router"], p["w_gate"], p["w_up"], p["w_down"], x)


def moe_forward(p: Params, x: torch.Tensor, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) → (y, aux_loss): the routed experts, plus the shared
    experts. Without a policy, over all B·S tokens at once (the reference's
    local branch); on a DTensor ``x`` under a policy, the expert-parallel
    branch where :func:`expert_parallel` holds, else the global dispatch on
    every rank."""
    moe = cfg.moe
    pol = current_policy()
    if pol is not None and is_dtensor(x):
        y, aux = (_expert_parallel(p, x, cfg, pol) if expert_parallel(pol, moe)
                  else _replicated(p, x, cfg))
    else:
        y, aux = _local_dispatch(p, x, cfg, 0, moe.n_experts,
                                 (p["w_gate"], p["w_up"], p["w_down"]))
    y = constrain(y, ("batch", None, None))
    if moe.n_shared > 0:
        y = y + blocks.ffn_forward(p["shared"], x, cfg)
    return y, aux
