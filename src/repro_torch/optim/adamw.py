"""AdamW with global-norm clipping, warmup + cosine schedule, and a
configurable optimizer-state dtype.

The port of ``src/repro/optim/adamw.py``. State is a plain dictionary
mirroring the parameter tree (``m``, ``v``) and ``step``, a 0-d int32
tensor on the parameters' device. Every scalar of the update (learning
rate, clip scale, bias corrections) stays a 0-d tensor on that device, so
a step reads nothing back to the host.

Unlike the reference, which returns new trees, :func:`apply_updates`
writes each leaf in place, one leaf at a time: a step holds at most one
leaf's float32 temporaries, never a second copy of the tree (Llama-3.2-3B
has no room for one on an 80 GB card). ``finite`` gives the reference's
error fuse (``jnp.where(finite, new, old)``) leaf by leaf.

Under a sharding policy the parameters, gradients and both moments are
DTensors of one placement a leaf (``parallel.sharding.param_specs``):
:func:`apply_updates` steps each rank's local shards, and
:func:`global_norm` sums each shard once (a replicated shard on the ranks
at coordinate 0 of its replicated axes) and all-reduces the total over the
process group, one collective a step, so every rank clips by the same norm
and reaches the same error-fuse decision.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.core.charge import div
from repro_torch.parallel.sharding import is_dtensor
from repro_torch.tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 2000
    total_steps: int = 100_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: str = "float32"  # "bfloat16" for the trillion-param arch


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup → cosine decay to min_lr_ratio·peak (float32, on
    ``step``'s device; each division rounded once, as the reference's)."""
    s = step.to(torch.float32)
    warm = div(s, float(max(cfg.warmup_steps, 1)))
    t = torch.clamp(div(s - cfg.warmup_steps, float(max(cfg.total_steps - cfg.warmup_steps, 1))),
                    0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.peak_lr * torch.where(s < cfg.warmup_steps, warm, cos)


def init_opt_state(params, cfg: OptConfig) -> Dict[str, Any]:
    """Zero moments (placed as their parameters where those are DTensors)
    and a 0-d step count."""
    dt = getattr(torch, cfg.state_dtype)
    zeros = lambda p: torch.zeros_like(p, dtype=dt)  # noqa: E731
    p0 = next(leaves(params))
    dev = p0.to_local().device if is_dtensor(p0) else p0.device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _owned(x) -> bool:
    """Whether this rank counts its shard of the DTensor ``x``: the rank at
    coordinate 0 of every mesh axis that replicates it."""
    from torch.distributed.tensor import Shard

    coord = x.device_mesh.get_coordinate()
    return all(c == 0 for c, p in zip(coord, x.placements) if not isinstance(p, Shard))


def global_norm(tree) -> torch.Tensor:
    """√(Σ g²) over every leaf, each squared and summed in float32. Over
    DTensor leaves (each Shard or Replicate on every mesh axis): each shard
    counted once, the sum all-reduced over the default process group (the
    mesh must span it); a plain 0-d tensor, equal on every rank."""
    ls = list(leaves(tree))
    if not ls or not is_dtensor(ls[0]):
        return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32))) for g in ls))
    import torch.distributed as dist

    mesh = ls[0].device_mesh
    if mesh.size() != dist.get_world_size():
        raise ValueError(f"global_norm: a mesh of {mesh.size()} ranks in a process group of "
                         f"{dist.get_world_size()}")
    local = [g.to_local() for g in ls if _owned(g)]
    total = torch.zeros((), dtype=torch.float32, device=ls[0].to_local().device)
    for g in local:
        total = total + torch.sum(torch.square(g.to(torch.float32)))
    dist.all_reduce(total)
    return torch.sqrt(total)


def apply_updates(params, grads, state: Dict[str, Any], cfg: OptConfig,
                  finite: Optional[torch.Tensor] = None,
                  gnorm: Optional[torch.Tensor] = None,
                  decay: Optional[Sequence[bool]] = None
                  ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step, written into ``params``, ``state["m"]`` and
    ``state["v"]`` in place, leaf by leaf. Returns (params, state, metrics)
    as the reference does; ``state["step"]`` is a new tensor.

    ``finite``: a 0-d bool tensor; where it is False every leaf, and the
    step count, keep their old values (the error fuse). ``gnorm``: the
    gradients' global norm when the caller has it already. ``decay``: which
    leaves (in ``leaves`` order) take weight decay; default the matrices,
    leaves of rank ≥ 2, the reference's rule on its own tree."""
    step = state["step"] + 1
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp_max(div(cfg.clip_norm, torch.clamp_min(gnorm, 1e-9)), 1.0)
    lr = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    c1 = 1.0 - torch.pow(b1, step.to(torch.float32))
    c2 = 1.0 - torch.pow(b2, step.to(torch.float32))
    ps = list(leaves(params))
    if decay is None:
        decay = [p.dim() >= 2 for p in ps]
    local = lambda t: t.to_local() if is_dtensor(t) else t  # noqa: E731
    with torch.no_grad():
        for p, g, m, v, dec in zip(ps, leaves(grads), leaves(state["m"]), leaves(state["v"]),
                                   decay):
            if is_dtensor(p):  # the rank's shards, placed alike
                if not (g.placements == m.placements == v.placements == p.placements):
                    raise ValueError(f"placements differ: parameter {p.placements}, "
                                     f"gradient {g.placements}")
                p, g, m, v = (local(t) for t in (p, g, m, v))
            g32 = g.to(torch.float32) * scale
            m32 = m.to(torch.float32) * b1 + g32 * (1 - b1)
            v32 = v.to(torch.float32) * b2 + torch.square(g32) * (1 - b2)
            del g32
            u = (m32 / c1) / (torch.sqrt(v32 / c2) + cfg.eps)
            if dec:  # decoupled weight decay on matrices only
                u = u + cfg.weight_decay * p.to(torch.float32)
            p_new = p.to(torch.float32) - lr * u
            del u
            if finite is None:
                p.copy_(p_new)
                m.copy_(m32)
                v.copy_(v32)
            else:
                p.copy_(torch.where(finite, p_new, p))
                m.copy_(torch.where(finite, m32, m))
                v.copy_(torch.where(finite, v32, v))
    if finite is not None:
        step = torch.where(finite, step, state["step"])
    new_state = dict(state, step=step)
    return params, new_state, {"grad_norm": gnorm, "lr": lr, "clip_scale": scale}
