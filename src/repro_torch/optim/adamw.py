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
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.core.charge import div
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
    dt = getattr(torch, cfg.state_dtype)
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)  # noqa: E731
    dev = next(leaves(params)).device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree) -> torch.Tensor:
    """√(Σ g²) over every leaf, each squared and summed in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32))) for g in leaves(tree)))


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
    with torch.no_grad():
        for p, g, m, v, dec in zip(ps, leaves(grads), leaves(state["m"]), leaves(state["v"]),
                                   decay):
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
