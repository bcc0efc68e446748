"""Training step: microbatched gradient accumulation + remat + AdamW.

The port of ``src/repro/train/step.py``. ``make_train_step(model_cfg,
train_cfg)`` returns ``step(params, opt_state, batch) → (params,
opt_state, metrics)``, run eagerly (the reference's is a pure function for
``jax.jit``). Each step:

1. casts the float32 matrices to ``compute_dtype`` — the other leaves are
   used as they are; "matrix" is the reference's rank rule on its own tree
   (:func:`reference_leaves`) — and differentiates
   :func:`repro_torch.models.model.lm_loss` with autograd with respect to
   those compute copies;
2. with ``microbatches > 1``, splits the batch's leading dimension and
   sums the microbatches' gradients in ``accum_dtype`` (a Python loop
   where the reference scans), then divides by their number;
3. optionally compresses the gradients (int8 with error feedback);
4. applies AdamW (:mod:`repro_torch.optim.adamw`; weight decay on the
   same matrices) to the parameters and
   the optimizer state in place, leaf by leaf — and, if the global
   gradient norm is not finite, leaves every leaf and the step count as
   they were and sets ``skipped`` (the AL-DRAM error fuse; ``launch/train.py``
   restores from the last checkpoint).

With one microbatch the reference casts the gradients to float32 before
clipping and AdamW; the port leaves them in the compute dtype, since the
norm and the update upcast each leaf first, which gives the same values
without a float32 copy of the gradient tree.

Under a sharding policy (``parallel.sharding.use_policy`` around the call;
the launcher's ``train(mesh=)``) the parameters and moments are DTensors
placed by ``param_specs`` and the batch is a DTensor (``data.pipeline.
shard_batch``): the forward, the per-layer recompute and autograd run on
DTensors, each gradient is placed as its parameter, the loss and the
global norm are plain tensors equal on every rank (so every rank takes the
same error-fuse decision), and AdamW steps each rank's local shards.

Attention must be differentiable: the flash-attention CUDA kernel has no
backward pass (nor has the reference's Pallas kernel: ``jax.grad`` through
it fails in ``pallas_call``'s JVP rule), so a config with ``attn_impl ==
"pallas"`` is refused; train with the default ``"chunked"``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import torch

from repro_torch.models import model as lm
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw
from repro_torch.optim import compress as gradcomp
from repro_torch.parallel.sharding import MeshShape, current_policy, is_dtensor, require_placed
from repro_torch.tree import leaves, tree_map, walk


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1
    remat: bool = True
    aux_coef: float = 0.01
    z_coef: float = 1e-4
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    accum_dtype: str = "float32"  # grad-accumulation buffer (bf16 at 1T scale)
    remat_offload: bool = False   # park boundary saves in pinned host memory
    compress_grads: bool = False
    opt: adamw.OptConfig = dataclasses.field(default_factory=adamw.OptConfig)


def _split_micro(batch: Dict[str, torch.Tensor], n: int) -> List[Dict[str, torch.Tensor]]:
    """The batch as ``n`` microbatches, each a slice of the leading (batch)
    dimension — of dimension 1 for M-RoPE's (3, B, S) ``positions``.

    M-RoPE's positions are tested first. The reference
    (``src/repro/train/step.py:47-50``) tests for a batch-leading leaf
    first, so at a microbatch count that divides 3 it splits the positions'
    stream axis instead (each microbatch gets one stream of all B rows) and
    its step fails; the port splits the batch axis at every count.

    A DTensor leaf (a sharded step's batch) is split on each rank's local
    rows and each piece wrapped with the leaf's placements: microbatch
    ``i`` holds every shard's ``i``-th slice (reshaping a sharded
    dimension of the DTensor itself would redistribute it)."""
    if any(is_dtensor(x) for x in batch.values()):
        from torch.distributed.tensor import DTensor

        local = _split_micro({k: x.to_local() if is_dtensor(x) else x
                              for k, x in batch.items()}, n)
        return [{k: DTensor.from_local(mb[k], x.device_mesh, x.placements, run_check=False)
                 if is_dtensor(x) else mb[k] for k, x in batch.items()} for mb in local]

    def f(k, x):
        if k == "positions" and x.dim() == 3 and x.shape[0] == 3 and x.shape[1] % n == 0:
            return x.reshape((3, n, x.shape[1] // n) + tuple(x.shape[2:])).swapaxes(0, 1)
        if x.dim() >= 2 and x.shape[0] % n == 0:
            return x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))
        raise ValueError(f"batch leaf {k!r} of shape {tuple(x.shape)} not splittable by {n}")

    split = {k: f(k, x) for k, x in batch.items()}
    return [{k: x[i] for k, x in split.items()} for i in range(n)]


def reference_leaves(params, cfg: ModelConfig) -> List[Tuple[int, Tuple]]:
    """For each leaf of ``params``, in ``leaves`` order: its rank in the
    reference's tree and the path of the reference's leaf that holds it.

    The reference stacks the layers of its scanned groups (layer
    ``n_prefix + g · pattern_len + j``, g < ``n_groups``) into one leaf per
    pattern position ``j``, one rank higher than the port's per-layer leaf.
    Its rank rules act on that tree: the compute-dtype cast and weight decay
    take leaves of rank ≥ 2 — so a norm scale or gate bias of a grouped
    layer, a (G, d) leaf there, is cast and decayed, and one of a prefix or
    suffix layer is not — and gradient compression scales each leaf as a
    whole."""
    start, stop = cfg.n_prefix, cfg.n_prefix + cfg.n_groups * cfg.pattern_len
    out = []
    for path, t in walk(params):
        if path[0] == "stack" and start <= path[1] < stop:
            out.append((t.dim() + 1, ("stack", "groups", (path[1] - start) % cfg.pattern_len)
                        + path[2:]))
        else:
            out.append((t.dim(), path))
    return out


def make_loss_fn(cfg: ModelConfig, tc: TrainConfig):
    remat = "offload" if (tc.remat and tc.remat_offload) else tc.remat

    def loss_fn(params, micro_batch):
        return lm.lm_loss(params, cfg, micro_batch, aux_coef=tc.aux_coef, z_coef=tc.z_coef,
                          remat=remat)

    return loss_fn


def make_train_step(cfg: ModelConfig, tc: TrainConfig):
    if cfg.attn_impl == "pallas":
        raise ValueError(
            f"{cfg.name}: attn_impl='pallas' cannot train: the flash-attention kernel has "
            "no backward pass (the reference's Pallas kernel has none either), so the "
            "attention inputs would get no gradient; train with attn_impl='chunked'")
    loss_fn = make_loss_fn(cfg, tc)
    compute = getattr(torch, tc.compute_dtype)
    accum = getattr(torch, tc.accum_dtype)

    def grads_of(params, ranks, mb):
        """(loss, gradients as a list in ``leaves`` order)."""
        rank = iter(ranks)

        def compute_copy(p: torch.Tensor) -> torch.Tensor:
            c = p.detach()
            if next(rank) >= 2 and c.dtype == torch.float32:
                c = c.to(compute)
            return c.requires_grad_(True)

        cparams = tree_map(compute_copy, params)
        cleaves = list(leaves(cparams))
        loss, _ = loss_fn(cparams, mb)
        grads = torch.autograd.grad(loss, cleaves, allow_unused=True)
        # A leaf the loss does not read (the embedding of a config fed
        # embeddings) has a zero gradient, as under jax.grad.
        grads = [torch.zeros_like(c) if g is None else g for c, g in zip(cleaves, grads)]
        if is_dtensor(loss):
            # Autograd leaves each gradient as sharding propagation placed
            # it (partial sums, strided shards): place it as its parameter.
            grads = [g.redistribute(c.device_mesh, c.placements) for c, g in zip(cleaves, grads)]
            loss = loss.detach().full_tensor()
        return loss.detach(), grads

    def train_step(params, opt_state, batch):
        pol = current_policy()
        if pol is not None and not isinstance(pol.mesh, MeshShape):
            for what, tree in (("params", params), ("opt/m", opt_state["m"]),
                               ("opt/v", opt_state["v"]), ("batch", batch)):
                require_placed(tree, what)
        layout = reference_leaves(params, cfg)
        ranks = [r for r, _ in layout]
        if tc.compress_grads and is_dtensor(next(leaves(params))):
            raise NotImplementedError("compress_grads under a sharding policy is not ported: "
                                      "its per-group scale needs a maximum over the mesh")
        if tc.microbatches > 1:
            acc = [torch.zeros_like(p, dtype=accum) for p in leaves(params)]
            lsum = torch.zeros((), dtype=torch.float32, device=opt_state["step"].device)
            for mb in _split_micro(batch, tc.microbatches):
                loss, grads = grads_of(params, ranks, mb)
                for a, g in zip(acc, grads):
                    a.add_(g.to(accum))
                del grads
                lsum = lsum + loss
            n = torch.full((), float(tc.microbatches), dtype=accum, device=lsum.device)
            grads = [a.div_(n) for a in acc]
            loss = lsum / n.to(torch.float32)
        else:
            loss, grads = grads_of(params, ranks, batch)

        if tc.compress_grads:
            groups: Dict[Tuple, List[int]] = {}
            for i, (_, ref_path) in enumerate(layout):
                groups.setdefault(ref_path, []).append(i)
            grads = [g.to(torch.float32) for g in grads]
            gradcomp.compress_with_feedback(grads, list(leaves(opt_state["grad_err"])),
                                            list(groups.values()))

        gnorm = adamw.global_norm(grads)
        finite = torch.isfinite(gnorm)
        _, new_opt, opt_metrics = adamw.apply_updates(
            params, grads, {k: opt_state[k] for k in ("m", "v", "step")}, tc.opt,
            finite=finite, gnorm=gnorm, decay=[r >= 2 for r in ranks])
        if tc.compress_grads:
            new_opt["grad_err"] = opt_state["grad_err"]
        metrics = {"loss": loss, "grad_norm": gnorm,
                   "skipped": (~finite).to(torch.float32), **opt_metrics}
        return params, new_opt, metrics

    return train_step


def init_train_state(gen: torch.Generator, cfg: ModelConfig, tc: TrainConfig):
    """Parameters drawn on ``gen.device`` and a zero optimizer state."""
    params = lm.init_params(gen, cfg, getattr(torch, tc.param_dtype))
    opt_state: Dict[str, Any] = adamw.init_opt_state(params, tc.opt)
    if tc.compress_grads:
        opt_state["grad_err"] = gradcomp.init_error_state(params)
    return params, opt_state
