"""Logical-axis sharding: models annotate, policies map to mesh axes.

The port of ``src/repro/parallel/sharding.py`` over PyTorch's counterpart
of GSPMD: a :class:`~torch.distributed.device_mesh.DeviceMesh` and DTensor
placements. Model code never names a mesh axis. It calls ``constrain(x,
("batch", "seq", None))`` with *logical* names; the active
:class:`ShardingPolicy` (installed by the launcher with :func:`use_policy`)
maps them onto the axes of the mesh — ``("data", "model")``, or ``("pod",
"data", "model")`` across pods — and redistributes the DTensor ``x`` to
those placements. With no active policy (unit tests, one-device runs)
``constrain`` returns ``x`` itself, so the same model code runs everywhere.

A policy's mesh is a ``DeviceMesh`` (for placing tensors) or a
:class:`MeshShape`, a record of axis names and sizes that needs no process
group: the rule work of :mod:`.policies` at the production 16 × 16 and 2 ×
16 × 16 meshes runs on one. :func:`axis_sizes` reads ``{axis: size}`` from
either.

``physical`` returns the reference's ``PartitionSpec`` as a plain tuple
(``None``, an axis name, or a tuple of names for each tensor dimension;
each mesh axis used once); ``placements`` turns it into one placement a
mesh dimension: ``Shard(d)`` for the axes that tensor dimension ``d``
takes, ``Replicate()`` for the rest. Parameter placements come from
:func:`param_specs` over the spec tree of ``models.model.logical_specs``.

Under a policy on a ``DeviceMesh`` no plain tensor meets a DTensor
unnoticed: ``constrain`` and :func:`require_placed` raise on one, and
:func:`replicated_like` is the one door for a value that is the same on
every rank (a mask, positions, a zero state).

Importing this module needs neither CUDA nor a process group.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
from typing import Any, Dict, Optional, Tuple, Union

import torch

from repro_torch.tree import walk

LogicalAxis = Optional[str]
LogicalSpec = Tuple[LogicalAxis, ...]
#: A dimension's mesh axes in ``physical``'s output: none, one, or several.
PhysicalAxis = Union[None, str, Tuple[str, ...]]

#: Default logical → mesh-axis table ("fsdp" resolves to the data axis;
#: "batch" to (pod, data) batch sharding; entries absent → replicated).
DEFAULT_RULES: Dict[str, Tuple[str, ...]] = {
    "batch": ("pod", "data"),       # activation batch
    "seq": (),                      # sequence (SP policies override)
    "heads": ("model",),            # attention heads (TP)
    "kv_heads": ("model",),         # KV heads when divisible (TP)
    "ff": ("model",),               # FFN hidden (TP)
    "d_model": (),                  # residual stream dim
    "vocab": ("model",),            # embedding/vocab (TP)
    "experts": ("model",),          # MoE experts (EP)
    "expert_cap": ("data",),        # MoE capacity rows
    "fsdp": ("data",),              # ZeRO-3 parameter shard axis
    "state": ("model",),            # recurrent state channels
    "head_dim": ("model",),         # KV-cache fallback when kv_heads < TP
}


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, without devices or a process group."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"{self.axis_names} vs sizes {self.sizes}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def axis_names(mesh) -> Tuple[str, ...]:
    """The mesh's axis names, in mesh-dimension order."""
    if isinstance(mesh, MeshShape):
        return mesh.axis_names
    return tuple(mesh.mesh_dim_names)


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis: size}`` of a ``DeviceMesh`` or a :class:`MeshShape`."""
    if isinstance(mesh, MeshShape):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def mesh_size(mesh) -> int:
    """The number of devices (ranks) of the mesh."""
    n = 1
    for s in axis_sizes(mesh).values():
        n *= s
    return n


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    """A resolved logical → physical mapping for a specific mesh."""

    mesh: Any  # DeviceMesh | MeshShape
    rules: Dict[str, Tuple[str, ...]]

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return axis_names(self.mesh)

    @property
    def shape(self) -> Dict[str, int]:
        return axis_sizes(self.mesh)

    def physical(self, spec: LogicalSpec) -> Tuple[PhysicalAxis, ...]:
        """The reference's ``PartitionSpec`` as a tuple, one entry a
        dimension; a mesh axis already taken by an earlier dimension is
        skipped."""
        axes = []
        used = set()
        names = self.axis_names
        for name in spec:
            if name is None:
                axes.append(None)
                continue
            phys = tuple(a for a in self.rules.get(name, ())
                         if a in names and a not in used)
            used.update(phys)
            if len(phys) == 0:
                axes.append(None)
            elif len(phys) == 1:
                axes.append(phys[0])
            else:
                axes.append(phys)
        return tuple(axes)

    def placements(self, spec: LogicalSpec) -> tuple:
        """DTensor placements of ``spec``, one a mesh dimension: ``Shard(d)``
        where tensor dimension ``d`` takes the axis, else ``Replicate()``;
        an axis of size 1 replicates (its one shard is the whole, and
        DTensor refuses some views of a dimension it marks sharded). Where
        one dimension takes several axes they must come in mesh order
        (DTensor splits a dimension by the mesh's axes left to right, as the
        reference's tuple does in its own order); other orders raise."""
        from torch.distributed.tensor import Replicate, Shard

        names, sizes = self.axis_names, self.shape
        out = [Replicate()] * len(names)
        for d, phys in enumerate(self.physical(spec)):
            if phys is None:
                continue
            group = (phys,) if isinstance(phys, str) else phys
            pos = [names.index(a) for a in group]
            if pos != sorted(pos):
                raise ValueError(f"{spec}: dimension {d} takes mesh axes {group} out of the "
                                 f"mesh's order {names}")
            for p in pos:
                if sizes[names[p]] > 1:
                    out[p] = Shard(d)
        return tuple(out)

    def dividable(self, dim: int, name: LogicalAxis) -> bool:
        """Can a dimension of this size be sharded under this rule?"""
        if name is None:
            return True
        shape = self.shape
        size = 1
        for a in self.rules.get(name, ()):
            if a in shape:
                size *= shape[a]
        return dim % size == 0

    def fit(self, shape, spec: LogicalSpec) -> LogicalSpec:
        """``spec`` with every axis whose dimension does not divide its mesh
        axes degraded to ``None`` (replicated)."""
        if len(spec) != len(shape):
            raise ValueError(f"spec {spec} does not match shape {tuple(shape)}")
        return tuple(name if self.dividable(shape[i], name) else None
                     for i, name in enumerate(spec))


_tls = threading.local()


def current_policy() -> Optional[ShardingPolicy]:
    return getattr(_tls, "policy", None)


@contextlib.contextmanager
def use_policy(policy: Optional[ShardingPolicy]):
    """Install ``policy`` for this thread within the block."""
    prev = current_policy()
    _tls.policy = policy
    try:
        yield policy
    finally:
        _tls.policy = prev


@functools.lru_cache(maxsize=None)
def _dtensor_type():
    """DTensor's class, or None where this torch build has no
    ``torch.distributed``."""
    try:
        from torch.distributed.tensor import DTensor
    except ImportError:
        return None
    return DTensor


def is_dtensor(x) -> bool:
    cls = _dtensor_type()
    return cls is not None and isinstance(x, cls)


def replicated_like(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The plain tensor ``t``, the same on every rank (a mask, positions, a
    constant), as a replicated DTensor on the mesh of the DTensor ``x``;
    ``t`` itself where ``x`` is plain. The one door by which a plain value
    enters a sharded computation: elsewhere DTensor refuses a plain tensor
    beside a DTensor."""
    if not is_dtensor(x):
        return t
    from torch.distributed.tensor import DTensor, Replicate

    mesh = x.device_mesh
    return DTensor.from_local(t, mesh, (Replicate(),) * mesh.ndim, run_check=False)


def require_placed(tree, what: str) -> None:
    """Raise unless every tensor leaf of ``tree`` is a DTensor: under an
    active policy a plain leaf escaped placement, and would otherwise meet
    DTensors only to be refused op by op (or, under DTensor's implicit
    replication, be taken silently as the same on every rank)."""
    for path, leaf in walk(tree):
        if isinstance(leaf, torch.Tensor) and not is_dtensor(leaf):
            raise TypeError(f"{what}/{'/'.join(map(str, path))}: a plain tensor of shape "
                            f"{tuple(leaf.shape)} under an active sharding policy (a value "
                            "that escaped placement)")


def constrain(x: torch.Tensor, spec: LogicalSpec) -> torch.Tensor:
    """Redistribute ``x`` to ``spec``'s placements if a policy is active.

    Logical axes whose size does not divide the mapped mesh axes degrade to
    replicated (small models on big meshes must still run — the AL-DRAM
    "worst-case always works" posture). With no policy ``x`` itself comes
    back. Under a policy ``x`` must be a DTensor: a plain tensor there is a
    value that escaped placement, and raises."""
    pol = current_policy()
    if pol is None:
        return x
    if not is_dtensor(x):
        raise TypeError(f"constrain({spec}): a plain tensor of shape {tuple(x.shape)} under "
                        "an active sharding policy (a value that escaped placement)")
    want = pol.placements(pol.fit(x.shape, spec))
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def _gathered(x):
    """``x`` with every mesh axis that shards a dimension other than the
    first (the batch) replicated."""
    from torch.distributed.tensor import Replicate, Shard

    want = tuple(Replicate() if isinstance(p, Shard) and p.dim != 0 else p
                 for p in x.placements)
    return x.redistribute(x.device_mesh, want)


def _splits_shards(x, shape) -> bool:
    """Whether reshaping the DTensor ``x`` to ``shape`` cuts through its
    shards: the reshape changes one run of dimensions, and a sharded
    dimension in it is not the first of a merge, or is split with a first
    factor its shard count does not divide (three heads over ``model`` = 2)."""
    from torch.distributed.tensor import Shard

    old, new = tuple(x.shape), tuple(shape)
    i = 0
    while i < min(len(old), len(new)) and old[i] == new[i]:
        i += 1
    j = 0
    while j < min(len(old), len(new)) - i and old[-1 - j] == new[-1 - j]:
        j += 1
    ways = {}
    for size, p in zip(x.device_mesh.mesh.shape, x.placements):
        if isinstance(p, Shard):
            ways[p.dim] = ways.get(p.dim, 1) * size
    changed = [d for d in ways if i <= d < len(old) - j]
    if not changed:
        return False
    if len(old) - j - i == 1:  # one dimension split into several
        return new[i] % ways[i] != 0
    return changed != [i]  # a merge: only its first dimension may be sharded


def _reshape(x: torch.Tensor, shape) -> torch.Tensor:
    if is_dtensor(x) and _splits_shards(x, shape):
        # DTensor splits or merges a sharded dimension only where the shard
        # boundaries stay whole; elsewhere the dimensions are gathered
        # first, as GSPMD does for an uneven split.
        x = _gathered(x)
    return x.reshape(shape)


class _Reshape(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shape):
        ctx.in_shape = tuple(x.shape)
        return _reshape(x, shape)

    @staticmethod
    def backward(ctx, g):
        return _reshape(g, ctx.in_shape), None


def reshape(x: torch.Tensor, shape) -> torch.Tensor:
    """``x.reshape(shape)``; on a DTensor whose sharded dimension the new
    shape splits or merges unevenly, that dimension is replicated first, in
    the forward and in the backward pass alike. A plain tensor is reshaped
    as it is."""
    if not is_dtensor(x):
        return x.reshape(shape)
    return _Reshape.apply(x, tuple(shape))


class _GradPlaced(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.mesh, ctx.placements = x.device_mesh, tuple(x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(ctx.mesh, ctx.placements)


def grad_placed(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself in the forward pass; in the backward pass its gradient
    placed as ``x`` is. For a DTensor used twice (tied embeddings: the
    lookup and the head), so that autograd adds two gradients of one
    placement (torch 2.11 cannot add a partial sum to a shard). A plain
    tensor comes back as it is."""
    return _GradPlaced.apply(x) if is_dtensor(x) else x


def _is_spec_leaf(x) -> bool:
    return x is None or (
        isinstance(x, tuple) and not hasattr(x, "_fields")
        and all(e is None or isinstance(e, str) for e in x))


@dataclasses.dataclass(frozen=True)
class Placed:
    """A leaf's placement under a policy: the mesh, the placements, and the
    (degraded) logical spec they come from."""

    mesh: Any
    placements: tuple
    spec: LogicalSpec


def param_specs(specs_tree, tree, policy: ShardingPolicy):
    """Zip a tree of logical specs with a tree of the same structure
    (tensors, or anything with ``.shape``) into :class:`Placed` leaves,
    degrading non-dividable axes to replicated. Trees are dictionaries,
    lists and tuples, as :mod:`repro_torch.tree` walks them."""

    def one(spec, shaped):
        shape = tuple(shaped.shape)
        if spec is None:
            spec = (None,) * len(shape)
        fixed = policy.fit(shape, spec)
        return Placed(policy.mesh, policy.placements(fixed), fixed)

    def zip_map(spec, tree):
        if _is_spec_leaf(spec):
            return one(spec, tree)
        if isinstance(spec, dict):
            if set(spec) != set(tree):
                raise ValueError(f"spec keys {sorted(spec)} vs tree keys {sorted(tree)}")
            return {k: zip_map(spec[k], tree[k]) for k in spec}
        if len(spec) != len(tree):
            raise ValueError(f"spec of {len(spec)} entries vs a tree of {len(tree)}")
        items = [zip_map(s, t) for s, t in zip(spec, tree)]
        return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)

    return zip_map(specs_tree, tree)


def _is_fake(t: torch.Tensor) -> bool:
    """Whether ``t`` is a fake tensor (a dry run's: shape and dtype, no
    storage to compare)."""
    from torch._subclasses.fake_tensor import FakeTensor

    return isinstance(t, FakeTensor)


def from_whole(t: torch.Tensor, mesh, placements, device=None):
    """The whole tensor ``t`` (the same on every rank) as a DTensor: each
    rank takes its shard along the ``Shard`` placements, in mesh order (an
    outer axis first, as DTensor nests them), copies it to ``device``
    (default ``t``'s; a shard never shares ``t``'s storage) and wraps it.
    No collective."""
    from torch.distributed.tensor import DTensor, Shard

    piece = t
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            n = mesh.size(i)
            if piece.shape[p.dim] % n:
                raise ValueError(f"dimension {p.dim} of {tuple(t.shape)} does not divide "
                                 f"mesh axis {mesh.mesh_dim_names[i]} of {n}")
            piece = piece.tensor_split(n, dim=p.dim)[mesh.get_local_rank(i)]
    piece = piece.to(device if device is not None else t.device)
    if piece.numel() < t.numel() and not _is_fake(piece) and \
            piece.untyped_storage().data_ptr() == t.untyped_storage().data_ptr():
        piece = piece.clone()  # its own storage, so that the whole can be freed
    piece = piece.contiguous()
    return DTensor.from_local(piece, mesh, tuple(placements), run_check=False,
                              shape=t.shape, stride=t.stride())


def distribute(tree, placed_tree):
    """Each tensor of ``tree`` (the same on every rank) as a DTensor placed
    by the matching :class:`Placed` leaf of ``placed_tree``: every rank
    keeps only its shard (:func:`from_whole`; the caller draws the same
    values on every rank)."""
    def zip_map(t, pl):
        if isinstance(pl, Placed):
            return from_whole(t, pl.mesh, pl.placements)
        if isinstance(pl, dict):
            return {k: zip_map(t[k], pl[k]) for k in pl}
        items = [zip_map(a, b) for a, b in zip(t, pl)]
        return type(t)(*items) if hasattr(t, "_fields") else type(t)(items)

    return zip_map(tree, placed_tree)
