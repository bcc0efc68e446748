"""DIMM-axis sharding of the fleet pipeline over ``torch.distributed``.

Every stage of the pipeline is independent across DIMMs: the sweep
characterizes each module alone, the controller advances each module's
registers alone, and the trace score reduces per-DIMM figures. So the
pipeline scales by splitting its one DIMM axis over a 1-D ``("dimm",)``
device mesh, one process per device: each rank runs the single-device
port, its CUDA kernels included, on its contiguous block of DIMMs, and the
ranks meet only in ``all_reduce`` (SUM, MIN, MAX) and ``all_gather``. On
cards the backend is NCCL (gloo when ranks share a card); on the CPU it is
gloo. This module is that mechanism, shared by :func:`fleet.sweep
<repro_torch.core.fleet.sweep>` and ``sweep_regions``, :func:`controller.replay
<repro_torch.core.controller.replay>`, the ``trace_score`` family and the
stream (each takes ``mesh=``):

* :func:`fleet_mesh` builds the mesh over the default process group, which
  ``torchrun`` (:func:`init_from_env`) or :func:`launch` made.
* **Padding**: a fleet whose size the shard count does not divide (or that
  is smaller than it) is padded to :func:`padded_size` by *edge
  replication* (:func:`padded_block`, the one block layout every caller
  uses): padding entries copy the last real DIMM,
  so they flow through every kernel as benign, finite values, and a rank
  whose block is all padding still runs on one or more DIMMs (no kernel is
  launched on zero). Rank ``k``'s padded block is ``[k·b, (k+1)·b)`` with
  ``b = padded_size / D``; its real DIMMs are :func:`local_range`.
* :func:`sharded_dimm_map` is the one entry point for map-like stages: it
  pads, takes the rank's block, runs the single-device function on it, and
  hands each DIMM-axis output back as the rank's real block or gathered
  whole (:func:`gather_dimm`: equal padded blocks, then a slice). Per-DIMM
  arithmetic is untouched, so map outputs are bitwise the single-device
  port's.
* Reductions (the score finalize) sum each rank's real rows locally and
  combine the partial sums with :func:`psum` / :func:`pmin`; no per-DIMM
  array crosses devices.

The process group is made outside this module's functions, once a process:
``torchrun`` (call :func:`init_from_env` first) or :func:`launch`, which
spawns one process a shard, makes the group and returns rank 0's result.
"""

from __future__ import annotations

import datetime
import os
import socket
import tempfile
from typing import Any, Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch import resolve_device

#: The one mesh-axis name of the fleet mesh; every ``mesh=`` in the
#: pipeline expects a mesh carrying it.
DIMM_AXIS: str = "dimm"

#: The CUDA sources the fleet pipeline launches, built once before ranks
#: start (by :func:`launch`'s parent, or by local rank 0 before a barrier
#: under ``torchrun``), so no two ranks compile the same source at once.
FLEET_KERNELS: Tuple[str, ...] = ("charge_sweep", "replay_step", "accumulate")

#: Seconds a collective may wait for the other ranks before the group
#: fails: a rank that raised before a collective must not leave the
#: others waiting forever.
COLLECTIVE_TIMEOUT_S: float = 180.0


# ---------------------------------------------------------------------------
# The process group and the mesh
# ---------------------------------------------------------------------------
def _backend(device_type: str, world: int) -> str:
    """gloo on the CPU and where ranks share a card, NCCL where each rank
    has a card of its own."""
    if device_type == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def _set_device(device_type: str, local_rank: int) -> None:
    if device_type == "cuda":
        torch.cuda.set_device(local_rank % torch.cuda.device_count())


def init_from_env(device: str | torch.device = "cuda") -> None:
    """Make the default process group of a ``torchrun`` rank (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT`` from
    the environment), select the rank's card, and build the fleet kernels
    on local rank 0 before a barrier. A no-op where the group exists."""
    if dist.is_initialized():
        return
    dev = resolve_device(device)
    world = int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ.get("LOCAL_RANK", os.environ["RANK"]))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    _set_device(dev.type, local_rank)
    dist.init_process_group(_backend(dev.type, local_world),
                            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    if dev.type == "cuda":
        if local_rank == 0:
            from repro_torch.kernels import _build

            _build.build(FLEET_KERNELS)
        dist.barrier()


def in_torchrun() -> bool:
    """Whether this process is a rank that a launcher started (the
    launcher's ``WORLD_SIZE`` is in the environment)."""
    return "WORLD_SIZE" in os.environ


def fleet_mesh(n_devices: Optional[int] = None, device: str | torch.device = "cuda"):
    """The 1-D ``("dimm",)`` :class:`~torch.distributed.device_mesh.DeviceMesh`
    over the default process group. Raises ``ValueError`` when no group is
    initialized, when ``n_devices`` is not the world size, and on a CUDA
    request with fewer cards than local ranks unless the group is gloo
    (ranks sharing a card)."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_available() or not dist.is_initialized():
        raise ValueError(
            "no torch.distributed process group is initialized: start the ranks with "
            "torchrun (then repro_torch.core.shard.init_from_env) or "
            "repro_torch.core.shard.launch")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"n_devices={n_devices} but the process group has {world} ranks")
    dev = resolve_device(device)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        if torch.cuda.device_count() < local and dist.get_backend() != "gloo":
            raise ValueError(
                f"{local} local ranks but {torch.cuda.device_count()} card(s): ranks that "
                "share a card need the gloo backend")
    return DeviceMesh(dev.type, torch.arange(world), mesh_dim_names=(DIMM_AXIS,))


def n_shards(mesh) -> int:
    """Size of the mesh's DIMM axis (raises if the axis is absent)."""
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    if DIMM_AXIS not in names:
        raise ValueError(f"mesh axes {names} carry no {DIMM_AXIS!r} axis; build the "
                         "fleet mesh with repro_torch.core.shard.fleet_mesh()")
    return int(mesh.size(names.index(DIMM_AXIS)))


def _group(mesh):
    n_shards(mesh)
    return mesh.get_group(DIMM_AXIS)


def _rank(mesh) -> int:
    n_shards(mesh)
    return int(mesh.get_local_rank(DIMM_AXIS))


# ---------------------------------------------------------------------------
# Padding, masks and blocks
# ---------------------------------------------------------------------------
def _tree_map(fn: Callable[[torch.Tensor], torch.Tensor], tree: Any) -> Any:
    """``fn`` over every tensor of a tensor, a (named) tuple of them, or
    ``None``."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple):
        leaves = [_tree_map(fn, t) for t in tree]
        return type(tree)(*leaves) if hasattr(tree, "_fields") else tuple(leaves)
    raise TypeError(f"expected tensors, got {type(tree).__name__}")


def padded_size(n: int, shards: int) -> int:
    """Smallest multiple of ``shards`` that is >= ``n`` (and >= shards: a
    fleet smaller than the shard count pads up to one DIMM a rank)."""
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    if shards < 1:
        raise ValueError(f"shards must be >= 1, got {shards}")
    return -(-n // shards) * shards


def dimm_mask(n: int, padded: int, device: str | torch.device = "cpu") -> torch.Tensor:
    """(padded,) bool validity mask: True for the ``n`` real DIMMs."""
    return torch.arange(padded, device=device) < n


def padded_block(a: torch.Tensor, lo: int, hi: int, b: int, axis: int = 0,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The one padded-block layout of the DIMM axis: entries ``lo:hi`` of
    ``a`` along ``axis``, then copies of ``a``'s last entry (zeros where
    ``a`` has none) up to ``b`` entries. It is a fleet padded for its mesh
    (:func:`pad_dimm`, ``lo = 0``), a rank's block of the whole axis
    (:func:`local_block`), a rank's real block before a gather
    (:func:`gather_dimm`) and a telemetry chunk's column block (the
    stream). Written into ``out`` (that shape, any dtype: a pinned staging
    buffer) when given; otherwise returned, as ``a`` itself or a view of it
    where no padding is needed."""
    real = hi - lo
    if not 0 <= real <= b:
        raise ValueError(f"block {lo}:{hi} on axis {axis} does not fit {b} entries")
    if out is None:
        if real == b:
            return a if real == a.shape[axis] else a.narrow(axis, lo, real)
        shape = list(a.shape)
        shape[axis] = b
        out = a.new_empty(shape)
    out.narrow(axis, 0, real).copy_(a.narrow(axis, lo, real))
    if real < b:
        pad = out.narrow(axis, real, b - real)
        if a.shape[axis]:
            pad.copy_(a.narrow(axis, a.shape[axis] - 1, 1).expand(pad.shape))
        else:
            pad.zero_()
    return out


def pad_dimm(tree: Any, target: int, axis: int = 0) -> Any:
    """Pad every tensor's DIMM axis to ``target`` entries by edge
    replication (:func:`padded_block`): padding rows copy the LAST real
    DIMM. A tensor already at ``target`` passes through."""
    return _tree_map(lambda a: padded_block(a, 0, a.shape[axis], target, axis), tree)


def slice_dimm(tree: Any, n: int, axis: int = 0) -> Any:
    """Every tensor's first ``n`` entries along ``axis``."""
    return _tree_map(lambda a: a.narrow(axis, 0, n), tree)


def block_size(n_dimms: int, mesh) -> int:
    """``b``: the DIMMs of each rank's padded block."""
    shards = n_shards(mesh)
    return padded_size(n_dimms, shards) // shards


def local_range(n_dimms: int, mesh) -> Tuple[int, int]:
    """``(lo, hi)``: this rank's real DIMMs, ``[rank·b, (rank+1)·b)`` clipped
    to ``n_dimms``; ``lo == hi`` for a rank whose block is all padding."""
    b, k = block_size(n_dimms, mesh), _rank(mesh)
    return min(k * b, n_dimms), min((k + 1) * b, n_dimms)


def local_block(tree: Any, mesh, n_dimms: int, axis: int = 0) -> Any:
    """This rank's padded block of every tensor's whole DIMM axis
    (``n_dimms`` entries), contiguous: its real DIMMs, then copies of DIMM
    ``n_dimms - 1`` up to ``b`` entries (:func:`padded_block`)."""
    b = block_size(n_dimms, mesh)
    lo, hi = local_range(n_dimms, mesh)

    def one(a: torch.Tensor) -> torch.Tensor:
        if a.shape[axis] != n_dimms:
            raise ValueError(f"DIMM axis {axis} has {a.shape[axis]} entries, "
                             f"expected {n_dimms}")
        return padded_block(a, lo, hi, b, axis).contiguous()

    return _tree_map(one, tree)


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------
def _all_reduce(x: torch.Tensor, mesh, op) -> torch.Tensor:
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=op, group=_group(mesh))
    return out


def psum(x: torch.Tensor, mesh) -> torch.Tensor:
    """Sum of a local partial across the mesh (out of place)."""
    return _all_reduce(x, mesh, dist.ReduceOp.SUM)


def pmin(x: torch.Tensor, mesh) -> torch.Tensor:
    """Minimum of a local partial across the mesh (out of place)."""
    return _all_reduce(x, mesh, dist.ReduceOp.MIN)


def pmax(x: torch.Tensor, mesh) -> torch.Tensor:
    """Maximum of a local partial across the mesh (out of place)."""
    return _all_reduce(x, mesh, dist.ReduceOp.MAX)


def _gather_padded(x: torch.Tensor, mesh, n_dimms: int, axis: int) -> torch.Tensor:
    """All ranks' equal ``b``-entry blocks along ``axis``, concatenated in
    rank order and sliced to ``n_dimms``."""
    shards = n_shards(mesh)
    moved = x.movedim(axis, 0).contiguous()
    out = torch.empty((shards * moved.shape[0],) + tuple(moved.shape[1:]),
                      dtype=moved.dtype, device=moved.device)
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    if moved.dtype == torch.bool:  # collectives take bytes, not bools
        gather(out.view(torch.uint8), moved.view(torch.uint8), group=_group(mesh))
    else:
        gather(out, moved, group=_group(mesh))
    return out[:n_dimms].movedim(0, axis)


def gather_dimm(tree: Any, mesh, n_dimms: int, axis: int = 0) -> Any:
    """The whole ``n_dimms`` DIMM axis on every rank, from each rank's real
    block (``local_range``'s ``hi - lo`` entries along ``axis``): each block
    is padded to ``b`` entries, the equal blocks are gathered
    (``all_gather_single``) and the padding is sliced off."""
    b = block_size(n_dimms, mesh)
    lo, hi = local_range(n_dimms, mesh)

    def one(a: torch.Tensor) -> torch.Tensor:
        if a.shape[axis] != hi - lo:
            raise ValueError(f"local block has {a.shape[axis]} entries on axis {axis}, "
                             f"this rank holds {hi - lo}")
        return _gather_padded(padded_block(a, 0, hi - lo, b, axis), mesh, n_dimms, axis)

    return _tree_map(one, tree)


def sharded_dimm_map(
    fn: Callable[..., Tuple],
    mesh,
    in_axes: Sequence[Optional[int]],
    out_axes: Sequence[Optional[int]],
    n_dimms: int,
    gather: bool | Sequence[bool] = False,
) -> Callable[..., Tuple]:
    """Wrap a single-device function as its DIMM-sharded counterpart on
    this rank.

    ``fn(*args) -> tuple`` must compute each DIMM independently along each
    argument's DIMM axis. ``in_axes`` / ``out_axes`` give that axis for each
    argument / output (``None``: not split, e.g. a scalar or a table every
    DIMM reads; an argument or output may be a named tuple of tensors that
    share the axis). The wrapper pads each DIMM-carrying argument to
    :func:`padded_size` by edge replication, takes this rank's contiguous
    block, runs ``fn`` on it, and hands back each DIMM-axis output as the
    rank's real block (``[lo:hi]`` of the padded block) or, where
    ``gather`` asks for it (one flag, or one per output), gathered whole
    and sliced to ``n_dimms``. ``None`` outputs and outputs declared
    ``None`` pass through. Outputs are bitwise those of the unsharded call
    (per-DIMM arithmetic is unchanged)."""
    in_axes, out_axes = tuple(in_axes), tuple(out_axes)
    gathers = ((bool(gather),) * len(out_axes) if isinstance(gather, bool)
               else tuple(bool(g) for g in gather))
    if len(gathers) != len(out_axes):
        raise ValueError(f"{len(gathers)} gather flags for {len(out_axes)} outputs")

    def run(*args):
        if len(args) != len(in_axes):
            raise ValueError(f"expected {len(in_axes)} args, got {len(args)}")
        blocks = tuple(arg if ax is None else local_block(arg, mesh, n_dimms, ax)
                       for arg, ax in zip(args, in_axes))
        outs = fn(*blocks)
        lo, hi = local_range(n_dimms, mesh)
        result = []
        for out, ax, g in zip(outs, out_axes, gathers):
            if ax is None or out is None:
                result.append(out)
            elif g:
                result.append(_tree_map(lambda a, ax=ax: _gather_padded(a, mesh, n_dimms, ax),
                                        out))
            else:
                result.append(slice_dimm(out, hi - lo, ax))
        return tuple(result)

    return run


# ---------------------------------------------------------------------------
# Spawning one process a shard
# ---------------------------------------------------------------------------
def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return int(s.getsockname()[1])


def _rank_main(rank: int, world: int, device_type: str, card: Optional[int], port: int,
               out_path: str, fn: Callable, args: tuple) -> None:
    """One spawned rank: the group, the card (``card``, or its own), then
    ``fn(*args)``; rank 0's return value goes to ``out_path``. A rank that
    raises exits at once (the parent then ends the others)."""
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world))
    if device_type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    _set_device(device_type, rank if card is None else card)
    dist.init_process_group("gloo" if card is not None else _backend(device_type, world),
                            init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    result = fn(*args)
    if rank == 0:
        torch.save(result, out_path)
    dist.barrier()
    dist.destroy_process_group()


def launch(fn: Callable, n_shards: int, device: str | torch.device, *args):
    """Run ``fn(*args)`` on ``n_shards`` spawned ranks of one fleet mesh and
    return rank 0's return value (saved with ``torch.save``, loaded to the
    CPU).

    Each rank is a fresh process (start method ``spawn``: ``fn`` must be a
    module-level function of a module that imports no JAX) with the default
    process group made: gloo on the CPU, NCCL where every rank has a card
    of its own, gloo where ranks share one. On ``"cuda"`` each rank selects
    its own card (``rank % device_count``) before ``fn`` runs; on
    ``"cuda:k"`` every rank selects card ``k`` and the group is gloo (the
    one-card rehearsal of a multi-rank run). The fleet kernels are built
    here first. A rank that raises makes this raise with its traceback; the
    other ranks are ended."""
    import torch.multiprocessing as mp

    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    dev = resolve_device(device)
    if dev.type == "cuda":
        from repro_torch.kernels import _build

        _build.build(FLEET_KERNELS)
    with tempfile.TemporaryDirectory(prefix="shard-launch-") as tmp:
        out_path = os.path.join(tmp, "rank0.pt")
        mp.start_processes(_rank_main, args=(n_shards, dev.type, dev.index, _free_port(),
                                             out_path, fn, args),
                           nprocs=n_shards, join=True, start_method="spawn")
        return torch.load(out_path, map_location="cpu", weights_only=False)


def run_ranks(fn: Callable, device: str | torch.device, n_shards: Optional[int] = None,
              *args):
    """Run ``fn(*args)`` as the ranks of one fleet mesh, the way a command
    line's ``--sharded`` does: under ``torchrun`` this process is one rank
    (:func:`init_from_env`, then ``fn``; returns its own result); otherwise
    :func:`launch` spawns ``n_shards`` ranks (default: one a visible card;
    required on the CPU) and returns rank 0's."""
    if in_torchrun():
        init_from_env(device)
        result = fn(*args)
        dist.destroy_process_group()
        return result
    dev = resolve_device(device)
    if n_shards is None:
        if dev.type != "cuda":
            raise ValueError("give the number of CPU ranks (--shards N): a CPU has no "
                             "visible devices to count")
        n_shards = torch.cuda.device_count()
    return launch(fn, n_shards, dev, *args)
