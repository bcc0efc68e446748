"""Production mesh construction over ``torch.distributed``.

The port of ``src/repro/launch/mesh.py``. Functions, not module-level
constants, so importing never touches a process group. Single pod: 256
ranks as (data=16, model=16). Multi-pod: 2 pods × 256 = 512 ranks as
(pod=2, data=16, model=16) — the ``pod`` axis maps onto the inter-node
dimension; policies keep only gradient/FSDP traffic on it.

Every mesh here is a :class:`~torch.distributed.device_mesh.DeviceMesh`
over the default process group (``torchrun``, or
``repro_torch.core.shard.launch``), with one rank a device. For rule work
without a group, use ``parallel.sharding.MeshShape``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch import resolve_device


def auto_mesh(shape: Sequence[int], axes: Sequence[str],
              device: str | torch.device = "cuda"):
    """A ``DeviceMesh`` of ``shape`` with axis names ``axes`` over the
    default process group (``init_device_mesh``). Raises ``ValueError``
    when no group is initialized or its world size is not the mesh's
    size."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} vs axes {axes}")
    n = 1
    for s in shape:
        n *= s
    if not dist.is_available() or not dist.is_initialized():
        raise ValueError(f"a {shape} mesh needs {n} ranks, and no torch.distributed process "
                         "group is initialized: start the ranks with torchrun or "
                         "repro_torch.core.shard.launch")
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"a {shape} mesh needs {n} ranks but the process group has {world}")
    return init_device_mesh(resolve_device(device).type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device: str | torch.device = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return auto_mesh(shape, axes, device)


def make_mesh_for(devices_per_pod: int, n_pods: int = 1, model_parallel: int = 16,
                  device: str | torch.device = "cuda"):
    """Elastic variant: arbitrary pod count/size (restart after pod loss)."""
    data = devices_per_pod // model_parallel
    if n_pods > 1:
        return auto_mesh((n_pods, data, model_parallel), ("pod", "data", "model"), device)
    return auto_mesh((data, model_parallel), ("data", "model"), device)


def fleet_mesh(n_devices: Optional[int] = None, axis: str = "dimm",
               device: str | torch.device = "cuda"):
    """1-D mesh over the DIMM axis — the fleet-characterization data mesh:
    :func:`repro_torch.core.shard.fleet_mesh` (its one axis is ``"dimm"``)."""
    from repro_torch.core import shard

    if axis != shard.DIMM_AXIS:
        raise ValueError(f"the fleet mesh's axis is {shard.DIMM_AXIS!r}, not {axis!r}")
    return shard.fleet_mesh(n_devices, device)
