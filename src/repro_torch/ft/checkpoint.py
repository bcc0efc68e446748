"""Fault-tolerant checkpointing: atomic, CRC-verified, async.

The port of ``src/repro/ft/checkpoint.py``, with its layout: one ``.npy``
per leaf (path-keyed: ``params/stack/3/attn/wq`` is
``params__stack__3__attn__wq.npy``; the port's stack is a list of layers),
a JSON manifest with each file's CRC32, shape and dtype, the step and
free-form meta, written to a temp directory and atomically renamed — a
torn write can never look like a checkpoint. ``save_async`` copies the
state to host memory at once (a copy also of a leaf already there) and
writes it in a worker thread, so the
train loop overlaps the next step with the write. ``keep`` most recent
checkpoints are kept; older ones are pruned after a successful save
(never before).

A bfloat16 leaf is stored as its raw 16-bit words (a ``uint16`` array;
numpy has no bfloat16) with ``"dtype": "bfloat16"`` in the manifest, the
name the reference writes.

:func:`restore` writes into the tensors of the tree it is given, in place,
after every leaf has been read and checked on the host: a restore never
holds a second copy of the state on the device, and a corrupt or
mismatched checkpoint changes nothing.

Sharded state (DTensor leaves, under a ``parallel.sharding`` policy) is
saved whole: every rank gathers each leaf's ``full_tensor()`` in the
calling thread (a collective, so never in ``save_async``'s worker, which
only writes), and rank 0 alone writes the files, the same files as an
unsharded save. A DTensor leaf of ``state_like`` restores in place into
its local shard. Under a process group every rank calls ``save``,
:func:`agreed_latest_step` and ``restore`` together, and they agree: a
``save`` returns once rank 0's files are in place, ``restore`` reads the
step that rank 0 names (rank 0 having waited for its own ``save_async``
before it calls), and no rank returns from it before every rank has read
— so no write or prune of a later save runs under a reader. ``restore(shardings=)`` is the reference's elastic
restore: each ``.npy`` is read whole and placed under the *current* mesh
(``distribute_tensor``, every rank keeping its shard of the same file), so
a run saved on one mesh shape resumes on another.
"""

from __future__ import annotations

import concurrent.futures as cf
import json
import pathlib
import shutil
import zlib
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.parallel.sharding import Placed, from_whole, is_dtensor
from repro_torch.tree import walk

MANIFEST = "manifest.json"


def _flatten(tree) -> Dict[str, Any]:
    """Leaves of a tree by their '/'-joined path."""
    return {"/".join(map(str, path)): leaf for path, leaf in walk(tree)}


def _grouped() -> bool:
    """Whether this process is one rank of a process group."""
    dist = torch.distributed
    return dist.is_available() and dist.is_initialized()


def _writer() -> bool:
    """Whether this process writes checkpoints: rank 0 of a process group,
    or the only process."""
    return not _grouped() or torch.distributed.get_rank() == 0


def _rank0s(value):
    """Rank 0's ``value`` on every rank of the process group (a collective;
    ``value`` itself without a group)."""
    if not _grouped():
        return value
    box = [value]
    torch.distributed.broadcast_object_list(box, src=0)
    return box[0]


def _gather(leaf):
    """A DTensor leaf as the whole tensor (a collective: every rank calls
    it), anything else as it is."""
    return leaf.full_tensor() if is_dtensor(leaf) else leaf


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as (numpy array to store, dtype name for the manifest)."""
    if isinstance(leaf, torch.Tensor):
        # A copy also where the leaf is on the CPU already (``.cpu()`` would
        # return the leaf itself): the train loop updates the state in place
        # while ``save_async`` writes it.
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.array(leaf)
    return arr, str(arr.dtype)


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).view(np.uint8).reshape(-1))


def save(ckpt_dir, step: int, state: Dict[str, Any],
         extra_meta: Optional[Dict[str, Any]] = None, keep: int = 3) -> pathlib.Path:
    """Synchronous atomic checkpoint of a state tree (tensors, DTensors or
    numpy). Under a process group every rank calls it; rank 0 writes."""
    host = _host_state(state)
    out = (pathlib.Path(ckpt_dir) / f"step_{step:010d}" if host is None
           else _write(ckpt_dir, step, host, extra_meta, keep))
    if _grouped():  # the files in place before any rank returns
        torch.distributed.barrier()
    return out


def _host_state(state) -> Optional[Dict[str, Tuple[np.ndarray, str]]]:
    """The state's leaves on the host, {path: (array, dtype name)}, on the
    writing rank (DTensors gathered on every rank, leaf by leaf); None on
    the others."""
    writer = _writer()
    host = {}
    for name, leaf in _flatten(state).items():
        whole = _gather(leaf)
        if writer:
            host[name] = _to_host(whole)
        del whole
    return host if writer else None


def _write(ckpt_dir, step: int, host: Dict[str, Tuple[np.ndarray, str]],
           extra_meta: Optional[Dict[str, Any]], keep: int) -> pathlib.Path:
    """Write leaves already on the host ({path: (array, dtype name)})."""
    root = pathlib.Path(ckpt_dir)
    root.mkdir(parents=True, exist_ok=True)
    final = root / f"step_{step:010d}"
    tmp = root / f".tmp_step_{step:010d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    manifest: Dict[str, Any] = {"step": step, "files": {}, "meta": extra_meta or {}}
    for name, (arr, dtype) in host.items():
        fname = name.replace("/", "__") + ".npy"
        np.save(tmp / fname, arr)
        manifest["files"][name] = {"file": fname, "crc32": _crc(arr),
                                   "shape": list(arr.shape), "dtype": dtype}
    (tmp / MANIFEST).write_text(json.dumps(manifest, indent=1))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)  # atomic on POSIX
    _prune(root, keep)
    return final


_POOL: Optional[cf.ThreadPoolExecutor] = None


def save_async(ckpt_dir, step: int, state: Dict[str, Any],
               extra_meta: Optional[Dict[str, Any]] = None, keep: int = 3) -> cf.Future:
    """Asynchronous save: copies the state to host memory now (DTensors
    gathered here, on every rank), writes it in a background thread; the
    caller keeps training. Read the future's result before the next save.
    A rank that does not write gets a future that is already done: before
    a restore, rank 0 reads its own future, and :func:`agreed_latest_step`
    and ``restore`` make the others wait for it."""
    global _POOL
    host = _host_state(state)
    if host is None:
        done: cf.Future = cf.Future()
        done.set_result(pathlib.Path(ckpt_dir) / f"step_{step:010d}")
        return done
    if _POOL is None:
        _POOL = cf.ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt")
    return _POOL.submit(_write, ckpt_dir, step, host, extra_meta, keep)


def latest_step(ckpt_dir) -> Optional[int]:
    root = pathlib.Path(ckpt_dir)
    if not root.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in root.iterdir()
             if p.is_dir() and p.name.startswith("step_") and (p / MANIFEST).exists()]
    return max(steps) if steps else None


def agreed_latest_step(ckpt_dir) -> Optional[int]:
    """:func:`latest_step` as rank 0 sees it, on every rank of a process
    group (each rank calls it; rank 0 first waits for its own pending
    ``save_async``); :func:`latest_step` without a group."""
    return _rank0s(latest_step(ckpt_dir) if _writer() else None)


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore(ckpt_dir, state_like: Dict[str, Any], step: Optional[int] = None,
            shardings: Optional[Any] = None, verify_crc: bool = True
            ) -> Tuple[Dict[str, Any], int]:
    """Restore into ``state_like``: every leaf is read and checked (CRC,
    shape) first, then each tensor leaf receives its values in place
    (``copy_``, converting to the leaf's dtype and device; a DTensor leaf
    its own shard) and each numpy leaf is replaced. Returns
    (``state_like``, step).

    ``shardings``: a tree of ``parallel.sharding.Placed`` leaves
    (``param_specs`` for the *current* mesh) over some of ``state_like``'s
    subtrees, e.g. ``{"params": ...}`` — the elastic restore. Then a new
    tree comes back (its tuples as lists) and ``state_like`` is unchanged:
    each placed leaf is a DTensor of the file's values on that mesh (in the
    leaf's dtype, on the mesh's device), each other tensor a new one placed
    as its leaf (a DTensor on its mesh, else on its device).

    Under a process group every rank calls it, and every rank reads the
    step rank 0 names (``step``, else its latest); none returns before all
    have read."""
    root = pathlib.Path(ckpt_dir)
    if step is None and _writer():
        step = latest_step(root)
    step = _rank0s(step)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {root}")
    try:
        return _restore(root, state_like, step, shardings, verify_crc), step
    finally:
        if _grouped():  # no later save writes or prunes under a reader
            torch.distributed.barrier()


def _restore(root: pathlib.Path, state_like, step: int, shardings, verify_crc: bool):
    cdir = root / f"step_{step:010d}"
    manifest = json.loads((cdir / MANIFEST).read_text())

    flat_like = _flatten(state_like)
    loaded: Dict[str, Any] = {}
    for name, like in flat_like.items():
        info = manifest["files"].get(name)
        if info is None:
            raise KeyError(f"checkpoint missing leaf {name!r}")
        arr = np.load(cdir / info["file"])
        if verify_crc and _crc(arr) != info["crc32"]:
            raise IOError(f"CRC mismatch for {name!r} (corrupt checkpoint)")
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"{name}: shape {arr.shape} != {tuple(like.shape)}")
        loaded[name] = (arr, info["dtype"])

    if shardings is not None:
        placed = {n: pl for n, pl in _flatten(shardings).items() if isinstance(pl, Placed)}
        unknown = set(placed) - set(flat_like)
        if unknown:
            raise KeyError(f"shardings name leaves the state has not: {sorted(unknown)[:3]}")
        state_like = _copy_tree(state_like)

    def put(tree, prefix: str = ""):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        for k, v in list(items):
            name = f"{prefix}/{k}" if prefix else str(k)
            if isinstance(v, (dict, list, tuple)):
                put(v, name)
            elif shardings is not None and isinstance(v, torch.Tensor):
                host = _from_host(*loaded[name]).to(v.dtype)
                pl = placed.get(name) or (Placed(v.device_mesh, tuple(v.placements), ())
                                          if is_dtensor(v) else None)
                tree[k] = _place(host, pl) if pl is not None else host.to(v.device, copy=True)
            elif is_dtensor(v):
                with torch.no_grad():
                    v.to_local().copy_(_place(_from_host(*loaded[name]).to(v.dtype),
                                              Placed(v.device_mesh, tuple(v.placements),
                                                     ())).to_local())
            elif isinstance(v, torch.Tensor):
                with torch.no_grad():
                    v.copy_(_from_host(*loaded[name]))
            else:
                tree[k] = loaded[name][0]

    put(state_like)
    return state_like


def _copy_tree(tree):
    """The tree's containers copied (a tuple as a list), its leaves shared."""
    if isinstance(tree, dict):
        return {k: _copy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_copy_tree(v) for v in tree]
    return tree


def _place(t: torch.Tensor, pl: Placed):
    """A whole host tensor as a DTensor under ``pl``: each rank copies its
    own shard to the mesh's device (the same file on every rank, so no
    collective)."""
    mesh = pl.mesh
    dev = torch.device(mesh.device_type, torch.cuda.current_device()) \
        if mesh.device_type == "cuda" else torch.device(mesh.device_type)
    return from_whole(t, mesh, pl.placements, dev)


def _prune(root: pathlib.Path, keep: int) -> None:
    dirs = sorted(p for p in root.iterdir() if p.is_dir() and p.name.startswith("step_"))
    for p in dirs[:-keep] if keep > 0 else []:
        shutil.rmtree(p, ignore_errors=True)
