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
mismatched checkpoint changes nothing. Elastic restore onto another mesh
(the reference's ``shardings=``) waits for ROADMAP item 9h.
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

from repro_torch.tree import walk

MANIFEST = "manifest.json"


def _flatten(tree) -> Dict[str, Any]:
    """Leaves of a tree by their '/'-joined path."""
    return {"/".join(map(str, path)): leaf for path, leaf in walk(tree)}


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
    """Synchronous atomic checkpoint of a state tree (tensors or numpy)."""
    host = {name: _to_host(leaf) for name, leaf in _flatten(state).items()}
    return _write(ckpt_dir, step, host, extra_meta, keep)


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
    """Asynchronous save: copies the state to host memory now, writes it in
    a background thread; the caller keeps training. Read the future's
    result before the next save."""
    global _POOL
    if _POOL is None:
        _POOL = cf.ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt")
    host = {name: _to_host(leaf) for name, leaf in _flatten(state).items()}
    return _POOL.submit(_write, ckpt_dir, step, host, extra_meta, keep)


def latest_step(ckpt_dir) -> Optional[int]:
    root = pathlib.Path(ckpt_dir)
    if not root.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in root.iterdir()
             if p.is_dir() and p.name.startswith("step_") and (p / MANIFEST).exists()]
    return max(steps) if steps else None


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore(ckpt_dir, state_like: Dict[str, Any], step: Optional[int] = None,
            shardings: Optional[Any] = None, verify_crc: bool = True
            ) -> Tuple[Dict[str, Any], int]:
    """Restore into ``state_like``: every leaf is read and checked (CRC,
    shape) first, then each tensor leaf receives its values in place
    (``copy_``, converting to the leaf's dtype and device) and each numpy
    leaf is replaced. Returns (``state_like``, step)."""
    if shardings is not None:
        raise NotImplementedError(
            "restore(shardings=): elastic restore onto another mesh waits for ROADMAP "
            "item 9h (sharded training)")
    root = pathlib.Path(ckpt_dir)
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {root}")
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

    def put(tree, prefix: str = ""):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        for k, v in list(items):
            name = f"{prefix}/{k}" if prefix else str(k)
            if isinstance(v, (dict, list, tuple)):
                put(v, name)
            elif isinstance(v, torch.Tensor):
                with torch.no_grad():
                    v.copy_(_from_host(*loaded[name]))
            else:
                tree[k] = loaded[name][0]

    put(state_like)
    return state_like, step


def _prune(root: pathlib.Path, keep: int) -> None:
    dirs = sorted(p for p in root.iterdir() if p.is_dir() and p.name.startswith("step_"))
    for p in dirs[:-keep] if keep > 0 else []:
        shutil.rmtree(p, ignore_errors=True)
