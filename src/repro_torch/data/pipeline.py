"""Deterministic synthetic data pipeline (host-sharded, seedable).

The port of ``src/repro/data/pipeline.py``, in the same numpy calls: a
batch is bitwise the reference's for the same (seed, step, host). The
stream is a fixed-seed Zipf-ish token process with bigram coupling, so a
small model visibly learns within a few hundred steps (a flat random
stream would give a constant loss and hide optimizer bugs).

Determinism contract: a batch depends only on (seed, step, host index), so
a restart replays identically. The host is the ``torch.distributed`` rank
when a process group is initialized (each rank materializes its slice of
the global batch), else 0 of 1 — unless the caller names it
(``process=``).

Under a sharding policy the ranks of a mesh do not feed one batch each:
the two tensor-parallel ranks of one data row must see the same rows. So a
sharded step takes the reference's single-host global batch, drawn as by
process 0 of 1 (``process=(0, 1)``), and :func:`shard_batch` places it:
each rank keeps the rows of its coordinate along the batch rule's mesh
axes, wrapped as a DTensor (no collective).

:func:`input_specs` gives the reference's dry-run shapes and dtypes as
``device="meta"`` tensors (no allocation).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    seed: int = 0
    vocab_zipf_a: float = 1.2


def _process() -> Tuple[int, int]:
    """(index, count) of this process among the hosts feeding one batch."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _host_slice(global_batch: int, process: Tuple[int, int]) -> slice:
    i, n = process
    per = global_batch // n
    return slice(i * per, (i + 1) * per)


def synth_tokens(cfg: ModelConfig, dc: DataConfig, step: int,
                 process: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """(B_host, S+1) int32 — deterministic in (seed, step, host);
    ``process`` (index, count) defaults to :func:`_process`."""
    process = process or _process()
    sl = _host_slice(dc.global_batch, process)
    b = sl.stop - sl.start
    rng = np.random.default_rng(np.random.SeedSequence([dc.seed, step, process[0]]))
    v = cfg.vocab_size
    # Zipf marginal + bigram coupling: token_{t+1} correlates with token_t.
    base = rng.zipf(dc.vocab_zipf_a, size=(b, dc.seq_len + 1)).astype(np.int64)
    base = np.minimum(base - 1, v - 1)
    prev = np.roll(base, 1, axis=1)
    mix = rng.random((b, dc.seq_len + 1)) < 0.3
    tok = np.where(mix, (prev * 31 + 7) % v, base)
    return tok.astype(np.int32)


def batch_for_step(cfg: ModelConfig, dc: DataConfig, step: int,
                   process: Optional[Tuple[int, int]] = None) -> Dict[str, np.ndarray]:
    """Next-token LM batch for this host, as numpy arrays: ``labels`` and
    ``tokens`` (B, S) int32, or ``embeds`` (B, S, d) float32 (a modality
    stub: deterministic embeddings of the token ids) and, with M-RoPE,
    ``positions`` (3, B, S) int32. ``process``: (index, count) of the host,
    default :func:`_process`; ``(0, 1)`` gives the whole global batch."""
    process = process or _process()
    tok = synth_tokens(cfg, dc, step, process)
    out: Dict[str, np.ndarray] = {"labels": tok[:, 1:].copy()}
    if cfg.embeds_input:
        rng = np.random.default_rng(np.random.SeedSequence([dc.seed + 1, step, process[0]]))
        proj = rng.standard_normal((257, cfg.d_model)).astype(np.float32) * 0.02
        out["embeds"] = proj[tok[:, :-1] % 257].astype(np.float32)
        if cfg.rope_variant == "mrope":
            b, s = tok.shape[0], dc.seq_len
            pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
            out["positions"] = np.broadcast_to(pos, (3, b, s)).copy()
    else:
        out["tokens"] = tok[:, :-1].copy()
    return out


def iterate(cfg: ModelConfig, dc: DataConfig, start_step: int = 0) -> Iterator[Dict]:
    step = start_step
    while True:
        yield batch_for_step(cfg, dc, step)
        step += 1


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A numpy batch as tensors on ``device`` (dtypes kept)."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


#: Each batch leaf's logical spec (M-RoPE's positions are (3, B, S)).
BATCH_SPECS = {"tokens": ("batch", None), "labels": ("batch", None),
               "embeds": ("batch", None, None), "positions": (None, "batch", None)}


def shard_batch(batch: Dict[str, np.ndarray], policy, device) -> Dict[str, torch.Tensor]:
    """The global numpy batch as DTensors under ``policy`` (a DeviceMesh
    policy): each rank copies only the rows of its coordinate along the
    batch rule's axes to ``device`` (the whole leaf where the batch does not
    divide them: replicated, as ``constrain`` degrades)."""
    from repro_torch.parallel.sharding import from_whole

    return {k: from_whole(torch.from_numpy(v), policy.mesh,
                          policy.placements(policy.fit(v.shape, BATCH_SPECS[k])), device)
            for k, v in batch.items()}


def input_specs(cfg: ModelConfig, seq_len: int, global_batch: int,
                kind: str) -> Dict[str, torch.Tensor]:
    """The reference's dry-run stand-ins, as ``device="meta"`` tensors of
    its shapes and dtypes (no allocation). kind: "train" → the loss
    function's batch; "prefill" → the prefill batch; "decode" → the
    (tokens, pos) pair (cache shapes come from the launcher, which knows the
    policy)."""
    b, s = global_batch, seq_len

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    if kind == "decode":
        return {"tokens": meta((b, 1), torch.int32), "pos": meta((), torch.int32)}
    out = {"labels": meta((b, s), torch.int32)}
    if cfg.embeds_input:
        out["embeds"] = meta((b, s, cfg.d_model), torch.bfloat16)
        if cfg.rope_variant == "mrope":
            out["positions"] = meta((3, b, s), torch.int32)
    else:
        out["tokens"] = meta((b, s), torch.int32)
    return out
