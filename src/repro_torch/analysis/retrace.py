"""Retrace counter: rebuild accounting for the named hot runners.

The port of ``src/repro/analysis/retrace.py``. The reference counts jax
recompiles (``jit(...)._cache_size()``). The port runs eagerly and
compiles nothing per call; what it pays again for a new signature is:

* a CUDA kernel build (``nvcc``, seconds) and a library load
  (``kernels._build``): once per source and flags in a process;
* DTensor's sharding propagation: each op on DTensors looks up its output
  placements in a cache keyed by the op and its operands' placements and
  shapes; a miss runs the propagation rules on the host. The first
  sharded step pays one miss a new op signature; a miss in steady state —
  a shape leak, a placement that alternates — is the port's retrace
  storm, a host cost on every step.

``RetraceCounter`` samples a named set of counters (each a callable
returning a cumulative count) and reports per-counter deltas over a
scope::

    with RetraceCounter() as rc:
        step(params, opt, batch)
    assert rc.deltas["dtensor.sharding_prop"] == 0   # steady state

``rows()`` gives the benchmark rows ``lint/retrace_<name>``, as the
reference's.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Tuple

import torch

#: A sampler: a callable returning a cumulative count.
Counter = Callable[[], int]


def _kernel_builds() -> int:
    from repro_torch.kernels import _build

    return _build.BUILDS


def _kernel_loads() -> int:
    from repro_torch.kernels import _build

    return _build.load.cache_info().misses


def sharding_prop_misses() -> int:
    """Misses of DTensor's sharding-propagation caches (the propagations
    run): the Python cache's on this thread, plus the C++ dispatch fast
    path's where this torch has one (2.13 looks up there first and runs
    the propagation itself on a miss); 0 where this torch has no
    ``torch.distributed``."""
    try:
        from torch.distributed.tensor import DTensor
    except ImportError:
        return 0
    n = DTensor._op_dispatcher.sharding_propagator.propagate_op_sharding.cache_info().misses
    fast = getattr(torch._C, "_get_DTensor_sharding_propagator_cache_stats", None)
    if fast is not None:
        n += fast()[1]
    return int(n)


def default_runners() -> Dict[str, Counter]:
    """The counters worth watching, by stable name."""
    return {
        "kernels.build": _kernel_builds,
        "kernels.load": _kernel_loads,
        "dtensor.sharding_prop": sharding_prop_misses,
    }


def _count(fn: Counter) -> int:
    if not callable(fn):
        raise TypeError(f"{fn!r} is not a counter: RetraceCounter samples callables that "
                        "return a cumulative count")
    return int(fn())


class RetraceCounter:
    """Context manager measuring counter growth per named runner."""

    def __init__(self, runners: Optional[Mapping[str, Counter]] = None):
        self.runners: Dict[str, Counter] = dict(
            runners if runners is not None else default_runners()
        )
        self._baseline: Dict[str, int] = {}
        self.deltas: Dict[str, int] = {}

    def snapshot(self) -> Dict[str, int]:
        return {name: _count(fn) for name, fn in self.runners.items()}

    def __enter__(self) -> "RetraceCounter":
        self._baseline = self.snapshot()
        self.deltas = {}
        return self

    def __exit__(self, *exc) -> None:
        now = self.snapshot()
        self.deltas = {
            name: now[name] - self._baseline[name] for name in self.runners
        }

    def total(self) -> int:
        return sum(self.deltas.values())

    def rows(
        self, expected: Optional[Mapping[str, int]] = None
    ) -> Tuple[Tuple[str, float, float], ...]:
        """Benchmark rows ``(lint/retrace_<name>, observed, expected)``.

        ``expected`` defaults to the observed value (informational row);
        pass explicit expectations to make a downstream diff meaningful.
        """
        expected = dict(expected or {})
        return tuple(
            (
                f"lint/retrace_{name}",
                float(delta),
                float(expected.get(name, delta)),
            )
            for name, delta in sorted(self.deltas.items())
        )
