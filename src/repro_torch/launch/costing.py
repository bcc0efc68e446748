"""Roofline terms of executed code: FLOPs, bytes and collective bytes.

The port of ``src/repro/launch/costing.py``. The reference lowers and
compiles a function and reads XLA's ``cost_analysis`` and the collectives
of the optimized HLO. The port has no compiled artifact: :func:`cost_of`
runs the function once, eagerly, and counts what it dispatches — on fake
tensors (``FakeTensorMode``: shapes and dtypes, no storage, no device), so
a production-size step costs no memory and no device time:

* **FLOPs** by the formulas of ``torch.utils.flop_counter``
  (``FlopCounterMode``'s registry: matrix products, convolutions,
  attention); elementwise ops count 0, where XLA counts them too;
* **bytes**: each aten op's tensor operands and results, each once — what
  eager execution moves, since it runs unfused (a view moves nothing and
  is skipped); an XLA fusion moves less;
* **collective bytes by kind**: the results of the ``_c10d_functional``
  collectives DTensor runs when it redistributes, under the reference's
  HLO names (``all-gather``, ``all-reduce``, ``reduce-scatter``,
  ``all-to-all``).

Per device. A dispatch mode runs before a tensor subclass, so on DTensors
it would see each op at its global shapes (``FlopCounterMode`` over a
sharded ``x @ w`` counts the whole product) and none of the collectives
that DTensor runs inside its own dispatch. The mode therefore passes
every op on DTensors on to DTensor (it returns ``NotImplemented``, as
``torch.distributed.tensor.debug.CommDebugMode`` does) and counts what
DTensor desugars it into: the ops on the local shards and the collectives
— the FSDP gathers of weights, the redistributions that sharding
propagation picks, the gradients' reductions. Ops on plain tensors — the
local shards inside ``local_map`` bodies (attention, the experts, the
xLSTM mixers) — are one rank's already. The ops that DTensor's sharding
propagation runs on fake tensors of the global shapes, to learn an output's
shape (once per new op signature), are not counted.

The reference's ``collective_bytes`` (a regex over HLO text) is kept, copied,
for reading HLO dumps of the reference beside the port's counts.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, Dict, Tuple

import torch

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1,
}

_COLL_RE = re.compile(
    r"=\s*(?:\([^)]*\)|(\w+)\[([\d,]*)\][^ ]*)\s*"
    r"(all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)"
)
# Tuple-result collectives: shapes inside the parens.
_TUPLE_RE = re.compile(
    r"=\s*\(([^)]*)\)\s*(all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)"
)
_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")


def _shape_bytes(dtype: str, dims: str) -> int:
    n = 1
    for d in dims.split(","):
        if d:
            n *= int(d)
    return n * _DTYPE_BYTES.get(dtype, 4)


def collective_bytes(hlo_text: str) -> Dict[str, int]:
    """Sum result-shape bytes of collective ops in HLO text, per kind."""
    out: Dict[str, int] = {}
    for line in hlo_text.splitlines():
        m = _TUPLE_RE.search(line)
        if m:
            kind = m.group(2)
            total = sum(
                _shape_bytes(dt, dims) for dt, dims in _SHAPE_RE.findall(m.group(1))
            )
            out[kind] = out.get(kind, 0) + total
            continue
        m = _COLL_RE.search(line)
        if m and m.group(1):
            kind = m.group(3)
            out[kind] = out.get(kind, 0) + _shape_bytes(m.group(1), m.group(2))
    return out


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    coll: Dict[str, float] = dataclasses.field(default_factory=dict)

    def scaled(self, k: float) -> "Cost":
        return Cost(
            self.flops * k, self.bytes * k,
            {kk: v * k for kk, v in self.coll.items()},
        )

    def __add__(self, other: "Cost") -> "Cost":
        coll = dict(self.coll)
        for k, v in other.coll.items():
            coll[k] = coll.get(k, 0.0) + v
        return Cost(self.flops + other.flops, self.bytes + other.bytes, coll)

    @property
    def coll_total(self) -> float:
        return sum(self.coll.values())


#: ``_c10d_functional`` collectives → the reference's HLO kind names.
COLLECTIVE_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "broadcast",
}


def _tensors(tree):
    from torch.utils._pytree import tree_leaves

    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class CostMode:
    """A dispatch mode counting one rank's FLOPs, bytes and collective bytes
    (see the module docstring); ``cost`` holds the totals."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import flop_registry

        try:
            from torch.distributed.tensor import DTensor
        except ImportError:  # a torch without torch.distributed
            DTensor = None
        counter = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                if isinstance(func, torch._ops.HigherOrderOperator):
                    return func(*args, **kwargs)
                if DTensor is not None and any(issubclass(t, DTensor) for t in types):
                    return NotImplemented  # counted as DTensor's local ops
                out = func(*args, **kwargs)
                if not counter._paused:
                    counter._count(func, out, args, kwargs, flop_registry)
                return out

        self.cost = Cost()
        self._mode = _Mode()
        self._paused = False
        self._unpatch = None

    def _count(self, func, out, args, kwargs, registry) -> None:
        packet = func._overloadpacket
        if func.namespace == "_c10d_functional":
            name = packet.__name__
            if name in COLLECTIVE_KINDS:
                kind = COLLECTIVE_KINDS[name]
                self.cost.coll[kind] = self.cost.coll.get(kind, 0.0) + sum(
                    _nbytes(t) for t in _tensors(out))
            return
        if func.is_view or func.namespace == "prim":
            return
        if packet in registry:
            self.cost.flops += float(registry[packet](*args, **kwargs, out_val=out))
        self.cost.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs))) + \
            sum(_nbytes(t) for t in _tensors(out))

    def _skip_propagation(self):
        """Pause the count while DTensor's sharding propagation runs an op on
        global-shape fake tensors; returns the undo."""
        try:
            from torch.distributed.tensor._sharding_prop import ShardingPropagator
        except ImportError:  # no torch.distributed: no DTensor either
            return lambda: None
        name = "_propagate_tensor_meta_non_cached"
        orig = ShardingPropagator.__dict__.get(name)
        if orig is None:
            raise RuntimeError(f"this torch's ShardingPropagator has no {name}: the cost "
                               "mode cannot keep its global-shape ops out of the count")
        counter = self

        def paused(prop, op_schema):
            was, counter._paused = counter._paused, True
            try:
                return orig(prop, op_schema)
            finally:
                counter._paused = was

        setattr(ShardingPropagator, name, paused)
        return lambda: setattr(ShardingPropagator, name, orig)

    def __enter__(self) -> "CostMode":
        self._unpatch = self._skip_propagation()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        try:
            return self._mode.__exit__(*exc)
        finally:
            self._unpatch()


def cost_of(fn: Callable, *args, **kwargs) -> Tuple[Cost, object]:
    """Run ``fn(*args, **kwargs)`` once under :class:`CostMode`; return
    (one rank's :class:`Cost`, ``fn``'s result). Give it fake tensors (or
    DTensors of fake shards) to count a step without running it."""
    with CostMode() as cm:
        out = fn(*args, **kwargs)
    return cm.cost, out


# ---------------------------------------------------------------------------
# Hardware constants: NVIDIA H100 SXM5 80 GB, the data sheet's peaks (not
# measurements; "NVIDIA H100 Tensor Core GPU" data sheet, H100 SXM column).
# ---------------------------------------------------------------------------
PEAK_FLOPS = 989e12          # dense BF16 Tensor Core FLOP/s a card (1,979 with sparsity)
HBM_BW = 3.35e12             # HBM3 bytes/s a card
ICI_BW = 450e9               # NVLink 4 bytes/s a card, one direction (900 GB/s both)


def roofline_terms(cost: Cost, n_chips: int = 1) -> Dict[str, float]:
    """cost is PER-DEVICE, so terms are per-card latencies."""
    t_compute = cost.flops / PEAK_FLOPS
    t_memory = cost.bytes / HBM_BW
    t_coll = cost.coll_total / ICI_BW
    dom = max(
        ("compute", t_compute), ("memory", t_memory), ("collective", t_coll),
        key=lambda kv: kv[1],
    )[0]
    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "bottleneck": dom,
        "step_lower_bound_s": max(t_compute, t_memory, t_coll),
    }
