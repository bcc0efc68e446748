"""``sanitize()``: one context manager wiring the port's runtime guards.

The port of ``src/repro/analysis/sanitizers.py``, with the same
configuration, environment names and modes. The reference's three guards
are jax config scopes; the port's are torch's counterparts:

* ``transfer_guard`` → ``torch.cuda.set_sync_debug_mode``: an op that
  makes the host wait for the card (``.item()``, ``.cpu()``, ``nonzero``,
  a pageable copy) is the eager analogue of jax's implicit transfer.
  ``"allow"`` → 0 (off); ``"log"`` and ``"log_explicit"`` → ``"warn"``;
  ``"disallow"`` and ``"disallow_explicit"`` → ``"error"``. Without a card
  there is nothing to wait for: the guard is then a no-op (the mode stays
  unset).
* ``rank_promotion`` → a ``TorchFunctionMode`` that warns
  (``RuntimeWarning``) or raises (``ValueError``) when an elementwise op
  broadcasts operands of different rank (``(n, 4)`` op ``(4,)``), as jax's
  ``numpy_rank_promotion``; rank-0 operands broadcast freely, as there.
  The port's model code broadcasts norm scales and biases by rank, so
  ``"raise"`` is for code written to the reference's explicit-broadcast
  convention.
* ``debug_nans`` → a ``TorchDispatchMode`` that raises
  ``FloatingPointError`` at the first op whose floating output holds a
  NaN, naming that op (it reads every output: a host wait an op on a
  card, so off by default; flip on when hunting).

Environment overrides (read by :func:`config_from_env`):

* ``REPRO_SANITIZE=0``            — disable the whole context
* ``REPRO_TRANSFER_GUARD=<mode>`` — allow | log | disallow (and _explicit variants)
* ``REPRO_RANK_PROMOTION=<mode>`` — allow | warn | raise
* ``REPRO_DEBUG_NANS=1``          — enable NaN debugging
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import warnings
from typing import Iterator, Optional

import torch

_TRANSFER_MODES = (
    "allow", "log", "disallow", "log_explicit", "disallow_explicit",
)
_RANK_MODES = ("allow", "warn", "raise")

#: ``transfer_guard`` → ``torch.cuda.set_sync_debug_mode``'s argument.
SYNC_DEBUG_MODE = {"allow": 0, "log": "warn", "log_explicit": "warn",
                   "disallow": "error", "disallow_explicit": "error"}

#: Elementwise functions whose operands the rank check compares (names as
#: the torch function mode sees them, without ``__``/``r``/``i``/``_``
#: decorations: ``__radd__``, ``add_`` and ``torch.add`` are all ``add``).
ELEMENTWISE = frozenset({
    "add", "sub", "subtract", "mul", "multiply", "div", "divide", "true_divide",
    "truediv", "floordiv", "floor_divide", "mod", "remainder", "fmod", "pow",
    "and", "or", "xor", "eq", "ne", "lt", "le", "gt", "ge", "maximum",
    "minimum", "fmax", "fmin", "where", "atan2", "hypot", "copysign",
    "logical_and", "logical_or", "logical_xor", "bitwise_and", "bitwise_or",
    "bitwise_xor", "lerp", "addcmul", "addcdiv",
})


@dataclasses.dataclass(frozen=True)
class SanitizeConfig:
    """Resolved guard settings for one :func:`sanitize` scope."""

    transfer_guard: str = "allow"
    rank_promotion: str = "raise"
    debug_nans: bool = False
    enabled: bool = True

    def __post_init__(self) -> None:
        if self.transfer_guard not in _TRANSFER_MODES:
            raise ValueError(
                f"transfer_guard={self.transfer_guard!r}: "
                f"expected one of {_TRANSFER_MODES}"
            )
        if self.rank_promotion not in _RANK_MODES:
            raise ValueError(
                f"rank_promotion={self.rank_promotion!r}: "
                f"expected one of {_RANK_MODES}"
            )


def config_from_env(**overrides) -> SanitizeConfig:
    """The environment-driven config."""
    cfg = dict(
        enabled=os.environ.get("REPRO_SANITIZE", "1") != "0",
        transfer_guard=os.environ.get("REPRO_TRANSFER_GUARD", "allow"),
        rank_promotion=os.environ.get("REPRO_RANK_PROMOTION", "raise"),
        debug_nans=os.environ.get("REPRO_DEBUG_NANS", "0") == "1",
    )
    cfg.update(overrides)
    return SanitizeConfig(**cfg)


def _elementwise_name(func) -> Optional[str]:
    name = getattr(func, "__name__", "")
    bare = name.strip("_")
    if name.startswith("__") and bare[:1] in ("r", "i") and bare[1:] in ELEMENTWISE:
        bare = bare[1:]
    bare = bare.rstrip("_")
    return bare if bare in ELEMENTWISE else None


@contextlib.contextmanager
def rank_promotion_guard(mode: str) -> Iterator[None]:
    """Warn or raise (``mode`` "warn" / "raise") when an elementwise op
    broadcasts operands of different nonzero rank; "allow" does nothing."""
    if mode == "allow":
        yield
        return
    from torch.overrides import TorchFunctionMode

    class _RankPromotion(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            name = _elementwise_name(func)
            if name is not None:
                shapes = [tuple(a.shape) for a in list(args) + list(kwargs.values())
                          if isinstance(a, torch.Tensor) and a.dim() > 0]
                if len({len(s) for s in shapes}) > 1:
                    msg = (f"{name}: operands of shapes {shapes} could not be broadcast "
                           f"without rank promotion (rank_promotion={mode!r})")
                    if mode == "raise":
                        raise ValueError(msg)
                    warnings.warn(msg, RuntimeWarning, stacklevel=2)
            return func(*args, **kwargs)

    with _RankPromotion():
        yield


@contextlib.contextmanager
def nan_guard() -> Iterator[None]:
    """Raise ``FloatingPointError`` at the first op whose floating output
    holds a NaN, naming the op."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class _DebugNans(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor) and t.is_floating_point() and \
                        not isinstance(t, torch._subclasses.FakeTensor) and \
                        bool(torch.isnan(t).any()):
                    raise FloatingPointError(f"NaN in the output of {func} (debug_nans)")
            return out

    with _DebugNans():
        yield


@contextlib.contextmanager
def sync_guard(mode: str) -> Iterator[None]:
    """``torch.cuda.set_sync_debug_mode`` for ``transfer_guard`` ``mode``
    within the block, the previous mode restored after; a no-op without a
    card."""
    if not torch.cuda.is_available():
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(SYNC_DEBUG_MODE[mode])
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


@contextlib.contextmanager
def sanitize(
    config: Optional[SanitizeConfig] = None,
    *,
    transfer_guard: Optional[str] = None,
    rank_promotion: Optional[str] = None,
    debug_nans: Optional[bool] = None,
) -> Iterator[SanitizeConfig]:
    """Enter the configured guard scopes (a no-op when disabled).

    Keyword arguments override individual fields of ``config`` (which
    defaults to :func:`config_from_env`), so a strict steady-state block
    reads::

        with analysis.sanitize(transfer_guard="disallow"):
            run_warm_loop()
    """
    overrides = {k: v for k, v in (("transfer_guard", transfer_guard),
                                   ("rank_promotion", rank_promotion),
                                   ("debug_nans", debug_nans)) if v is not None}
    cfg = dataclasses.replace(config or config_from_env(), **overrides)
    if not cfg.enabled:
        yield cfg
        return
    with contextlib.ExitStack() as stack:
        stack.enter_context(sync_guard(cfg.transfer_guard))
        stack.enter_context(rank_promotion_guard(cfg.rank_promotion))
        if cfg.debug_nans:
            stack.enter_context(nan_guard())
        yield cfg
