"""DRAM timing parameters: the four timings AL-DRAM adapts (tRCD, tRAS,
tWR, tRP), in nanoseconds, and the JEDEC DDR3-1600 baseline (JESD79-3F).

Pure Python; the port keeps its own copy so that it never imports the JAX
package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterator, Tuple

#: DDR3-1600: 800 MHz bus clock.
TCK_DDR3_1600_NS: float = 1.25

#: Names, in the paper's canonical order (the last axis of every stack).
PARAM_NAMES: Tuple[str, str, str, str] = ("trcd", "tras", "twr", "trp")

#: Access types, in the axis order of every stack with an access axis.
ACCESS_TYPES: Tuple[str, str] = ("read", "write")


@dataclasses.dataclass(frozen=True)
class TimingParams:
    """The four critical DRAM timing parameters, in nanoseconds. Fields may
    be Python floats or broadcastable tensors (the perf model evaluates
    whole stacks at once)."""

    trcd: float
    tras: float
    twr: float
    trp: float

    @property
    def read_sum(self) -> float:
        """tRCD + tRAS + tRP: the paper's read-latency figure of merit."""
        return self.trcd + self.tras + self.trp

    @property
    def write_sum(self) -> float:
        """tRCD + tWR + tRP: the paper's write-latency figure of merit."""
        return self.trcd + self.twr + self.trp

    @property
    def trc(self) -> float:
        """Row-cycle time tRC = tRAS + tRP (back-to-back row activations)."""
        return self.tras + self.trp

    def scaled(self, factors: "TimingParams | Dict[str, float]") -> "TimingParams":
        """Multiply each parameter by a per-parameter factor."""
        if isinstance(factors, TimingParams):
            factors = factors.as_dict()
        return TimingParams(**{k: getattr(self, k) * factors[k] for k in PARAM_NAMES})

    def reduced(self, reductions: Dict[str, float]) -> "TimingParams":
        """Apply fractional reductions, e.g. ``{"twr": 0.33}`` → tWR × 0.67."""
        return TimingParams(
            **{k: getattr(self, k) * (1.0 - reductions.get(k, 0.0)) for k in PARAM_NAMES}
        )

    def quantize(self, tck_ns: float = TCK_DDR3_1600_NS) -> "TimingParams":
        """Round each parameter *up* to an integer number of clock cycles."""
        return TimingParams(**{k: c * tck_ns for k, c in self.cycles(tck_ns).items()})

    def cycles(self, tck_ns: float = TCK_DDR3_1600_NS) -> Dict[str, int]:
        """Integer cycle counts at the given bus clock (rounded up)."""
        return {k: int(math.ceil(round(getattr(self, k) / tck_ns, 9))) for k in PARAM_NAMES}

    def reduction_vs(self, baseline: "TimingParams") -> Dict[str, float]:
        """Fractional reduction of each parameter relative to ``baseline``."""
        return {k: 1.0 - getattr(self, k) / getattr(baseline, k) for k in PARAM_NAMES}

    def as_dict(self) -> Dict[str, float]:
        return {k: getattr(self, k) for k in PARAM_NAMES}

    def __iter__(self) -> Iterator[float]:
        return iter(getattr(self, k) for k in PARAM_NAMES)

    def validate(self) -> None:
        for k in PARAM_NAMES:
            v = getattr(self, k)
            if not (v > 0.0 and math.isfinite(v)):
                raise ValueError(f"{k}={v!r} must be positive and finite")


@dataclasses.dataclass(frozen=True)
class AccessTimings:
    """One timing set per access type (read, write)."""

    read: TimingParams
    write: TimingParams

    def by_type(self, access: str) -> TimingParams:
        if access not in ACCESS_TYPES:
            raise KeyError(f"unknown access type {access!r}")
        return getattr(self, access)

    def __iter__(self) -> Iterator[TimingParams]:
        return iter((self.read, self.write))

    @classmethod
    def merged(cls, t: TimingParams) -> "AccessTimings":
        """A single merged set duplicated into both slots (legacy tables)."""
        return cls(read=t, write=t)


#: JEDEC DDR3-1600 standard timings: the worst-case provisioned baseline.
JEDEC_DDR3_1600 = TimingParams(trcd=13.75, tras=35.0, twr=15.0, trp=13.75)

#: JEDEC for both access types: the beyond-last-bin and fused fallback.
JEDEC_ACCESS = AccessTimings(read=JEDEC_DDR3_1600, write=JEDEC_DDR3_1600)

#: Additional fixed latencies used by the performance model (not adapted).
TCL_NS: float = 13.75  # CAS latency
TBURST_NS: float = 5.0  # burst transfer of one 64B cache line (BL8)
