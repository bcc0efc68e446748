"""DRAM timing parameters: the four timings AL-DRAM adapts (tRCD, tRAS,
tWR, tRP), in nanoseconds, and the JEDEC DDR3-1600 baseline (JESD79-3F).

Pure Python; the port keeps its own copy so that it never imports the JAX
package.
"""

from __future__ import annotations

import dataclasses
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

    def as_dict(self) -> Dict[str, float]:
        return {k: getattr(self, k) for k in PARAM_NAMES}

    def __iter__(self) -> Iterator[float]:
        return iter(getattr(self, k) for k in PARAM_NAMES)


@dataclasses.dataclass(frozen=True)
class AccessTimings:
    """One timing set per access type (read, write)."""

    read: TimingParams
    write: TimingParams

    def __iter__(self) -> Iterator[TimingParams]:
        return iter((self.read, self.write))


#: JEDEC DDR3-1600 standard timings: the worst-case provisioned baseline.
JEDEC_DDR3_1600 = TimingParams(trcd=13.75, tras=35.0, twr=15.0, trp=13.75)

#: Additional fixed latencies used by the performance model (not adapted).
TCL_NS: float = 13.75  # CAS latency
TBURST_NS: float = 5.0  # burst transfer of one 64B cache line (BL8)
