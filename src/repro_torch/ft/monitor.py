"""Fleet health monitor: heartbeats, straggler detection, error fuses.

The port of ``src/repro/ft/monitor.py`` (pure Python, copied). This is
AL-DRAM's operating-condition sensing at cluster scale: per-host step-time
EWMAs play the role of the DIMM temperature sensor; the normalized load
they produce feeds ``repro_torch.core.altune.runtime.AdaptiveExecutor``
(condition bins with hysteresis), and non-finite-gradient events trip the
fuse (fall back to the conservative config and restore from the last
checkpoint).

Straggler policy: a host whose EWMA exceeds ``straggler_factor`` × the
fleet median for ``patience`` consecutive heartbeats is flagged; a
supervisor then either re-balances (a smaller microbatch on that host) or
evicts the host and restarts on the survivors.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Dict, List, Optional


@dataclasses.dataclass
class HostStats:
    ewma_s: float = 0.0
    n: int = 0
    last_beat: float = 0.0
    slow_streak: int = 0
    flagged: bool = False
    fused: bool = False


class FleetMonitor:
    def __init__(
        self,
        alpha: float = 0.2,
        straggler_factor: float = 1.3,
        patience: int = 5,
        heartbeat_timeout_s: float = 300.0,
    ):
        self.alpha = alpha
        self.straggler_factor = straggler_factor
        self.patience = patience
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.hosts: Dict[str, HostStats] = {}

    # -- ingestion -----------------------------------------------------------
    def record_step(self, host: str, step_seconds: float, now: Optional[float] = None):
        st = self.hosts.setdefault(host, HostStats())
        st.ewma_s = (
            step_seconds if st.n == 0
            else (1 - self.alpha) * st.ewma_s + self.alpha * step_seconds
        )
        st.n += 1
        st.last_beat = now if now is not None else time.time()
        self._update_flags()

    def record_error(self, host: str):
        """Non-finite grads / device error → fuse (AL-DRAM fallback)."""
        self.hosts.setdefault(host, HostStats()).fused = True

    # -- queries --------------------------------------------------------------
    def fleet_median(self) -> float:
        vals = [s.ewma_s for s in self.hosts.values() if s.n > 0]
        return statistics.median(vals) if vals else 0.0

    def load_of(self, host: str) -> float:
        """Normalized condition for altune bins: ewma / fleet median."""
        med = self.fleet_median()
        st = self.hosts.get(host)
        if st is None or st.n == 0 or med == 0:
            return 1.0
        return st.ewma_s / med

    def stragglers(self) -> List[str]:
        return [h for h, s in self.hosts.items() if s.flagged and not s.fused]

    def dead_hosts(self, now: Optional[float] = None) -> List[str]:
        now = now if now is not None else time.time()
        return [
            h for h, s in self.hosts.items()
            if s.n > 0 and now - s.last_beat > self.heartbeat_timeout_s
        ]

    def fused_hosts(self) -> List[str]:
        return [h for h, s in self.hosts.items() if s.fused]

    def _update_flags(self):
        med = self.fleet_median()
        if med <= 0:
            return
        for s in self.hosts.values():
            if s.ewma_s > self.straggler_factor * med:
                s.slow_streak += 1
            else:
                s.slow_streak = 0
                s.flagged = False
            if s.slow_streak >= self.patience:
                s.flagged = True

    # -- supervisor decision --------------------------------------------------
    def plan(self, now: Optional[float] = None) -> Dict[str, List[str]]:
        """What the supervisor should do this round."""
        return {
            "evict": self.dead_hosts(now),
            "degrade": self.stragglers(),
            "restore": self.fused_hosts(),
        }
