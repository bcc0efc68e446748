"""TimingTable: the memory-controller registers of the kernel embodiment.

Persists selected execution configs per (kernel, shape-class, device-bin,
condition-bin) as JSON, in the reference's format
(``src/repro/core/altune/table.py``), so a table written by either package
loads in the other; the runtime loads it at startup exactly like the AL-DRAM
controller loads per-DIMM timing sets at boot.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Any, Dict, Optional, Tuple

Key = Tuple[str, str, str, str]  # (kernel, shape_class, device_bin, cond_bin)


@dataclasses.dataclass
class TimingTable:
    entries: Dict[Key, Dict[str, Any]] = dataclasses.field(default_factory=dict)

    def put(self, kernel: str, shape: str, device_bin: str, cond_bin: str,
            config: Any, margin: float) -> None:
        self.entries[(kernel, shape, device_bin, cond_bin)] = {
            "config": dataclasses.asdict(config)
            if dataclasses.is_dataclass(config) else config,
            "config_type": type(config).__name__,
            "margin": margin,
        }

    def get(self, kernel: str, shape: str, device_bin: str = "default",
            cond_bin: str = "default") -> Optional[Dict[str, Any]]:
        for key in (
            (kernel, shape, device_bin, cond_bin),
            (kernel, shape, device_bin, "default"),
            (kernel, shape, "default", "default"),
        ):
            if key in self.entries:
                return self.entries[key]
        return None

    @classmethod
    def from_fleet(cls, result, vendor=None, kernel: str = "dram_timing") -> "TimingTable":
        """Not ported yet: it reads ``SweepResult.table_entries`` and the
        profiler's stacked reductions, which the port lacks (ROADMAP queue 1,
        item 8)."""
        raise NotImplementedError(
            "TimingTable.from_fleet needs SweepResult.table_entries and "
            "profiler.stack_reductions, not ported yet (ROADMAP queue 1, item 8)")

    # -- persistence --------------------------------------------------------
    def save(self, path: str | pathlib.Path) -> None:
        obj = {"|".join(k): v for k, v in self.entries.items()}
        pathlib.Path(path).write_text(json.dumps(obj, indent=1))

    @classmethod
    def load(cls, path: str | pathlib.Path) -> "TimingTable":
        obj = json.loads(pathlib.Path(path).read_text())
        entries = {tuple(k.split("|")): v for k, v in obj.items()}
        return cls(entries=entries)  # type: ignore[arg-type]
