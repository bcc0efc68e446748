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

    # -- fleet consumption --------------------------------------------------
    @classmethod
    def from_fleet(cls, result, vendor=None, kernel: str = "dram_timing") -> "TimingTable":
        """Ingest a :class:`repro_torch.core.fleet.SweepResult` as controller
        registers: one entry per (DIMM, temperature bin, access type),
        condition-binned ``T{temp}:{read|write}``, device-binned by vendor,
        margin = that set's mean fractional reduction vs JEDEC (through
        ``SweepResult.table_entries``, a host-side generator: small fleets)."""
        from repro_torch.core.timing import PARAM_NAMES

        vendors = [int(v) for v in vendor.tolist()] if vendor is not None else None
        table = cls()
        for _b, t, i, access, timings, margin in result.table_entries():
            table.put(
                kernel,
                f"dimm{i:05d}",
                f"vendor{vendors[i] if vendors else 0}",
                f"T{t:g}:{access}",
                dict(zip(PARAM_NAMES, timings)),
                margin,
            )
        return table

    # -- persistence --------------------------------------------------------
    def save(self, path: str | pathlib.Path) -> None:
        obj = {"|".join(k): v for k, v in self.entries.items()}
        pathlib.Path(path).write_text(json.dumps(obj, indent=1))

    @classmethod
    def load(cls, path: str | pathlib.Path) -> "TimingTable":
        obj = json.loads(pathlib.Path(path).read_text())
        entries = {tuple(k.split("|")): v for k, v in obj.items()}
        return cls(entries=entries)  # type: ignore[arg-type]
