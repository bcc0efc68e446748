"""Thermal scenarios for trace-driven controller evaluation, in PyTorch.

Only the paper's deployment regime, :func:`diurnal`, is ported: a
day/night sinusoid in the measured 26–34 °C server band, per-DIMM placement
skew and sensor noise, drift-bounded (<0.1 °C/s, paper §1.4). Traces are
``(n_steps, n_dimms)`` float32. Random draws come from a
``torch.Generator``, or are passed in pre-drawn (:class:`DiurnalNoise`),
which is how the tests feed both packages the same draws.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch import resolve_device

#: Paper §1.4 field measurement: the deployment-regime drift bound.
PAPER_MAX_DRIFT_C_PER_S: float = 0.1

#: Default observation cadence: one thermal-sensor reading per minute.
DEFAULT_DT_S: float = 60.0

#: Lowest physically plausible machine-room temperature we generate.
MIN_AMBIENT_C: float = 10.0

#: Scenarios of the reference; only "diurnal" is ported.
SCENARIOS = ("diurnal",)


class DiurnalNoise(NamedTuple):
    """Standardized draws of one diurnal trace."""

    phase: torch.Tensor   # (n_dimms,) standard normal
    skew: torch.Tensor    # (n_dimms,) uniform in [-1, 1)
    noise: torch.Tensor   # (n_steps, n_dimms) standard normal


def enforce_drift_bound(trace: torch.Tensor, dt_s: float,
                        max_rate_c_per_s: float = PAPER_MAX_DRIFT_C_PER_S) -> torch.Tensor:
    """Clamp per-step increments to the drift bound (cumulative, so the
    output tracks the input wherever the input already respects it)."""
    lim = max_rate_c_per_s * dt_s
    steps = torch.clamp(torch.diff(trace, dim=0), -lim, lim)
    return torch.cat([trace[:1], trace[:1] + torch.cumsum(steps, dim=0)], dim=0)


def draw_diurnal_noise(generator: torch.Generator, n_dimms: int, n_steps: int,
                       device: str | torch.device = "cuda") -> DiurnalNoise:
    dev = resolve_device(device)
    kw = dict(generator=generator, dtype=torch.float32, device=dev)
    return DiurnalNoise(
        phase=torch.randn((n_dimms,), **kw),
        skew=torch.rand((n_dimms,), **kw) * 2.0 - 1.0,
        noise=torch.randn((n_steps, n_dimms), **kw),
    )


def diurnal(
    generator: Optional[torch.Generator],
    n_dimms: int,
    n_steps: int,
    dt_s: float = DEFAULT_DT_S,
    base_c: float = 30.0,
    swing_c: float = 4.0,
    noise_c: float = 0.3,
    skew_c: float = 1.5,
    period_s: float = 86400.0,
    device: str | torch.device = "cuda",
    draws: Optional[DiurnalNoise] = None,
) -> torch.Tensor:
    """The paper's deployment regime, ``(n_steps, n_dimms)`` float32 °C.
    Draws come from ``generator`` unless ``draws`` are given."""
    if draws is None:
        draws = draw_diurnal_noise(generator, n_dimms, n_steps, device)
    dev = draws.noise.device
    t_s = torch.arange(n_steps, dtype=torch.float32, device=dev)[:, None] * dt_s
    phase = 0.15 * draws.phase
    skew = skew_c * draws.skew
    wave = swing_c * torch.sin(2.0 * math.pi * t_s / period_s + phase[None, :])
    out = base_c + skew[None, :] + wave + noise_c * draws.noise
    return enforce_drift_bound(torch.clamp(out, min=MIN_AMBIENT_C), dt_s)


def generate(name: str, generator: torch.Generator, n_dimms: int, n_steps: int,
             dt_s: float = DEFAULT_DT_S, device: str | torch.device = "cuda") -> torch.Tensor:
    """Dispatch a scenario by name (only ``"diurnal"`` is ported)."""
    if name != "diurnal":
        raise NotImplementedError(
            f"scenario {name!r}: the other seven scenarios are not ported yet"
        )
    return diurnal(generator, n_dimms, n_steps, dt_s, device=device)


def error_injections(generator: torch.Generator, n_steps: int, n_dimms: int,
                     rate: float = 0.0, device: str | torch.device = "cuda") -> torch.Tensor:
    """Per-(step, DIMM) Bernoulli error mask for the reliability fuse. The
    paper observed zero errors, so the deployment-faithful rate is 0.0."""
    dev = resolve_device(device)
    if rate <= 0.0:
        return torch.zeros((n_steps, n_dimms), dtype=torch.bool, device=dev)
    u = torch.rand((n_steps, n_dimms), generator=generator, dtype=torch.float32, device=dev)
    return u < rate
