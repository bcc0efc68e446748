"""Thermal scenarios for trace-driven controller evaluation, in PyTorch.

Whole-fleet temperature traces, ``(n_steps, n_dimms)`` float32 °C, that
either respect the paper's field bounds (§1.4: drift <0.1 °C/s, never above
34 °C) or deliberately violate them:

* :func:`diurnal` — the paper's regime: a day/night sinusoid in the measured
  26–34 °C server band, per-DIMM placement skew and sensor noise,
  drift-bounded.
* :func:`cold_start` — power-on below ambient, settling exponentially into
  the diurnal band (drift-bounded).
* :func:`load_bursts` — job-placement heat spikes with sharp onsets
  (violates the drift bound on purpose).
* :func:`hvac_failure` — cooling loss: a sustained ramp past the last
  profiled bin (violates both bounds; exercises the JEDEC sentinel).
* :func:`refresh_storm` — half the fleet dwells just inside the
  extended-temperature range (>85 °C), where refresh doubles.
* :func:`hot_bank` — a fraction of the fleet lifted a few °C by a hammered
  bank, gradually.
* :func:`design_skew` — thermally the diurnal regime (its signature is the
  region-access mix, :data:`SCENARIO_REGION_PROFILES`).
* :func:`vendor_skew` — per-vendor constant thermal offsets.

Random draws come from a ``torch.Generator``, or are passed in pre-drawn
(:class:`DiurnalNoise`, :class:`EventDraws`, ``hot_region=``), which is how
the tests feed the port the reference's own ``jax.random`` draws.

:func:`region_access_mix` gives the per-step region-access counts that
region-aware scoring weighs (:func:`repro_torch.core.perfmodel.region_trace_score`).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.core.charge import div

#: Paper §1.4 field measurement: the deployment-regime drift bound.
PAPER_MAX_DRIFT_C_PER_S: float = 0.1

#: Default observation cadence: one thermal-sensor reading per minute.
DEFAULT_DT_S: float = 60.0

#: Lowest physically plausible machine-room temperature we generate.
MIN_AMBIENT_C: float = 10.0


class DiurnalNoise(NamedTuple):
    """Standardized draws of one diurnal trace."""

    phase: torch.Tensor   # (n_dimms,) standard normal
    skew: torch.Tensor    # (n_dimms,) uniform in [-1, 1)
    noise: torch.Tensor   # (n_steps, n_dimms) standard normal


class EventDraws(NamedTuple):
    """Draws of a scenario made of a diurnal base plus one Bernoulli mask,
    kept as uniforms in [0, 1) so the mask is ``u < probability``:
    ``(n_steps, n_dimms)`` burst onsets (:func:`load_bursts`) or
    ``(n_dimms,)`` hot DIMMs (:func:`refresh_storm`, :func:`hot_bank`)."""

    base: DiurnalNoise
    u: torch.Tensor


# ---------------------------------------------------------------------------
# Drift-bound helpers
# ---------------------------------------------------------------------------
def drift_rates(trace: torch.Tensor, dt_s: float) -> torch.Tensor:
    """Absolute per-step drift rates, °C/s — shape (n_steps-1, n_dimms)."""
    return torch.abs(torch.diff(trace, dim=0)) / dt_s


def max_drift_rate(trace: torch.Tensor, dt_s: float) -> float:
    """Worst |dT/dt| anywhere in the trace, °C/s."""
    return float(drift_rates(trace, dt_s).max())


def enforce_drift_bound(trace: torch.Tensor, dt_s: float,
                        max_rate_c_per_s: float = PAPER_MAX_DRIFT_C_PER_S) -> torch.Tensor:
    """Clamp per-step increments to the drift bound (cumulative, so the
    output tracks the input wherever the input already respects it)."""
    lim = max_rate_c_per_s * dt_s
    steps = torch.clamp(torch.diff(trace, dim=0), -lim, lim)
    return torch.cat([trace[:1], trace[:1] + torch.cumsum(steps, dim=0)], dim=0)


# ---------------------------------------------------------------------------
# Draws
# ---------------------------------------------------------------------------
def draw_diurnal_noise(generator: torch.Generator, n_dimms: int, n_steps: int,
                       device: str | torch.device = "cuda") -> DiurnalNoise:
    dev = resolve_device(device)
    kw = dict(generator=generator, dtype=torch.float32, device=dev)
    return DiurnalNoise(
        phase=torch.randn((n_dimms,), **kw),
        skew=torch.rand((n_dimms,), **kw) * 2.0 - 1.0,
        noise=torch.randn((n_steps, n_dimms), **kw),
    )


def draw_events(generator: torch.Generator, n_dimms: int, n_steps: int,
                shape: Tuple[int, ...], device: str | torch.device = "cuda") -> EventDraws:
    base = draw_diurnal_noise(generator, n_dimms, n_steps, device)
    u = torch.rand(shape, generator=generator, dtype=torch.float32,
                   device=base.noise.device)
    return EventDraws(base=base, u=u)


def _steps(n_steps: int, like: torch.Tensor) -> torch.Tensor:
    """(n_steps, 1) float32 step indices."""
    return torch.arange(n_steps, dtype=torch.float32, device=like.device)[:, None]


# ---------------------------------------------------------------------------
# Scenarios
# ---------------------------------------------------------------------------
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
    t_s = _steps(n_steps, draws.noise) * dt_s
    phase = 0.15 * draws.phase
    skew = skew_c * draws.skew
    wave = swing_c * torch.sin(2.0 * math.pi * t_s / period_s + phase[None, :])
    out = base_c + skew[None, :] + wave + noise_c * draws.noise
    return enforce_drift_bound(torch.clamp(out, min=MIN_AMBIENT_C), dt_s)


def cold_start(generator, n_dimms: int, n_steps: int, dt_s: float = DEFAULT_DT_S,
               start_c: float = 18.0, settle_tau_s: float = 1800.0,
               device: str | torch.device = "cuda", draws: Optional[DiurnalNoise] = None,
               **diurnal_kw) -> torch.Tensor:
    """Power-on below ambient, settling exponentially into the diurnal band
    (drift-bounded: the default time constant warms at ~0.007 °C/s)."""
    steady = diurnal(generator, n_dimms, n_steps, dt_s, device=device, draws=draws,
                     **diurnal_kw)
    settle = torch.exp(-(_steps(n_steps, steady) * dt_s) / settle_tau_s)
    out = steady + (start_c - steady[0])[None, :] * settle
    return enforce_drift_bound(out, dt_s)


def _event_draws(generator, n_dimms: int, n_steps: int, shape, device,
                 draws: Optional[EventDraws]) -> EventDraws:
    return draw_events(generator, n_dimms, n_steps, shape, device) if draws is None else draws


def load_bursts(generator, n_dimms: int, n_steps: int, dt_s: float = DEFAULT_DT_S,
                burst_c: float = 18.0, burst_prob: float = 0.005, burst_len: int = 8,
                device: str | torch.device = "cuda", draws: Optional[EventDraws] = None,
                **diurnal_kw) -> torch.Tensor:
    """Job-placement heat spikes on the diurnal base: a +``burst_c`` step in
    one observation (violating the drift bound on purpose) that holds for
    ``burst_len`` steps after each onset."""
    draws = _event_draws(generator, n_dimms, n_steps, (n_steps, n_dimms), device, draws)
    base = diurnal(None, n_dimms, n_steps, dt_s, draws=draws.base, **diurnal_kw)
    onsets = draws.u < burst_prob
    # A burst holds for `burst_len` steps: rolling any-onset window.
    cs = torch.cumsum(onsets.to(torch.int32), dim=0)
    lag = min(burst_len, n_steps)
    lagged = torch.cat([torch.zeros((lag, n_dimms), dtype=cs.dtype, device=cs.device),
                        cs[:n_steps - lag]], dim=0)
    active = (cs - lagged) > 0
    return base + burst_c * active.to(torch.float32)


def hvac_failure(generator, n_dimms: int, n_steps: int, dt_s: float = DEFAULT_DT_S,
                 onset_frac: float = 0.5, ramp_c_per_s: float = 0.25, peak_c: float = 95.0,
                 device: str | torch.device = "cuda", draws: Optional[DiurnalNoise] = None,
                 **diurnal_kw) -> torch.Tensor:
    """Cooling loss at ``onset_frac`` of the trace: a sustained ramp past the
    drift bound, beyond the last profiled bin, capped at ``peak_c``."""
    base = diurnal(generator, n_dimms, n_steps, dt_s, device=device, draws=draws,
                   **diurnal_kw)
    onset = int(onset_frac * n_steps)
    steps_after = torch.clamp(_steps(n_steps, base) - float(onset), min=0.0)
    ramp = ramp_c_per_s * dt_s * steps_after
    return torch.clamp(base + ramp, max=peak_c)


def _excursion(generator, n_dimms: int, n_steps: int, dt_s: float, onset_frac: float,
               recover_frac: float, cap, hot_frac: float, ramp_c_per_s: float, device,
               draws: Optional[EventDraws], diurnal_kw) -> torch.Tensor:
    """A random ``hot_frac`` of the fleet ramps up from ``onset_frac``, holds
    at ``cap(base)`` and ramps back from ``recover_frac`` of the trace."""
    draws = _event_draws(generator, n_dimms, n_steps, (n_dimms,), device, draws)
    base = diurnal(None, n_dimms, n_steps, dt_s, draws=draws.base, **diurnal_kw)
    onset = int(onset_frac * n_steps)
    recover = int(recover_frac * n_steps)
    t = _steps(n_steps, base)
    rate = ramp_c_per_s * dt_s
    rise = torch.clamp(t - float(onset), min=0.0) * rate
    fall = torch.clamp(t - float(recover), min=0.0) * rate
    env = torch.clamp(torch.minimum(rise, cap(base)) - fall, min=0.0)
    hot = draws.u < hot_frac
    return base + env * hot[None, :].to(torch.float32)


def refresh_storm(generator, n_dimms: int, n_steps: int, dt_s: float = DEFAULT_DT_S,
                  onset_frac: float = 0.25, recover_frac: float = 0.75,
                  plateau_c: float = 88.0, hot_frac: float = 0.5, ramp_c_per_s: float = 0.05,
                  device: str | torch.device = "cuda", draws: Optional[EventDraws] = None,
                  **diurnal_kw) -> torch.Tensor:
    """Extended-temperature storm: a random ``hot_frac`` of the fleet ramps
    past 85 °C within the drift bound, holds a ``plateau_c`` plateau between
    ``onset_frac`` and ``recover_frac`` of the trace, then ramps back."""
    def lift(base):
        return torch.clamp(plateau_c - base, min=0.0)

    return _excursion(generator, n_dimms, n_steps, dt_s, onset_frac, recover_frac, lift,
                      hot_frac, ramp_c_per_s, device, draws, diurnal_kw)


def hot_bank(generator, n_dimms: int, n_steps: int, dt_s: float = DEFAULT_DT_S,
             onset_frac: float = 0.2, recover_frac: float = 0.8, lift_c: float = 7.0,
             hot_frac: float = 0.35, ramp_c_per_s: float = 0.05,
             device: str | torch.device = "cuda", draws: Optional[EventDraws] = None,
             **diurnal_kw) -> torch.Tensor:
    """Bank-locality hotspot: a random ``hot_frac`` of the fleet lifted by
    ``lift_c`` for the middle of the trace, ramped within the drift bound."""
    def lift(base):
        return torch.full_like(base, lift_c)

    return _excursion(generator, n_dimms, n_steps, dt_s, onset_frac, recover_frac, lift,
                      hot_frac, ramp_c_per_s, device, draws, diurnal_kw)


def design_skew(generator, n_dimms: int, n_steps: int, dt_s: float = DEFAULT_DT_S,
                device: str | torch.device = "cuda", draws: Optional[DiurnalNoise] = None,
                **diurnal_kw) -> torch.Tensor:
    """Design-induced-variation regime: thermally the diurnal one; its
    signature is the near-skewed region-access mix it pairs with
    (:data:`SCENARIO_REGION_PROFILES`)."""
    return diurnal(generator, n_dimms, n_steps, dt_s, device=device, draws=draws,
                   **diurnal_kw)


def vendor_skew(generator, n_dimms: int, n_steps: int, dt_s: float = DEFAULT_DT_S,
                vendor: Optional[torch.Tensor] = None,
                offsets_c: Sequence[float] = (0.0, 3.0, 6.0),
                device: str | torch.device = "cuda", draws: Optional[DiurnalNoise] = None,
                **diurnal_kw) -> torch.Tensor:
    """Fleet heterogeneity: each vendor's modules run at a constant thermal
    offset. ``vendor`` is the fleet's vendor index (default round-robin)."""
    base = diurnal(generator, n_dimms, n_steps, dt_s, device=device, draws=draws,
                   **diurnal_kw)
    if vendor is None:
        vendor = torch.arange(n_dimms, device=base.device) % len(offsets_c)
    offsets = torch.tensor(tuple(offsets_c), dtype=torch.float32, device=base.device)
    return base + offsets[vendor.to(base.device).long() % len(offsets_c)][None, :]


#: Scenario registry: name → generator with the uniform
#: ``(generator, n_dimms, n_steps, dt_s, **kw)`` signature.
SCENARIOS: Dict[str, Callable[..., torch.Tensor]] = {
    "diurnal": diurnal,
    "cold_start": cold_start,
    "load_bursts": load_bursts,
    "hvac_failure": hvac_failure,
    "refresh_storm": refresh_storm,
    "vendor_skew": vendor_skew,
    "hot_bank": hot_bank,
    "design_skew": design_skew,
}


#: Default region-access-mix profile per scenario (:func:`region_access_mix`);
#: scenarios without a region signature read uniformly.
SCENARIO_REGION_PROFILES: Dict[str, str] = {
    "design_skew": "near",
    "hot_bank": "hot_bank",
}


def generate(name: str, generator: Optional[torch.Generator], n_dimms: int, n_steps: int,
             dt_s: float = DEFAULT_DT_S, device: str | torch.device = "cuda",
             **kw) -> torch.Tensor:
    """Dispatch a scenario by name (see :data:`SCENARIOS`); ``kw`` goes to
    the generator (``draws=``, ``vendor=`` for ``vendor_skew``, ...)."""
    try:
        fn = SCENARIOS[name]
    except KeyError:
        raise ValueError(f"unknown scenario {name!r}; choose from {sorted(SCENARIOS)}") from None
    return fn(generator, n_dimms, n_steps, dt_s, device=device, **kw)


def error_injections(generator: torch.Generator, n_steps: int, n_dimms: int,
                     rate: float = 0.0, device: str | torch.device = "cuda") -> torch.Tensor:
    """Per-(step, DIMM) Bernoulli error mask for the reliability fuse. The
    paper observed zero errors, so the deployment-faithful rate is 0.0."""
    dev = resolve_device(device)
    if rate <= 0.0:
        return torch.zeros((n_steps, n_dimms), dtype=torch.bool, device=dev)
    u = torch.rand((n_steps, n_dimms), generator=generator, dtype=torch.float32, device=dev)
    return u < rate


#: Region-access-mix profiles (see :func:`region_access_mix`).
REGION_MIX_PROFILES: Tuple[str, ...] = ("uniform", "near", "far", "hot_bank")


def _row_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis, left to right, one float32 add at a time (the
    order a small reduction takes in the reference), so that the allocation's
    floors do not depend on a reduction's blocking."""
    out = x[..., 0]
    for r in range(1, x.shape[-1]):
        out = out + x[..., r]
    return out


def _integer_allocate(weights: torch.Tensor, total: int) -> torch.Tensor:
    """Split ``total`` accesses across the last axis in proportion to
    ``weights``: floors, then the remainder dealt one each to the slots of
    largest fractional remainder (ties to the lower index, by stable sorts),
    so every row sums to exactly ``total``. int32."""
    w = weights / _row_sum(weights)[..., None]
    ideal = w * float(total)
    floor = torch.floor(ideal)
    base = floor.to(torch.int32)
    short = total - base.sum(dim=-1, dtype=torch.int32)
    frac = ideal - floor
    order = torch.argsort(-frac, dim=-1, stable=True)
    rank = torch.argsort(order, dim=-1, stable=True)
    return base + (rank < short[..., None]).to(torch.int32)


def region_access_mix(
    generator: Optional[torch.Generator],
    n_steps: int,
    n_dimms: int,
    n_regions: int,
    profile: str = "uniform",
    accesses_per_step: int = 64,
    skew: float = 4.0,
    hot_share: float = 0.75,
    hot_region: Optional[torch.Tensor] = None,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """Per-step region-access counts, ``(n_steps, n_dimms, n_regions)``
    int32, each row summing to ``accesses_per_step``; region 0 is the
    nearest (fastest) class. Profiles:

    * ``"uniform"`` — an equal split (remainders to the nearest regions);
    * ``"near"`` — a geometric skew toward near regions, ratio ``skew``
      between the nearest and the farthest (page placement on fast rows);
    * ``"far"`` — its mirror image (adversarial for region awareness);
    * ``"hot_bank"`` — each DIMM puts ``hot_share`` of its accesses in one
      region (drawn from ``generator``, or given as ``hot_region``, an
      ``(n_dimms,)`` integer tensor), the rest uniform.

    Counts are deterministic given the weights (largest-remainder
    allocation). The rows do not change over steps, so the result is an
    ``expand``ed view of one ``(n_dimms, n_regions)`` allocation, not a copy."""
    if n_regions < 1:
        raise ValueError(f"n_regions must be >= 1, got {n_regions}")
    if accesses_per_step < 1:
        raise ValueError(f"accesses_per_step must be >= 1, got {accesses_per_step}")
    if profile not in REGION_MIX_PROFILES:
        raise ValueError(f"unknown region mix profile {profile!r}; choose from "
                         f"{REGION_MIX_PROFILES}")
    dev = resolve_device(device)
    idx = torch.arange(n_regions, dtype=torch.float32, device=dev)
    if profile == "uniform":
        w = torch.ones((1, n_regions), dtype=torch.float32, device=dev)
    elif profile in ("near", "far"):
        span = max(n_regions - 1, 1)
        g = torch.pow(torch.full((), skew, dtype=torch.float32, device=dev),
                      div(-idx, float(span)))
        w = (g.flip(0) if profile == "far" else g)[None, :]
    else:
        if hot_region is None:
            hot_region = torch.randint(0, n_regions, (n_dimms,), generator=generator,
                                       device=dev)
        hot_region = torch.as_tensor(hot_region).to(device=dev)
        if tuple(hot_region.shape) != (n_dimms,):
            raise ValueError(f"hot_region must be ({n_dimms},), got {tuple(hot_region.shape)}")
        regions = torch.arange(n_regions, device=dev)
        onehot = (hot_region.long()[:, None] == regions[None, :]).to(torch.float32)
        w = onehot * hot_share + (1.0 - hot_share) / float(n_regions)
    per_dimm = _integer_allocate(w, accesses_per_step).expand(n_dimms, n_regions)
    return per_dimm[None].expand(n_steps, n_dimms, n_regions)
