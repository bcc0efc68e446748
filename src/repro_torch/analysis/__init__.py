"""Runtime sanitizers: the dynamic half of the repro-lint story.

The port of ``src/repro/analysis``. :mod:`tools.repro_lint` catches
convention violations the AST can see; this package catches the ones
only a running program exposes — host waits for the card (the eager
analogue of implicit transfers), silent rank promotion, NaNs born inside a
step, and rebuild storms (kernel builds, DTensor sharding propagation).
Everything funnels through one context:

    with repro_torch.analysis.sanitize():
        ...

A measured region is wrapped in it; ``RetraceCounter.rows`` reports its
retrace counts as ``lint/retrace_*`` rows, as the reference's.
"""

from repro_torch.analysis.retrace import (  # noqa: F401
    RetraceCounter,
    default_runners,
)
from repro_torch.analysis.sanitizers import (  # noqa: F401
    SanitizeConfig,
    config_from_env,
    sanitize,
)

__all__ = [
    "RetraceCounter",
    "SanitizeConfig",
    "config_from_env",
    "default_runners",
    "sanitize",
]
