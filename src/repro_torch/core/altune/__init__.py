"""altune: AL-DRAM's profile→tabulate→adapt method for execution params.

costmodel — analytical H100 latency model and tile gate (the SPICE analogue)
profiler  — candidate sweep + oracle validation + repeatability (the FPGA
            platform analogue)
table     — persisted (kernel, shape, device-bin, condition-bin) → config
runtime   — guard-banded, hysteretic, fused adaptive selection
steptuner — the same method on a training step's execution parameters
            (microbatches, remat offload, block-skip, KV chunk) over the
            analytic roofline and memory models (import it by module: it
            needs ``launch.analytic``)
"""

from repro_torch.core.altune.costmodel import (  # noqa: F401
    Estimate,
    flash_estimate,
    matmul_estimate,
    scan_estimate,
)
from repro_torch.core.altune.profiler import ProfileResult, profile_kernel  # noqa: F401
from repro_torch.core.altune.runtime import AdaptiveExecutor, ConditionBins  # noqa: F401
from repro_torch.core.altune.table import TimingTable  # noqa: F401
