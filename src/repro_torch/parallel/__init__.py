"""Distribution: logical-axis sharding policies over the (pod, data, model)
mesh, on ``torch.distributed`` DeviceMesh and DTensor placements."""

from repro_torch.parallel.sharding import (  # noqa: F401
    DEFAULT_RULES,
    MeshShape,
    ShardingPolicy,
    constrain,
    current_policy,
    param_specs,
    use_policy,
)
