"""tpu_kubernetes_torch.parallel — mesh/sharding, the multi-process
bootstrap and the collectives of the sharded training step (port of
``tpu_kubernetes/parallel``: its mesh and distributed modules; the
pipeline, ring attention and sharded serving wait for ROADMAP.md queue 1
items 7b and 7c)."""

from tpu_kubernetes_torch.parallel.distributed import (  # noqa: F401
    DistributedEnv,
    backend_for,
    initialize,
    read_env,
)
from tpu_kubernetes_torch.parallel.mesh import (  # noqa: F401
    DATA_AXES,
    DEFAULT_RULES,
    MESH_AXES,
    Mesh,
    NamedSharding,
    PartitionSpec,
    active_mesh,
    batch_sharding,
    create_hybrid_mesh,
    create_mesh,
    data_axes_in,
    device_prefix_for,
    logical_to_spec,
    mesh_context,
    mesh_shape_for_devices,
    param_shardings,
    parse_mesh_shape,
)
