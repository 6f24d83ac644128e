"""tpu_kubernetes_torch.parallel — mesh/sharding, the multi-process
bootstrap, the collectives of the sharded training step, the pipeline
over ``stage`` and ring attention over ``sequence`` (port of
``tpu_kubernetes/parallel``; sharded serving waits for ROADMAP.md queue 1
item 7c)."""

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
from tpu_kubernetes_torch.parallel.pipeline import (  # noqa: F401
    pipeline_forward,
    pipeline_loss_fn,
    pipeline_param_shardings,
)
from tpu_kubernetes_torch.parallel.ring_attention import (  # noqa: F401
    ring_attention,
    ring_attention_sharded,
)
