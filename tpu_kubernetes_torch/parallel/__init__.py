"""tpu_kubernetes_torch.parallel — mesh/sharding, the multi-process
bootstrap, the collectives of the sharded training step, the pipeline
over ``stage``, ring attention over ``sequence`` and sharded serving (port
of ``tpu_kubernetes/parallel``)."""

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

# sharded serving (parallel/serving.py) builds on the models, which import
# this package: its names load at first use
_SERVING = ("check_serving_mesh", "gather_kv", "kv_model_program",
            "kv_movement", "kv_partition_spec", "kv_tree_shardings",
            "make_sharded_generate", "serving_param_shardings", "shard_kv")


def __getattr__(name: str):
    if name in _SERVING:
        from tpu_kubernetes_torch.parallel import serving

        return getattr(serving, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
