"""tpu_kubernetes_torch.models — the dense LLaMA family of the port
(models/llama.py: forward, loss, remat) and its KV-cache inference (models/decode.py), with
the JAX weight bridge (models/from_jax.py)."""

from tpu_kubernetes_torch.models.decode import (  # noqa: F401
    KVCache,
    decode_segment,
    decode_step,
    generate,
    init_cache,
    prefill,
)
from tpu_kubernetes_torch.models.from_jax import params_from_numpy  # noqa: F401
from tpu_kubernetes_torch.models.llama import (  # noqa: F401
    CONFIGS,
    ModelConfig,
    forward,
    init_params,
    loss_fn,
    param_count,
)
