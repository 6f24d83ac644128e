"""tpu_kubernetes_torch.ops — the port's numerical ops: flash attention
(hand-written CUDA kernel + plain version) and RMSNorm/RoPE (plain
PyTorch)."""

from tpu_kubernetes_torch.ops.flash_attention import (  # noqa: F401
    attention_reference,
    flash_attention,
    flash_fwd_cuda,
)
from tpu_kubernetes_torch.ops.norms import (  # noqa: F401
    apply_rope,
    rms_norm,
    rope_frequencies,
)
