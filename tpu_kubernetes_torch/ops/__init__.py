"""tpu_kubernetes_torch.ops — the port's numerical ops: flash attention
and the grouped (MoE expert) matmul (hand-written CUDA kernels, forward
and backward, + plain versions), the next-token loss and RMSNorm/RoPE
(plain PyTorch)."""

from tpu_kubernetes_torch.ops.flash_attention import (  # noqa: F401
    attention_bwd_reference,
    attention_reference,
    flash_attention,
    flash_bwd_cuda,
    flash_fwd_cuda,
)
from tpu_kubernetes_torch.ops.grouped_matmul import (  # noqa: F401
    grouped_matmul,
    grouped_matmul_reference,
)
from tpu_kubernetes_torch.ops.losses import next_token_nll  # noqa: F401
from tpu_kubernetes_torch.ops.norms import (  # noqa: F401
    apply_rope,
    rms_norm,
    rope_frequencies,
)
