"""tpu_kubernetes_torch.ops — the port's numerical ops: flash attention
and the grouped (MoE expert) matmul (hand-written CUDA kernels, forward
and backward, + plain versions), the fused AdamW update, decode attention
over a dense or paged KV cache (bf16/f32 or int8) and the weight-only
int8 matmul (hand-written CUDA kernels of the port alone, + plain
versions), the next-token loss and RMSNorm/RoPE (plain PyTorch)."""

from tpu_kubernetes_torch.ops.adamw import (  # noqa: F401
    adamw_,
    adamw_update_cuda_,
    adamw_update_reference_,
    global_norm_cuda,
    global_norm_reference,
)
from tpu_kubernetes_torch.ops.decode_attention import (  # noqa: F401
    decode_attention,
    decode_attention_cuda,
    decode_attention_reference,
)
from tpu_kubernetes_torch.ops.flash_attention import (  # noqa: F401
    attention_bwd_reference,
    attention_reference,
    flash_attention,
    flash_bwd_cuda,
    flash_bwd_dkv_cuda,
    flash_bwd_dq_cuda,
    flash_fwd_cuda,
)
from tpu_kubernetes_torch.ops.grouped_matmul import (  # noqa: F401
    gmm_cuda,
    gmm_drhs_cuda,
    grouped_matmul,
    grouped_matmul_reference,
)
from tpu_kubernetes_torch.ops.losses import next_token_nll  # noqa: F401
from tpu_kubernetes_torch.ops.w8_matmul import (  # noqa: F401
    w8_matmul,
    w8_matmul_cuda,
    w8_matmul_reference,
)
from tpu_kubernetes_torch.ops.norms import (  # noqa: F401
    apply_rope,
    rms_norm,
    rope_frequencies,
    rope_tables,
)


def kernel_wrappers() -> dict:
    """Every kernel wrapper of the port, by kernel name; each counts its
    launches in ``launches`` (and the routed ones by route in
    ``route_launches``)."""
    return {"flash_fwd": flash_fwd_cuda,
            "flash_bwd_dq": flash_bwd_dq_cuda,
            "flash_bwd_dkv": flash_bwd_dkv_cuda,
            "gmm": gmm_cuda,
            "gmm_drhs": gmm_drhs_cuda,
            "adamw_sumsq": global_norm_cuda,
            "adamw_update": adamw_update_cuda_,
            "decode_attention": decode_attention_cuda,
            "w8_matmul": w8_matmul_cuda}


def launch_counts() -> dict[str, int]:
    """Every wrapper's launches by kernel name, the routed wrappers'
    launches by route as ``name.route`` (the weight-only int8 matmul's
    "dequant" route launches no kernel of its own: ``w8_matmul`` counts
    its "tc" and "gemv" kernels alone), and decode attention's chunks of
    more than one position (verify windows) by route as
    ``name.route.chunk``."""
    counts = {}
    for name, fn in kernel_wrappers().items():
        counts[name] = fn.launches
        for route, n in getattr(fn, "route_launches", {}).items():
            counts[f"{name}.{route}"] = n
        for route, n in getattr(fn, "chunk_launches", {}).items():
            counts[f"{name}.{route}.chunk"] = n
    return counts


def reset_launch_counts() -> None:
    for fn in kernel_wrappers().values():
        fn.launches = 0
        for counts in (getattr(fn, "route_launches", {}),
                       getattr(fn, "chunk_launches", {})):
            for route in counts:
                counts[route] = 0
