"""Causal flash attention forward (port of
``tpu_kubernetes/ops/flash_attention.py``).

* :func:`attention_reference` — the plain PyTorch version, numerically the
  reference's ``attention_reference`` (f32 scores, ``-1e30`` mask aligned
  bottom-right, f32 softmax, P cast to ``v.dtype`` before P·V).
* :func:`flash_fwd_cuda` — the wrapper of the hand-written Hopper kernel
  (``csrc/flash_fwd.cu``), which replaces the Pallas ``_fwd_kernel``. It
  returns O and the per-row log-sum-exp; its ``launches`` attribute counts
  the kernel launches it made.
* :func:`flash_attention` — the dispatcher with the reference's contract:
  ``use_kernel=None`` picks the kernel for CUDA tensors and the plain
  version for CPU tensors; the config's block sizes are fit to the
  sequence with :func:`_fit_block` and an indivisible length raises the
  reference's ``ValueError``. A CUDA tensor launches the kernel or raises:
  there is no fallback lane.

Only the forward is ported: serving needs no gradient. The two backward
kernels come with the training slice.
"""

from __future__ import annotations

import ctypes
import math

import torch

DEFAULT_BLOCK_Q = 128
DEFAULT_BLOCK_K = 128
NEG_INF = -1e30
KERNEL_HEAD_DIMS = (16, 32, 64, 128)
KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
    sm_scale: float | None = None,
) -> torch.Tensor:
    """Plain attention. q, k, v: (batch, heads, seq, head_dim)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if causal:
        seq_q, seq_k = s.shape[-2], s.shape[-1]
        mask = torch.ones(seq_q, seq_k, dtype=torch.bool,
                          device=s.device).tril(seq_k - seq_q)
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum(
        "bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float()
    ).to(q.dtype)


def _check_kernel_inputs(q, k, v, causal: bool) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(
                f"flash_fwd_cuda needs CUDA tensors; {name} is on {t.device}"
            )
        if t.dtype != q.dtype or t.dtype not in KERNEL_DTYPES:
            raise TypeError(
                f"flash_fwd_cuda takes q, k, v all bfloat16 or all float32; "
                f"got {q.dtype}, {k.dtype}, {v.dtype}"
            )
        if t.dim() != 4 or not t.is_contiguous():
            raise ValueError(
                f"flash_fwd_cuda takes contiguous (batch, heads, seq, "
                f"head_dim) tensors; {name} has shape {tuple(t.shape)}, "
                f"strides {t.stride()}"
            )
        if t.device != q.device:
            raise ValueError("q, k, v must be on one device")
    b, h, seq_q, d = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != d:
        raise ValueError(
            f"k and v must be (batch, heads, seq_k, head_dim) matching q "
            f"{tuple(q.shape)}; got {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"flash_fwd_cuda takes head_dim in {KERNEL_HEAD_DIMS}, got {d}"
        )
    if seq_q == 0 or k.shape[2] == 0 or b * h == 0:
        raise ValueError("flash_fwd_cuda needs non-empty tensors")
    if causal and seq_q > k.shape[2]:
        raise ValueError(
            f"causal flash_fwd_cuda needs seq_q <= seq_k, got {seq_q} > "
            f"{k.shape[2]}"
        )


def load_kernel():
    """The kernel's C entry point (``csrc/flash_fwd.cu``), built by
    ``nvcc`` on the first call of the process if its library is missing:
    (q, k, v, o, lse, batch·heads, seq_q, seq_k, head_dim, is_bf16,
    causal, sm_scale, stream) → CUDA error code."""
    from tpu_kubernetes_torch.ops import _build

    return _build.load("flash_fwd", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_void_p])


def flash_fwd_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
    sm_scale: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the Hopper flash-attention forward on the current stream.
    → (O like q, LSE f32 (batch, heads, seq_q)). Raises on anything the
    kernel does not take, and when the launch is refused."""
    _check_kernel_inputs(q, k, v, causal)
    fn = load_kernel()
    b, h, seq_q, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, h, seq_q), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), b * h, seq_q, k.shape[2], d,
                 int(q.dtype == torch.bfloat16), int(bool(causal)),
                 float(sm_scale), stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error {err}")
    flash_fwd_cuda.launches += 1
    return o, lse


flash_fwd_cuda.launches = 0


def _fit_block(block: int, seq: int) -> int:
    """Largest halving of ``block`` that divides ``seq`` (seq=768 with
    block=512 → 256). Degenerate fits (< 16) hand back the original block
    so the caller's divisibility check raises — the reference's rule."""
    orig = block = min(block, seq)
    while block >= 16 and seq % block:
        block //= 2
    if block < 16 and block < seq:
        return orig
    return block


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    sm_scale: float | None = None,
    block_q: int = DEFAULT_BLOCK_Q,
    block_k: int = DEFAULT_BLOCK_K,
    use_kernel: bool | None = None,
) -> torch.Tensor:
    """Attention over (batch, heads, seq, head_dim) tensors.

    ``use_kernel=None`` picks the CUDA kernel when q lies on a CUDA device
    and the plain version when it lies on the CPU; ``use_kernel=False``
    forces the plain version (the comparisons in tests and
    ``chip_smoke.py``). The kernel lane keeps the reference's block
    contract: the blocks fit to the sequence lengths or a ``ValueError``
    names them."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if use_kernel is None:
        use_kernel = q.is_cuda
    if not use_kernel:
        return attention_reference(q, k, v, causal=causal, sm_scale=sm_scale)

    seq_q, seq_k = q.shape[2], k.shape[2]
    block_q = _fit_block(block_q, seq_q)
    block_k = _fit_block(block_k, seq_k)
    if seq_q % block_q or seq_k % block_k:
        raise ValueError(
            f"sequence lengths ({seq_q}, {seq_k}) must be divisible by the "
            f"block sizes ({block_q}, {block_k})"
        )
    return flash_fwd_cuda(q, k, v, causal, sm_scale)[0]
