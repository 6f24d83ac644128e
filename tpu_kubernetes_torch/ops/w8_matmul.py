"""The weight-only int8 matmul: ``y = x @ W`` with W an int8-quantized
weight (``{"q": int8 (K, N), "s": f32 (1, N)}``, ``models/quant.py``),
formed as the reference forms it, ``q.to(dtype) * s.to(dtype)`` in x's
dtype (a kernel of the port alone: the JAX package reads the weight
through ``weight()`` and XLA fuses the dequantize into the dot).

* :func:`w8_matmul_reference` — the plain version: the dequantized weight
  in x's dtype, then ``x @ W``.
* :func:`w8_matmul_cuda` — the wrapper, on two routes by the number of
  rows M (the product of x's leading dimensions): "gemv" for M <=
  :data:`MAX_ROWS` (a decode step of 1..8 rows, a verify window of 72),
  the hand-written kernel of ``csrc/w8_matmul.cu`` (``w8_matmul``: the
  int8 weights read once and formed in registers, K split over the blocks
  of a thread-block cluster, f32 sums in an order that depends on K and N
  only, so a row's output is the same bits at every M); "dequant" for
  more rows (a prefill), the weight dequantized
  into a temporary and ``torch.matmul``, the product the JAX package
  computes outside any Pallas kernel too. ``launches`` counts the
  kernel's launches, ``route_launches`` the calls by route.
* :func:`w8_matmul` — the dispatcher :func:`~tpu_kubernetes_torch.models.
  quant.matmul_w` calls: ``use_kernel=None`` takes the wrapper for CUDA
  tensors and the plain version for CPU tensors; ``use_kernel=False``
  forces the plain version. A CUDA tensor goes through the wrapper or
  raises: there is no fallback lane.
"""

from __future__ import annotations

import ctypes

import torch

MAX_ROWS = 128            # rows the kernel takes; more take "dequant"
KERNEL_DTYPES = (torch.bfloat16, torch.float32)
COLS = 128                # output columns a block (csrc/w8_matmul.cu)
MAX_CLUSTER = 8           # blocks a cluster splits K over (portable)
TARGET_BLOCKS = 264       # two blocks a multiprocessor
MIN_RANGE = 64            # K positions a split takes at least


def w8_matmul_reference(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor
                        ) -> torch.Tensor:
    """``x @ (q.to(x.dtype) * s.to(x.dtype))``."""
    return x @ (q.to(x.dtype) * s.to(x.dtype))


def k_split(K: int, N: int) -> tuple[int, int]:
    """(the cluster's blocks, K positions a block) for an (K, N) weight:
    the largest power of two up to MAX_CLUSTER that keeps the grid within
    TARGET_BLOCKS blocks of COLS columns and each block's range at least
    MIN_RANGE positions; the range a multiple of 16. A function of K and
    N alone, so every row count sums in one order."""
    n_tiles = -(-N // COLS)
    cs = 1
    while (2 * cs <= MAX_CLUSTER and 2 * cs * n_tiles <= TARGET_BLOCKS
           and -(-K // (2 * cs)) >= MIN_RANGE):
        cs *= 2
    kb = -(-(-(-K // cs)) // 16) * 16
    return cs, kb


def load_kernel():
    """The C entry point, built by ``nvcc`` on first use."""
    from tpu_kubernetes_torch.ops import _build

    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    return _build.load("w8_matmul", [ptr] * 4 + [i32] * 6 + [ptr])


def _check(cond: bool, msg: str, exc=ValueError) -> None:
    if not cond:
        raise exc(f"w8_matmul_cuda: {msg}")


def w8_matmul_cuda(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor
                   ) -> torch.Tensor:
    """``x (..., K) @ W`` on the card → (..., N) in x's dtype, as
    :func:`w8_matmul_reference` (see the module docstring for the
    routes)."""
    _check(q.dim() == 2 and q.dtype == torch.int8,
           f"takes an int8 weight (K, N); got {q.dtype} "
           f"{tuple(q.shape)}", TypeError)
    K, N = q.shape
    _check(s.dtype == torch.float32 and s.numel() == N,
           f"takes f32 scales of {N} columns; got {s.dtype} "
           f"{tuple(s.shape)}", TypeError)
    _check(x.shape[-1] == K, f"x {tuple(x.shape)} does not contract with "
                             f"a weight of {K} rows")
    _check(x.dtype in KERNEL_DTYPES,
           f"takes bfloat16 or float32 x; got {x.dtype}", TypeError)
    for name, t in (("x", x), ("q", q), ("s", s)):
        _check(t.is_cuda and t.device == x.device,
               f"needs CUDA tensors on one device; {name} is on {t.device}")
    lead = x.shape[:-1]
    M = x.numel() // K if K else 0
    if M > MAX_ROWS:
        w8_matmul_cuda.route_launches["dequant"] += 1
        return w8_matmul_reference(x, q, s)
    _check(N % 8 == 0 and q.is_contiguous() and q.data_ptr() % 8 == 0,
           f"takes a contiguous, 8-byte aligned weight of a multiple of 8 "
           f"columns; got {tuple(q.shape)} strides {q.stride()}")
    x2 = x.reshape(M, K).contiguous()
    s = s.contiguous()
    cs, kb = k_split(K, N)
    dev = x.device
    y = torch.empty((M, N), dtype=x.dtype, device=dev)
    fn = load_kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x2.data_ptr(), q.data_ptr(), s.data_ptr(), y.data_ptr(),
                 M, K, N, kb, cs, int(x.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"w8_matmul kernel launch failed: CUDA error "
                           f"{err}")
    w8_matmul_cuda.launches += 1
    w8_matmul_cuda.route_launches["gemv"] += 1
    return y.reshape(*lead, N)


w8_matmul_cuda.launches = 0
w8_matmul_cuda.route_launches = {"gemv": 0, "dequant": 0}


def w8_matmul(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
              use_kernel: bool | None = None) -> torch.Tensor:
    """The weight-only int8 matmul on either lane (see the module
    docstring)."""
    if use_kernel is None:
        use_kernel = x.is_cuda
    if not use_kernel:
        return w8_matmul_reference(x, q, s)
    return w8_matmul_cuda(x, q, s)
