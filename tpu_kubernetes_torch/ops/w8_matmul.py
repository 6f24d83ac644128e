"""The weight-only int8 matmul: ``y = x @ W`` with W an int8-quantized
weight (``{"q": int8 (K, N), "s": f32 (1, N)}``, ``models/quant.py``),
formed as the reference forms it, ``q.to(dtype) * s.to(dtype)`` in x's
dtype (a kernel of the port alone: the JAX package reads the weight
through ``weight()`` and XLA fuses the dequantize into the dot).

* :func:`w8_matmul_reference` — the plain version: the dequantized weight
  in x's dtype, then ``x @ W``.
* :func:`w8_matmul_cuda` — the wrapper, on three routes that
  :func:`_route` picks by x's dtype, the row count M (the product of x's
  leading dimensions) and the weight's shape: "tc" for bf16 x of M <=
  :data:`MAX_ROWS` rows (a decode step of 1..8 rows, a verify window of
  72) and K and N multiples of 16, the tensor-core kernel of
  ``csrc/w8_matmul_tc.cu`` (``w8_matmul_tc``: 16 output columns on
  mma.sync's M and up to 8 rows on its N, the int8 weights by TMA into a
  ring, widened and scaled to the reference's bf16 weight in registers);
  "gemv" for the other calls of at most MAX_ROWS rows (f32 x), the
  CUDA-core kernel of ``csrc/w8_matmul.cu`` (``w8_matmul``: the weights
  formed in registers, f32 fmas); both split K over the blocks of a
  thread-block cluster and sum in an order that depends on K and N only,
  so a row's output is the same bits at every M; "dequant" for more rows
  (a prefill), the weight dequantized into a temporary and
  ``torch.matmul``, the product the JAX package computes outside any
  Pallas kernel too. ``route="gemv"`` forces the CUDA-core kernel on a
  call the tensor cores take (the comparisons). ``launches`` counts both
  kernels' launches, ``route_launches`` the calls by route.
* :func:`w8_matmul` — the dispatcher :func:`~tpu_kubernetes_torch.models.
  quant.matmul_w` calls: ``use_kernel=None`` takes the wrapper for CUDA
  tensors and the plain version for CPU tensors; ``use_kernel=False``
  forces the plain version. A CUDA tensor goes through the wrapper or
  raises: there is no fallback lane.
"""

from __future__ import annotations

import ctypes

import torch

MAX_ROWS = 128            # rows the kernels take; more take "dequant"
KERNEL_DTYPES = (torch.bfloat16, torch.float32)
COLS = 128                # output columns a block (csrc/w8_matmul.cu)
MAX_CLUSTER = 8           # blocks a cluster splits K over (portable)
TARGET_BLOCKS = 264       # two blocks a multiprocessor
MIN_RANGE = 64            # K positions a split takes at least
TC_COLS = 128             # output columns a block (csrc/w8_matmul_tc.cu)
TC_KT = 64                # K positions a ring stage
TC_ALIGN = 16             # K and N the tensor-core route takes: multiples
ENTRY = {"tc": "w8_matmul_tc", "gemv": "w8_matmul"}


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


def tc_split(K: int, N: int) -> tuple[int, int]:
    """The tensor-core kernel's (cluster's blocks, K positions a block): the
    largest power of two up to MAX_CLUSTER that keeps the grid within
    TARGET_BLOCKS blocks of TC_COLS columns and gives every block a ring
    stage of TC_KT positions; the range a multiple of TC_KT (the last
    block's may run past K, which reads as zeros, or hold nothing). A
    function of K and N alone, so every row count sums in one order."""
    n_tiles = -(-N // TC_COLS)
    stages = -(-K // TC_KT)
    cs = 1
    while (2 * cs <= MAX_CLUSTER and 2 * cs * n_tiles <= TARGET_BLOCKS
           and 2 * cs <= stages):
        cs *= 2
    return cs, TC_KT * -(-stages // cs)


def _route(dtype, rows: int, K: int, N: int) -> str:
    """The route of a call of ``rows`` rows of ``dtype`` by a (K, N)
    weight: "dequant" past MAX_ROWS rows; "tc" (the tensor cores) for bf16
    with K and N multiples of TC_ALIGN; "gemv" (the CUDA cores) for
    every other call."""
    if rows > MAX_ROWS:
        return "dequant"
    if dtype == torch.bfloat16 and K % TC_ALIGN == 0 and N % TC_ALIGN == 0:
        return "tc"
    return "gemv"


def load_kernel(route: str = "gemv"):
    """The C entry point of ``route``, built by ``nvcc`` on first use:
    ``w8_matmul_tc`` of ``csrc/w8_matmul_tc.cu`` (tc) or ``w8_matmul`` of
    ``csrc/w8_matmul.cu`` (gemv)."""
    from tpu_kubernetes_torch.ops import _build

    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    if route == "tc":
        return _build.load("w8_matmul_tc", [ptr] * 4 + [i32] * 5 + [ptr])
    return _build.load("w8_matmul", [ptr] * 4 + [i32] * 6 + [ptr])


def _check(cond: bool, msg: str, exc=ValueError) -> None:
    if not cond:
        raise exc(f"w8_matmul_cuda: {msg}")


def w8_matmul_cuda(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                   route: str | None = None) -> torch.Tensor:
    """``x (..., K) @ W`` on the card → (..., N) in x's dtype, as
    :func:`w8_matmul_reference` (see the module docstring for the
    routes). ``route=None`` takes :func:`_route`'s; ``"gemv"`` forces the
    CUDA-core kernel on a call of at most MAX_ROWS rows."""
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
    lead = x.shape[:-1]
    M = x.numel() // K if K else 0
    own = _route(x.dtype, M, K, N)
    _check(route in (None, own) or (route == "gemv" and own == "tc"),
           f"route {route!r} does not take {M} rows of {x.dtype} by a "
           f"{K} x {N} weight")
    route = route or own
    for name, t in (("x", x), ("q", q), ("s", s)):
        _check(t.is_cuda and t.device == x.device,
               f"needs CUDA tensors on one device; {name} is on {t.device}")
    if route == "dequant":
        w8_matmul_cuda.route_launches["dequant"] += 1
        return w8_matmul_reference(x, q, s)
    align = 16 if route == "tc" else 8
    _check(N % 8 == 0 and q.is_contiguous() and q.data_ptr() % align == 0,
           f"takes a contiguous, {align}-byte aligned weight of a multiple "
           f"of 8 columns; got {tuple(q.shape)} strides {q.stride()}")
    x2 = x.reshape(M, K).contiguous()
    if x2.data_ptr() % 16:
        x2 = x2.clone()
    s = s.contiguous()
    dev = x.device
    y = torch.empty((M, N), dtype=x.dtype, device=dev)
    fn = load_kernel(route)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if route == "tc":
            cs, kb = tc_split(K, N)
            err = fn(x2.data_ptr(), q.data_ptr(), s.data_ptr(), y.data_ptr(),
                     M, K, N, kb, cs, stream)
        else:
            cs, kb = k_split(K, N)
            err = fn(x2.data_ptr(), q.data_ptr(), s.data_ptr(), y.data_ptr(),
                     M, K, N, kb, cs, int(x.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"{ENTRY[route]} kernel launch failed: CUDA error "
                           f"{err}")
    w8_matmul_cuda.launches += 1
    w8_matmul_cuda.route_launches[route] += 1
    return y.reshape(*lead, N)


w8_matmul_cuda.launches = 0
w8_matmul_cuda.route_launches = {"tc": 0, "gemv": 0, "dequant": 0}


def w8_matmul(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
              use_kernel: bool | None = None) -> torch.Tensor:
    """The weight-only int8 matmul on either lane (see the module
    docstring)."""
    if use_kernel is None:
        use_kernel = x.is_cuda
    if not use_kernel:
        return w8_matmul_reference(x, q, s)
    return w8_matmul_cuda(x, q, s)
