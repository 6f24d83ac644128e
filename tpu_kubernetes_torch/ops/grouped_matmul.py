"""Grouped (ragged) matmul, forward and backward (port of
``tpu_kubernetes/ops/grouped_matmul.py``): the dropless-MoE expert GEMM.

``grouped_matmul(lhs, rhs, group_sizes)`` multiplies contiguous row groups
of ``lhs`` (M, K) by per-group weights ``rhs`` (E, K, N): rows
``[off_e, off_{e+1})`` (offsets = running sum of the group sizes) go
through ``rhs[e]``.

* :func:`grouped_matmul_reference` — the plain version of the forward
  kernel: E masked full products summed in f32; rows past
  ``sum(group_sizes)`` are zero.
* :func:`gmm_drhs_reference` — the plain version of the weight-gradient
  kernel: per group ``lhs[rows_e]ᵀ @ dout[rows_e]`` in f32, empty groups
  zero.
* :func:`gmm_cuda`, :func:`gmm_drhs_cuda` — the wrappers of the
  hand-written Hopper kernels (``csrc/grouped_matmul.cu``), which replace
  the Pallas ``_gmm_kernel`` and ``_gmm_drhs_kernel``. Each has a
  ``launches`` attribute that counts the launches it made. The group sizes
  stay on the device: no call waits for the host. Each kernel has two
  routes, chosen from the dtype alone by :func:`_route`: ``"tc"`` (entries ``gmm_forward_tc`` and
  ``gmm_drhs_tc``, wgmma fed by a TMA ring, bf16) and ``"simt"`` (entries
  ``gmm_forward`` and ``gmm_drhs``, the CUDA-core kernels, f32);
  ``gmm_cuda.route_launches`` and ``gmm_drhs_cuda.route_launches`` count
  the launches of each.
* :func:`grouped_matmul` — the dispatcher with the reference's contract:
  ``use_kernel=None`` picks the kernels for CUDA tensors and the plain
  version (under autograd) for CPU tensors. The kernel lane checks the
  reference's block and 128-multiple rules (which it raises on before it
  looks at the device) and is an autograd function (the reference's
  ``jax.custom_vjp``): dlhs runs the forward kernel against ``rhsᵀ``
  (read transposed in place, no copy), drhs the weight-gradient kernel,
  each on the route the dtype picks.
  A CUDA tensor launches the kernels or raises: there is no fallback
  lane.

The forward kernel is reached through the custom op
``tpu_kubernetes_torch::gmm``, so that a selective-checkpoint policy can
see it: remat "moe" (``models/llama.py``) saves the product that carries
the checkpoint name ``moe_expert_out`` instead of launching it again.
"""

from __future__ import annotations

import ctypes

import torch

from tpu_kubernetes_torch.ops.flash_attention import _fit_block, _stream

DEFAULT_BLOCK_M = 128
DEFAULT_BLOCK_N = 512
DEFAULT_BLOCK_K = 512
KERNEL_DTYPES = (torch.bfloat16, torch.float32)
# the C entry point of each route: the forward's and the weight gradient's
GMM_ENTRY = {"tc": "gmm_forward_tc", "simt": "gmm_forward"}
DRHS_ENTRY = {"tc": "gmm_drhs_tc", "simt": "gmm_drhs"}


def _row_groups(group_sizes: torch.Tensor, m: int, device):
    """(gid (M,) group of each row, valid (M,) row below sum(sizes))."""
    off = torch.cumsum(group_sizes.to(device=device, dtype=torch.int64), 0)
    rows = torch.arange(m, device=device)
    gid = torch.searchsorted(off, rows, right=True)
    return gid, rows < off[-1]


def grouped_matmul_reference(lhs: torch.Tensor, rhs: torch.Tensor,
                             group_sizes: torch.Tensor) -> torch.Tensor:
    """Plain grouped matmul: E full products with row masks, summed in
    f32, cast to lhs's dtype. O(E·M·K·N) operations: the oracle and the
    CPU lane."""
    m = lhs.shape[0]
    gid, valid = _row_groups(group_sizes, m, lhs.device)
    acc = torch.zeros((m, rhs.shape[-1]), dtype=torch.float32,
                      device=lhs.device)
    for e in range(rhs.shape[0]):
        sel = ((gid == e) & valid)[:, None]
        acc = acc + torch.where(sel, lhs.float() @ rhs[e].float(), 0.0)
    return acc.to(lhs.dtype)


def gmm_drhs_reference(lhs: torch.Tensor, dout: torch.Tensor,
                       group_sizes: torch.Tensor, n_groups: int,
                       out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version of the weight-gradient kernel: (n_groups, K, N), group
    e's ``lhs[rows_e]ᵀ @ dout[rows_e]`` in f32 (zero for an empty group),
    cast to ``out_dtype``."""
    gid, valid = _row_groups(group_sizes, lhs.shape[0], lhs.device)
    out = [torch.where(((gid == e) & valid)[:, None], lhs.float(), 0.0).T
           @ dout.float() for e in range(n_groups)]
    return torch.stack(out).to(out_dtype)


def _check(name: str, cond: bool, msg: str, exc=ValueError) -> None:
    if not cond:
        raise exc(f"{name}: {msg}")


def _check_operands(name: str, a: torch.Tensor, b_name: str,
                    b: torch.Tensor, group_sizes: torch.Tensor) -> None:
    """lhs and the other operand CUDA, contiguous, one kernel dtype;
    group_sizes a contiguous int32 vector on their device."""
    for arg, t in (("lhs", a), (b_name, b)):
        _check(name, t.is_cuda, f"needs CUDA tensors; {arg} is on {t.device}")
        _check(name, t.is_contiguous(),
               f"{arg} must be contiguous, strides {t.stride()}")
    _check(name, a.device == b.device, "operands must be on one device")
    _check(name, a.dtype == b.dtype and a.dtype in KERNEL_DTYPES,
           f"takes operands all bfloat16 or all float32; got {a.dtype}, "
           f"{b.dtype}", TypeError)
    _check(name, group_sizes.dtype == torch.int32
           and group_sizes.device == a.device and group_sizes.dim() == 1
           and group_sizes.is_contiguous(),
           f"group_sizes must be a contiguous int32 vector on {a.device}; "
           f"got {group_sizes.dtype} {tuple(group_sizes.shape)} on "
           f"{group_sizes.device}")


def _check_dims(name: str, m: int, k: int, n: int) -> None:
    _check(name, m > 0, f"needs rows, got M = {m}")
    _check(name, k % 128 == 0, f"K = {k} must be a multiple of 128")
    _check(name, n % 128 == 0, f"N = {n} must be a multiple of 128")


def _route(dtype: torch.dtype) -> str:
    """The kernels that serve a call, the forward and the weight gradient
    alike: ``"tc"`` (tensor cores) for bf16, ``"simt"`` (the CUDA-core
    kernels) for f32, which the port never runs on TF32."""
    return "tc" if dtype == torch.bfloat16 else "simt"


def load_kernels(route: str = "simt"):
    """The two C entry points of ``route`` in ``csrc/grouped_matmul.cu``,
    built by ``nvcc`` on first use: the forward — ``gmm_forward`` (simt:
    lhs, rhs, group_sizes, out, m, k, n, e, is_bf16, trans_rhs, stream) or
    ``gmm_forward_tc`` (tc: the same without ``is_bf16``) — and the weight
    gradient — ``gmm_drhs`` (simt: lhs, dout, group_sizes, drhs, m, k, n,
    e, is_bf16, stream) or ``gmm_drhs_tc`` (tc: the same without
    ``is_bf16``) → CUDA error code."""
    from tpu_kubernetes_torch.ops import _build

    ptrs = [ctypes.c_void_p] * 4
    ints = 6 if route == "simt" else 5      # the weight gradient: no trans_rhs
    return (_build.load(GMM_ENTRY[route], ptrs + [ctypes.c_int] * ints
                        + [ctypes.c_void_p], library="grouped_matmul"),
            _build.load(DRHS_ENTRY[route], ptrs + [ctypes.c_int] * (ints - 1)
                        + [ctypes.c_void_p], library="grouped_matmul"))


def gmm_cuda(lhs: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor,
             trans_rhs: bool = False, route: str | None = None
             ) -> torch.Tensor:
    """Launch the grouped-matmul kernel on the current stream: out (M, N)
    in lhs's dtype, group e's rows ``lhs[rows_e] @ rhs[e]``, where rhs is
    (E, K, N); with ``trans_rhs`` rhs is (E, N, K) and the rows multiply
    ``rhs[e]ᵀ``. Rows past ``sum(group_sizes)`` come out zero. ``route=None``
    takes :func:`_route`'s; ``"simt"`` runs the CUDA-core kernel on
    either dtype (the comparisons in ``chip_smoke.py``). Raises on anything
    the kernel does not take, and when the launch is refused."""
    name = "gmm_cuda"
    own = _route(lhs.dtype)
    _check(name, route in (None, own, "simt"),
           f"route {route!r} does not take {lhs.dtype}")
    route = route or own
    _check_operands(name, lhs, "rhs", rhs, group_sizes)
    _check(name, lhs.dim() == 2 and rhs.dim() == 3,
           f"takes lhs (M, K) and rhs (E, K, N); got {tuple(lhs.shape)}, "
           f"{tuple(rhs.shape)}")
    m, k = lhs.shape
    e, k2, n = (rhs.shape[0], rhs.shape[2], rhs.shape[1]) if trans_rhs \
        else rhs.shape
    _check(name, k == k2 and group_sizes.shape == (e,),
           f"shape mismatch: lhs {tuple(lhs.shape)}, rhs {tuple(rhs.shape)} "
           f"(trans_rhs={trans_rhs}), group_sizes {tuple(group_sizes.shape)}")
    _check_dims(name, m, k, n)
    fn, _ = load_kernels(route)
    out = torch.empty((m, n), dtype=lhs.dtype, device=lhs.device)
    args = [lhs.data_ptr(), rhs.data_ptr(), group_sizes.data_ptr(),
            out.data_ptr(), m, k, n, e]
    if route == "simt":
        args.append(int(lhs.dtype == torch.bfloat16))
    with torch.cuda.device(lhs.device):
        err = fn(*args, int(bool(trans_rhs)), _stream(lhs.device))
    if err != 0:
        raise RuntimeError(f"{GMM_ENTRY[route]} kernel launch failed: CUDA "
                           f"error {err}")
    gmm_cuda.launches += 1
    gmm_cuda.route_launches[route] += 1
    return out


gmm_cuda.launches = 0
gmm_cuda.route_launches = {"tc": 0, "simt": 0}


def gmm_drhs_cuda(lhs: torch.Tensor, dout: torch.Tensor,
                  group_sizes: torch.Tensor, route: str | None = None
                  ) -> torch.Tensor:
    """Launch the weight-gradient kernel on the current stream → drhs
    (E, K, N) in lhs's dtype, group e's ``lhs[rows_e]ᵀ @ dout[rows_e]``,
    zero for an empty group. E is ``group_sizes.shape[0]``. ``route=None``
    takes :func:`_route`'s; ``"simt"`` runs the CUDA-core kernel on
    either dtype (the comparisons in ``chip_smoke.py``)."""
    name = "gmm_drhs_cuda"
    own = _route(lhs.dtype)
    _check(name, route in (None, own, "simt"),
           f"route {route!r} does not take {lhs.dtype}")
    route = route or own
    _check_operands(name, lhs, "dout", dout, group_sizes)
    _check(name, lhs.dim() == 2 and dout.dim() == 2
           and lhs.shape[0] == dout.shape[0],
           f"takes lhs (M, K) and dout (M, N); got {tuple(lhs.shape)}, "
           f"{tuple(dout.shape)}")
    (m, k), n, e = lhs.shape, dout.shape[1], group_sizes.shape[0]
    _check_dims(name, m, k, n)
    _check(name, e > 0, "needs at least one group")
    _, fn = load_kernels(route)
    drhs = torch.empty((e, k, n), dtype=lhs.dtype, device=lhs.device)
    args = [lhs.data_ptr(), dout.data_ptr(), group_sizes.data_ptr(),
            drhs.data_ptr(), m, k, n, e]
    if route == "simt":
        args.append(int(lhs.dtype == torch.bfloat16))
    with torch.cuda.device(lhs.device):
        err = fn(*args, _stream(lhs.device))
    if err != 0:
        raise RuntimeError(f"{DRHS_ENTRY[route]} kernel launch failed: CUDA "
                           f"error {err}")
    gmm_drhs_cuda.launches += 1
    gmm_drhs_cuda.route_launches[route] += 1
    return drhs


gmm_drhs_cuda.launches = 0
gmm_drhs_cuda.route_launches = {"tc": 0, "simt": 0}


@torch.library.custom_op("tpu_kubernetes_torch::gmm", mutates_args=())
def _gmm_op(lhs: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor,
            checkpoint_name: str) -> torch.Tensor:
    """The forward kernel as an op a checkpoint policy can see; the name
    is read only by the policy (``models/llama.py:remat_policy_kwargs``)."""
    return gmm_cuda(lhs, rhs, group_sizes)


class _GroupedMatmul(torch.autograd.Function):
    """The kernel lane under autograd (the reference's ``_gmm`` custom
    VJP): the forward kernel, then dlhs = the forward kernel on dout and
    rhsᵀ and drhs = the weight-gradient kernel. group_sizes gets no
    gradient."""

    @staticmethod
    def forward(ctx, lhs, rhs, group_sizes, checkpoint_name):
        ctx.save_for_backward(lhs, rhs, group_sizes)
        return torch.ops.tpu_kubernetes_torch.gmm(lhs, rhs, group_sizes,
                                                  checkpoint_name)

    @staticmethod
    def backward(ctx, dout):
        lhs, rhs, group_sizes = ctx.saved_tensors
        dout = dout.contiguous()
        dlhs = drhs = None
        if ctx.needs_input_grad[0]:
            dlhs = gmm_cuda(dout, rhs, group_sizes, trans_rhs=True)
        if ctx.needs_input_grad[1]:
            drhs = gmm_drhs_cuda(lhs, dout, group_sizes)
        return dlhs, drhs, None, None


def grouped_matmul(
    lhs: torch.Tensor,
    rhs: torch.Tensor,
    group_sizes: torch.Tensor,
    *,
    block_m: int = DEFAULT_BLOCK_M,
    block_n: int = DEFAULT_BLOCK_N,
    block_k: int = DEFAULT_BLOCK_K,
    use_kernel: bool | None = None,
    checkpoint_name: str = "",
) -> torch.Tensor:
    """Per-group matmul over contiguous row groups, differentiable in lhs
    and rhs on both lanes.

    lhs (M, K) with group e on rows [Σ_{i<e} sizes, Σ_{i≤e} sizes); rhs
    (E, K, N); group_sizes (E,) int → (M, N) in lhs's dtype.

    ``use_kernel=None`` picks the CUDA kernels when lhs lies on a CUDA
    device and the plain version when it lies on the CPU; ``False`` forces
    the plain version (the comparisons in tests and ``chip_smoke.py``).
    The kernel lane keeps the reference's contract: M divisible by the
    fitted ``block_m``, N by the fitted ``block_n``, K and N multiples of
    128 (the backward swaps them), each refused with the reference's
    ``ValueError``. The blocks fix only which shapes are accepted (the
    kernel tiles on its own; ``block_k`` never refuses a K that is a
    multiple of 128). The model pads the last group so that
    ``sum(group_sizes) == M``; rows past the sum come out zero on both
    lanes. ``checkpoint_name`` names the kernel lane's output for remat
    "moe" (``jax.ad_checkpoint.checkpoint_name`` in the reference)."""
    del block_k
    m, k = lhs.shape
    e, k2, n = rhs.shape
    if k != k2 or tuple(group_sizes.shape) != (e,):
        raise ValueError(
            f"shape mismatch: lhs {tuple(lhs.shape)}, rhs {tuple(rhs.shape)}, "
            f"group_sizes {tuple(group_sizes.shape)}"
        )
    if use_kernel is None:
        use_kernel = lhs.is_cuda
    if not use_kernel:
        return grouped_matmul_reference(lhs, rhs, group_sizes)

    block_m = _fit_block(block_m, m)
    block_n = _fit_block(block_n, n)
    if m % block_m or n % block_n:
        raise ValueError(
            f"(M, N) = ({m}, {n}) must be divisible by blocks "
            f"({block_m}, {block_n})"
        )
    if k % 128:
        raise ValueError(f"K = {k} must be a multiple of 128")
    if n % 128:
        raise ValueError(f"N = {n} must be a multiple of 128")
    return _GroupedMatmul.apply(lhs, rhs, group_sizes.to(torch.int32),
                                checkpoint_name)
