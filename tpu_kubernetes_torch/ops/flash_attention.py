"""Causal flash attention, forward and backward (port of
``tpu_kubernetes/ops/flash_attention.py``).

* :func:`attention_reference` — the plain PyTorch forward, numerically the
  reference's ``attention_reference`` (f32 scores, ``-1e30`` mask aligned
  bottom-right, f32 softmax, P cast to ``v.dtype`` before P·V).
* :func:`attention_bwd_reference` — the plain version of both backward
  kernels (:func:`attention_bwd_dq_reference`,
  :func:`attention_bwd_dkv_reference`, each recomputing P as its kernel
  does): P from the forward's log-sum-exp, ``delta = rowsum(dO·O)`` and
  ``dS = P·(dP − delta)·sm_scale`` in f32.
* :func:`flash_fwd_cuda`, :func:`flash_bwd_dq_cuda`,
  :func:`flash_bwd_dkv_cuda` — the wrappers of the hand-written Hopper
  kernels (``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``), which replace the
  Pallas ``_fwd_kernel``, ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``. Each
  has a ``launches`` attribute that counts the launches it made;
  :func:`flash_bwd_cuda` computes ``delta`` and calls both backward ones.
  The forward has two routes, chosen by :func:`_route` from the dtype
  and head_dim alone: ``"tc"`` (entry ``flash_fwd_tc``, wgmma fed by TMA,
  bf16 at head_dim 64/128) and ``"simt"`` (entry ``flash_fwd``, the CUDA-core
  kernel: f32, and head_dim 16/32); ``flash_fwd_cuda.route_launches``
  counts the launches of each. Both backward kernels have the same two
  routes, by the same rule: dQ ``"tc"`` (entry ``flash_bwd_dq_tc``) and
  ``"simt"`` (entry ``flash_bwd_dq``), counted in
  ``flash_bwd_dq_cuda.route_launches``; dK/dV ``"tc"`` (entry
  ``flash_bwd_dkv_tc``) and ``"simt"`` (entry ``flash_bwd_dkv``), counted
  in ``flash_bwd_dkv_cuda.route_launches``.
* :func:`flash_attention` — the dispatcher with the reference's contract:
  ``use_kernel=None`` picks the kernels for CUDA tensors and the plain
  version (under autograd) for CPU tensors; the config's block sizes are
  fit to the sequence with :func:`_fit_block` and an indivisible length
  raises the reference's ``ValueError``. The kernel lane is an autograd
  function (the reference's ``jax.custom_vjp``): its backward runs the
  two backward kernels. A CUDA tensor launches the kernels or raises:
  there is no fallback lane.
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
TC_HEAD_DIMS = (64, 128)
# the C entry point of each route: the forward's, the dQ and the dK/dV
# kernel's
FWD_ENTRY = {"tc": "flash_fwd_tc", "simt": "flash_fwd"}
DQ_ENTRY = {"tc": "flash_bwd_dq_tc", "simt": "flash_bwd_dq"}
DKV_ENTRY = {"tc": "flash_bwd_dkv_tc", "simt": "flash_bwd_dkv"}


def _scores(q, k, causal: bool, sm_scale: float) -> torch.Tensor:
    """f32 scores ``sm_scale·Q·Kᵀ``, masked to ``-1e30`` above the
    offset-aligned diagonal when causal."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if causal:
        seq_q, seq_k = s.shape[-2], s.shape[-1]
        mask = torch.ones(seq_q, seq_k, dtype=torch.bool,
                          device=s.device).tril(seq_k - seq_q)
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    return s


def attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
    sm_scale: float | None = None,
) -> torch.Tensor:
    """Plain attention. q, k, v: (batch, heads, seq, head_dim)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    p = torch.softmax(_scores(q, k, causal, sm_scale), dim=-1)
    return torch.einsum(
        "bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float()
    ).to(q.dtype)


def logsumexp_reference(q, k, causal: bool, sm_scale: float) -> torch.Tensor:
    """The forward kernel's second output, plainly: (b, h, seq_q) f32."""
    return torch.logsumexp(_scores(q, k, causal, sm_scale), dim=-1)


def _probs_and_ds(q, k, v, do, lse, delta, causal, sm_scale):
    """P = exp(s − lse) and dS = P·(dO·Vᵀ − delta)·sm_scale, f32."""
    p = torch.exp(_scores(q, k, causal, sm_scale) - lse[..., None])
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float())
    return p, p * (dp - delta[..., None]) * sm_scale


def attention_bwd_dq_reference(q, k, v, do, lse, delta, causal: bool,
                               sm_scale: float) -> torch.Tensor:
    """The plain version of the dQ kernel: dS·K, in q's dtype."""
    _, ds = _probs_and_ds(q, k, v, do, lse, delta, causal, sm_scale)
    return torch.einsum("bhqk,bhkd->bhqd", ds, k.float()).to(q.dtype)


def attention_bwd_dkv_reference(q, k, v, do, lse, delta, causal: bool,
                                sm_scale: float
                                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the dK/dV kernel: (dSᵀ·Q, Pᵀ·dO) in k's and
    v's dtypes."""
    p, ds = _probs_and_ds(q, k, v, do, lse, delta, causal, sm_scale)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def attention_bwd_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    lse: torch.Tensor, do: torch.Tensor, causal: bool, sm_scale: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of both backward kernels (the reference's
    ``_bwd``): → (dq, dk, dv) in the inputs' dtypes, from the forward's
    O and unbroadcast f32 LSE (b, h, seq_q)."""
    delta = (do.float() * o.float()).sum(-1)
    dq = attention_bwd_dq_reference(q, k, v, do, lse, delta, causal, sm_scale)
    dk, dv = attention_bwd_dkv_reference(q, k, v, do, lse, delta, causal,
                                         sm_scale)
    return dq, dk, dv


def _check_kernel_inputs(name: str, q, k, v, causal: bool) -> None:
    for arg, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(
                f"{name} needs CUDA tensors; {arg} is on {t.device}"
            )
        if t.dtype != q.dtype or t.dtype not in KERNEL_DTYPES:
            raise TypeError(
                f"{name} takes q, k, v all bfloat16 or all float32; "
                f"got {q.dtype}, {k.dtype}, {v.dtype}"
            )
        if t.dim() != 4 or not t.is_contiguous():
            raise ValueError(
                f"{name} takes contiguous (batch, heads, seq, head_dim) "
                f"tensors; {arg} has shape {tuple(t.shape)}, strides "
                f"{t.stride()}"
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
            f"{name} takes head_dim in {KERNEL_HEAD_DIMS}, got {d}"
        )
    if seq_q == 0 or k.shape[2] == 0 or b * h == 0:
        raise ValueError(f"{name} needs non-empty tensors")
    if causal and seq_q > k.shape[2]:
        raise ValueError(
            f"causal {name} needs seq_q <= seq_k, got {seq_q} > "
            f"{k.shape[2]}"
        )


def _check_bwd_inputs(name: str, q, k, v, do, lse, delta, causal) -> None:
    _check_kernel_inputs(name, q, k, v, causal)
    if (do.shape != q.shape or do.dtype != q.dtype
            or do.device != q.device or not do.is_contiguous()):
        raise ValueError(
            f"{name} takes dO contiguous and like q {tuple(q.shape)} "
            f"{q.dtype}; got {tuple(do.shape)} {do.dtype}, strides "
            f"{do.stride()}"
        )
    for arg, t in (("lse", lse), ("delta", delta)):
        if (t.shape != q.shape[:3] or t.dtype != torch.float32
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError(
                f"{name} takes {arg} contiguous float32 "
                f"{tuple(q.shape[:3])}; got {tuple(t.shape)} {t.dtype}"
            )


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _route(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel (forward, dQ or dK/dV) that serves a call: ``"tc"`` (tensor
    cores) for bf16 at head_dim 64 or 128, ``"simt"`` (the CUDA-core
    kernels) for f32, which the port never runs on TF32, and for head_dim
    16 and 32."""
    if dtype == torch.bfloat16 and head_dim in TC_HEAD_DIMS:
        return "tc"
    return "simt"


def _pick_route(name: str, q, route: str | None) -> str:
    """``route``, or :func:`_route`'s when it is None; raises when
    ``route`` does not take q's dtype and head_dim ("simt" takes any)."""
    own = _route(q.dtype, q.shape[-1])
    if route not in (None, own, "simt"):
        raise ValueError(f"{name}: route {route!r} does not take "
                         f"{q.dtype} at head_dim {q.shape[-1]}")
    return route or own


def _launch(wrapper, entry: str, fn, args: list, route: str, q,
            causal: bool, sm_scale: float) -> None:
    """Call the C entry ``fn`` (named ``entry``) on q's device and current
    stream, with ``is_bf16`` for the CUDA-core route; raise when the launch
    is refused, else count it on ``wrapper``."""
    if route == "simt":
        args = [*args, int(q.dtype == torch.bfloat16)]
    with torch.cuda.device(q.device):
        err = fn(*args, int(bool(causal)), float(sm_scale), _stream(q.device))
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {err}")
    wrapper.launches += 1
    wrapper.route_launches[route] += 1


def load_kernel(route: str):
    """The forward's C entry point of ``route`` (``csrc/flash_fwd.cu``),
    built by ``nvcc`` on the first call of the process if its library is
    missing. ``flash_fwd`` (simt): (q, k, v, o, lse, batch·heads, seq_q,
    seq_k, head_dim, is_bf16, causal, sm_scale, stream); ``flash_fwd_tc``
    (tc): the same without ``is_bf16``. → CUDA error code."""
    from tpu_kubernetes_torch.ops import _build

    ints = 6 if route == "simt" else 5
    return _build.load(FWD_ENTRY[route], [ctypes.c_void_p] * 5
                       + [ctypes.c_int] * ints
                       + [ctypes.c_float, ctypes.c_void_p], library="flash_fwd")


def load_bwd_kernels(route: str):
    """The two C entry points of ``route`` in ``csrc/flash_bwd.cu``, built
    on first use: the dQ kernel — ``flash_bwd_dq`` (simt) or
    ``flash_bwd_dq_tc`` (tc): (q, k, v, dO, lse, delta, dq, …) — and the
    dK/dV kernel — ``flash_bwd_dkv`` (simt) or ``flash_bwd_dkv_tc`` (tc):
    (q, k, v, dO, lse, delta, dk, dv, …) — each then (batch·heads, seq_q,
    seq_k, head_dim, is_bf16, causal, sm_scale, stream), without
    ``is_bf16`` for tc → CUDA error code."""
    from tpu_kubernetes_torch.ops import _build

    tail = ([ctypes.c_int] * (6 if route == "simt" else 5)
            + [ctypes.c_float, ctypes.c_void_p])
    return (_build.load(DQ_ENTRY[route], [ctypes.c_void_p] * 7 + tail,
                        library="flash_bwd"),
            _build.load(DKV_ENTRY[route], [ctypes.c_void_p] * 8 + tail,
                        library="flash_bwd"))


def flash_fwd_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
    sm_scale: float, route: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the Hopper flash-attention forward on the current stream.
    → (O like q, LSE f32 (batch, heads, seq_q)). ``route=None`` takes
    :func:`_route`'s; ``"simt"`` runs the CUDA-core kernel on any
    input it takes (the comparisons in ``chip_smoke.py``). Raises on
    anything the kernel does not take, and when the launch is refused."""
    route = _pick_route("flash_fwd_cuda", q, route)
    _check_kernel_inputs("flash_fwd_cuda", q, k, v, causal)
    b, h, seq_q, d = q.shape
    fn = load_kernel(route)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, seq_q), dtype=torch.float32, device=q.device)
    _launch(flash_fwd_cuda, FWD_ENTRY[route], fn,
            [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             lse.data_ptr(), b * h, seq_q, k.shape[2], d],
            route, q, causal, sm_scale)
    return o, lse


flash_fwd_cuda.launches = 0
flash_fwd_cuda.route_launches = {"tc": 0, "simt": 0}


def flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal: bool,
                      sm_scale: float, route: str | None = None
                      ) -> torch.Tensor:
    """Launch the dQ kernel on the current stream → dq like q. ``lse`` and
    ``delta`` are f32 (batch, heads, seq_q); ``do`` is contiguous.
    ``route=None`` takes :func:`_route`'s; ``"simt"`` runs the CUDA-core
    kernel on any input it takes (the comparisons in ``chip_smoke.py``)."""
    route = _pick_route("flash_bwd_dq_cuda", q, route)
    _check_bwd_inputs("flash_bwd_dq_cuda", q, k, v, do, lse, delta, causal)
    fn, _ = load_bwd_kernels(route)
    b, h, seq_q, d = q.shape
    dq = torch.empty_like(q)
    _launch(flash_bwd_dq_cuda, DQ_ENTRY[route], fn,
            [q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b * h, seq_q,
             k.shape[2], d],
            route, q, causal, sm_scale)
    return dq


flash_bwd_dq_cuda.launches = 0
flash_bwd_dq_cuda.route_launches = {"tc": 0, "simt": 0}


def flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal: bool,
                       sm_scale: float, route: str | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the dK/dV kernel on the current stream → (dk like k, dv
    like v). ``route=None`` takes :func:`_route`'s; ``"simt"`` runs the
    CUDA-core kernel on any input it takes (the comparisons in
    ``chip_smoke.py``)."""
    route = _pick_route("flash_bwd_dkv_cuda", q, route)
    _check_bwd_inputs("flash_bwd_dkv_cuda", q, k, v, do, lse, delta, causal)
    _, fn = load_bwd_kernels(route)
    b, h, seq_q, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch(flash_bwd_dkv_cuda, DKV_ENTRY[route], fn,
            [q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             b * h, seq_q, k.shape[2], d],
            route, q, causal, sm_scale)
    return dk, dv


flash_bwd_dkv_cuda.launches = 0
flash_bwd_dkv_cuda.route_launches = {"tc": 0, "simt": 0}


def flash_bwd_cuda(q, k, v, o, lse, do, causal: bool, sm_scale: float
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward of :func:`flash_fwd_cuda` → (dq, dk, dv), both
    kernels on the route the dtype and head_dim pick. ``delta =
    rowsum(dO·O)`` is a torch op in f32, as the reference computes it
    outside Pallas; ``do`` may be a strided view (the gradient of the
    model's ``attn.transpose(1, 2)``) and is made contiguous here."""
    do = do.contiguous()
    delta = (do.float() * o.float()).sum(-1)
    dq = flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal, sm_scale)
    dk, dv = flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal, sm_scale)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The kernel lane under autograd: the forward kernel, and a backward
    that runs the two backward kernels from the saved O and LSE."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, sm_scale: float):
        o, lse = flash_fwd_cuda(q, k, v, causal, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd_cuda(q, k, v, o, lse, do, ctx.causal,
                                    ctx.sm_scale)
        return dq, dk, dv, None, None


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
    """Attention over (batch, heads, seq, head_dim) tensors, differentiable
    in q, k and v on both lanes.

    ``use_kernel=None`` picks the CUDA kernels when q lies on a CUDA device
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
    return _FlashAttention.apply(q, k, v, causal, sm_scale)
