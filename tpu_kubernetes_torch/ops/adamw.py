"""The fused AdamW update of the train step, in place (a kernel of the port
alone: the JAX package leaves the optax update to XLA, which fuses it
inside the jitted step, ``tpu_kubernetes/train/trainer.py``
``make_optimizer``).

* :func:`global_norm_reference`, :func:`adamw_update_reference_` — the
  plain versions: the global gradient norm (f32 sums of squares, added
  leaf by leaf) and the per-leaf AdamW loop, in place. The CPU runs them
  and the tests compare against them.
* :func:`global_norm_cuda`, :func:`adamw_update_cuda_` — the wrappers of
  the hand-written kernels of ``csrc/adamw.cu`` (``adamw_sumsq``: per-block
  partial sums and one ordered reduce, no float atomics, so a replay gives
  the same norm every time; ``adamw_update``: every leaf in one launch,
  each operation rounded once). Each has a ``launches`` attribute that
  counts the launches it made. Given the same norm, the update is the
  plain version's bit for bit.
* :func:`adamw_` — the dispatcher the optimizer calls: CPU leaves take the
  plain versions; CUDA leaves launch both kernels or raise (the norm's
  alone is skipped when there is no clip, as in the LoRA optimizer).
  :func:`global_norm` is the norm's dispatcher, which Adafactor's clip
  calls too.

The per-element arithmetic is optax's ``chain(clip_by_global_norm(clip),
adamw(lr_t, b1, b2, eps, wd))`` as ``train/trainer.py``'s ``AdamW``
documents it. The step's scalars (the step size, minus the learning rate
of the count before it moves, and the two bias corrections of the count
after) come in as one (3,) f32 tensor on the leaves' device, so nothing
here reads the device from the host.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import torch

KERNEL_DTYPES = (torch.bfloat16, torch.float32)


@dataclass(frozen=True)
class Hyper:
    """AdamW's constants, as the optimizer holds them."""

    b1: float
    b2: float
    eps: float
    weight_decay: float
    grad_clip: float


def global_norm_reference(grads: list[torch.Tensor]) -> torch.Tensor:
    """√Σ g² over every leaf, in f32: the plain version of ``adamw_sumsq``."""
    return torch.sqrt(sum(torch.sum(g.float() * g.float()) for g in grads))


def clip_factors(norm: torch.Tensor, clip: float, dtype: torch.dtype
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """optax ``clip_by_global_norm``'s select (its ``<``), made on the
    device, as a divisor and a factor for leaves of ``dtype`` (f32 0-d
    tensors): the norm cast to the leaf's dtype and ``clip`` at or above
    the clip; 1 and 1 below it, so a leaf is divided and multiplied by 1
    and stays exactly itself, and no pass is added to the clip's two."""
    keep = norm < clip
    return (torch.where(keep, 1.0, norm.to(dtype).float()),
            torch.where(keep, 1.0, clip))


def adamw_update_reference_(grads, params, mus, nus, norm: torch.Tensor,
                            scalars: torch.Tensor, h: Hyper) -> None:
    """The plain version of ``adamw_update``: each leaf's params, mu and nu
    updated in place from its gradient, the global ``norm`` and
    ``scalars`` = (step size, 1 − b1^t, 1 − b2^t)."""
    step_size, bc1, bc2 = scalars[0], scalars[1], scalars[2]
    clip_by = {}                # per leaf dtype
    for g, p, mu, nu in zip(grads, params, mus, nus):
        if p.dtype not in clip_by:
            clip_by[p.dtype] = (*clip_factors(norm, h.grad_clip, p.dtype),
                                step_size.to(p.dtype).float())
        div, mul, lr = clip_by[p.dtype]
        g = g.float() / div * mul
        mu32 = (1 - h.b1) * g + h.b1 * mu.float()
        nu32 = (1 - h.b2) * (g * g) + h.b2 * nu.float()
        mu.copy_(mu32)
        nu.copy_(nu32)
        u = (mu32 / bc1) / (torch.sqrt(nu32 / bc2) + h.eps)
        u = u + h.weight_decay * p.float()
        p.copy_(p.float() + lr * u)


def _check(name: str, cond: bool, msg: str, exc=ValueError) -> None:
    if not cond:
        raise exc(f"{name}: {msg}")


def _leaf_args(name: str, leaves: list[torch.Tensor], *others):
    """(n, numel array, is_bf16 array, pointer arrays of ``leaves`` and of
    each list in ``others``); raises on what the kernels do not take."""
    _check(name, len(leaves) > 0, "needs at least one leaf")
    dev = leaves[0].device
    for group in (leaves, *others):
        _check(name, len(group) == len(leaves),
               "every list must hold one tensor per leaf")
        for t, ref in zip(group, leaves):
            _check(name, t.is_cuda and t.device == dev,
                   f"needs CUDA tensors on one device; got {t.device}")
            _check(name, t.dtype == ref.dtype and t.dtype in KERNEL_DTYPES,
                   f"takes bfloat16 or float32 leaves, alike across lists; "
                   f"got {t.dtype} beside {ref.dtype}", TypeError)
            _check(name, t.shape == ref.shape and t.is_contiguous(),
                   f"takes contiguous leaves of one shape; got "
                   f"{tuple(t.shape)} beside {tuple(ref.shape)}")
    n = len(leaves)
    numel = (ctypes.c_longlong * n)(*(t.numel() for t in leaves))
    is_bf16 = (ctypes.c_int * n)(*(int(t.dtype == torch.bfloat16)
                                   for t in leaves))
    ptrs = [(ctypes.c_void_p * n)(*(t.data_ptr() for t in group))
            for group in (leaves, *others)]
    return n, numel, is_bf16, ptrs


def load_kernels():
    """The C entry points of ``csrc/adamw.cu``, built by ``nvcc`` on first
    use: ``adamw_blocks`` (n, numel → the launch's blocks),
    ``adamw_sumsq`` (n, numel, is_bf16, g, partial, partial_len, ticket,
    norm, stream) and ``adamw_update`` (n, numel, is_bf16, g, p, mu, nu,
    norm, scalars, 1 − b1, b1, 1 − b2, b2, eps, wd, clip, stream) → CUDA
    error code."""
    from tpu_kubernetes_torch.ops import _build

    blocks = _build.load("adamw_blocks", [ctypes.c_int, ctypes.c_void_p],
                         library="adamw")
    blocks.restype = ctypes.c_longlong
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    sumsq = _build.load("adamw_sumsq", [i32, ptr, ptr, ptr, ptr,
                                        ctypes.c_longlong, ptr, ptr, ptr],
                        library="adamw")
    update = _build.load("adamw_update", [i32] + [ptr] * 8
                         + [ctypes.c_float] * 7 + [ptr], library="adamw")
    return blocks, sumsq, update


def _launched(fn_name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{fn_name} kernel launch failed: CUDA error {err}")


def global_norm_cuda(grads: list[torch.Tensor]) -> torch.Tensor:
    """Launch ``adamw_sumsq`` on the current stream → the f32 global norm,
    a 0-d tensor on the leaves' device."""
    n, numel, is_bf16, (g,) = _leaf_args("global_norm_cuda", grads)
    blocks_fn, fn, _ = load_kernels()
    blocks = blocks_fn(n, numel)
    _check("global_norm_cuda", blocks > 0, "leaves too many or empty")
    dev = grads[0].device
    partial = torch.empty(blocks, dtype=torch.float32, device=dev)
    ticket = torch.zeros(1, dtype=torch.int32, device=dev)
    norm = torch.empty((), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = fn(n, numel, is_bf16, g, partial.data_ptr(), blocks,
                 ticket.data_ptr(), norm.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    _launched("adamw_sumsq", err)
    global_norm_cuda.launches += 1
    return norm


global_norm_cuda.launches = 0


def adamw_update_cuda_(grads, params, mus, nus, norm: torch.Tensor,
                       scalars: torch.Tensor, h: Hyper) -> None:
    """Launch ``adamw_update`` on the current stream: every leaf's params,
    mu and nu in place, as :func:`adamw_update_reference_`."""
    name = "adamw_update_cuda_"
    n, numel, is_bf16, (g, p, mu, nu) = _leaf_args(name, grads, params, mus,
                                                   nus)
    dev = grads[0].device
    for arg, t, shape in (("norm", norm, ()), ("scalars", scalars, (3,))):
        _check(name, t.device == dev and t.dtype == torch.float32
               and tuple(t.shape) == shape and t.is_contiguous(),
               f"takes {arg} f32 {shape} on {dev}; got {t.dtype} "
               f"{tuple(t.shape)} on {t.device}")
    _, _, fn = load_kernels()
    with torch.cuda.device(dev):
        err = fn(n, numel, is_bf16, g, p, mu, nu, norm.data_ptr(),
                 scalars.data_ptr(), 1 - h.b1, h.b1, 1 - h.b2, h.b2, h.eps,
                 h.weight_decay, h.grad_clip,
                 torch.cuda.current_stream(dev).cuda_stream)
    _launched("adamw_update", err)
    adamw_update_cuda_.launches += 1


adamw_update_cuda_.launches = 0


def global_norm(grads: list[torch.Tensor]) -> torch.Tensor:
    """√Σ g² over every leaf, f32, on the leaves' device: CPU leaves take
    the plain version; CUDA leaves launch ``adamw_sumsq`` or raise."""
    if grads[0].is_cuda:
        return global_norm_cuda(grads)
    return global_norm_reference(grads)


def adamw_(grads, params, mus, nus, scalars: torch.Tensor, h: Hyper,
           norm: torch.Tensor | None = None) -> torch.Tensor:
    """One AdamW step over the leaves, in place → the global norm (0 when
    ``h.grad_clip`` is infinite: no clip, and the norm is not computed).
    A given ``norm`` (a sharded step's: its leaves are one rank's blocks,
    so the whole model's norm comes from every rank) is used as it is.
    CPU leaves take the plain versions; CUDA leaves launch the kernels or
    raise."""
    if norm is not None:
        pass
    elif math.isinf(h.grad_clip):
        # below an infinite clip every leaf is kept as it is: the update
        # reads a zero norm and the norm kernel does not run
        norm = torch.zeros((), dtype=torch.float32, device=grads[0].device)
    else:
        norm = global_norm(grads)
    if grads[0].is_cuda:
        adamw_update_cuda_(grads, params, mus, nus, norm, scalars, h)
    else:
        adamw_update_reference_(grads, params, mus, nus, norm, scalars, h)
    return norm
