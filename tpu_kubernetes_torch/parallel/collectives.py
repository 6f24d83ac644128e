"""Differentiable collectives over one mesh axis's process group (the
port's own: in the reference GSPMD inserts them).

Each takes a group from ``Mesh.group`` (None: the axis is trivial and the
op is the identity, as the reference drops size-1 axes). Two families,
by how the loss counts the ranks of the group:

* **data-like axes** (data, fsdp, expert): each rank holds other rows and
  the step's objective is the mean of the ranks' losses, so a collective's
  backward is its true adjoint: :func:`all_gather` ↔ a reduce-scatter
  (sum), :func:`reduce_scatter` ↔ an all-gather, :func:`all_reduce` ↔ an
  all-reduce, :func:`all_to_all` ↔ the same exchange back.
* **tensor** (Megatron): every rank of the group computes the same loss
  on the same rows, counted once, so :func:`copy_to` is the identity
  forward and an all-reduce backward (before a column-split product),
  :func:`reduce_from` an all-reduce forward and the identity backward
  (after a row-split product, a vocab-split lookup or loss term) and
  :func:`gather_from` an all-gather forward and this rank's block of the
  cotangent backward (the vocab-split logits made whole).

The raw ops (``*_raw``, no autograd) run each collective on the group's
backend as it is: NCCL takes CUDA tensors, gloo CPU and CUDA tensors
(several ranks sharing one card run over gloo; torch 2.11's gloo carries
all four ops for CUDA tensors, measured on an H100, ``PERF.md`` §6). Any other
backend, or a CPU tensor under NCCL, raises; nothing is skipped or
substituted on failure.
"""

from __future__ import annotations

import warnings

import torch
import torch.distributed as dist

# the *_tensor names are deprecated in favour of *_single in newer torch;
# both take the same arguments
warnings.filterwarnings(
    "ignore", message=r".*is deprecated\. Please use `torch\.distributed\.",
    category=FutureWarning)

def _run(fn, out: torch.Tensor, x: torch.Tensor, group) -> torch.Tensor:
    """``fn(out, x, group)`` on the group's backend (see the module
    docstring); → ``out``."""
    backend = dist.get_backend(group)
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"collectives run on nccl or gloo, not {backend!r}")
    if backend == "nccl" and not x.is_cuda:
        raise ValueError(f"NCCL takes CUDA tensors; got one on {x.device}")
    fn(out, x, group)
    return out


def _all_reduce_into(op):
    def fn(out, x, group):
        if out.data_ptr() != x.data_ptr():
            out.copy_(x)
        dist.all_reduce(out, op=op, group=group)
    return fn


def all_reduce_raw(x: torch.Tensor, group, op=dist.ReduceOp.SUM
                   ) -> torch.Tensor:
    """A new tensor: ``op`` over the group of ``x``."""
    if group is None:
        return x
    x = x.contiguous()
    return _run(_all_reduce_into(op), torch.empty_like(x), x, group)


def all_gather_raw(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's blocks of ``x`` concatenated along ``dim`` in group
    rank order."""
    if group is None:
        return x
    n = dist.get_world_size(group)
    xt = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * xt.shape[0], *xt.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _run(lambda o, i, g: dist.all_gather_into_tensor(o, i, group=g),
         out, xt, group)
    return out.movedim(0, dim).contiguous()


def reduce_scatter_raw(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum over the group of ``x``, this rank's block along ``dim``."""
    if group is None:
        return x
    n = dist.get_world_size(group)
    xt = x.movedim(dim, 0).contiguous()
    if xt.shape[0] % n:
        raise ValueError(f"reduce-scatter of dimension {dim} of size "
                         f"{xt.shape[0]} over {n} ranks")
    out = torch.empty((xt.shape[0] // n, *xt.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _run(lambda o, i, g: dist.reduce_scatter_tensor(o, i, group=g),
         out, xt, group)
    return out.movedim(0, dim).contiguous()


def all_to_all_raw(x: torch.Tensor, group) -> torch.Tensor:
    """Equal-split exchange along dimension 0: block j of ``x`` goes to
    group rank j, block i of the result came from group rank i."""
    if group is None:
        return x
    x = x.contiguous()
    return _run(lambda o, i, g: dist.all_to_all_single(o, i, group=g),
                torch.empty_like(x), x, group)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_raw(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_raw(g, ctx.dim, ctx.group), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return reduce_scatter_raw(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return all_gather_raw(g, ctx.dim, ctx.group), None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_raw(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_raw(g, ctx.group), None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_raw(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_raw(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group, ctx.n = dim, group, x.shape[dim]
        return all_gather_raw(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        me = dist.get_rank(ctx.group)
        return g.narrow(ctx.dim, me * ctx.n, ctx.n).contiguous(), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_to_all_raw(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_to_all_raw(g, ctx.group), None


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """All-gather along ``dim``; backward: reduce-scatter (sum)."""
    return x if group is None else _AllGather.apply(x, dim, group)


def reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Reduce-scatter (sum) along ``dim``; backward: all-gather."""
    return x if group is None else _ReduceScatter.apply(x, dim, group)


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce (sum); backward: all-reduce (a data-like axis)."""
    return x if group is None else _AllReduce.apply(x, group)


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Identity; backward: all-reduce (into a tensor-split product)."""
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce (sum); backward: identity (out of a tensor split)."""
    return x if group is None else _ReduceFrom.apply(x, group)


def gather_from(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """All-gather along ``dim``; backward: this rank's block of the
    cotangent (out of a tensor split: the replicas count once)."""
    return x if group is None else _GatherFrom.apply(x, dim, group)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Equal-split exchange along dimension 0; backward: the same
    exchange, which is its own reverse."""
    return x if group is None else _AllToAll.apply(x, group)
