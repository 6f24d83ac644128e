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
all four ops for CUDA tensors, measured on an H100, ``PERF.md`` §6; the
shift, :func:`ppermute`, rides on the equal-split all-to-all). Any other
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


def ppermute_raw(xs: tuple, perm, group) -> tuple:
    """``lax.ppermute`` of every tensor of ``xs`` over the group: group
    rank i sends to j for each pair (i, j) of ``perm`` (at most one pair
    from and one to each rank); a rank that receives nothing gets zeros.
    All of ``xs`` travel as one buffer of bytes in one equal-split
    ``all_to_all_single``: block j of a rank's send buffer holds the bytes
    when j is its destination and zeros otherwise, block i of what it
    receives is the source's. (Gloo on torch 2.11 aborts the process on
    uneven splits and on ``batch_isend_irecv`` for CUDA tensors, and
    carries the equal-split exchange: ``PERF.md`` §6.)"""
    if group is None:                   # one rank: itself, or nothing
        keep = (0, 0) in [tuple(p) for p in perm]
        return tuple(x if keep else torch.zeros_like(x) for x in xs)
    me, n = dist.get_rank(group), dist.get_world_size(group)
    dest = [j for i, j in perm if i == me]
    src = [i for i, j in perm if j == me]
    flat = [x.contiguous().view(-1).view(torch.uint8) for x in xs]
    nbytes = sum(f.numel() for f in flat)
    send = torch.zeros((n, nbytes), dtype=torch.uint8, device=flat[0].device)
    if dest:
        torch.cat(flat, out=send[dest[0]])
    got = _run(lambda o, i, g: dist.all_to_all_single(o, i, group=g),
               torch.empty_like(send), send, group)
    if not src:
        return tuple(torch.zeros_like(x) for x in xs)
    out, at = [], 0
    for x, f in zip(xs, flat):
        part = got[src[0], at:at + f.numel()]
        if (src[0] * nbytes + at) % x.element_size():
            part = part.clone()         # a dtype view wants its alignment
        out.append(part.view(x.dtype).view(x.shape))
        at += f.numel()
    return tuple(out)


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


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, perm, group, *xs):
        ctx.perm, ctx.group = perm, group
        return ppermute_raw(xs, perm, group)

    @staticmethod
    def backward(ctx, *gs):
        # the adjoint sends each cotangent back along the inverse pairs
        back = [(j, i) for i, j in ctx.perm]
        return (None, None, *ppermute_raw(gs, back, ctx.group))


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


def ppermute(xs: tuple, perm, group) -> tuple:
    """The shift of :func:`ppermute_raw` (``lax.ppermute`` over a line of
    the mesh); backward: each cotangent sent back along the inverse pairs,
    zeros where nothing comes back. The pipeline's stage-to-stage hand-off
    (``i → i+1``) and ring attention's rotation (cyclic) are its two uses.

    Every rank of the group calls it the same number of times in the same
    order, and so must its backward run: a rank whose backward skipped a
    shift would leave its peers waiting. So the callers thread a *token*
    through every shift, a zero scalar that requires a gradient and ends
    in their output: each shift is then a node of every rank's backward
    whatever the rank computed, and the token's chain runs them in
    reverse order on every rank."""
    return _PPermute.apply(perm, group, *xs)


def chain_token(*xs: torch.Tensor) -> torch.Tensor:
    """The token of :func:`ppermute`'s callers: a 0-d f32 zero connected
    to ``xs`` (their gradient through it is zero), so that whatever
    reaches the token's end reaches ``xs`` on every rank, and requiring a
    gradient wherever one is being taken."""
    tok = sum((x.sum().float() * 0 for x in xs),
              torch.zeros((), dtype=torch.float32, device=xs[0].device))
    if torch.is_grad_enabled() and not tok.requires_grad:
        tok = tok.detach().requires_grad_(True)
    return tok
