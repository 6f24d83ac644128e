"""Expert-parallel dropless MoE: the grouped path sharded over the
``expert`` mesh axis (port of ``tpu_kubernetes/models/moe_ep.py``).

The reference runs this inside a ``shard_map`` over the expert axis; the
port runs it on each rank of the ``expert`` group (one process per card),
on the rank's rows and its slab of ``n_experts / expert`` experts, with
the token exchange written out as in the reference:

1. each rank sorts its (token, choice) rows by global expert with the
   single-shard grouped branch's plan (``models/moe.py``
   ``_grouped_sort_plan``), stable, so per-expert token order holds;
2. per-expert row counts are exchanged with one int32 all-gather (the
   (ep, E) count matrix; everything else is derived from it on the
   device, so no rank branches on its own data and every rank issues the
   same collectives);
3. rows travel to their expert's owner through an equal-split all-to-all
   over worst-case bins (a bin holds all of a rank's rows; pad rows are
   zeros and fold into the kernel's last group), as the reference does
   (``ADVICE.md``: a ragged exchange is the later upgrade);
4. each rank re-sorts what it received by its local expert slab and runs
   ``grouped_matmul`` (the B1/B2 kernels on the card) over it, dropless;
5. the same exchange runs in reverse and each token combines its k rows
   with the router weights locally.

Every row movement is a gather whose backward is the complementary
gather (the no-row-scatter discipline of ``models/moe.py``); the
all-to-all's backward is the exchange back. :func:`expert_parallel_context`
records the mesh, as the reference's does (the sharded train step enters
``parallel.mesh_context`` itself); ``models/moe.py``'s grouped branch
delegates here whenever the context mesh has a non-trivial ``expert``
axis.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpu_kubernetes_torch.ops import grouped_matmul
from tpu_kubernetes_torch.ops.grouped_matmul import DEFAULT_BLOCK_M
from tpu_kubernetes_torch.parallel.collectives import (
    all_gather_raw,
    all_to_all,
    reduce_from,
)
from tpu_kubernetes_torch.parallel.mesh import active_mesh, mesh_context


def expert_parallel_context(mesh):
    """Make ``mesh`` the model's mesh (``parallel.mesh_context``): MoE
    layers with ``dispatch_mode="grouped"`` then exchange their rows over
    its ``expert`` axis. The parameters and rows the model is given must
    be this rank's shards of them."""
    return mesh_context(mesh)


def active_expert_mesh():
    """The context mesh, if it has a non-trivial expert axis, else None."""
    mesh = active_mesh()
    return mesh if mesh is not None and mesh.axis_size("expert") > 1 else None


class _FillBins(torch.autograd.Function):
    """Sorted rows → per-destination bins: out[j, q] = ys[idx[j, q]] where
    valid, else 0. Backward: the complementary gather — every sorted row
    sits in exactly one bin slot (dst_of, pos_of)."""

    @staticmethod
    def forward(ctx, ys, idx, valid, dst_of, pos_of):
        ctx.save_for_backward(dst_of, pos_of)
        take = ys[idx.clamp(max=ys.shape[0] - 1)]
        return take * valid[..., None].to(ys.dtype)

    @staticmethod
    def backward(ctx, dout):
        dst_of, pos_of = ctx.saved_tensors
        return dout[dst_of, pos_of], None, None, None, None


class _ReadBins(torch.autograd.Function):
    """Per-destination bins → sorted rows, the inverse of
    :class:`_FillBins` (same metadata), after the return exchange."""

    @staticmethod
    def forward(ctx, bins, dst_of, pos_of, idx, valid):
        ctx.save_for_backward(idx, valid)
        ctx.n = dst_of.shape[0]
        return bins[dst_of, pos_of]

    @staticmethod
    def backward(ctx, dout):
        idx, valid = ctx.saved_tensors
        take = dout[idx.clamp(max=ctx.n - 1)]
        return take * valid[..., None].to(dout.dtype), None, None, None, None


def grouped_ep_mlp(cfg, y: torch.Tensor, gates: torch.Tensor, layer: dict,
                   mesh) -> torch.Tensor:
    """Dropless expert MLP over an expert-parallel mesh, on this rank.

    y (b_l, s, d) this rank's token rows, gates (b_l, s, E) f32 router
    probabilities, layer this rank's slab of the layer (w_gate/w_up/w_down
    with a leading local-expert axis of E / ep; their mlp dimension this
    rank's ``tensor`` block) → (b_l, s, d) combined expert output (no
    residual). Raises ValueError when ``expert`` does not divide
    n_experts."""
    from tpu_kubernetes_torch.models.llama import tensor_group
    from tpu_kubernetes_torch.models.moe import (
        _DispatchSorted,
        _grouped_sort_plan,
        _named,
        _UnsortRows,
    )

    ep = mesh.shape["expert"]
    E = cfg.n_experts
    if E % ep:
        raise ValueError(
            f"n_experts {E} not divisible by expert mesh axis {ep}")
    e_loc = E // ep
    k = cfg.experts_per_token
    group = mesh.group("expert")
    p = mesh.my_coords()["expert"]
    b_l, s, d = y.shape
    m_l = b_l * s * k
    dev = y.device

    # -- local routing plan: the single-shard grouped branch's
    perm, sizes, token_of, inv, weight, _ = _grouped_sort_plan(gates, k, E)

    # -- exchange metadata: one int32 all-gather of per-expert counts
    send = sizes.reshape(ep, e_loc).sum(1)                  # rows per dst
    send_end = torch.cumsum(send, 0)
    dst_start = send_end - send
    counts = all_gather_raw(sizes[None], 0, group)          # (ep, E)
    c_re = counts.reshape(ep, ep, e_loc)[:, p, :]           # (src, E_loc)
    recv = c_re.sum(1)                                      # rows per src

    q = torch.arange(m_l, device=dev)
    # sorted row i lives in bin (dst_of[i], pos_of[i]); bin slot (j, q)
    # reads sorted row idx[j, q] while q < send[j]
    dst_of = torch.searchsorted(send_end, q, right=True).clamp(0, ep - 1)
    pos_of = q - dst_start[dst_of]
    idx = dst_start[:, None] + q[None, :]                   # (ep, m_l)
    valid_bin = q[None, :] < send[:, None]
    perm, inv, token_of, weight = (
        _named(cfg, t, "moe_plan") for t in (perm, inv, token_of, weight))

    # -- dispatch: token rows → expert-sorted → bins → all-to-all
    ys = _DispatchSorted.apply(y.reshape(b_l * s, d), token_of, inv, k)
    bins = _FillBins.apply(ys, idx, valid_bin, dst_of, pos_of)
    got = all_to_all(bins, group)                           # (src, m_l, d)

    # -- local re-sort by my expert slab: chunk from src i holds rows for
    # my experts sorted by expert, c_re[i] of each; invalid tail rows are
    # zeros and sort to the end (key e_loc), where the kernel's pad group
    # takes them
    cap = ep * m_l
    csum = torch.cumsum(c_re, 1).contiguous()               # (src, E_loc)
    eloc = torch.searchsorted(csum, q.expand(ep, m_l).contiguous()
                              .to(csum.dtype), right=True)
    key = torch.where(q[None, :] < recv[:, None], eloc, e_loc)
    perm2 = torch.argsort(key.reshape(-1), stable=True)
    inv2 = torch.empty_like(perm2).scatter_(
        0, perm2, torch.arange(cap, device=dev))
    perm2, inv2 = (_named(cfg, t, "moe_plan") for t in (perm2, inv2))
    ys2 = _UnsortRows.apply(got.reshape(cap, d), perm2, inv2)

    cap_pad = -(-cap // DEFAULT_BLOCK_M) * DEFAULT_BLOCK_M
    sizes_loc = c_re.sum(0).to(torch.int32)                 # (E_loc,)
    # alignment and invalid rows ride in the last group (zero lhs rows →
    # zero outputs), as the single-shard path's m_pad does
    sizes_loc[e_loc - 1] += (cap_pad - sizes_loc.sum()).to(torch.int32)
    lhs = _named(cfg, F.pad(ys2, (0, 0, 0, cap_pad - cap)), "moe_dispatch")
    use = cfg.use_kernel
    gated = F.silu(grouped_matmul(lhs, layer["w_gate"], sizes_loc,
                                  use_kernel=use)) \
        * grouped_matmul(lhs, layer["w_up"], sizes_loc, use_kernel=use)
    # under a tensor split the mlp products are partial: whole rows before
    # the exchange back, so the combine and the router see whole outputs
    rows_out = reduce_from(grouped_matmul(
        gated, layer["w_down"], sizes_loc, use_kernel=use,
        checkpoint_name="moe_expert_out"), tensor_group())

    # -- return exchange: unsort to chunk order, all-to-all back, read my
    # rows out of the bins they came back in
    back = _UnsortRows.apply(rows_out[:cap], inv2, perm2)
    ret = all_to_all(back.reshape(ep, m_l, d), group)
    back_sorted = _ReadBins.apply(ret, dst_of, pos_of, idx, valid_bin)

    rows_tok = _UnsortRows.apply(back_sorted, inv, perm)
    w_tok = weight.permute(1, 2, 0).reshape(b_l, s, k)
    return torch.sum(rows_tok.reshape(b_l, s, k, d)
                     * w_tok[..., None].to(rows_tok.dtype), dim=2)
