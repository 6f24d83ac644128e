"""Ring attention: exact context parallelism over a mesh ``sequence`` axis
(port of ``tpu_kubernetes/parallel/ring_attention.py``).

Each rank of the ring holds one sequence block of Q, K and V. The K/V
blocks rotate around the ring (:func:`~tpu_kubernetes_torch.parallel.
collectives.ppermute`, cyclic ``i → i+1``) while every rank accumulates
its Q block's attention with the online-softmax combine, so no rank
holds the whole score matrix. Causality follows the block order: the
block that started at ring position j counts fully when j < i, as the
local triangle when j == i, and not at all when j > i.

Plain PyTorch, term for term the reference's (which computes it with
``einsum``s in f32 outside any Pallas kernel): q, k and v in f32, the
-1e30 mask, ``sm_scale = 1/√d``, the ``l ≥ 1e-30`` guard, the output in
q's dtype. Autograd differentiates it through the shift's adjoint. One
difference of cost, not of value: a block that the causal mask removes
whole (j > i) is not computed. The reference computes it and its weight
``exp(-1e30 - m)`` is exactly 0 (m is finite from the first step, the
diagonal block, on), so skipping it leaves every value and gradient bit
for bit the same.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from tpu_kubernetes_torch.parallel.collectives import chain_token, ppermute
from tpu_kubernetes_torch.parallel.mesh import Mesh, NamedSharding, PartitionSpec

NEG_INF = -1e30


def _block_attn(q, k, v, mask, sm_scale):
    """Scores and the masked partial softmax statistics of one (q block,
    kv block) pair. q: (b, h, sq, d); k, v: (b, h, sk, d), all f32; mask
    broadcastable to (sq, sk) or None (all kept)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * sm_scale
    if mask is not None:
        s = torch.where(mask, s, torch.full((), NEG_INF, dtype=s.dtype,
                                            device=s.device))
    m = s.amax(dim=-1, keepdim=True)                          # (b,h,sq,1)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    pv = torch.einsum("bhqk,bhkd->bhqd", p, v)
    return m, l, pv


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group, causal: bool = True,
                   sm_scale: float | None = None) -> torch.Tensor:
    """This rank's block of the attention of the whole sequence, the
    sequence split over ``group`` (the mesh's ``sequence`` line; None: one
    rank, plain attention). q, k, v: this rank's block (batch, heads,
    seq_local, head_dim), block i at group rank i. Collective: every rank
    of the group calls it."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    n = 1 if group is None else dist.get_world_size(group)
    my = 0 if group is None else dist.get_rank(group)
    sq = q.shape[2]
    qf = q.float()
    local_tri = torch.tril(torch.ones((sq, sq), dtype=torch.bool,
                                      device=q.device))
    perm = [(i, (i + 1) % n) for i in range(n)]

    b, h, _, d = q.shape
    m = torch.full((b, h, sq, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, sq, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    kt, vt = k.float(), v.float()
    token = chain_token(kt)
    for t in range(n):
        j = (my - t) % n    # the ring position this K/V block started at
        if not (causal and j > my):
            mask = (None if not causal or j < my else local_tri)
            bm, bl, bpv = _block_attn(qf, kt, vt, mask, sm_scale)
            m_new = torch.maximum(m, bm)
            alpha = torch.exp(m - m_new)
            beta = torch.exp(bm - m_new)
            l = l * alpha + bl * beta
            acc = acc * alpha + bpv * beta
            m = m_new
        # rotate K/V to the next ring position (every step, every rank)
        kt, vt, token = ppermute((kt, vt, token), perm, group)
    # guard fully masked rows (none with the causal diagonal; kept for
    # the edge cases, as the reference keeps it)
    l = torch.clamp(l, min=1e-30)
    return (acc / l).to(q.dtype) + token.to(q.dtype)


def seq_sharding(mesh: Mesh, seq_axis: str = "sequence") -> NamedSharding:
    """The layout of :func:`ring_attention_sharded`'s inputs and output:
    (b, h, seq, d) with the sequence split over ``seq_axis``."""
    return NamedSharding(mesh, PartitionSpec(None, None, seq_axis, None))


def ring_attention_sharded(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, mesh: Mesh,
                           seq_axis: str = "sequence", causal: bool = True,
                           sm_scale: float | None = None) -> torch.Tensor:
    """:func:`ring_attention` over ``mesh``'s ``seq_axis``: q, k, v and
    the result are this rank's block of (b, h, seq, d) under
    :func:`seq_sharding` (``parallel.mesh.shard_tensor`` /
    ``gather_tensor``); nothing gathers the whole sequence onto one
    rank."""
    return ring_attention(q, k, v, mesh.group(seq_axis), causal=causal,
                          sm_scale=sm_scale)
