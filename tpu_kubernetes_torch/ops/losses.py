"""Shared loss primitives (port of ``tpu_kubernetes/ops/losses.py``), and
the vocab-parallel form of the next-token loss that the reference's
GSPMD derives for logits split over the ``tensor`` axis."""

from __future__ import annotations

import torch


def next_token_nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy. logits: (batch, seq, vocab), taken in
    float32; targets: (batch, seq) int. → a float32 scalar."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    return nll.mean()


def next_token_nll_vocab_parallel(logits: torch.Tensor, targets: torch.Tensor,
                                  vocab_start: int, group) -> torch.Tensor:
    """:func:`next_token_nll` of logits whose vocab is split over the
    ranks of ``group`` (``tensor``): ``logits`` (batch, seq, vocab/t) hold
    the columns from ``vocab_start``. The row maximum and the sum of
    exponentials are all-reduced over the group, and the target's logit is
    picked on the rank that holds it (zero elsewhere) and all-reduced:
    ``nll = max + log Σ exp(l − max) − l[target]``, the plain loss up to
    rounding. Every rank returns the same scalar; the backward reaches
    each rank's own columns (the reductions are ``reduce_from``'s)."""
    import torch.distributed as dist

    from tpu_kubernetes_torch.parallel.collectives import (
        all_reduce_raw,
        reduce_from,
    )

    logits = logits.float()
    n = logits.shape[-1]
    # the shift cancels in the loss, so it carries no gradient
    m = all_reduce_raw(logits.detach().amax(-1), group, dist.ReduceOp.MAX)
    sumexp = reduce_from(torch.exp(logits - m[..., None]).sum(-1), group)
    local = targets.long() - vocab_start
    hit = (local >= 0) & (local < n)
    picked = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    target_logit = reduce_from(torch.where(hit, picked, 0.0), group)
    return (m + torch.log(sumexp) - target_logit).mean()
