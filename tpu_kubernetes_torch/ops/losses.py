"""Shared loss primitives (port of ``tpu_kubernetes/ops/losses.py``)."""

from __future__ import annotations

import torch


def next_token_nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy. logits: (batch, seq, vocab), taken in
    float32; targets: (batch, seq) int. → a float32 scalar."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    return nll.mean()
