"""RMSNorm and rotary position embeddings (port of
``tpu_kubernetes/ops/norms.py``).

Plain PyTorch on purpose, as the reference keeps them plain jnp: they
are bandwidth-bound elementwise ops. Computation runs in float32 and
casts back.
"""

from __future__ import annotations

import torch

_ROPE_TABLES: dict[tuple, tuple[torch.Tensor, torch.Tensor]] = {}


NORM_CHUNK = 64     # the mean of squares averages chunks of this many first


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """LLaMA-style RMSNorm: x * rsqrt(mean(x²)) * weight.

    A row's result does not depend on how many rows come with it: the
    mean of squares is a mean over chunks of NORM_CHUNK values, then over
    the chunks' means, two reductions whose every row sums in one order at
    any batch. PyTorch's CUDA reduction of a whole 2,048-wide row splits
    it by a plan that follows the number of rows, so a row's bits would
    move with the batch, and the slot engine's 8 rows part from the solo
    lane's 1 a few dozen steps into a request. The weight multiplies in
    f32 by promotion, with no cast of its own."""
    x32 = x.float()
    d = x32.shape[-1]
    sq = x32.square()
    if d % NORM_CHUNK == 0:
        var = sq.unflatten(-1, (d // NORM_CHUNK, NORM_CHUNK)).mean(-1).mean(
            -1, keepdim=True)
    else:
        var = sq.mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * weight).to(x.dtype)


def rope_frequencies(
    head_dim: int, max_seq: int, theta: float = 10000.0,
    device: torch.device | str = "cuda",
) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables of shape (max_seq, head_dim // 2), float32."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    inv_freq = 1.0 / torch.pow(
        torch.tensor(theta, dtype=torch.float32, device=device), exponent
    )
    t = torch.arange(max_seq, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    return torch.cos(freqs), torch.sin(freqs)


def rope_tables(
    head_dim: int, max_seq: int, theta: float,
    device: torch.device | str,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`rope_frequencies`, built once per (head_dim, max_seq, theta,
    device) and kept: the decode and train programs read the same tables
    on every call, and a CUDA graph must not own them (a table built while
    a graph captures would live in its memory pool). Callers never write
    to them."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = (head_dim, max_seq, float(theta), device)
    tables = _ROPE_TABLES.get(key)
    if tables is None:
        tables = _ROPE_TABLES[key] = rope_frequencies(head_dim, max_seq,
                                                      theta, device)
    return tables


def apply_rope(
    x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
    positions: torch.Tensor | None = None,
) -> torch.Tensor:
    """Rotate split halves of the channels (not interleaved pairs).
    x: (batch, heads, seq, head_dim); cos/sin: (max_seq, head_dim//2);
    positions: (seq,) shared across the batch, (batch, seq) per row, or
    None for 0..seq-1. The result is contiguous in x's layout."""
    seq = x.shape[2]
    if positions is None:
        cos_t, sin_t = cos[:seq], sin[:seq]
    else:
        cos_t, sin_t = cos[positions.long()], sin[positions.long()]
    x1, x2 = x.float().chunk(2, dim=-1)
    if positions is not None and positions.dim() == 2:
        cos_t = cos_t[:, None, :, :]         # (b, 1, seq, hd/2)
        sin_t = sin_t[:, None, :, :]
    else:
        cos_t = cos_t[None, None, :, :]
        sin_t = sin_t[None, None, :, :]
    rotated = torch.cat(
        [x1 * cos_t - x2 * sin_t, x1 * sin_t + x2 * cos_t], dim=-1
    )
    return rotated.to(x.dtype)
