"""Mixtral-style sparse Mixture-of-Experts decoder, functional PyTorch (port
of ``tpu_kubernetes/models/moe.py``, single device).

The attention sublayer is the dense model's (``models/llama.py``); the
SwiGLU MLP becomes a top-k routed expert layer. Params keep the
reference's layout, so weights carry over leaf for leaf: expert weights
stacked ``(n_layers, n_experts, …)``, the router ``w_router`` in float32
whatever the model's dtype (routing decisions are precision-sensitive).

Three dispatch modes, as in the reference:

* ``"gather"`` (the presets' default): expert-capacity routing with
  indexed dispatch and combine — row gathers driven by int slot indices,
  whose backward passes (autograd functions here, the reference's custom
  VJPs) are the complementary gathers, term for term.
* ``"einsum"``: the GShard dense one-hot dispatch, the numerical oracle.
* ``"grouped"``: dropless — token rows sorted by expert and multiplied by
  ``ops.grouped_matmul`` (the hand-written CUDA kernels on the card), the
  last group padded so the rows fill whole 128-row blocks.

Routing reproduces the reference decision for decision: ``argmax`` takes
the first maximum, chosen experts drop to -1 before the next round, slot
positions come from one exclusive cumsum over the sequence (causal
dropping), the expert sort is stable. Nothing in the layer waits for the
host: out-of-range slots and dropped claims are masked, never filtered.

Under a mesh (``parallel.mesh_context``) the layer runs on this rank's
rows and shards (see ``models/llama.py``): the expert products are split
over ``tensor`` on the mlp dimension (the rows into them ``copy_to``, the
w_down product all-reduced before the combine, so the router's gradient
sees whole expert outputs); ``"grouped"`` over a non-trivial ``expert``
axis takes the expert-parallel branch (``models/moe_ep.py``: an
all-to-all to each expert's owner and back), the other modes all-gather
the expert stacks; the load-balance loss takes the fractions and mean
gates over the whole batch (all-reduced over the data-like axes), as the
reference computes it on globally sharded arrays.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from tpu_kubernetes_torch.models.llama import (
    ModelConfig,
    _dense_init,
    attention_sublayer,
    checkpoint_name,
    embed_tokens,
    full_logits,
    head_logits,
    nll,
    remat_policy_kwargs,
    tensor_group,
    use_layer,
)
from tpu_kubernetes_torch.models.moe_ep import (
    active_expert_mesh,
    grouped_ep_mlp,
)
from tpu_kubernetes_torch.ops import grouped_matmul, rms_norm, rope_tables
from tpu_kubernetes_torch.ops.grouped_matmul import DEFAULT_BLOCK_M
from tpu_kubernetes_torch.parallel.collectives import (
    all_gather,
    all_reduce,
    all_reduce_raw,
    copy_to,
    reduce_from,
)
from tpu_kubernetes_torch.parallel.mesh import (
    active_mesh,
    data_axes_in,
    in_context_mesh,
)


@dataclass(frozen=True)
class MoEConfig(ModelConfig):
    n_experts: int = 8
    experts_per_token: int = 2
    # per-expert token capacity = ceil(k · seq · capacity_factor / n_experts)
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # "gather" | "einsum" | "grouped" (dropless; capacity_factor ignored)
    dispatch_mode: str = "gather"
    # "dots" + the layer's named routing plan and bucketed activations
    remat_policy: str = "moe"


MOE_CONFIGS: dict[str, MoEConfig] = {
    "moe-test": MoEConfig(
        vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
        d_ff=128, max_seq=128, remat=False, n_experts=4, experts_per_token=2,
    ),
    # the grouped twin of moe-test; d_model 64 is below the kernel's
    # multiple-of-128 rule, so it runs on the CPU lane only
    "moe-test-grouped": MoEConfig(
        vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
        d_ff=128, max_seq=128, remat=False, n_experts=4, experts_per_token=2,
        dispatch_mode="grouped",
    ),
    "moe-1b": MoEConfig(
        vocab_size=32000, d_model=1024, n_layers=12, n_heads=16, n_kv_heads=8,
        d_ff=3584, max_seq=2048, n_experts=8, experts_per_token=2,
        # capacity at the mean expert load: no padded slots, the overflow
        # of an imbalanced router dropped (the reference's choice)
        capacity_factor=1.0,
    ),
    "mixtral-8x7b": MoEConfig(
        vocab_size=32000, d_model=4096, n_layers=32, n_heads=32, n_kv_heads=8,
        d_ff=14336, max_seq=4096, rope_theta=1e6, n_experts=8,
        experts_per_token=2,
    ),
}


def expert_capacity(cfg: MoEConfig, seq: int) -> int:
    return max(1, math.ceil(
        cfg.experts_per_token * seq * cfg.capacity_factor / cfg.n_experts))


# -- params -------------------------------------------------------------------

def init_params(cfg: MoEConfig, generator: torch.Generator,
                device: torch.device | str = "cuda") -> dict:
    """Random parameters in the reference's layout and scale (normal /
    √fan_in, norms at 1, the router normal / √d_model in float32), drawn
    from ``generator`` on ``device``. The draws differ from
    ``jax.random``'s; tests carry JAX weights over with ``models.from_jax``
    (without a ``dtype`` override, so the router stays float32)."""
    d, h, kv, hd, ff, L, E = (
        cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
        cfg.d_ff, cfg.n_layers, cfg.n_experts,
    )

    def init(shape, fan_in):
        return _dense_init(shape, cfg, fan_in, generator, device)

    def ones(shape):
        return torch.ones(shape, dtype=cfg.dtype, device=device)

    router = torch.randn((L, d, E), generator=generator, dtype=torch.float32,
                         device=device) / math.sqrt(d)
    return {
        "embed": init((cfg.vocab_size, d), 1.0),
        "layers": {
            "attn_norm": ones((L, d)),
            "wq": init((L, d, h * hd), d),
            "wk": init((L, d, kv * hd), d),
            "wv": init((L, d, kv * hd), d),
            "wo": init((L, h * hd, d), h * hd),
            "mlp_norm": ones((L, d)),
            "w_router": router,
            "w_gate": init((L, E, d, ff), d),
            "w_up": init((L, E, d, ff), d),
            "w_down": init((L, E, ff, d), ff),
        },
        "final_norm": ones((d,)),
        "lm_head": init((d, cfg.vocab_size), d),
    }


def logical_axes(cfg: MoEConfig) -> dict:
    """The reference's table: the expert stacks split over ``expert`` on
    their expert dimension, the router over ``embed`` alone."""
    return {
        "embed": ("vocab", "embed"),
        "layers": {
            "attn_norm": ("layer", "embed"),
            "wq": ("layer", "embed", "heads"),
            "wk": ("layer", "embed", "kv"),
            "wv": ("layer", "embed", "kv"),
            "wo": ("layer", "heads", "embed"),
            "mlp_norm": ("layer", "embed"),
            "w_router": ("layer", "embed", None),
            "w_gate": ("layer", "expert", "embed", "mlp"),
            "w_up": ("layer", "expert", "embed", "mlp"),
            "w_down": ("layer", "expert", "mlp", "embed"),
        },
        "final_norm": ("embed",),
        "lm_head": ("embed", "vocab"),
    }


# -- routing ------------------------------------------------------------------

def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """f32 one-hot of ``idx`` over ``n`` classes; an index outside
    [0, n) gives a zero row, as ``jax.nn.one_hot`` does."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def _topk_selection(gates: torch.Tensor, k: int):
    """k argmax rounds over (b, s, E) gates → (idxs, masks): k (b, s)
    int64 tensors and k (b, s, E) f32 one-hots. A chosen expert drops to
    -1, so even gates that underflowed to exactly 0 never re-pick it."""
    remaining = gates
    idxs, masks = [], []
    for _ in range(k):
        idx = torch.argmax(remaining, dim=-1)        # the first maximum
        mask = _one_hot(idx, gates.shape[-1])
        idxs.append(idx)
        masks.append(mask)
        remaining = torch.where(mask > 0, -1.0, remaining)
    return idxs, masks


def _route(gates: torch.Tensor, k: int, capacity: int):
    """Top-k expert-capacity routing (the einsum path). gates (b, s, E) f32
    → (dispatch, combine) both (b, s, E, C) f32, and the first-choice mask
    (b, s, E). A token's slot in expert e is the number of claims on e by
    strictly earlier tokens (causal dropping); combine weights are
    renormalized over the selected experts, dropped ones included."""
    b, s, E = gates.shape
    _, masks = _topk_selection(gates, k)
    total = sum(masks)
    pos = torch.cumsum(total, dim=1) - total              # exclusive cumsum
    dispatch = torch.zeros((b, s, E, capacity), device=gates.device)
    combine = torch.zeros((b, s, E, capacity), device=gates.device)
    selected_sum = torch.zeros((b, s), device=gates.device)
    for mask in masks:
        keep = mask * (pos < capacity)
        sel = keep[..., None] * _one_hot(pos.long(), capacity)
        gate_i = torch.sum(gates * mask, dim=-1)
        dispatch = dispatch + sel
        combine = combine + sel * gate_i[..., None, None]
        selected_sum = selected_sum + gate_i
    combine = combine / torch.clamp(selected_sum, min=1e-9)[..., None, None]
    return dispatch, combine, masks[0]


def _topk_plan(gates: torch.Tensor, k: int):
    """→ (expert_idx (k, b, s) int64, masks, weight (k, b, s) f32): the
    selection and the combine weights, renormalized over ALL selected
    experts (the router's gradient path)."""
    idxs, masks = _topk_selection(gates, k)
    gate_r = torch.stack([torch.sum(gates * m, dim=-1) for m in masks])
    weight = gate_r / torch.clamp(gate_r.sum(0), min=1e-9)
    return torch.stack(idxs), masks, weight


def _grouped_sort_plan(gates: torch.Tensor, k: int, E: int):
    """Stable expert-sort plan of the dropless path. Row t·k + r of the
    (token, choice) rows is token t's round-r choice. → (perm, sizes,
    token_of, inv, weight, first): the sort permutation over the b·s·k
    rows, per-expert row counts (int32, unpadded), each sorted row's token,
    the inverse permutation, the combine weights (k, b, s) and the
    first-choice one-hot."""
    expert_idx, masks, weight = _topk_plan(gates, k)
    m = expert_idx.numel()
    e_flat = expert_idx.permute(1, 2, 0).reshape(m)
    perm = torch.argsort(e_flat, stable=True)
    # jnp.bincount(length=E); torch.bincount reads its input's maximum on
    # the host, an index_add does not
    sizes = torch.zeros(E, dtype=torch.int64, device=e_flat.device).index_add_(
        0, e_flat, torch.ones_like(e_flat)).to(torch.int32)
    inv = torch.empty_like(perm).scatter_(
        0, perm, torch.arange(m, device=perm.device))
    return perm, sizes, perm // k, inv, weight, masks[0]


def _route_plan(gates: torch.Tensor, k: int, capacity: int):
    """Indexed form of :func:`_route` → (dst (k, b, s) int64 flat slot
    e·C + pos, keep (k, b, s) bool slot within capacity, weight (k, b, s)
    f32, first (b, s, E))."""
    expert_idx, masks, weight = _topk_plan(gates, k)
    total = sum(masks)
    pos_all = torch.cumsum(total, dim=1) - total
    pos = torch.stack([torch.sum(pos_all * m, dim=-1).long() for m in masks])
    return expert_idx * capacity + pos, pos < capacity, weight, masks[0]


def _slot_sources(dst: torch.Tensor, keep: torch.Tensor, n_slots: int):
    """Invert the token→slot map: src (b, n_slots) = sequence index of the
    token claiming each slot, valid = whether it is claimed. Dropped
    claims write to one spare slot past the end, which is cut off (the
    reference's ``mode="drop"``); kept claims are unique."""
    k, b, s = dst.shape
    tok = torch.arange(s, device=dst.device).expand(k, b, s)
    spare = b * n_slots
    flat = torch.where(
        keep, dst + (torch.arange(b, device=dst.device) * n_slots)[None, :, None],
        spare)
    claims = torch.zeros(spare + 1, dtype=torch.int64, device=dst.device)
    claims.scatter_(0, flat.reshape(-1), tok.reshape(-1) + 1)
    claims = claims[:spare].reshape(b, n_slots)
    return torch.clamp(claims - 1, min=0), claims > 0


def _take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batched row gather: table (b, n, d), idx (b, m) → (b, m, d)."""
    return torch.gather(table, 1, idx[..., None].expand(-1, -1,
                                                          table.shape[-1]))


# -- the four row movers (the reference's custom VJPs) ------------------------

class _DispatchRows(torch.autograd.Function):
    """Token rows → expert slots: (b, s, d) → (b, E·C, d), unclaimed slots
    zero. Backward: each token gathers the ≤ k slot cotangents it fed."""

    @staticmethod
    def forward(ctx, y, src, valid, dst, keep):
        ctx.save_for_backward(dst, keep)
        return _take_rows(y, src) * valid[..., None].to(y.dtype)

    @staticmethod
    def backward(ctx, dxe):
        dst, keep = ctx.saved_tensors
        n = dxe.shape[1]
        dy = None
        for r in range(dst.shape[0]):
            rows = _take_rows(dxe, torch.clamp(dst[r], max=n - 1))
            rows = rows * keep[r][..., None].to(dxe.dtype)
            dy = rows if dy is None else dy + rows
        return dy, None, None, None, None


class _CombineRows(torch.autograd.Function):
    """Expert slots → tokens: out[b, s] = Σ_r weight_r · out_e[b, dst_r]
    over the token's kept slots. Differentiable in ``out_e`` and in
    ``weight`` (in f32, the router's gradient path)."""

    @staticmethod
    def forward(ctx, out_e, weight, dst, keep, src, valid):
        ctx.save_for_backward(out_e, weight, dst, keep, src, valid)
        n = out_e.shape[1]
        acc = None
        for r in range(dst.shape[0]):
            rows = _take_rows(out_e, torch.clamp(dst[r], max=n - 1))
            rows = rows * (weight[r] * keep[r])[..., None].to(out_e.dtype)
            acc = rows if acc is None else acc + rows
        return acc

    @staticmethod
    def backward(ctx, dout):
        out_e, weight, dst, keep, src, valid = ctx.saved_tensors
        k, n = weight.shape[0], out_e.shape[1]
        # d·out_e[b, j] = w_slot[b, j] · dout[b, src[b, j]], each slot's
        # weight found by checking which round of its token claimed it
        slots = torch.arange(n, device=dst.device)[None, :]
        w_slot = None
        for r in range(k):
            w_src = torch.gather(weight[r] * keep[r], 1, src)
            hit = torch.gather(dst[r], 1, src) == slots
            term = torch.where(hit, w_src, 0.0)
            w_slot = term if w_slot is None else w_slot + term
        w_slot = w_slot * valid
        d_out_e = _take_rows(dout, src) * w_slot[..., None].to(dout.dtype)
        # d·weight[r, b, s] = keep · ⟨dout[b, s], out_e[b, dst_r]⟩ in f32
        dws = []
        for r in range(k):
            rows = _take_rows(out_e, torch.clamp(dst[r], max=n - 1))
            dw = torch.sum(rows.float() * dout.float(), dim=-1)
            dws.append(dw * keep[r])
        return (d_out_e.to(out_e.dtype), torch.stack(dws), None, None, None,
                None)


class _DispatchSorted(torch.autograd.Function):
    """Token rows → expert-sorted rows: (b·s, d) → (b·s·k, d), row i =
    y2[token_of[i]]. Backward: each token gathers its k sorted cotangent
    rows through ``inv`` and sums them (no row scatter)."""

    @staticmethod
    def forward(ctx, y2, token_of, inv, k):
        ctx.save_for_backward(inv)
        ctx.k = k
        return y2[token_of]

    @staticmethod
    def backward(ctx, dout):
        (inv,) = ctx.saved_tensors
        dy2 = dout[inv].reshape(-1, ctx.k, dout.shape[-1]).sum(1)
        return dy2.to(dout.dtype), None, None, None


class _UnsortRows(torch.autograd.Function):
    """Expert-sorted rows → (token, choice) order: row i = rows[inv[i]];
    the cotangent goes back through ``perm`` (both pure gathers)."""

    @staticmethod
    def forward(ctx, rows, inv, perm):
        ctx.save_for_backward(perm)
        return rows[inv]

    @staticmethod
    def backward(ctx, dout):
        (perm,) = ctx.saved_tensors
        return dout[perm], None, None


# -- the routed layer ---------------------------------------------------------

def _named(cfg: MoEConfig, x: torch.Tensor, name: str) -> torch.Tensor:
    """``checkpoint_name`` where the "moe" policy can read it: under remat
    "moe" with a backward to come. Elsewhere the tag's copy buys nothing."""
    if cfg.remat and cfg.remat_policy == "moe" and torch.is_grad_enabled():
        return checkpoint_name(x, name)
    return x


def _expert_mlp(xe: torch.Tensor, layer: dict) -> torch.Tensor:
    """The experts' SwiGLU over bucketed tokens xe (b, E, C, d)."""
    gated = F.silu(torch.einsum("becd,edf->becf", xe, layer["w_gate"])) \
        * torch.einsum("becd,edf->becf", xe, layer["w_up"])
    return torch.einsum("becf,efd->becd", gated, layer["w_down"])


def moe_sublayer(cfg: MoEConfig, x: torch.Tensor, layer: dict):
    """Pre-norm routed-expert MLP + residual. x (b, s, d) → (out, aux)."""
    b, s, d = x.shape
    C = expert_capacity(cfg, s)
    E, k = cfg.n_experts, cfg.experts_per_token
    y = rms_norm(x, layer["mlp_norm"], cfg.norm_eps)
    gates = torch.softmax(y.float() @ layer["w_router"], dim=-1)
    mesh = active_mesh()
    tp = tensor_group()
    # the rows into the expert products (tensor-split over mlp); the
    # router above reads y whole
    ye = copy_to(y, tp)
    ep_mesh = active_expert_mesh()
    if ep_mesh is not None and cfg.dispatch_mode != "grouped":
        # the non-expert-parallel modes compute every expert on this
        # rank's rows: the expert stacks all-gathered over "expert"
        layer = {**layer, **{w: all_gather(layer[w], 0,
                                           ep_mesh.group("expert"))
                             for w in ("w_gate", "w_up", "w_down")}}

    if cfg.dispatch_mode == "grouped" and ep_mesh is not None:
        out = grouped_ep_mlp(cfg, ye, gates, layer, ep_mesh)
        # the round-0 selection the local plans use
        first = _topk_selection(gates, 1)[1][0]
    elif cfg.dispatch_mode == "einsum":
        dispatch, combine, first = _route(gates, k, C)
        xe = torch.einsum("bsec,bsd->ebcd", dispatch.to(cfg.dtype), ye)
        gated = F.silu(torch.einsum("ebcd,edf->ebcf", xe, layer["w_gate"])) \
            * torch.einsum("ebcd,edf->ebcf", xe, layer["w_up"])
        out_e = reduce_from(
            torch.einsum("ebcf,efd->ebcd", gated, layer["w_down"]), tp)
        out = torch.einsum("ebcd,bsec->bsd", out_e, combine.to(cfg.dtype))
    elif cfg.dispatch_mode == "gather":
        dst, keep, weight, first = _route_plan(gates, k, C)
        src, valid = _slot_sources(dst, keep, E * C)
        dst, keep, weight, src, valid = (
            _named(cfg, t, "moe_plan") for t in (dst, keep, weight, src, valid))
        xe = _named(cfg, _DispatchRows.apply(ye, src, valid, dst, keep),
                    "moe_dispatch")
        out_e = _named(cfg, reduce_from(
            _expert_mlp(xe.reshape(b, E, C, d), layer), tp), "moe_expert_out")
        out = _CombineRows.apply(out_e.reshape(b, E * C, d), weight, dst,
                                 keep, src, valid)
    elif cfg.dispatch_mode == "grouped":
        m_rows = b * s * k
        m_pad = -(-m_rows // DEFAULT_BLOCK_M) * DEFAULT_BLOCK_M
        perm, sizes, token_of, inv, weight, first = _grouped_sort_plan(
            gates, k, E)
        # alignment pad rows ride in the last group; their lhs rows are
        # zero, so their outputs are zero and nothing gathers them back
        sizes[E - 1] += m_pad - m_rows
        perm, sizes, token_of, inv, weight = (
            _named(cfg, t, "moe_plan")
            for t in (perm, sizes, token_of, inv, weight))
        lhs = F.pad(_DispatchSorted.apply(ye.reshape(b * s, d), token_of,
                                          inv, k), (0, 0, 0, m_pad - m_rows))
        lhs = _named(cfg, lhs, "moe_dispatch")
        gated = F.silu(grouped_matmul(lhs, layer["w_gate"], sizes,
                                      use_kernel=cfg.use_kernel)) \
            * grouped_matmul(lhs, layer["w_up"], sizes,
                             use_kernel=cfg.use_kernel)
        # the kernel lane's output carries its name itself: a tag after it
        # could not stop the launch that the "moe" policy saves
        rows_out = reduce_from(grouped_matmul(
            gated, layer["w_down"], sizes, use_kernel=cfg.use_kernel,
            checkpoint_name="moe_expert_out"), tp)
        rows_tok = _UnsortRows.apply(rows_out[:m_rows], inv, perm)
        w_tok = weight.permute(1, 2, 0).reshape(b, s, k)
        out = torch.sum(rows_tok.reshape(b, s, k, d)
                        * w_tok[..., None].to(rows_tok.dtype), dim=2)
    else:
        raise ValueError(f"unknown dispatch_mode {cfg.dispatch_mode!r}")

    # Switch-style load-balance loss: n_experts · Σ_e f_e · P_e, f_e the
    # fraction of tokens whose FIRST choice is e, P_e the mean gate of e
    f = first.mean(dim=(0, 1))
    p = gates.mean(dim=(0, 1))
    if mesh is not None:
        # over the whole batch: the ranks' equal-sized means averaged
        dp_axes = data_axes_in(mesh)
        dp = mesh.group(dp_axes)
        n = math.prod(mesh.shape[a] for a in dp_axes)
        f = all_reduce_raw(f, dp) / n
        p = all_reduce(p, dp) / n
    return x + out, E * torch.sum(f * p)


# -- forward ------------------------------------------------------------------

def _block(cfg: MoEConfig, cos, sin, x, layer):
    layer = use_layer(cfg, layer)
    return moe_sublayer(cfg, attention_sublayer(cfg, cos, sin, x, layer),
                        layer)


def _logits_with_aux(params: dict, tokens: torch.Tensor, cfg: MoEConfig
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens (b, s) int → (:func:`~models.llama.head_logits`, mean aux)."""
    cos, sin = rope_tables(cfg.head_dim, cfg.max_seq, cfg.rope_theta,
                           tokens.device)
    x = embed_tokens(params, tokens, cfg)
    remat = cfg.remat and torch.is_grad_enabled()
    kwargs = remat_policy_kwargs(cfg) if remat else {}
    # one unbind per stacked leaf (see llama.forward)
    stacked = {k: v.unbind(0) for k, v in params["layers"].items()}
    block = in_context_mesh(_block)      # see llama._hidden
    auxes = []
    for li in range(params["layers"]["wq"].shape[0]):
        layer = {k: v[li] for k, v in stacked.items()}
        if remat:
            x, aux = checkpoint(block, cfg, cos, sin, x, layer, **kwargs)
        else:
            x, aux = _block(cfg, cos, sin, x, layer)
        auxes.append(aux)
    return head_logits(params, x, cfg), torch.stack(auxes).mean()


def forward_with_aux(params: dict, tokens: torch.Tensor, cfg: MoEConfig
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens (b, s) int → (logits (b, s, vocab) f32, mean aux loss)."""
    logits, aux = _logits_with_aux(params, tokens, cfg)
    return full_logits(logits), aux


def forward(params: dict, tokens: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    return forward_with_aux(params, tokens, cfg)[0]


def loss_fn(params: dict, tokens: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """Next-token cross-entropy + router load-balance auxiliary loss."""
    logits, aux = _logits_with_aux(params, tokens[:, :-1], cfg)
    return nll(logits, tokens[:, 1:]) + cfg.router_aux_coef * aux
