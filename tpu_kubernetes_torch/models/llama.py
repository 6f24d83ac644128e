"""LLaMA-family decoder-only transformer, functional PyTorch (port of
``tpu_kubernetes/models/llama.py``, dense part).

Same layout as the reference so weights carry over by a plain copy: params
are a nested dict of tensors, layer leaves stacked on a leading
``(n_layers, …)`` axis, weights ``(in, out)`` used as ``x @ W``. GQA repeats
the KV heads (``repeat_interleave``, the reference's ``jnp.repeat``) just
before attention. :func:`forward` is differentiable; with ``cfg.remat``
each block runs under ``torch.utils.checkpoint`` with the reference's
policies (:func:`remat_policy_kwargs`). The serving entry points in
``models/decode.py`` carry their own ``torch.no_grad``.

Under a mesh (``parallel.mesh_context``, entered by the sharded train and
eval steps) the same functions run on this rank's shards, laid out by
:func:`logical_axes`, and on its rows of the batch: each block all-gathers
the ``fsdp``-split dimension of the weights it uses (ZeRO-3; the backward
reduce-scatters their gradients); under ``tensor`` wq/wk/wv and
w_gate/w_up are column-split (over heads, kv and mlp) and wo and w_down
row-split, followed by an all-reduce (Megatron), the embedding looks up
its vocab rows and all-reduces, and ``lm_head`` is split over the vocab:
:func:`loss_fn` then takes the vocab-parallel loss and :func:`forward`
gathers the logits. The loss is this rank's rows' mean; the step averages
it over the data-like ranks.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from tpu_kubernetes_torch.models.quant import (
    is_quantized,
    layer_slice,
    matmul_w,
    quantized_sharding,
)
from tpu_kubernetes_torch.ops import (
    apply_rope,
    flash_attention,
    next_token_nll,
    rms_norm,
    rope_tables,
)
from tpu_kubernetes_torch.ops.losses import next_token_nll_vocab_parallel
from tpu_kubernetes_torch.parallel.collectives import (
    copy_to,
    gather_from,
    reduce_from,
)
from tpu_kubernetes_torch.parallel.mesh import (
    active_mesh,
    gather_axes,
    in_context_mesh,
    param_shardings,
)


@dataclass(frozen=True)
class ModelConfig:
    vocab_size: int = 32000
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32
    d_ff: int = 11008
    max_seq: int = 2048
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    dtype: torch.dtype = torch.bfloat16
    # attention block contract, forwarded to ops.flash_attention (the
    # kernel tiles on its own; these only fix which lengths are accepted)
    attn_block_q: int = 512
    attn_block_k: int = 512
    use_kernel: bool | None = None
    remat: bool = True
    # "dots" saves the weight-matmul outputs and recomputes attention,
    # norms and RoPE in the backward; "full" recomputes everything
    remat_policy: str = "dots"  # "dots" | "full"

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


# -- presets (the reference's dense presets) ---------------------------------
CONFIGS: dict[str, ModelConfig] = {
    "llama-test": ModelConfig(
        vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
        d_ff=128, max_seq=128, remat=False,
    ),
    "llama-125m": ModelConfig(
        vocab_size=32000, d_model=768, n_layers=12, n_heads=12, n_kv_heads=12,
        d_ff=2048, max_seq=2048,
    ),
    "llama-1b": ModelConfig(
        vocab_size=32000, d_model=2048, n_layers=16, n_heads=16, n_kv_heads=8,
        d_ff=5632, max_seq=2048,
    ),
    "llama-7b": ModelConfig(),  # the defaults above are Llama-2-7B
    "llama-70b": ModelConfig(
        d_model=8192, n_layers=80, n_heads=64, n_kv_heads=8, d_ff=28672,
        max_seq=4096,
    ),
}


# -- parameter init -----------------------------------------------------------

def _dense_init(shape, cfg: ModelConfig, fan_in: float,
                generator: torch.Generator, device) -> torch.Tensor:
    x = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device)
    return (x / fan_in ** 0.5).to(cfg.dtype)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: torch.device | str = "cuda") -> dict:
    """Random parameters in the reference's layout and scale (normal /
    √fan_in, norms at 1), drawn from ``generator`` — which must live on
    ``device``. The draws differ from ``jax.random``'s; tests carry JAX
    weights over with ``models.from_jax`` instead."""
    d, h, kv, hd, ff, L = (
        cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
        cfg.d_ff, cfg.n_layers,
    )

    def init(shape, fan_in):
        return _dense_init(shape, cfg, fan_in, generator, device)

    def ones(shape):
        return torch.ones(shape, dtype=cfg.dtype, device=device)

    return {
        "embed": init((cfg.vocab_size, d), 1.0),
        "layers": {
            "attn_norm": ones((L, d)),
            "wq": init((L, d, h * hd), d),
            "wk": init((L, d, kv * hd), d),
            "wv": init((L, d, kv * hd), d),
            "wo": init((L, h * hd, d), h * hd),
            "mlp_norm": ones((L, d)),
            "w_gate": init((L, d, ff), d),
            "w_up": init((L, d, ff), d),
            "w_down": init((L, ff, d), ff),
        },
        "final_norm": ones((d,)),
        "lm_head": init((d, cfg.vocab_size), d),
    }


def logical_axes(cfg: ModelConfig) -> dict:
    """Logical sharding axes, one tuple per param leaf (None = replicated
    dim), the reference's table; ``parallel/mesh.py``'s rules map them to
    mesh axes."""
    return {
        "embed": ("vocab", "embed"),
        "layers": {
            "attn_norm": ("layer", "embed"),
            "wq": ("layer", "embed", "heads"),
            "wk": ("layer", "embed", "kv"),
            "wv": ("layer", "embed", "kv"),
            "wo": ("layer", "heads", "embed"),
            "mlp_norm": ("layer", "embed"),
            "w_gate": ("layer", "embed", "mlp"),
            "w_up": ("layer", "embed", "mlp"),
            "w_down": ("layer", "mlp", "embed"),
        },
        "final_norm": ("embed",),
        "lm_head": ("embed", "vocab"),
    }


def param_count(params: dict) -> int:
    def leaves(tree):
        for v in tree.values():
            yield from leaves(v) if isinstance(v, dict) else (v,)

    return sum(int(p.numel()) for p in leaves(params))


def layer_params(params: dict, li: int) -> dict:
    """Layer ``li``'s slice of the stacked layer leaves (views, no copy):
    an int8 leaf's ``q`` and ``s`` alike (``models/quant.py``)."""
    return {k: layer_slice(v, li) for k, v in params["layers"].items()}


# -- forward --------------------------------------------------------------------

def repeat_kv(x: torch.Tensor, rep: int) -> torch.Tensor:
    """GQA: (b, kv, s, d) → (b, kv*rep, s, d), each KV head repeated
    ``rep`` times in place (head i reads KV head i // rep)."""
    return x if rep == 1 else x.repeat_interleave(rep, dim=1)


def attention_sublayer(cfg: ModelConfig, cos, sin, x, layer):
    """Pre-norm attention + residual. x: (batch, seq, d_model)."""
    return attention_with_kv(cfg, cos, sin, x, layer)[0]


def attention_with_kv(cfg: ModelConfig, cos, sin, x, layer):
    """:func:`attention_sublayer` that also hands back this layer's K and
    V after RoPE, in KV heads (batch, kv_heads, seq, head_dim) — what
    prefill writes into the cache. → (x, k, v). The weight products go
    through :func:`~tpu_kubernetes_torch.models.quant.matmul_w`: a plain
    weight multiplies as ``y @ W`` (training), an int8 leaf through the
    weight-only int8 matmul (serving)."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    use = cfg.use_kernel
    tp = tensor_group()

    # under a tensor split this rank holds n_heads / tensor query heads
    # and n_kv_heads / tensor KV heads, so the GQA ratio is the model's
    y = copy_to(rms_norm(x, layer["attn_norm"], cfg.norm_eps), tp)
    q = matmul_w(y, layer["wq"], use).reshape(b, s, -1, hd).transpose(1, 2)
    k = matmul_w(y, layer["wk"], use).reshape(b, s, -1, hd).transpose(1, 2)
    v = matmul_w(y, layer["wv"], use).reshape(b, s, -1, hd).transpose(1, 2)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    # the rank's own ratio: the model's, or under serving's KV replication
    # (a tensor split wider than the KV heads) its query heads over one
    rep = q.shape[1] // k.shape[1]
    attn = flash_attention(
        q, repeat_kv(k, rep).contiguous(), repeat_kv(v, rep).contiguous(),
        causal=True, block_q=cfg.attn_block_q, block_k=cfg.attn_block_k,
        use_kernel=cfg.use_kernel,
    )
    attn = attn.transpose(1, 2).reshape(b, s, -1)
    return x + reduce_from(matmul_w(attn, layer["wo"], use), tp), k, v


def mlp_sublayer(cfg: ModelConfig, x, layer):
    """Pre-norm SwiGLU MLP + residual (weights through ``matmul_w``)."""
    use = cfg.use_kernel
    tp = tensor_group()
    y = copy_to(rms_norm(x, layer["mlp_norm"], cfg.norm_eps), tp)
    gated = torch.nn.functional.silu(matmul_w(y, layer["w_gate"], use)) * (
        matmul_w(y, layer["w_up"], use))
    return x + reduce_from(matmul_w(gated, layer["w_down"], use), tp)


def _block(cfg: ModelConfig, cos, sin, x, layer):
    """One transformer block. x: (batch, seq, d_model)."""
    layer = use_layer(cfg, layer)
    return mlp_sublayer(cfg, attention_sublayer(cfg, cos, sin, x, layer), layer)


# -- under a mesh ----------------------------------------------------------------

def tensor_group():
    """The active mesh's ``tensor`` group, or None (no mesh, or tensor of
    size 1): then every collective of the blocks is the identity and the
    one-device graph runs as it is."""
    mesh = active_mesh()
    return None if mesh is None else mesh.group("tensor")


@functools.lru_cache(maxsize=64)
def shardings_for(cfg: ModelConfig, mesh) -> dict:
    """The mesh's shardings of every param leaf of ``cfg``'s family."""
    from tpu_kubernetes_torch.models import logical_axes as family_axes

    return param_shardings(family_axes(cfg), mesh)


def use_layer(cfg: ModelConfig, layer: dict) -> dict:
    """One layer's leaves as the block uses them: under a mesh, each
    ``fsdp``-split dimension all-gathered (inside the block, so remat
    gathers again in the backward, and the gathered weights live for one
    layer; an int8 leaf's ``q`` and ``s`` each); without one, ``layer``
    itself."""
    mesh = active_mesh()
    if mesh is None or mesh.axis_size("fsdp") == 1:
        return layer
    sh = shardings_for(cfg, mesh)["layers"]
    return {k: gather_fsdp(v, sh[k], drop=1) for k, v in layer.items()}


def gather_fsdp(leaf, sharding, drop: int = 0):
    """``leaf`` (a tensor or an int8 leaf, ``models/quant.py``) with its
    ``fsdp``-split dimensions all-gathered (see ``gather_axes``)."""
    if is_quantized(leaf):
        sh = quantized_sharding(sharding)
        return {k: gather_axes(leaf[k], sh[k], ("fsdp",), drop)
                for k in ("q", "s")}
    return gather_axes(leaf, sharding, ("fsdp",), drop)


def kv_replicated(cfg: ModelConfig, mesh) -> bool:
    """True where ``mesh``'s tensor axis is wider than the KV heads: each
    rank then holds wk/wv whole and keeps the one KV head its query heads
    read (Megatron's KV replication; the serving path only, the train step
    refuses such a mesh)."""
    t = mesh.axis_size("tensor")
    return t > 1 and cfg.n_kv_heads % t != 0


def rank_kv_heads(cfg: ModelConfig) -> int:
    """The KV heads this rank holds under the context mesh: the model's
    over ``tensor``, 1 under :func:`kv_replicated`; without a mesh all."""
    mesh = active_mesh()
    if mesh is None or mesh.axis_size("tensor") == 1:
        return cfg.n_kv_heads
    if kv_replicated(cfg, mesh):
        return 1
    return cfg.n_kv_heads // mesh.axis_size("tensor")


def embed_tokens(params: dict, tokens: torch.Tensor, cfg: ModelConfig
                 ) -> torch.Tensor:
    """(b, s) ids → (b, s, d) rows of the embedding: under a ``tensor``
    split of the vocab, this rank's rows (the others zero), all-reduced."""
    mesh = active_mesh()
    if mesh is None:
        return params["embed"][tokens.long()]
    sh = shardings_for(cfg, mesh)["embed"]
    table = gather_axes(params["embed"], sh, ("fsdp",))
    tp = mesh.group("tensor")
    if tp is None:
        return table[tokens.long()]
    n = table.shape[0]
    local = tokens.long() - mesh.my_coords()["tensor"] * n
    hit = (local >= 0) & (local < n)
    rows = table[local.clamp(0, n - 1)] * hit[..., None].to(table.dtype)
    return reduce_from(rows, tp)


def head_logits(params: dict, x: torch.Tensor, cfg: ModelConfig
                ) -> torch.Tensor:
    """Final norm + ``lm_head`` → f32 logits: under a ``tensor`` split,
    this rank's vocab columns."""
    mesh = active_mesh()
    if mesh is None:
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return (x @ params["lm_head"]).float()
    sh = shardings_for(cfg, mesh)
    norm = gather_axes(params["final_norm"], sh["final_norm"], ("fsdp",))
    head = gather_axes(params["lm_head"], sh["lm_head"], ("fsdp",))
    x = copy_to(rms_norm(x, norm, cfg.norm_eps), mesh.group("tensor"))
    return (x @ head).float()


def full_logits(logits: torch.Tensor) -> torch.Tensor:
    """:func:`head_logits`' columns → every vocab column."""
    return gather_from(logits, -1, tensor_group())


def nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """The next-token loss of :func:`head_logits`' output: vocab-parallel
    under a ``tensor`` split."""
    tp = tensor_group()
    if tp is None:
        return next_token_nll(logits, targets)
    return next_token_nll_vocab_parallel(
        logits, targets, active_mesh().my_coords()["tensor"]
        * logits.shape[-1], tp)


def _save_weight_products(ctx, op, *args, **kwargs):
    """The "dots" policy: keep the output of every 2-D matrix product
    (the ``y @ W`` weight products reach autograd as ``aten.mm``) and
    recompute the rest."""
    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


# the names the MoE layer (models/moe.py) gives its routing plan, its
# dispatched rows and its expert outputs: saved under the "moe" policy, so
# the backward reads the forward's routing and the w_down product
MOE_SAVED_NAMES = ("moe_plan", "moe_dispatch", "moe_expert_out")


@torch.library.custom_op("tpu_kubernetes_torch::checkpoint_name",
                         mutates_args=())
def _checkpoint_name_op(x: torch.Tensor, name: str) -> torch.Tensor:
    return x.clone()      # a custom op may not hand back its input


def _pass_gradient(ctx, grad):
    return grad, None


_checkpoint_name_op.register_autograd(_pass_gradient)


def checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """``x`` tagged with ``name`` (the reference's
    ``jax.ad_checkpoint.checkpoint_name``): an op the "moe" policy sees
    and saves. It copies ``x``, so callers tag only under that policy."""
    return torch.ops.tpu_kubernetes_torch.checkpoint_name(x, name)


def _save_moe_names(ctx, op, *args, **kwargs):
    """The "moe" policy: "dots", plus every tagged tensor and the grouped
    kernel's output where it carries a saved name (the w_down product)."""
    if op is torch.ops.tpu_kubernetes_torch.checkpoint_name.default:
        return CheckpointPolicy.MUST_SAVE
    if (op is torch.ops.tpu_kubernetes_torch.gmm.default
            and args[3] in MOE_SAVED_NAMES):
        return CheckpointPolicy.MUST_SAVE
    return _save_weight_products(ctx, op, *args, **kwargs)


def remat_policy_kwargs(cfg: ModelConfig) -> dict:
    """→ kwargs for ``torch.utils.checkpoint.checkpoint`` per
    ``cfg.remat_policy``. "dots" is the analogue of the reference's
    ``dots_with_no_batch_dims_saveable``: the weight products are saved,
    attention (batched products, and the flash kernel, which therefore
    launches again in the backward, as the Pallas call re-runs under
    ``jax.checkpoint``), norms and RoPE are recomputed. "moe" is "dots"
    plus the MoE layer's named tensors (:data:`MOE_SAVED_NAMES`): the
    grouped kernel launches again for the w_gate and w_up products and not
    for w_down, as under the reference's policy. The recompute replays the
    routing ops (torch's checkpoint reruns the block eagerly where XLA
    drops what nothing reads), but the saved plan is what the backward
    uses. "full" saves nothing."""
    # no random op runs inside a block, so no RNG state is stashed for
    # the recompute (reading the CUDA generator's state is refused while a
    # CUDA graph captures the step)
    base = {"use_reentrant": False, "preserve_rng_state": False}
    if cfg.remat_policy == "dots":
        return {**base, "context_fn": functools.partial(
            create_selective_checkpoint_contexts, _save_weight_products)}
    if cfg.remat_policy == "moe":
        return {**base, "context_fn": functools.partial(
            create_selective_checkpoint_contexts, _save_moe_names)}
    if cfg.remat_policy == "full":
        return base
    raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}")


def _hidden(params: dict, tokens: torch.Tensor, cfg: ModelConfig
            ) -> torch.Tensor:
    """tokens (batch, seq) int → the last block's output (batch, seq, d)."""
    cos, sin = rope_tables(cfg.head_dim, cfg.max_seq, cfg.rope_theta,
                           tokens.device)
    x = embed_tokens(params, tokens, cfg)
    # trade FLOPs for memory across layers, only where a backward will run
    remat = cfg.remat and torch.is_grad_enabled()
    kwargs = remat_policy_kwargs(cfg) if remat else {}
    # one unbind per stacked leaf: its backward stacks the layers'
    # gradients once, where a per-layer select would add a full-size zero
    # gradient per layer
    stacked = {k: v.unbind(0) for k, v in params["layers"].items()}
    # the recompute runs on the autograd engine's thread: under this mesh
    block = in_context_mesh(_block)
    for li in range(params["layers"]["wq"].shape[0]):
        layer = {k: v[li] for k, v in stacked.items()}
        if remat:
            x = checkpoint(block, cfg, cos, sin, x, layer, **kwargs)
        else:
            x = _block(cfg, cos, sin, x, layer)
    return x


def forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """tokens (batch, seq) int → logits (batch, seq, vocab) float32."""
    return full_logits(head_logits(params, _hidden(params, tokens, cfg), cfg))


def loss_fn(params: dict, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Next-token cross-entropy over (batch, seq) tokens."""
    logits = head_logits(params, _hidden(params, tokens[:, :-1], cfg), cfg)
    return nll(logits, tokens[:, 1:])
