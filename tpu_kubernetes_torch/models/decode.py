"""Autoregressive inference for both model families (dense LLaMA and
MoE): KV-cache prefill + decode (port of ``tpu_kubernetes/models/decode.py``).

* **Cache in KV heads**, stacked ``(n_layers, batch, kv_heads, span,
  head_dim)``; decode attention groups query heads over their KV head
  (``q.reshape(b, kv, rep, c, d)``, the same head→KV mapping as the
  prefill's ``repeat_interleave``), so the cache is never widened.
* **Cache written in place.** Each layer writes its new positions into
  the preallocated cache tensors (``index_copy_`` at a slot held in a
  device tensor, so a CUDA graph of the step reads the slot at replay);
  no restacking. A step therefore mutates the cache it is given: the
  returned :class:`KVCache` shares its ``k``/``v`` tensors with the
  argument, and ``prefill`` can fill a caller's cache.
* **Ragged (right-padded) prompt batches** carry ``prompt_lengths`` and
  ``prompt_slots``: row i's real slots are ``[0, prompt_lengths[i])`` ∪
  ``[prompt_slots, length)``, everything else is masked, and generated
  tokens take the gapless positions ``prompt_lengths[i] + t``.
* Prefill runs the flash-attention dispatcher (the CUDA kernel on the
  card); decode attention runs the decode-attention dispatcher
  (``ops/decode_attention.py``: the port's kernel on the card, which
  reads the bf16 cache once and skips masked positions; the reference's
  masked f32 product on the CPU).
* **Chunks** (:func:`decode_chunk`, :func:`prefill_chunked` and
  :func:`prefill_resume`, the warm-prefix resume behind the server's
  prefix cache): c > 1 positions at once against the cache. On the card a
  chunk of at most ``MAX_CHUNK`` (16) positions, a speculative verify
  window among them, attends through the decode-attention kernel's chunk
  route over a uniform or a ragged cache, with each chunk row's own
  limit; a longer chunk over a uniform cache (a resumed prompt suffix)
  attends through the flash forward at seq_q = c < seq_k, the diagonal
  offset by the cached positions, and a longer one over a ragged cache
  raises there; on the CPU a chunk runs the reference's masked product.
* **Speculative verify rounds** (:func:`decode_verify_slots`,
  :func:`decode_verify_paged`, :func:`_verify_accept`): every slot row
  runs its ``draft_k + 1``-token window in one forward and keeps its
  matched draft prefix plus the target's own correction token, the state
  advanced in place by each row's accepted length.
* **Sampling a graph can hold** (:func:`sample_tokens`): the reference's
  filter (:func:`filter_logits`: temperature, top-k, nucleus) and a
  Gumbel-max :func:`draw`, with the knob values in a device tensor and
  the parts that run fixed by a variant (:func:`sampling_variant`);
  :func:`generate_into` is :func:`generate`'s body on caller-owned
  buffers, one CUDA graph per shape and variant in the server.
* MoE: the routed layer runs per chunk (the prompt in prefill, one token
  per decode step), so expert-capacity dropping, whose threshold scales
  with the chunk's length, effectively never fires at decode time; decode
  matches the training forward wherever nothing would be dropped. With
  ``dispatch_mode="grouped"`` every chunk runs the grouped kernels.

* **Continuous batching** (:class:`SlotState`): every row of a fixed
  (slots, max_seq) cache is its own request at its own position; rows are
  grafted in (:func:`cache_insert_row`) and wiped (:func:`cache_clear_row`)
  in place at a slot held in a 0-d device tensor, and
  :func:`decode_segment_slots` advances the slot state in place, so one
  captured program of each serves every slot.
* **Paged KV** (:class:`PagedKVCache`): the slots' positions live in a
  shared pool of fixed-size pages through a per-slot page table;
  :func:`paged_insert_row`, :func:`paged_clear_pages` and
  :func:`decode_segment_paged` update the pool in place (the reference
  donates it), and none reads the device on the host.

* **Int8 weights** (``models/quant.py``): every weight product reads its
  leaf through :func:`~tpu_kubernetes_torch.models.quant.matmul_w`, so a
  tree from ``quantize_for_decode`` serves through the same entry points
  (the weight-only int8 matmul kernel on the card); MoE expert stacks are
  dequantized to ``cfg.dtype`` before the routed layer, as in the
  reference.
* **Under a mesh** (``parallel.mesh_context``, entered by
  ``parallel/serving.py``): every entry point runs on this rank's shards
  and rows. A block projects this rank's query and KV heads
  (:func:`_qkv`) and all-reduces the attention output after ``wo`` over
  ``tensor`` (:func:`_attn_residual`; the MLP's after ``w_down``), the
  embedding looks up its vocab rows (``llama.embed_tokens``), the head
  computes its vocab columns and gathers them whole before any argmax,
  filter or draw (:func:`_logits`), each layer's ``fsdp``-split leaves
  are gathered as the block uses them (:func:`_layer`), and every cache
  and pool holds this rank's KV heads (``llama.rank_kv_heads``).
* **The int8 KV cache** (``kv_quant=True``): K/V stored as int8 with one
  f32 scale a (layer, row, KV head, position), symmetric absmax / 127
  over the head dim (:func:`_quantize_kv`), quantized on write and
  dequantized on read (on the card the decode-attention kernel's "tc8"
  route at bf16 and head_dim 64/128, its "q8" route otherwise). Prefill
  attends its own unquantized K/V and stores them
  quantized; unwritten slots hold q 0 and scale 1. Dense and paged alike.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable

import torch

from tpu_kubernetes_torch.models.llama import (
    ModelConfig,
    attention_with_kv,
    embed_tokens,
    full_logits,
    gather_fsdp,
    kv_replicated,
    layer_params,
    mlp_sublayer,
    rank_kv_heads,
    repeat_kv,
    shardings_for,
    tensor_group,
    use_layer,
)
from tpu_kubernetes_torch.models.moe import MoEConfig, moe_sublayer
from tpu_kubernetes_torch.models.quant import is_quantized, matmul_w, weight
from tpu_kubernetes_torch.ops import (
    apply_rope,
    decode_attention,
    flash_attention,
    rms_norm,
    rope_tables,
)
from tpu_kubernetes_torch.ops.decode_attention import MAX_CHUNK
from tpu_kubernetes_torch.parallel.collectives import copy_to, reduce_from
from tpu_kubernetes_torch.parallel.mesh import active_mesh

_LONG_RAGGED_CHUNK = (
    f"a chunk of more than MAX_CHUNK = {MAX_CHUNK} positions over a ragged "
    f"cache (prompt_lengths set) has no kernel on the card: the "
    f"decode-attention kernel's chunk route takes at most {MAX_CHUNK} "
    f"positions a row, and the flash forward has no pad-gap mask"
)


@dataclass(frozen=True)
class KVCache:
    """k/v: (n_layers, batch, kv_heads, span, head_dim); ``length`` is the
    number of filled slots (uniform across the batch). Ragged batches set
    ``prompt_lengths`` ((batch,) int32 tensor) and ``prompt_slots`` (the
    padded prompt width where generation slots begin); both None is the
    uniform case. An int8 cache (``kv_quant``) holds int8 k/v and their
    f32 dequant scales ``k_scale``/``v_scale`` (n_layers, batch, kv_heads,
    span), one a position and KV head; a full-precision cache has None."""

    k: torch.Tensor
    v: torch.Tensor
    length: int
    prompt_lengths: torch.Tensor | None = None
    prompt_slots: int | None = None
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None


def init_cache(cfg: ModelConfig, batch: int, max_seq: int | None = None,
               kv_quant: bool = False,
               device: torch.device | str = "cuda") -> KVCache:
    """A cold cache: zeros, and with ``kv_quant`` int8 zeros with scales
    1.0. Under a mesh its KV-head axis holds this rank's heads
    (``llama.rank_kv_heads``)."""
    s = max_seq or cfg.max_seq
    shape = (cfg.n_layers, batch, rank_kv_heads(cfg), s, cfg.head_dim)
    if kv_quant:
        return KVCache(
            k=torch.zeros(shape, dtype=torch.int8, device=device),
            v=torch.zeros(shape, dtype=torch.int8, device=device),
            length=0,
            k_scale=torch.ones(shape[:-1], dtype=torch.float32,
                               device=device),
            v_scale=torch.ones(shape[:-1], dtype=torch.float32,
                               device=device),
        )
    return KVCache(
        k=torch.zeros(shape, dtype=cfg.dtype, device=device),
        v=torch.zeros(shape, dtype=cfg.dtype, device=device),
        length=0,
    )


def _quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(…, head_dim) float → (int8 values, f32 scale (…,)): symmetric
    absmax / 127 over the head dim, rounded half to even (the reference's
    ``_quantize_kv``, bit for bit, in few elementwise kernels: a decode
    step runs it once a layer, K and V stacked)."""
    x32 = x.float()
    absmax = torch.linalg.vector_norm(x32, ord=float("inf"), dim=-1)
    scale = torch.where(absmax > 0, absmax / 127.0, 1.0)
    q = (x32 / scale[..., None]).round_().clamp_(-127, 127)
    return q.to(torch.int8), scale


def _quantize_pair(k: torch.Tensor, v: torch.Tensor) -> tuple:
    """K and V quantized in one pass → (k int8, v int8, k scale, v
    scale)."""
    q, sc = _quantize_kv(torch.stack((k, v)))
    return q[0], q[1], sc[0], sc[1]


def _mm(cfg, x: torch.Tensor, leaf) -> torch.Tensor:
    """A weight product of the serving path: a plain tensor or an int8
    leaf (``models/quant.py``), on the lane ``cfg.use_kernel`` picks."""
    return matmul_w(x, leaf, cfg.use_kernel)


def _layer(cfg: ModelConfig, params: dict, li: int) -> dict:
    """Layer ``li``'s leaves as this rank's blocks use them: under a mesh
    the ``fsdp``-split dimensions gathered (``llama.use_layer``) and,
    where the tensor split is wider than the KV heads
    (``llama.kv_replicated``), the whole wk/wv cut to the columns of the
    one KV head the rank's query heads read."""
    layer = use_layer(cfg, layer_params(params, li))
    mesh = active_mesh()
    if mesh is None or not kv_replicated(cfg, mesh):
        return layer
    i = mesh.my_coords()["tensor"] // (mesh.axis_size("tensor")
                                       // cfg.n_kv_heads)
    cols = slice(i * cfg.head_dim, (i + 1) * cfg.head_dim)

    def cut(leaf):
        if is_quantized(leaf):
            return {k: leaf[k][..., cols].contiguous() for k in ("q", "s")}
        return leaf[..., cols].contiguous()

    return {**layer, "wk": cut(layer["wk"]), "wv": cut(layer["wv"])}


def _qkv(cfg: ModelConfig, x: torch.Tensor, layer: dict) -> tuple:
    """The attention block's projections of x (b, c, d), before RoPE, in
    this rank's heads: q (b, h, c, hd), k and v (b, kv, c, hd). The normed
    input enters the tensor-split products through ``copy_to``."""
    b, c, _ = x.shape
    y = copy_to(rms_norm(x, layer["attn_norm"], cfg.norm_eps),
                tensor_group())

    def heads(name):
        return _mm(cfg, y, layer[name]).reshape(
            b, c, -1, cfg.head_dim).transpose(1, 2)

    return heads("wq"), heads("wk"), heads("wv")


def _attn_residual(cfg: ModelConfig, x: torch.Tensor, attn: torch.Tensor,
                   layer: dict) -> torch.Tensor:
    """x + the attention output (b, h, c, hd) through ``wo``, its partial
    sums over this rank's heads all-reduced over ``tensor``."""
    b, _, c, _ = attn.shape
    attn = attn.transpose(1, 2).reshape(b, c, -1)
    return x + reduce_from(_mm(cfg, attn, layer["wo"]), tensor_group())


def _logits(params: dict, x: torch.Tensor, cfg: ModelConfig
            ) -> torch.Tensor:
    """The final norm and ``lm_head`` (plain or int8, through ``_mm``) →
    f32 logits over every vocab column: under a mesh this rank's columns,
    all-gathered over ``tensor`` (``llama.full_logits``), so every rank
    along ``tensor`` takes its argmax, filter and draw over the same
    row."""
    mesh = active_mesh()
    norm, head = params["final_norm"], params["lm_head"]
    if mesh is not None:
        sh = shardings_for(cfg, mesh)
        norm = gather_fsdp(norm, sh["final_norm"])
        head = gather_fsdp(head, sh["lm_head"])
    x = copy_to(rms_norm(x, norm, cfg.norm_eps), tensor_group())
    return full_logits(_mm(cfg, x, head).float())


def _mlp(cfg: ModelConfig, x: torch.Tensor, layer: dict) -> torch.Tensor:
    """The post-attention sublayer of either family (residual included).
    An MoE layer's int8 expert stacks are dequantized to ``cfg.dtype``
    first (the reference's ``_mlp``), then run the routed layer (the
    grouped kernels under ``dispatch_mode="grouped"``)."""
    if isinstance(cfg, MoEConfig):
        experts = ("w_gate", "w_up", "w_down")
        if any(is_quantized(layer[k]) for k in experts):
            layer = {**layer,
                     **{k: weight(layer[k], cfg.dtype) for k in experts}}
        return moe_sublayer(cfg, x, layer)[0]
    return mlp_sublayer(cfg, x, layer)


def _attend_cache(cfg, q, k_cache, v_cache, limits,
                  prompt_lengths=None, prompt_slots=None, table=None,
                  k_scale=None, v_scale=None):
    """Decode-side attention: q (b, h, c, d) against the cache
    (b, kv, S, d), or with ``table`` a pool layer read through it; chunk
    row i attends slots < limits[i] (``limits`` (c,) shared across the
    batch, or (b, c) per row). Ragged batches also mask the pad slots
    between a row's prompt and the generation region; an int8 cache
    passes its scales. The dispatcher of ``ops/decode_attention.py``: the
    kernel on the card, the reference's plain computation on the CPU or
    with ``cfg.use_kernel`` False."""
    return decode_attention(q, k_cache, v_cache, limits, prompt_lengths,
                            prompt_slots, table, use_kernel=cfg.use_kernel,
                            k_scale=k_scale, v_scale=v_scale)


def _dequantize(cache: torch.Tensor, scale: torch.Tensor | None, end: int,
                dtype: torch.dtype) -> torch.Tensor:
    """The first ``end`` slots of one layer (b, kv, S, d): as they are,
    or, of an int8 cache, dequantized to ``dtype`` (the reference's
    read, ``q.float() * scale``, then the model's dtype)."""
    if scale is None:
        return cache[:, :, :end]
    return (cache[:, :, :end].float() * scale[:, :, :end, None]).to(dtype)


def _attend_chunk(cfg, q, k_cache, v_cache, end: int, k_scale=None,
                  v_scale=None):
    """A chunk of c > 1 query positions, the last at slot ``end - 1``, of a
    UNIFORM cache through the flash-attention dispatcher: q (b, h, c, d)
    against the cache's first ``end`` slots, widened to the query heads
    (``repeat_kv``; contiguous, which the kernel needs even at rep 1: the
    slice is strided). Causal with the offset ``end - c`` aligned
    bottom-right, chunk row j attends slots <= end - c + j, the
    ``limits`` mask of :func:`_attend_cache`. Over an int8 cache the
    ``end`` slots (the warm prefix and the chunk's own, both quantized)
    are first dequantized to ``cfg.dtype`` into a temporary
    (:func:`_dequantize`), counted in ``_attend_chunk.dequantized``: the
    flash forward reads bf16 or f32."""
    if k_scale is not None:
        _attend_chunk.dequantized += 1
    rep = q.shape[1] // k_cache.shape[1]
    k = _dequantize(k_cache, k_scale, end, cfg.dtype)
    v = _dequantize(v_cache, v_scale, end, cfg.dtype)
    return flash_attention(
        q, repeat_kv(k, rep).contiguous(), repeat_kv(v, rep).contiguous(),
        causal=True, block_q=cfg.attn_block_q, block_k=cfg.attn_block_k,
        use_kernel=cfg.use_kernel)


_attend_chunk.dequantized = 0


def _decode_block(cfg, cos, sin, start, li, x, layer, kv_state,
                  prompt_lengths, prompt_slots, end: int | None):
    """One layer, one chunk of c tokens at slots ``start .. start+c-1``.
    ``start`` is a 0-d int64 tensor on x's device, so a captured program
    reads the slot from memory instead of keeping the one it saw; ``end``
    is the host's ``start + c`` (None when the host does not know it: a
    program whose start moves between replays). x: (b, c, d);
    ``kv_state`` = (k_all, v_all, ks_all, vs_all), the full stacked cache
    and its int8 scales (None, None for a full-precision cache), whose
    layer ``li`` slots are written in place (an int8 cache quantized on
    write). → (x, kv_state).

    A chunk of c <= MAX_CHUNK (a decode step, a speculative verify
    window) attends through the decode-attention dispatcher, over a
    uniform or a ragged cache. A longer chunk on the kernel lane attends
    through the flash forward (:func:`_attend_chunk`: a resumed prompt
    suffix is prefill's work), which needs ``end`` and has no mask for a
    ragged cache's pad gap: a longer chunk over a ragged cache there
    raises before anything runs. On the plain lane every chunk stays on
    the reference's body (:func:`_attend_cache`)."""
    b, c, _ = x.shape
    # the kernel lane: cfg.use_kernel, or by default a CUDA tensor
    flash_chunk = c > MAX_CHUNK and (x.is_cuda if cfg.use_kernel is None
                                     else bool(cfg.use_kernel))
    if flash_chunk and prompt_lengths is not None:
        raise ValueError(_LONG_RAGGED_CHUNK)
    if flash_chunk and end is None:
        raise ValueError(
            f"a chunk of more than MAX_CHUNK = {MAX_CHUNK} positions on the "
            f"card attends through the flash forward, which needs the "
            f"host's end slot: pass no start tensor")
    q, k, v = _qkv(cfg, x, layer)
    slots = start + torch.arange(c, dtype=torch.int64, device=x.device)
    if prompt_lengths is not None:
        # row i's token in SLOT start+j sits at LOGICAL position
        # prompt_lengths[i] + (start - prompt_slots) + j
        positions = (
            prompt_lengths.long()[:, None] + (slots - prompt_slots)[None, :]
        )                                                    # (b, c)
        limits = (slots + 1)[None, :].expand(b, c)
    else:
        positions = slots                                    # (c,)
        limits = positions + 1
    q = apply_rope(q, cos, sin, positions=positions)
    k = apply_rope(k, cos, sin, positions=positions)

    k_all, v_all, ks_all, vs_all = kv_state
    k_sc = v_sc = None
    if ks_all is not None:               # int8 cache: quantize on write
        k, v, k_sc, v_sc = _quantize_pair(k, v)
        ks_all[li].index_copy_(2, slots, k_sc)
        vs_all[li].index_copy_(2, slots, v_sc)
        k_sc, v_sc = ks_all[li], vs_all[li]
    k_all[li].index_copy_(2, slots, k)
    v_all[li].index_copy_(2, slots, v)
    if flash_chunk:
        attn = _attend_chunk(cfg, q, k_all[li], v_all[li], end, k_sc, v_sc)
    else:
        attn = _attend_cache(cfg, q, k_all[li], v_all[li], limits,
                             prompt_lengths, prompt_slots, k_scale=k_sc,
                             v_scale=v_sc)
    x = _attn_residual(cfg, x, attn, layer)
    return _mlp(cfg, x, layer), (k_all, v_all, ks_all, vs_all)


@torch.no_grad()
def prefill(
    params: dict, tokens: torch.Tensor, cfg: ModelConfig,
    max_seq: int | None = None, lengths: torch.Tensor | None = None,
    kv_quant: bool = False, cache: KVCache | None = None,
) -> tuple[torch.Tensor, KVCache]:
    """Process the whole prompt at once. tokens: (batch, prompt_len) →
    (last-position logits (batch, vocab) f32, filled cache of span
    ``max_seq``, K/V zero past the prompt).

    ``lengths`` ((batch,) int32) marks a RIGHT-padded ragged batch: the
    logits are each row's last REAL position and the cache records the
    per-row lengths so decode masks the pad slots (the tensor itself when
    it is int32 on the tokens' device).

    ``cache`` is a caller-owned cache of that span to fill instead of a
    new one (a captured program's outputs must outlive its replay): its
    K/V tensors are written in place, past the prompt with zeros, and the
    returned cache shares them; an int8 caller cache (scales set) is
    filled quantized.

    ``kv_quant`` stores the cache as int8 with a scale a position (see
    :class:`KVCache`): prefill's own attention runs on the unquantized
    K/V, only what later steps read is quantized; the slots past the
    prompt hold q 0 and scale 1."""
    b, plen = tokens.shape
    S = max_seq or cfg.max_seq
    if plen > S:
        raise ValueError(f"prompt_len {plen} exceeds cache span {S}")
    device = tokens.device
    cos, sin = rope_tables(cfg.head_dim, cfg.max_seq, cfg.rope_theta,
                           device)
    if cache is None:
        cache = init_cache(cfg, b, S, kv_quant=kv_quant, device=device)
    else:
        quant = cache.k_scale is not None
        want = (cfg.n_layers, b, rank_kv_heads(cfg), S, cfg.head_dim)
        dtype = torch.int8 if quant else cfg.dtype
        if tuple(cache.k.shape) != want or tuple(cache.v.shape) != want \
                or cache.k.dtype != dtype or (kv_quant and not quant):
            raise ValueError(
                f"cache k/v {tuple(cache.k.shape)} {cache.k.dtype} do not "
                f"hold {want} {torch.int8 if kv_quant else dtype}")
        cache.k[:, :, :, plen:].zero_()
        cache.v[:, :, :, plen:].zero_()
        if quant:
            cache.k_scale[:, :, :, plen:].fill_(1.0)
            cache.v_scale[:, :, :, plen:].fill_(1.0)

    x = embed_tokens(params, tokens, cfg)
    for li in range(cfg.n_layers):
        layer = _layer(cfg, params, li)
        x, k, v = attention_with_kv(cfg, cos, sin, x, layer)
        if cache.k_scale is not None:
            k, v, k_sc, v_sc = _quantize_pair(k, v)
            cache.k_scale[li, :, :, :plen] = k_sc
            cache.v_scale[li, :, :, :plen] = v_sc
        cache.k[li, :, :, :plen] = k
        cache.v[li, :, :, :plen] = v
        x = _mlp(cfg, x, layer)

    if lengths is None:
        x_last = x[:, -1]
        cache = replace(cache, length=plen)
    else:
        lengths = lengths.to(device=device, dtype=torch.int32)
        x_last = x[torch.arange(b, device=device), lengths.long() - 1]
        cache = replace(cache, length=plen, prompt_lengths=lengths,
                        prompt_slots=plen)
    return _logits(params, x_last, cfg), cache


@torch.no_grad()
def decode_step(
    params: dict, cache: KVCache, token: torch.Tensor, cfg: ModelConfig,
    *, start: torch.Tensor | None = None,
) -> tuple[torch.Tensor, KVCache]:
    """One token for the whole batch. token: (batch,) int at position
    ``cache.length`` → (logits (batch, vocab) f32, cache advanced by 1;
    its K/V tensors are the argument's, written in place).

    ``start`` is that slot as a 0-d int64 tensor on the token's device
    (the one a captured program reads); by default it is made from
    ``cache.length``, the host's count, which alone guards the span."""
    pos = cache.length
    if pos >= cache.k.shape[3]:
        raise ValueError(f"cache span {cache.k.shape[3]} is full")
    if start is None:
        start = torch.full((), pos, dtype=torch.int64, device=token.device)
    cos, sin = rope_tables(cfg.head_dim, cfg.max_seq, cfg.rope_theta,
                           token.device)
    x = embed_tokens(params, token[:, None], cfg)              # (b, 1, d)
    kv_state = (cache.k, cache.v, cache.k_scale, cache.v_scale)
    for li in range(cache.k.shape[0]):
        x, kv_state = _decode_block(
            cfg, cos, sin, start, li, x, _layer(cfg, params, li), kv_state,
            cache.prompt_lengths, cache.prompt_slots, end=pos + 1,
        )
    return _logits(params, x[:, 0], cfg), replace(cache, length=pos + 1)


@torch.no_grad()
def prefill_chunked(
    params: dict, tokens: torch.Tensor, cfg: ModelConfig, max_seq: int,
    chunk: int = 256, kv_quant: bool = False,
) -> tuple[torch.Tensor, KVCache]:
    """Prefill a (batch, prompt_len) prompt in fixed ``chunk``-token
    pieces, each through the decode-chunk body (:func:`_decode_chunk_hidden`)
    against the growing cache. Same contract as :func:`prefill`
    (last-position logits + filled cache of span ``max_seq``), but peak
    activation memory and the attention shape are bounded by ``chunk``.
    prompt_len must divide by ``chunk``; ragged batches are not taken.
    The O(vocab) head runs ONCE, on the final position. Logits match
    :func:`prefill` up to float reduction order (each chunk scores
    against the cache instead of one fused attention), EXCEPT under
    ``kv_quant``: each chunk attends the already-quantized history (what
    later decode steps see, where whole-prompt :func:`prefill` attends
    full precision), so int8 rounding accumulates across chunks and long
    prompts can diverge beyond reduction-order ties."""
    b, plen = tokens.shape
    if not plen or plen % chunk:
        raise ValueError(f"prompt_len {plen} must be a positive multiple of "
                         f"chunk {chunk}")
    if plen > max_seq:
        raise ValueError(f"prompt_len {plen} exceeds cache max_seq {max_seq}")
    if plen > cfg.max_seq:
        # positions past the RoPE table have no rotation to take
        raise ValueError(
            f"prompt_len {plen} exceeds model max_seq {cfg.max_seq}")
    cache = init_cache(cfg, b, max_seq, kv_quant=kv_quant,
                       device=tokens.device)
    for i in range(0, plen, chunk):
        hidden, cache = _decode_chunk_hidden(params, cache,
                                             tokens[:, i:i + chunk], cfg)
    return _logits(params, hidden[:, -1], cfg), cache


@torch.no_grad()
def prefill_resume(
    params: dict, tokens: torch.Tensor, cfg: ModelConfig, cache: KVCache,
    lengths: torch.Tensor | None = None,
) -> tuple[torch.Tensor, KVCache]:
    """Warm-prefix prefill: continue a UNIFORM cache already holding
    ``p = cache.length`` prompt positions with ``tokens`` (batch, c), the
    prompt SUFFIX, in one chunked forward (written into the cache in
    place). Returns :func:`prefill`'s contract (last-real-position logits
    (batch, vocab) f32, filled cache): resuming at p with suffix width c
    yields a cache whose metadata is a cold ragged prefill's of the whole
    (p + c)-wide prompt, ``length = prompt_slots = p + c`` and
    ``prompt_lengths = p + lengths``, so every downstream decode program is
    shared with the cold path.

    ``lengths`` ((batch,) int32) marks a RIGHT-padded ragged suffix: row
    i's real suffix is tokens[i, :lengths[i]]; the pad slots in
    [p + lengths[i], p + c) hold K/V of pad tokens, as a cold ragged
    prefill's pads do, masked by the returned metadata. On the card the
    suffix attends through the flash forward (see :func:`_decode_block`).
    An int8 cache resumes quantized: the suffix attends the quantized
    prefix and its own quantized K/V (:func:`prefill_chunked`'s
    divergence from a cold prefill)."""
    if cache.prompt_lengths is not None:
        raise ValueError(
            "prefill_resume needs a uniform cache (prompt_lengths=None): "
            "a cached prefix is whole real positions [0, length)")
    b, c = tokens.shape
    if c < 1:
        raise ValueError("prefill_resume needs at least one suffix token")
    if c > cache.k.shape[3]:
        raise ValueError(
            f"suffix width {c} exceeds cache max_seq {cache.k.shape[3]}")
    hidden, new_cache = _decode_chunk_hidden(params, cache, tokens, cfg)
    if lengths is None:
        x_last = hidden[:, -1]
    else:
        lengths = lengths.to(device=hidden.device, dtype=torch.int32)
        x_last = hidden[torch.arange(b, device=hidden.device),
                        lengths.long() - 1]
        new_cache = replace(new_cache,
                            prompt_lengths=cache.length + lengths,
                            prompt_slots=new_cache.length)
    return _logits(params, x_last, cfg), new_cache


@torch.no_grad()
def decode_chunk(
    params: dict, cache: KVCache, tokens: torch.Tensor, cfg: ModelConfig,
    *, start: torch.Tensor | None = None,
) -> tuple[torch.Tensor, KVCache]:
    """Process ``c`` tokens at slots ``cache.length .. +c-1`` in ONE
    forward: tokens (b, c) → (logits (b, c, vocab) f32, one set a chunk
    position, cache advanced by c; its K/V written in place).

    The multi-token form of :func:`decode_step` (c = 1 is the same
    computation, through the same :func:`_decode_block`): the chunk's K/V
    are written into the cache first, then each chunk row attends every
    slot below its own, causal within the chunk and full against the
    history; this is the verify pass of speculative decoding
    (``models/speculative.py``). A ragged cache takes the chunk in its
    generation region with the pad gap masked; on the card a chunk over
    a ragged cache takes at most MAX_CHUNK positions.

    ``start`` is the first slot as a 0-d int64 device tensor (what a
    captured program reads, as in :func:`decode_step`): the chunk then
    starts there whatever ``cache.length`` says, the caller keeps it in
    the span, and on the card c is at most MAX_CHUNK."""
    x, cache = _decode_chunk_hidden(params, cache, tokens, cfg, start=start)
    return _logits(params, x, cfg), cache


def _decode_chunk_hidden(
    params: dict, cache: KVCache, tokens: torch.Tensor, cfg: ModelConfig,
    *, start: torch.Tensor | None = None,
) -> tuple[torch.Tensor, KVCache]:
    """:func:`decode_chunk` minus the head: (b, c) tokens → (the final
    hidden states (b, c, d) before the norm, the advanced cache).
    :func:`prefill_chunked` and :func:`prefill_resume` run this, so the
    O(c·vocab) logits product runs once at the end, not per chunk."""
    c = tokens.shape[1]
    pos = cache.length
    end = None
    device = tokens.device
    if start is None:
        if pos + c > cache.k.shape[3]:
            raise ValueError(f"cache span {cache.k.shape[3]} cannot take "
                             f"{c} positions after {pos}")
        start = torch.full((), pos, dtype=torch.int64, device=device)
        end = pos + c
    cos, sin = rope_tables(cfg.head_dim, cfg.max_seq, cfg.rope_theta, device)
    x = embed_tokens(params, tokens, cfg)                       # (b, c, d)
    kv_state = (cache.k, cache.v, cache.k_scale, cache.v_scale)
    for li in range(cache.k.shape[0]):
        x, kv_state = _decode_block(
            cfg, cos, sin, start, li, x, _layer(cfg, params, li), kv_state,
            cache.prompt_lengths, cache.prompt_slots, end=end,
        )
    return x, replace(cache, length=pos + c)


# -- sampling: a sampler a CUDA graph can hold ---------------------------------


def sampling_variant(temperature: float, top_k: int, top_p: float) -> str:
    """Which parts of the sampler a request runs: "greedy" (temperature 0:
    the first maximum, the filters unused, as the reference's ``_sample``),
    else "sample" with "+top_k" and "+top_p" for each filter that is on.
    A program is built per variant; the knob values are its inputs
    (:func:`sampling_knobs`), so arbitrary client values never grow the
    number of programs."""
    if float(temperature) == 0.0:
        return "greedy"
    return ("sample" + ("+top_k" if int(top_k) > 0 else "")
            + ("+top_p" if float(top_p) > 0.0 else ""))


def sampling_knobs(temperature: float, top_k: int, top_p: float,
                   device: torch.device | str = "cpu") -> torch.Tensor:
    """The knob values as one (3,) f32 tensor (temperature, top_k, top_p):
    a sampled program's input, copied into its buffer before each call."""
    return torch.tensor([float(temperature), float(int(top_k)),
                         float(top_p)], dtype=torch.float32, device=device)


def filter_logits(logits: torch.Tensor, temperature, top_k=0, top_p=0.0
                  ) -> torch.Tensor:
    """The reference's temperature, top-k and nucleus mask, in its order
    (``tpu_kubernetes/models/decode.py`` ``_sample``): (batch, vocab) f32
    → the scaled logits with every filtered-out token at -1e30. Each knob
    is a number or a 0-d tensor on the logits' device; a filter given as
    the number 0 is off, one given as a tensor is on (a program fixes
    which filters run, its calls the values). A top_k past the vocab
    keeps every token. The knobs are used as tensors on either form, so
    a program and an eager call divide alike."""
    def knob(x):
        return torch.as_tensor(x, dtype=torch.float32, device=logits.device)

    logits = logits / knob(temperature)
    neg = torch.full_like(logits, -1e30)
    if isinstance(top_k, torch.Tensor) or top_k:
        b, vocab = logits.shape
        col = (vocab - knob(top_k)).clamp(0, vocab - 1).long()
        kth = torch.sort(logits, dim=-1).values.gather(
            1, col.reshape(1, 1).expand(b, 1))
        logits = torch.where(logits < kth, neg, logits)
    if isinstance(top_p, torch.Tensor) or top_p:
        # keep the smallest prefix of descending-probability tokens whose
        # mass reaches top_p; the highest-probability token always stays
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep_sorted = (cum - probs) < knob(top_p)    # exclusive prefix mass
        cutoff = torch.where(
            keep_sorted, sorted_logits, torch.full_like(sorted_logits,
                                                        float("inf"))
        ).min(dim=-1, keepdim=True).values
        logits = torch.where(logits < cutoff, neg, logits)
    return logits


def draw(filtered: torch.Tensor, generator: torch.Generator | None = None,
         noise: torch.Tensor | None = None) -> torch.Tensor:
    """Gumbel-max: (batch, vocab) filtered logits → (batch,) int32
    ``argmax(filtered + noise)``, the first maximum. ``noise`` defaults to
    f32 Gumbel noise from ``generator``'s uniform draws (a CUDA graph
    replays them from the generator's seed and offset, ``util/graphs.py``;
    they differ from ``jax.random``'s); given JAX's own
    ``jax.random.gumbel(key, shape)``, the token is
    ``jax.random.categorical``'s."""
    if noise is None:
        u = torch.rand(filtered.shape, generator=generator,
                       device=filtered.device,
                       dtype=torch.float32).clamp_(min=1e-20)
        noise = -torch.log(-torch.log(u))
    return torch.argmax(filtered + noise, dim=-1).to(torch.int32)


def sample_tokens(logits: torch.Tensor, knobs: torch.Tensor, variant: str,
                  generator: torch.Generator | None = None) -> torch.Tensor:
    """(batch, vocab) f32 → (batch,) int32 under ``variant``
    (:func:`sampling_variant`) with the values of ``knobs``
    (:func:`sampling_knobs`, on the logits' device): greedy argmax, or
    :func:`filter_logits` then :func:`draw` from ``generator``. Nothing
    here reads the device on the host."""
    if variant == "greedy":
        return torch.argmax(logits, dim=-1).to(torch.int32)
    filtered = filter_logits(logits, knobs[0],
                             knobs[1] if "+top_k" in variant else 0,
                             knobs[2] if "+top_p" in variant else 0.0)
    return draw(filtered, generator)


@torch.no_grad()
def generate_into(
    params: dict, prompt: torch.Tensor, cfg: ModelConfig, out: torch.Tensor,
    cache: KVCache, knobs: torch.Tensor, variant: str, *,
    generator: torch.Generator | None = None,
    prompt_lengths: torch.Tensor | None = None, eos_id: int | None = None,
    pad_id: int = 0,
) -> None:
    """:func:`generate`'s body in the form one CUDA graph holds: the
    prefill of ``prompt`` (batch, width) into ``cache`` (the caller's, of
    the run's span), the first sample and ``out.shape[1] - 1`` decode
    steps, token t of every row written into ``out[:, t]`` ((batch,
    max_new) int32, the caller's). The knobs are the device tensor
    ``knobs`` under ``variant`` (:func:`sample_tokens`), the decode slots
    count on the device from the prompt width, and nothing reads the
    device on the host, so a replay draws and decodes as the eager body
    does."""
    logits, cache = prefill(params, prompt, cfg, max_seq=cache.k.shape[3],
                            lengths=prompt_lengths, cache=cache)

    def sample(logits):
        return sample_tokens(logits, knobs, variant, generator)

    token = sample(logits)
    out[:, 0].copy_(token)
    done = (token == eos_id if eos_id is not None
            else torch.zeros_like(token, dtype=torch.bool))
    if out.shape[1] > 1:
        emitted, *_ = decode_segment(params, cache, token, done, cfg,
                                     out.shape[1] - 1, eos_id=eos_id,
                                     pad_id=pad_id, sample=sample)
        out[:, 1:].copy_(emitted)


@torch.no_grad()
def generate(
    params: dict,
    prompt: torch.Tensor,
    cfg: ModelConfig,
    max_new_tokens: int,
    *,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 0.0,
    generator: torch.Generator | None = None,
    prompt_lengths: torch.Tensor | None = None,
    eos_id: int | None = None,
    pad_id: int = 0,
    cache_span: int | None = None,
    kv_quant: bool = False,
) -> torch.Tensor:
    """prompt (batch, prompt_len) int → (batch, max_new_tokens) int32.

    Prefill, then ``max_new_tokens - 1`` decode steps with sampling
    (:func:`generate_into`, run eagerly on buffers made here). The cache
    spans ``cache_span`` (default prompt_len + max_new_tokens); the span
    changes the attention reduction order, so pass the other program's
    span when comparing greedy outputs bitwise. ``eos_id`` stops a row
    once it samples that token: later positions emit ``pad_id``.
    ``prompt_lengths`` serves a right-padded ragged batch (see
    :class:`KVCache`). The draws come from ``generator`` in a fixed order
    (the first sample, then one a step), so a request seeded alike draws
    the same tokens here and through the server's programs. ``kv_quant``
    serves from an int8 KV cache (see :class:`KVCache`)."""
    b, plen = prompt.shape
    if plen + max_new_tokens > cfg.max_seq:
        raise ValueError(
            f"prompt {plen} + new {max_new_tokens} exceeds max_seq {cfg.max_seq}"
        )
    device = prompt.device
    out = torch.zeros((b, max_new_tokens), dtype=torch.int32, device=device)
    cache = init_cache(cfg, b, cache_span or (plen + max_new_tokens),
                       kv_quant=kv_quant, device=device)
    generate_into(params, prompt, cfg, out, cache,
                  sampling_knobs(temperature, top_k, top_p, device),
                  sampling_variant(temperature, top_k, top_p),
                  generator=generator, prompt_lengths=prompt_lengths,
                  eos_id=eos_id, pad_id=pad_id)
    return out


@torch.no_grad()
def decode_segment(
    params: dict, cache: KVCache, token: torch.Tensor, done: torch.Tensor,
    cfg: ModelConfig, steps: int, *, eos_id: int | None = None,
    pad_id: int = 0, start: torch.Tensor | None = None,
    sample: Callable[[torch.Tensor], torch.Tensor] | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, KVCache]:
    """``steps`` decode steps with per-row done-masking — the early-exit
    building block (a host loop runs one segment per K steps and stops
    once every row is finished) and :func:`generate_into`'s loop. token:
    (batch,) each row's previous raw sample; done: (batch,) bool. Each
    step's token is ``sample(logits)`` ((batch, vocab) f32 → (batch,)
    int32), greedy argmax by default. → (emitted (batch, steps) int32,
    next token, done, cache advanced by ``steps``) — token-identical to
    :func:`generate`'s loop. ``start`` is the first step's slot as a 0-d
    int64 device tensor (see :func:`decode_step`); the steps count on
    from it on the device."""
    if start is None:
        start = torch.full((), cache.length, dtype=torch.int64,
                           device=token.device)
    slots = start + torch.arange(steps, dtype=torch.int64,
                                 device=token.device)
    out = []
    for i in range(steps):
        logits, cache = decode_step(params, cache, token, cfg,
                                    start=slots[i])
        token = (torch.argmax(logits, dim=-1).to(torch.int32)
                 if sample is None else sample(logits))
        if eos_id is not None:
            out.append(torch.where(done, torch.full_like(token, pad_id), token))
            done = done | (token == eos_id)
        else:
            out.append(token)
    emitted = (torch.stack(out, dim=1) if out else
               torch.zeros((token.shape[0], 0), dtype=torch.int32,
                           device=token.device))
    return emitted, token, done, cache


# -- continuous batching: per-slot decode over a mixed batch -------------------


@dataclass(frozen=True)
class SlotState:
    """Per-slot decode carry of continuous batching: every row of the
    batch cache is an independent request at its own position. All fields
    are (slots,) int32 tensors; a slot is LIVE iff ``remaining > 0`` (EOS
    and an exhausted budget both zero it).

    * ``tok``: the row's previously emitted token (the step's input);
    * ``pos``: the cache slot the next K/V write lands in; its RoPE
      position is ``prompt_lengths + (pos - prompt_slots)``, gapless per
      row;
    * ``remaining``: tokens the row may still emit;
    * ``prompt_lengths`` / ``prompt_slots``: the per-ROW ragged prompt
      (real length, padded width), where :class:`KVCache` has one width.

    The fields are written in place (:func:`decode_segment_slots`), so a
    captured program reads and writes the same tensors at every replay.
    Retired and empty slots keep decoding (static shapes): a dead row
    re-writes its own unused slot ``pos`` (never advanced once
    ``remaining`` is 0, and in range, since admission requires
    ``prompt_slots + budget <= max_seq``), and its attention reads only
    its own row, so garbage never crosses rows."""

    tok: torch.Tensor
    pos: torch.Tensor
    remaining: torch.Tensor
    prompt_lengths: torch.Tensor
    prompt_slots: torch.Tensor


def init_slot_state(batch: int, device: torch.device | str = "cuda"
                    ) -> SlotState:
    """All slots free (remaining 0). An empty slot attends only its own
    row's slot 0, so it is numerically inert until an insert claims it."""
    return SlotState(*(torch.zeros((batch,), dtype=torch.int32,
                                   device=device) for _ in range(5)))


def cache_insert_row(cache: KVCache, row: KVCache, slot) -> KVCache:
    """Graft a freshly prefilled single-row cache (what :func:`prefill`
    fills for one request at its own bucketed width) into row ``slot`` of
    a fixed (slots, max_seq) batch cache, IN PLACE: the row's positions
    are copied along the batch axis, the span past its width is zeroed,
    so an occupied slot differs from a cold one only in its real
    positions (an int8 cache's scales past it are 1.0). ``slot`` is an
    int or a 0-d int64 device tensor (one captured program then serves
    every slot). → ``cache``."""
    S, s_row = cache.k.shape[3], row.k.shape[3]
    if s_row > S:
        raise ValueError(
            f"row cache width {s_row} exceeds engine max_seq {S}")
    if row.k.shape[1] != 1:
        raise ValueError(f"row cache must be batch-1, got {row.k.shape[1]}")
    if (cache.k_scale is None) != (row.k_scale is None):
        raise ValueError("cache/row kv-quant mismatch (one has int8 scales)")
    if row.k.dtype != cache.k.dtype:
        raise ValueError(
            f"cache/row dtype mismatch ({cache.k.dtype} vs {row.k.dtype})")
    idx = torch.as_tensor(slot, device=cache.k.device).reshape(1)
    for dst, src, fill in _kv_pairs(cache, row):
        dst[:, :, :, :s_row].index_copy_(1, idx, src)
        dst[:, :, :, s_row:].index_fill_(1, idx, fill)
    return cache


def _kv_pairs(dst, src=None):
    """(destination, source, cold value) of every tensor a cache or pool
    holds: k and v (0), and an int8 one's scales (1.0)."""
    src = dst if src is None else src
    pairs = [(dst.k, src.k, 0), (dst.v, src.v, 0)]
    if dst.k_scale is not None:
        pairs += [(dst.k_scale, src.k_scale, 1.0),
                  (dst.v_scale, src.v_scale, 1.0)]
    return pairs


def cache_clear_row(cache: KVCache, slot) -> KVCache:
    """Reset row ``slot`` to cold values (zeros; an int8 cache's scales
    1.0), in place: slot recycling after a request drains. Not needed for
    correctness (rows are independent and the next insert rewrites the
    row) but keeps a freed slot bitwise equal to a cold one. →
    ``cache``."""
    idx = torch.as_tensor(slot, device=cache.k.device).reshape(1)
    for dst, _, fill in _kv_pairs(cache):
        dst.index_fill_(1, idx, fill)
    return cache


@torch.no_grad()
def decode_step_slots(params: dict, cache: KVCache, st: SlotState,
                      cfg: ModelConfig) -> tuple[torch.Tensor, KVCache]:
    """One greedy-decode forward where EVERY row sits at its own position
    ``st.pos``, the mixed-batch form of :func:`decode_step`. Each row's
    K/V is written at (row, kv head, ``st.pos[row]``) by one
    ``index_put_`` a layer, with no host read; attention masks each row
    to its own prompt and generated span; RoPE positions are gapless per
    row. An int8 cache is quantized on write. → (logits (slots, vocab)
    f32, ``cache``, written in place; its ``length`` and batch-wide
    prompt fields are ignored)."""
    device = st.tok.device
    b = st.tok.shape[0]
    cos, sin = rope_tables(cfg.head_dim, cfg.max_seq, cfg.rope_theta, device)
    pos = st.pos.long()[:, None]                                 # (b, 1)
    positions = st.prompt_lengths.long()[:, None] + (
        pos - st.prompt_slots.long()[:, None])
    limits = pos + 1
    rows = torch.arange(b, device=device)[:, None]               # (b, 1)
    heads = torch.arange(rank_kv_heads(cfg), device=device)[None, :]
    x = embed_tokens(params, st.tok[:, None], cfg)               # (b, 1, d)
    for li in range(cache.k.shape[0]):
        layer = _layer(cfg, params, li)
        q, k, v = _qkv(cfg, x, layer)
        q = apply_rope(q, cos, sin, positions=positions)
        k = apply_rope(k, cos, sin, positions=positions)
        scales = _write_kv(cache, li, (rows, heads, pos), k[:, :, 0],
                           v[:, :, 0])
        attn = _attend_cache(cfg, q, cache.k[li], cache.v[li], limits,
                             st.prompt_lengths, st.prompt_slots, None,
                             *scales)
        x = _mlp(cfg, _attn_residual(cfg, x, attn, layer), layer)
    return _logits(params, x[:, 0], cfg), cache


def _write_kv(cache, li: int, index: tuple, k: torch.Tensor,
              v: torch.Tensor) -> tuple:
    """Scatter K/V rows into layer ``li`` of a cache or a pool at
    ``index`` (``index_put_`` indices over its (row or page, KV head,
    slot) axes), an int8 one's quantized with their scales. → the
    layer's (k_scale, v_scale), or (None, None)."""
    if cache.k_scale is None:
        cache.k[li].index_put_(index, k)
        cache.v[li].index_put_(index, v)
        return None, None
    k, v, k_sc, v_sc = _quantize_pair(k, v)
    cache.k[li].index_put_(index, k)
    cache.v[li].index_put_(index, v)
    cache.k_scale[li].index_put_(index, k_sc)
    cache.v_scale[li].index_put_(index, v_sc)
    return cache.k_scale[li], cache.v_scale[li]


@torch.no_grad()
def decode_segment_slots(
    params: dict, cache: KVCache, st: SlotState, cfg: ModelConfig,
    steps: int, *, eos_id: int | None = None, pad_id: int = 0,
) -> tuple[torch.Tensor, SlotState, KVCache]:
    """``steps`` greedy :func:`decode_step_slots` steps, the continuous
    form of :func:`decode_segment`. A live row (remaining > 0) emits its
    greedy token, advances ``pos`` and spends one unit of budget (EOS
    zeroes the rest); a dead row emits ``pad_id`` and freezes. The slot
    state and the cache are updated IN PLACE. → (emitted (slots, steps)
    int32, ``st``, ``cache``)."""
    emitted = _advance(
        st, steps, lambda: decode_step_slots(params, cache, st, cfg)[0],
        eos_id, pad_id)
    return emitted, st, cache


def _advance(st: SlotState, steps: int, step, eos_id: int | None,
             pad_id: int) -> torch.Tensor:
    """The slot segments' emission logic: ``steps`` calls of ``step()``
    (→ logits of the rows at ``st``), the state advanced in place after
    each. → emitted (slots, steps) int32."""
    out = []
    for _ in range(steps):
        live = st.remaining > 0
        nxt = torch.argmax(step(), dim=-1).to(torch.int32)
        out.append(torch.where(live, nxt, torch.full_like(nxt, pad_id)))
        rem = torch.where(live, st.remaining - 1,
                          torch.zeros_like(st.remaining))
        if eos_id is not None:
            rem = torch.where(live & (nxt == eos_id),
                              torch.zeros_like(rem), rem)
        st.tok.copy_(torch.where(live, nxt, st.tok))
        st.pos.copy_(torch.where(live, st.pos + 1, st.pos))
        st.remaining.copy_(rem)
    return (torch.stack(out, dim=1) if out else
            torch.zeros((st.tok.shape[0], 0), dtype=torch.int32,
                        device=st.tok.device))


# -- speculative verify rounds over the slot batch ------------------------------


def _verify_accept(greedy: torch.Tensor, drafts: torch.Tensor, st: SlotState,
                   *, eos_id: int | None, pad_id: int) -> torch.Tensor:
    """Ragged per-row draft acceptance (the reference's ``_verify_accept``,
    the batched form of ``models/speculative.py``'s rule): row i keeps the
    longest prefix of ``drafts[i]`` ((b, k) int32) that the target's
    ``greedy[i]`` ((b, k + 1) int32) agrees with, plus one correction
    token, clipped to the row's remaining budget and to the first emitted
    EOS. The emitted tokens are the target's own greedy choices at valid
    context, so acceptance decides how many tokens a round emits, never
    which. Dead rows (remaining 0) emit ``pad_id`` and freeze. The state
    advances IN PLACE, as :func:`_advance` does for segments: ``pos`` by
    the emitted length (the rejected window slots above it stay masked
    until the next window rewrites them), ``tok`` to the last emitted
    token, ``remaining`` down (to 0 at an EOS). → emitted (b, k + 1)
    int32, padded with ``pad_id``; nothing reads the device on the host."""
    b, c = greedy.shape
    k = c - 1
    off = torch.arange(c, dtype=torch.int32, device=greedy.device)
    matches = (drafts == greedy[:, :k]).to(torch.int32)
    j = torch.cumprod(matches, dim=1).sum(dim=1, dtype=torch.int32)
    n_acc = torch.minimum(j + 1, st.remaining)             # the budget clip
    if eos_id is not None:
        eos_idx = torch.where(greedy == eos_id, off[None, :],
                              torch.full_like(greedy, c)).amin(dim=1)
        n_emit = torch.minimum(n_acc, eos_idx + 1)
        hit_eos = eos_idx < n_acc          # an EOS inside the emitted prefix
        rem = torch.where(hit_eos, torch.zeros_like(n_emit),
                          st.remaining - n_emit)
    else:
        n_emit = n_acc
        rem = st.remaining - n_emit
    emitted = torch.where(off[None, :] < n_emit[:, None], greedy,
                          torch.full_like(greedy, pad_id))
    last = torch.gather(greedy, 1,
                        (n_emit - 1).clamp(0, k).long()[:, None])[:, 0]
    st.tok.copy_(torch.where(n_emit > 0, last, st.tok))
    st.pos.copy_(st.pos + n_emit)
    st.remaining.copy_(rem)
    return emitted


def _window(st: SlotState, c: int):
    """A verify window's per-row metadata: (RoPE positions (b, c) int64,
    gapless per row; the cache slots pos .. pos + c - 1 (b, c) int64;
    the attention limits (b, c), chunk row j admitting slots < pos + 1 +
    j)."""
    off = torch.arange(c, dtype=torch.int64, device=st.pos.device)
    pos = st.pos.long()[:, None]
    positions = st.prompt_lengths.long()[:, None] + (
        pos - st.prompt_slots.long()[:, None]) + off[None, :]
    slots = pos + off[None, :]
    return positions, slots, slots + 1


def _verify_forward(params, cfg, st: SlotState, drafts: torch.Tensor, write,
                    attend) -> torch.Tensor:
    """The target over every row's window ``[tok, drafts]`` ((b, k + 1)):
    ``write(li, k, v, slots)`` lands the window's K/V (b, kv, c, hd) in
    the cache before ``attend(li, q, limits)`` reads it. → the greedy
    tokens (b, k + 1) int32."""
    b, k = drafts.shape
    c = k + 1
    cos, sin = rope_tables(cfg.head_dim, cfg.max_seq, cfg.rope_theta,
                           st.pos.device)
    positions, slots, limits = _window(st, c)
    # a frozen row's window may reach past the RoPE table: its position
    # clamps to the table's last, as the reference's gather clamps it
    positions = positions.clamp(max=cos.shape[0] - 1)
    chunk = torch.cat((st.tok[:, None], drafts.to(st.tok.dtype)), dim=1)
    x = embed_tokens(params, chunk, cfg)                         # (b, c, d)
    for li in range(cfg.n_layers):
        layer = _layer(cfg, params, li)
        q, kc, vc = _qkv(cfg, x, layer)
        q = apply_rope(q, cos, sin, positions=positions)
        kc = apply_rope(kc, cos, sin, positions=positions)
        write(li, kc, vc, slots)
        attn = attend(li, q, limits)
        x = _mlp(cfg, _attn_residual(cfg, x, attn, layer), layer)
    return torch.argmax(_logits(params, x, cfg), dim=-1).to(torch.int32)


@torch.no_grad()
def decode_verify_slots(
    params: dict, cache: KVCache, st: SlotState, drafts: torch.Tensor,
    cfg: ModelConfig, *, eos_id: int | None = None, pad_id: int = 0,
) -> tuple[torch.Tensor, SlotState, KVCache]:
    """ONE speculative verify round over the slot engine's mixed batch
    (the reference's ``decode_verify_slots``): every row runs the target
    once over its ``draft_k + 1``-token window ``[st.tok[i], drafts[i]]``
    at slots ``pos .. pos + k`` (per-row gapless RoPE positions, per-row
    causal ``limits`` (b, c): :func:`decode_step_slots` widened from c = 1
    to c = k + 1), then accepts per :func:`_verify_accept`. The window's
    K/V land in the cache, in place, before attention reads them, so
    window row j attends exactly the sequential context when rows
    0 .. j - 1 matched; rejected slots above the accepted position stay
    masked and the next window, which starts at or below them, rewrites
    them first. On the card attention is the decode-attention kernel's
    chunk route (c <= MAX_CHUNK).

    The reference lets a drained row's frozen window poke past max_seq and
    drops those writes; here a window slot past the span writes the row's
    own first window slot ``pos`` instead, with the value that slot takes
    anyway, so every write stays in the row's own span and the duplicates
    agree (``st.pos`` < max_seq, as for :func:`decode_step_slots`). → (emitted
    (b, k + 1) int32 padded with ``pad_id``, ``st`` advanced in place by
    each row's accepted length, ``cache`` written in place)."""
    b, k = drafts.shape
    span = cache.k.shape[3]
    rows = torch.arange(b, device=st.pos.device)[:, None, None]
    heads = torch.arange(rank_kv_heads(cfg),
                         device=st.pos.device)[None, :, None]

    def write(li, kc, vc, slots):
        ok = slots < span                                        # (b, c)
        at = torch.where(ok, slots, slots[:, :1])[:, None, :]    # (b, 1, c)
        keep = ok[:, None, :, None]
        _write_kv(cache, li, (rows, heads, at),
                  torch.where(keep, kc, kc[:, :, :1]),
                  torch.where(keep, vc, vc[:, :, :1]))

    def attend(li, q, limits):
        return _attend_cache(cfg, q, cache.k[li], cache.v[li], limits,
                             st.prompt_lengths, st.prompt_slots, None,
                             *_layer_scales(cache, li))

    greedy = _verify_forward(params, cfg, st, drafts, write, attend)
    emitted = _verify_accept(greedy, drafts, st, eos_id=eos_id,
                             pad_id=pad_id)
    return emitted, st, cache


# -- paged KV cache: a fixed page pool + per-slot page tables ------------------


@dataclass(frozen=True)
class PagedKVCache:
    """A fixed POOL of KV pages shared by every slot: k/v are
    (n_layers, n_pages + 1, kv_heads, page_size, head_dim); one logical
    page spans all layers and covers ``page_size`` contiguous positions of
    ONE row. Physical page 0 is a write SINK: retired rows keep writing
    into it (static shapes) and unallocated table entries point at it, so
    nothing is allocated inside a program; usable pages are 1..n_pages,
    owned by the host's free list (``serve/pages.py``).

    WHERE a row's positions live is the page table, a (slots, max_pages)
    int32 tensor (position p of row i at page ``table[i, p // page_size]``,
    offset ``p % page_size``); WHEN a row stops is :class:`SlotState`.
    Attention reads each row's pages through the table (the kernel) or
    gathers them into a (max_pages * page_size)-wide virtual dense row
    (the plain version, the reference's computation); with
    ``max_pages * page_size == max_seq`` both read and sum what the dense
    slot engine does, so paged greedy decode is token-identical to it.

    The int8 pool (``kv_quant``): k/v int8 and ``k_scale``/``v_scale``
    (n_layers, n_pages + 1, kv_heads, page_size) f32, the dense layout
    paged."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None


def _layer_scales(cache, li: int) -> tuple:
    """Layer ``li``'s (k_scale, v_scale) of a cache or pool, or (None,
    None) at full precision."""
    if cache.k_scale is None:
        return None, None
    return cache.k_scale[li], cache.v_scale[li]


def page_bytes(cfg: ModelConfig, page_size: int,
               kv_quant: bool = False) -> int:
    """Device bytes of ONE logical page (all layers, k + v, an int8 pool's
    scales included): the pool-sizing unit behind ``SERVE_KV_POOL_MB``;
    under a mesh, this rank's heads of it."""
    kv = rank_kv_heads(cfg)
    per_pos = cfg.n_layers * kv * cfg.head_dim
    if kv_quant:
        scale = cfg.n_layers * kv * 4                   # f32 a position
        return page_size * 2 * (per_pos + scale)        # int8 k/v
    itemsize = torch.empty((), dtype=cfg.dtype).element_size()
    return page_size * 2 * per_pos * itemsize


def init_paged_pool(cfg: ModelConfig, num_pages: int, page_size: int,
                    kv_quant: bool = False,
                    device: torch.device | str = "cuda") -> PagedKVCache:
    """A cold pool of ``num_pages`` usable pages plus the page-0 sink, all
    zeros (an int8 pool's scales 1.0): bitwise what :func:`init_cache`
    rows are, and what :func:`paged_clear_pages` wipes a freed page back
    to."""
    if num_pages < 1:
        raise ValueError(f"num_pages must be >= 1, got {num_pages}")
    if page_size < 1:
        raise ValueError(f"page_size must be >= 1, got {page_size}")
    shape = (cfg.n_layers, num_pages + 1, rank_kv_heads(cfg), page_size,
             cfg.head_dim)
    if kv_quant:
        return PagedKVCache(
            k=torch.zeros(shape, dtype=torch.int8, device=device),
            v=torch.zeros(shape, dtype=torch.int8, device=device),
            k_scale=torch.ones(shape[:-1], dtype=torch.float32,
                               device=device),
            v_scale=torch.ones(shape[:-1], dtype=torch.float32,
                               device=device),
        )
    return PagedKVCache(
        k=torch.zeros(shape, dtype=cfg.dtype, device=device),
        v=torch.zeros(shape, dtype=cfg.dtype, device=device),
    )


def _to_pages(a: torch.Tensor, skip_pages: int, ps: int) -> torch.Tensor:
    """A batch-1 dense row segment → page-major: (L, 1, kv, n*ps[, hd]) →
    (L, n - skip_pages, kv, ps[, hd]), the first ``skip_pages`` pages
    (positions already resident in the pool) dropped."""
    L, _, kv, width = a.shape[:4]
    a = a[:, 0].reshape(L, kv, width // ps, ps, *a.shape[4:]).transpose(1, 2)
    return a[:, skip_pages:]


def paged_insert_row(pool: PagedKVCache, row: KVCache,
                     pages: torch.Tensor, skip: int = 0) -> PagedKVCache:
    """The paged admission primitive (:func:`cache_insert_row`'s analog):
    scatter a freshly prefilled batch-1 row cache of width
    ``n * page_size`` into pool pages ``pages`` ((n,) integer tensor, page
    i taking positions [i*page_size, (i+1)*page_size)), IN PLACE. ``skip``
    (page-aligned) leaves the first ``skip`` positions unwritten: they
    live in shared pages already. ``pages`` may be a device buffer, so one
    captured program a width serves every admission. → ``pool``."""
    ps = pool.k.shape[3]
    s_row = row.k.shape[3]
    n = pages.shape[0]
    if row.k.shape[1] != 1:
        raise ValueError(f"row cache must be batch-1, got {row.k.shape[1]}")
    if s_row != n * ps:
        raise ValueError(f"row width {s_row} != {n} pages x page_size {ps}")
    if skip % ps or not 0 <= skip < s_row:
        raise ValueError(f"skip {skip} must be page-aligned in [0, {s_row})")
    if (pool.k_scale is None) != (row.k_scale is None):
        raise ValueError("pool/row kv-quant mismatch (one has int8 scales)")
    if row.k.dtype != pool.k.dtype:
        raise ValueError(f"pool/row kv-quant mismatch ({pool.k.dtype} vs "
                         f"{row.k.dtype})")
    sp = skip // ps
    dst = pages[sp:].to(device=pool.k.device, dtype=torch.int64)
    for pool_a, row_a, _ in _kv_pairs(pool, row):
        pool_a.index_copy_(1, dst, _to_pages(row_a, sp, ps))
    return pool


def paged_clear_pages(pool: PagedKVCache, pages: torch.Tensor
                      ) -> PagedKVCache:
    """Wipe freed pages back to cold values (zeros; an int8 pool's scales
    1.0), IN PLACE: the paged
    :func:`cache_clear_row`. ``pages`` is (n,) and may be padded with any
    out-of-range sentinel (>= n_pages + 1), so one program at a fixed n
    clears any smaller set. The reference's scatter drops the sentinels;
    here they are redirected, on the device, to the sink page 0, which
    this then zeroes too: no live row weights the sink, so the two differ
    only there. → ``pool``."""
    idx = pages.to(device=pool.k.device, dtype=torch.int64)
    idx = torch.where(idx < pool.k.shape[1], idx, torch.zeros_like(idx))
    for pool_a, _, fill in _kv_pairs(pool):
        pool_a.index_fill_(1, idx, fill)
    return pool


def gather_pages(pool: PagedKVCache, pages: torch.Tensor) -> KVCache:
    """Pages → a contiguous batch-1 dense row cache of width
    ``n * page_size`` (every slot < length real): the bytes
    :func:`paged_insert_row` scattered."""
    ps, n = pool.k.shape[3], pages.shape[0]
    idx = pages.to(device=pool.k.device, dtype=torch.int64)

    def dense(a):
        if a is None:
            return None
        a = a[:, idx].transpose(1, 2)            # (L, kv, n, ps[, hd])
        return a.reshape(a.shape[0], 1, a.shape[1], n * ps, *a.shape[4:])

    return KVCache(k=dense(pool.k), v=dense(pool.v), length=n * ps,
                   k_scale=dense(pool.k_scale), v_scale=dense(pool.v_scale))


@torch.no_grad()
def decode_step_paged(params: dict, pool: PagedKVCache, table: torch.Tensor,
                      st: SlotState, cfg: ModelConfig
                      ) -> tuple[torch.Tensor, PagedKVCache]:
    """:func:`decode_step_slots` through a page table: every row writes
    this step's K/V at (``table[row, pos // ps]``, kv head, ``pos % ps``)
    by one ``index_put_`` a layer and attends its pages through the table.
    The host sees to it that every LIVE row's table covers ``pos`` before
    the call; retired rows write the page-0 sink. → (logits (b, vocab)
    f32, ``pool``, written in place)."""
    device = st.tok.device
    ps = pool.k.shape[3]
    cos, sin = rope_tables(cfg.head_dim, cfg.max_seq, cfg.rope_theta, device)
    pos = st.pos.long()[:, None]                                 # (b, 1)
    positions = st.prompt_lengths.long()[:, None] + (
        pos - st.prompt_slots.long()[:, None])
    limits = pos + 1
    page = torch.gather(table, 1, pos // ps).long()              # (b, 1)
    off = pos % ps
    heads = torch.arange(rank_kv_heads(cfg), device=device)[None, :]
    x = embed_tokens(params, st.tok[:, None], cfg)               # (b, 1, d)
    for li in range(pool.k.shape[0]):
        layer = _layer(cfg, params, li)
        q, k, v = _qkv(cfg, x, layer)
        q = apply_rope(q, cos, sin, positions=positions)
        k = apply_rope(k, cos, sin, positions=positions)
        # live rows own their pages, so the writes collide only on the
        # sink (dead rows), which nothing reads at a weight above 0
        scales = _write_kv(pool, li, (page, heads, off), k[:, :, 0],
                           v[:, :, 0])
        attn = _attend_cache(cfg, q, pool.k[li], pool.v[li], limits,
                             st.prompt_lengths, st.prompt_slots, table,
                             *scales)
        x = _mlp(cfg, _attn_residual(cfg, x, attn, layer), layer)
    return _logits(params, x[:, 0], cfg), pool


@torch.no_grad()
def decode_segment_paged(
    params: dict, pool: PagedKVCache, table: torch.Tensor, st: SlotState,
    cfg: ModelConfig, steps: int, *, eos_id: int | None = None,
    pad_id: int = 0,
) -> tuple[torch.Tensor, SlotState, PagedKVCache]:
    """``steps`` greedy :func:`decode_step_paged` steps, with the emission
    logic of :func:`decode_segment_slots`, so the two engines are
    token-identical step for step. The table stays fixed across the
    segment: the host tops every live row's table up to cover
    ``pos + min(steps, remaining)`` first. The state and the pool are
    updated IN PLACE. → (emitted (slots, steps) int32, ``st``, ``pool``)."""
    emitted = _advance(
        st, steps,
        lambda: decode_step_paged(params, pool, table, st, cfg)[0],
        eos_id, pad_id)
    return emitted, st, pool


@torch.no_grad()
def decode_verify_paged(
    params: dict, pool: PagedKVCache, table: torch.Tensor, st: SlotState,
    drafts: torch.Tensor, cfg: ModelConfig, *, eos_id: int | None = None,
    pad_id: int = 0,
) -> tuple[torch.Tensor, SlotState, PagedKVCache]:
    """:func:`decode_verify_slots` through a page table (the reference's
    ``decode_verify_paged``): each row's window positions ``pos .. pos +
    k`` scatter at (``table[row, p // ps]``, kv head, ``p % ps``), and
    attention reads the row's pages through the table (on the card the
    decode-attention kernel's chunk route, never a gathered copy): the
    same masks and acceptance, so paged speculation is token-identical to
    the dense engine's. The host tops every live row's table up to cover
    ``pos + min(k + 1, remaining) - 1`` first; window positions past that
    fall on table entries 0, the page-0 sink, which acceptance never emits
    from (the budget clips them). A position past the table (only a
    frozen row's window gets there) writes the sink too, as the
    reference's out-of-range gather fills and its scatter drops. After
    the round the host truncates each row's table to its accepted extent.
    → (emitted (b, k + 1), ``st``, ``pool``; both updated in place)."""
    ps, mp = pool.k.shape[3], table.shape[1]
    heads = torch.arange(rank_kv_heads(cfg),
                         device=st.pos.device)[None, :, None]

    def write(li, kc, vc, slots):
        idx = slots // ps
        page = torch.gather(table, 1, idx.clamp(max=mp - 1)).long()
        page = torch.where(idx < mp, page, torch.zeros_like(page))
        page = page[:, None, :]                                  # (b, 1, c)
        off = (slots % ps)[:, None, :]
        # live rows own their pages, so the writes collide only on the
        # sink, which nothing reads at a weight above 0
        _write_kv(pool, li, (page, heads, off), kc, vc)

    def attend(li, q, limits):
        return _attend_cache(cfg, q, pool.k[li], pool.v[li], limits,
                             st.prompt_lengths, st.prompt_slots, table,
                             *_layer_scales(pool, li))

    greedy = _verify_forward(params, cfg, st, drafts, write, attend)
    emitted = _verify_accept(greedy, drafts, st, eos_id=eos_id,
                             pad_id=pad_id)
    return emitted, st, pool
