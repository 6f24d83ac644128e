"""Decode attention: a chunk of query positions a row (one in a decode step,
``k + 1`` in a speculative verify window) against a KV cache, dense or
paged (a kernel of the port alone: the JAX package computes it in
``tpu_kubernetes/models/decode.py`` ``_attend_cache``, and for the paged
cache after ``decode_step_paged``'s ``virtual`` gather, both fused by XLA).

* :func:`decode_attention_reference` — the plain version, the reference's
  ``_attend_cache`` body: f32 scores, the ``-1e30`` mask of positions past
  each chunk row's limit and of a ragged row's pad gap, an f32 softmax and
  P·V in f32, cast back to the query's dtype. With a page ``table`` the
  cache is one layer of a page pool, first gathered into each row's
  virtual dense row as the reference's ``virtual`` does. An int8 cache
  (``k_scale``/``v_scale`` given) dequantizes on read as the reference
  does, ``k.float() * k_scale[..., None]`` (V likewise, after the
  softmax).
* :func:`decode_attention_cuda` — the wrapper of the hand-written
  kernels, on two routes that :func:`_route` picks by dtype, head_dim and
  group width: "tc" (``csrc/decode_attention_tc.cu``,
  ``decode_attention_tc``: bf16 at head_dim 64 or 128 with up to 16 query
  heads a KV head; one launch, a cluster of blocks a (row, KV head,
  column group) that share out the group's admitted 64-position tiles, a
  TMA ring, mma.sync on the tensor cores, the blocks' partials merged
  through distributed shared memory) and "simt"
  (``csrc/decode_attention.cu``, ``decode_attention``: the CUDA-core
  kernel, f32 and head_dim 16 and 32; one block per (span split, KV head,
  row), then an ordered merge of the splits in a second kernel); and for
  an int8 cache, "tc8" for bf16 q at head_dim 64 or 128 with up to 16
  query heads a KV head (``csrc/decode_attention_tc.cu``,
  ``decode_attention_tc_q8``: the tc kernel templated on the cache's
  type, the int8 K/V rows widened to bf16 in registers, each position's
  ``k_scale`` on its row of scores and its ``v_scale`` folded into P) and
  "q8" for every other call (``csrc/decode_attention.cu``,
  ``decode_attention_q8``: the CUDA-core kernel reading int8 K/V rows and
  a scale a position, at every dtype and head_dim the wrapper takes;
  forced, the comparison on the tc8 route's calls). A column is one
  (query head, chunk position) pair; all read each admitted K/V row once
  for all the columns of a KV head (the tensor-core routes once a group
  of 16 columns) and mask each column past its own limit.
  Its ``launches`` attribute counts the launches it made,
  ``route_launches`` the same by route and ``chunk_launches`` those of
  them with c > 1, by route. It takes a chunk of 1 <= c <=
  :data:`MAX_CHUNK` query positions a row (a verify window of
  ``SERVE_DRAFT_K + 1`` up to draft_k 15), bf16 or f32, head_dim 16, 32,
  64 or 128, and raises on anything else: on the card a longer chunk over
  a uniform cache takes the flash forward instead (``models/decode.py``).
* :func:`decode_attention` — the dispatcher ``models/decode.py`` calls:
  ``use_kernel=None`` picks the kernel for CUDA tensors and the plain
  version for CPU tensors; ``use_kernel=False`` forces the plain version
  (the comparisons in tests and ``chip_smoke.py``). A CUDA tensor launches
  the kernel or raises: there is no fallback lane.

Shapes, for all three: q (b, h, c, d); a dense cache k, v (b, kv, S, d),
or with ``table`` ((b, max_pages) int32) a pool layer (n_pages + 1, kv,
page_size, d) whose row i's position p lies at page
``table[i, p // page_size]``, offset ``p % page_size``; ``limits`` (c,)
shared across the batch or (b, c) per row (chunk row j attends positions
< limits[..., j]); ``prompt_lengths`` (b,) and ``prompt_slots`` (an int,
or (b,) a row) mark each row's pad gap ``[prompt_lengths, prompt_slots)``;
for an int8 cache ``k_scale``, ``v_scale`` f32 shaped as k, v less the
last dimension ((b, kv, S) or a pool layer's (n_pages + 1, kv,
page_size)).
Query head ``g * rep + r`` reads KV head ``g`` (rep = h // kv).
"""

from __future__ import annotations

import ctypes
import math

import torch

KERNEL_HEAD_DIMS = (16, 32, 64, 128)
KERNEL_DTYPES = (torch.bfloat16, torch.float32)
TC_HEAD_DIMS = (64, 128)
TC_MAX_REP = 16           # query heads a KV head on the tensor cores
MAX_CHUNK = 16            # query positions a row
NEG_INF = -1e30
MAX_SPAN = 65536          # the simt merge holds 1,024 splits of 64
ENTRY = {"tc": "decode_attention_tc", "simt": "decode_attention",
         "q8": "decode_attention_q8", "tc8": "decode_attention_tc_q8"}
# a route that takes another route's calls when forced (the comparisons)
FORCEABLE = {"tc": "simt", "tc8": "q8"}


def virtual_rows(pool_layer: torch.Tensor, table: torch.Tensor
                 ) -> torch.Tensor:
    """One pool layer (n_pages + 1, kv, ps[, d]) gathered through
    ``table`` (b, max_pages) → the (b, kv, max_pages * ps[, d]) virtual
    dense rows (the reference's ``virtual``; K/V or their scales)."""
    b, mp = table.shape
    a = pool_layer[table.long()]                 # (b, mp, kv, ps[, d])
    a = a.transpose(1, 2)                        # (b, kv, mp, ps[, d])
    return a.reshape(b, a.shape[1], mp * a.shape[3], *a.shape[4:])


def decode_attention_reference(q, k, v, limits, prompt_lengths=None,
                               prompt_slots=None, table=None, k_scale=None,
                               v_scale=None):
    """The plain decode attention (see the module docstring) → (b, h, c, d)
    in q's dtype."""
    if table is not None:
        k, v = virtual_rows(k, table), virtual_rows(v, table)
        if k_scale is not None:
            k_scale = virtual_rows(k_scale, table)
            v_scale = virtual_rows(v_scale, table)
    b, h, c, hd = q.shape
    kv = k.shape[1]
    rep = h // kv
    qg = q.reshape(b, kv, rep, c, hd).float()
    k32 = k.float()
    if k_scale is not None:              # int8 cache: dequantize on read
        k32 = k32 * k_scale[..., None]
    s = torch.einsum("bkrcd,bksd->bkrcs", qg, k32) * (
        1.0 / (hd ** 0.5))
    slots = torch.arange(k.shape[2], device=q.device)
    mask = slots < limits[..., None]                # (c, S) | (b, c, S)
    if prompt_lengths is not None:
        # prompt_slots is an int for a uniform batch (one padded width)
        # or a (b,) tensor for a slot batch, where each row keeps its own
        ps = (prompt_slots.reshape(-1, 1) if torch.is_tensor(prompt_slots)
              else prompt_slots)
        real = (
            (slots[None, :] < prompt_lengths[:, None])
            | (slots[None, :] >= ps)
        )                                           # (b, S)
        mask = mask & real[:, None, :]
    neg = torch.full_like(s, NEG_INF)
    if mask.dim() == 2:                             # shared across batch
        s = torch.where(mask[None, None, None], s, neg)
    else:                                           # per row
        s = torch.where(mask[:, None, None], s, neg)
    p = torch.softmax(s, dim=-1)
    v32 = v.float()
    if v_scale is not None:
        v32 = v32 * v_scale[..., None]
    out = torch.einsum("bkrcs,bksd->bkrcd", p, v32)
    return out.reshape(b, h, c, hd).to(q.dtype)


def _route(dtype, head_dim: int, rep: int, kv_dtype=None) -> str:
    """The kernel route of a call: bf16 q at head_dim 64 or 128 with at
    most TC_MAX_REP query heads a KV head takes the tensor cores, "tc8"
    over an int8 cache and "tc" over a bf16 one; every other call the
    CUDA cores, "q8" over an int8 cache and "simt" over the rest."""
    tensor_cores = (dtype == torch.bfloat16 and head_dim in TC_HEAD_DIMS
                    and rep <= TC_MAX_REP)
    if kv_dtype == torch.int8:
        return "tc8" if tensor_cores else "q8"
    return "tc" if tensor_cores else "simt"


def load_kernel(route: str):
    """The C entry point of ``route``, built by ``nvcc`` on first use:
    ``decode_attention_tc`` (tc) or ``decode_attention_tc_q8`` (tc8) of
    ``csrc/decode_attention_tc.cu``, ``decode_attention`` (simt) or
    ``decode_attention_q8`` (q8) of ``csrc/decode_attention.cu``."""
    from tpu_kubernetes_torch.ops import _build

    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    if route == "tc8":
        return _build.load(
            "decode_attention_tc_q8",
            [ptr] * 7 + [i64, i64, ptr, ptr, i32, ptr, i32, i32, i64]
            + [i32] * 6 + [i64] * 12 + [ctypes.c_float, ptr],
            library="decode_attention_tc")
    if route == "tc":
        return _build.load(
            "decode_attention_tc",
            [ptr] * 5 + [i64, i64, ptr, ptr, i32, ptr, i32, i32, i64]
            + [i32] * 6 + [i64] * 6 + [ctypes.c_float, ptr])
    if route == "q8":
        return _build.load(
            "decode_attention_q8",
            [ptr] * 10 + [i64, i64, ptr, ptr, i32, ptr, i32, i32]
            + [i32] * 7 + [i64] * 12 + [ctypes.c_float, ptr],
            library="decode_attention")
    return _build.load(
        "decode_attention",
        [ptr] * 8 + [i64, i64, ptr, ptr, i32, ptr, i32, i32]
        + [i32] * 7 + [i64] * 6 + [ctypes.c_float, ptr])


def simt_split() -> int:
    """Positions a split of the simt kernel: it sizes the partials."""
    from tpu_kubernetes_torch.ops import _build

    return _build.load("decode_attention_split", [],
                       library="decode_attention")()


def _check(cond: bool, msg: str, exc=ValueError) -> None:
    if not cond:
        raise exc(f"decode_attention_cuda: {msg}")


def _int_tensor(t: torch.Tensor, dtype, dev) -> torch.Tensor:
    _check(t.device == dev, f"takes index tensors on {dev}; got {t.device}")
    return t.to(dtype).contiguous()


def decode_attention_cuda(q, k, v, limits, prompt_lengths=None,
                          prompt_slots=None, table=None,
                          route: str | None = None, k_scale=None,
                          v_scale=None) -> torch.Tensor:
    """Launch the decode-attention kernel on the current stream →
    (b, h, c, d) in q's dtype, as :func:`decode_attention_reference`.
    ``route=None`` takes :func:`_route`'s; ``"simt"`` runs the CUDA-core
    kernel on any bf16 or f32 input it takes, ``"q8"`` on any call over
    an int8 cache (the comparisons in ``chip_smoke.py``). Every chunk row
    must leave at least one position unmasked (each attends its own new
    token)."""
    _check(q.dim() == 4, f"takes q (b, h, c, d); got {tuple(q.shape)}")
    b, h, c, d = q.shape
    _check(1 <= c <= MAX_CHUNK,
           f"takes a chunk of 1 <= c <= MAX_CHUNK = {MAX_CHUNK} query "
           f"positions a row, not c = {c}: a longer chunk over a uniform "
           f"cache attends through the flash forward (models/decode.py "
           f"_attend_chunk)")
    _check(d in KERNEL_HEAD_DIMS, f"takes head_dim in {KERNEL_HEAD_DIMS}; "
                                  f"got {d}")
    _check(k.dim() == 4 and h % k.shape[1] == 0,
           f"{h} query heads do not group over the KV heads of k "
           f"{tuple(k.shape)}")
    own = _route(q.dtype, d, h // k.shape[1], k.dtype)
    _check(route in (None, own) or route == FORCEABLE.get(own),
           f"route {route!r} does not take {q.dtype} at head_dim {d} with "
           f"{h // k.shape[1]} query heads a KV head over a {k.dtype} cache")
    route = route or own
    q8 = route in ("q8", "tc8")             # over an int8 cache
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(t.is_cuda and t.device == dev,
               f"needs CUDA tensors on one device; {name} is on {t.device}")
    _check(q.dtype in KERNEL_DTYPES,
           f"takes a bfloat16 or float32 q; got {q.dtype}", TypeError)
    for name, t in (("k", k), ("v", v)):
        _check(t.dtype == (torch.int8 if q8 else q.dtype),
               f"takes bfloat16 or float32 q, k, v of one dtype, or int8 k "
               f"and v; {name} is {t.dtype}", TypeError)
    _check(k.shape == v.shape and k.shape[3] == d,
           f"takes k, v of one shape (., kv, ., {d}); got {tuple(k.shape)} "
           f"and {tuple(v.shape)}")
    _check(q8 == (k_scale is not None and v_scale is not None),
           "takes k_scale and v_scale with an int8 cache, and only then")
    kv = k.shape[1]
    vec = (8 if route == "q8" else 16) // k.element_size()
    for name, t in (("k", k), ("v", v)):
        _check(t.stride(3) == 1 and all(s % vec == 0 for s in t.stride()[:3])
               and t.data_ptr() % 16 == 0,
               f"takes {name} with contiguous, 16-byte aligned rows; got "
               f"strides {t.stride()}")
    if q8:
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            _check(t.is_cuda and t.device == dev
                   and t.dtype == torch.float32
                   and tuple(t.shape) == tuple(k.shape[:3]),
                   f"takes f32 {name} {tuple(k.shape[:3])} on {dev}; got "
                   f"{t.dtype} {tuple(t.shape)} on {t.device}", TypeError)
    if table is None:
        _check(k.shape[0] == b, f"a dense cache of {k.shape[0]} rows for "
                                f"{b} query rows")
        span, max_pages, page_size, tab = k.shape[2], 0, 0, None
    else:
        _check(table.dim() == 2 and table.shape[0] == b,
               f"takes a page table (b, max_pages); got "
               f"{tuple(table.shape)}")
        tab = _int_tensor(table, torch.int32, dev)
        max_pages, page_size = table.shape[1], k.shape[2]
        span = max_pages * page_size
        _check(route not in ("tc", "tc8")
               or page_size & (page_size - 1) == 0,
               f"takes pages of a power of two positions on the tensor "
               f"cores; got {page_size}")
    _check(limits.device == dev, f"takes limits on {dev}; got "
                                 f"{limits.device}")
    _check(span <= MAX_SPAN, f"takes a span of at most {MAX_SPAN}; got "
                             f"{span}")
    lim = limits.to(torch.int64)       # a broadcast (b, c) keeps stride 0
    _check(tuple(lim.shape) in ((c,), (b, c)),
           f"takes limits ({c},) or (b, {c}); got {tuple(lim.shape)}")
    lim_stride = 0 if lim.dim() == 1 else lim.stride(0)
    c_stride = lim.stride(-1)
    pl = ps = None
    ps_scalar = 0
    if prompt_lengths is not None:
        pl = _int_tensor(prompt_lengths, torch.int32, dev)
        _check(pl.shape == (b,), f"takes prompt_lengths (b,); got "
                                 f"{tuple(prompt_lengths.shape)}")
        if torch.is_tensor(prompt_slots):
            ps = _int_tensor(prompt_slots, torch.int32, dev)
            _check(ps.shape == (b,), f"takes prompt_slots (b,) or an int; "
                                     f"got {tuple(prompt_slots.shape)}")
        else:
            ps_scalar = int(prompt_slots)
    q = q.contiguous()
    fn = load_kernel(route)
    o = torch.empty((b, h, c, d), dtype=q.dtype, device=dev)
    ptr = (lambda t: None if t is None else t.data_ptr())
    shared = [lim.data_ptr(), lim_stride, c_stride, ptr(pl), ptr(ps),
              ps_scalar, ptr(tab), max_pages, page_size]
    tail = [*k.stride()[:3], *v.stride()[:3], 1.0 / math.sqrt(d)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if route == "tc":
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                     *shared, k.shape[0], b, h, kv, c, d, span, *tail,
                     stream)
        elif route == "tc8":
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                     k_scale.data_ptr(), v_scale.data_ptr(), *shared,
                     k.shape[0], b, h, kv, c, d, span, *tail[:6],
                     *k_scale.stride(), *v_scale.stride(), tail[6], stream)
        else:
            n_splits = -(-span // simt_split())
            part_m = torch.empty((b, h * c, n_splits), dtype=torch.float32,
                                 device=dev)
            part_l = torch.empty_like(part_m)
            part_acc = torch.empty((b, h * c, n_splits, d),
                                   dtype=torch.float32, device=dev)
            parts = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                     part_m.data_ptr(), part_l.data_ptr(),
                     part_acc.data_ptr())
            is_bf16 = int(q.dtype == torch.bfloat16)
            if q8:
                err = fn(*parts, k_scale.data_ptr(), v_scale.data_ptr(),
                         *shared, b, h, kv, c, d, span, is_bf16,
                         *tail[:6], *k_scale.stride(), *v_scale.stride(),
                         tail[6], stream)
            else:
                err = fn(*parts, *shared, b, h, kv, c, d, span, is_bf16,
                         *tail, stream)
    if err != 0:
        raise RuntimeError(f"{ENTRY[route]} kernel launch failed: CUDA "
                           f"error {err}")
    decode_attention_cuda.launches += 1
    decode_attention_cuda.route_launches[route] += 1
    if c > 1:
        decode_attention_cuda.chunk_launches[route] += 1
    return o


decode_attention_cuda.launches = 0
decode_attention_cuda.route_launches = {"tc": 0, "simt": 0, "q8": 0,
                                        "tc8": 0}
decode_attention_cuda.chunk_launches = {"tc": 0, "simt": 0, "q8": 0,
                                        "tc8": 0}


def decode_attention(q, k, v, limits, prompt_lengths=None, prompt_slots=None,
                     table=None, use_kernel: bool | None = None,
                     k_scale=None, v_scale=None) -> torch.Tensor:
    """Decode attention on either lane (see the module docstring):
    ``use_kernel=None`` launches the kernel when q lies on a CUDA device and
    runs the plain version when it lies on the CPU."""
    if use_kernel is None:
        use_kernel = q.is_cuda
    if not use_kernel:
        return decode_attention_reference(q, k, v, limits, prompt_lengths,
                                          prompt_slots, table, k_scale,
                                          v_scale)
    return decode_attention_cuda(q, k, v, limits, prompt_lengths,
                                 prompt_slots, table, k_scale=k_scale,
                                 v_scale=v_scale)
