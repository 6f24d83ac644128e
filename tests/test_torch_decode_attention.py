"""The port's decode attention (``ops/decode_attention.py``) against the JAX
package's ``_attend_cache`` on the CPU.

The plain version, which the dispatcher runs for CPU tensors, takes the
same numpy inputs as ``tpu_kubernetes/models/decode.py`` ``_attend_cache``
(float32, within 1e-5 absolute: both take f32 scores, the ``-1e30`` mask
and an f32 softmax, summed in their own orders): a uniform ragged batch
with an int ``prompt_slots``, a slot batch with one per row, limits shared
across the batch, GQA groups of 1, 2 and 4 query heads, the limits 1 and
S, a row with an empty prompt, and a paged cache read through a shuffled
page table against JAX's ``virtual`` gather followed by ``_attend_cache``.
The kernel wrapper's refusals that need no card are pinned here too; the
kernel itself is held to the plain version on the card
(``tests/test_torch_kernel_cuda.py``)."""

import importlib
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_kubernetes.models import decode as jdec
from tpu_kubernetes_torch.models import decode as tdec

# the module, not the dispatcher that ops/__init__ re-exports by its name
tda = importlib.import_module("tpu_kubernetes_torch.ops.decode_attention")

ATOL = 1e-5     # f32 on both sides: summation order and exp ulps only


def _cfg(h, kv, d):
    return SimpleNamespace(n_heads=h, n_kv_heads=kv, head_dim=d)


def _inputs(seed, b, h, kv, S, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, 1, d)).astype(np.float32)
    k = rng.standard_normal((b, kv, S, d)).astype(np.float32)
    v = rng.standard_normal((b, kv, S, d)).astype(np.float32)
    return q, k, v


def _both(q, k, v, limits, pl=None, ps=None):
    """→ (JAX's _attend_cache, the port's plain decode attention), numpy."""
    cfg = _cfg(q.shape[1], k.shape[1], q.shape[3])
    j = jdec._attend_cache(
        cfg, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(limits),
        None if pl is None else jnp.asarray(pl),
        None if ps is None else (jnp.asarray(ps) if isinstance(ps, np.ndarray)
                                 else ps))
    t = tda.decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(limits),
        None if pl is None else torch.from_numpy(pl),
        None if ps is None else (torch.from_numpy(ps)
                                 if isinstance(ps, np.ndarray) else ps))
    return np.asarray(j), t.numpy()


def test_uniform_batch_with_one_prompt_width():
    """The greedy lane's case: one padded width for the batch (an int
    prompt_slots), per-row prompt lengths, limits broadcast as (b, 1)."""
    q, k, v = _inputs(0, 3, 4, 2, 64, 16)
    limits = np.full((3, 1), 41, np.int64)
    pl = np.array([10, 24, 3], np.int32)
    j, t = _both(q, k, v, limits, pl, 24)
    np.testing.assert_allclose(t, j, atol=ATOL, rtol=0)


def test_slot_batch_with_a_width_per_row():
    """The slot engine's case: every row at its own limit and prompt width
    ((b,) prompt_slots), including an empty slot at position 0."""
    q, k, v = _inputs(1, 4, 4, 2, 96, 16)
    limits = np.array([[70], [17], [1], [96]], np.int64)
    pl = np.array([40, 5, 0, 30], np.int32)
    ps = np.array([64, 16, 0, 32], np.int32)
    j, t = _both(q, k, v, limits, pl, ps)
    np.testing.assert_allclose(t, j, atol=ATOL, rtol=0)


def test_limits_shared_across_the_batch():
    """A uniform batch without a ragged prompt: limits (c,)."""
    q, k, v = _inputs(2, 2, 8, 4, 48, 32)
    j, t = _both(q, k, v, np.array([33], np.int64))
    np.testing.assert_allclose(t, j, atol=ATOL, rtol=0)


@pytest.mark.parametrize("rep", [1, 2, 4])
def test_gqa_groups(rep):
    """Query head g * rep + r reads KV head g, as the reference groups."""
    kv = 2
    q, k, v = _inputs(3 + rep, 3, kv * rep, kv, 40, 16)
    limits = np.array([[40], [25], [9]], np.int64)
    pl = np.array([20, 8, 9], np.int32)
    ps = np.array([24, 16, 9], np.int32)
    j, t = _both(q, k, v, limits, pl, ps)
    np.testing.assert_allclose(t, j, atol=ATOL, rtol=0)


@pytest.mark.parametrize("limit", [1, 64])
def test_limit_one_and_the_full_span(limit):
    q, k, v = _inputs(10 + limit, 2, 4, 2, 64, 16)
    j, t = _both(q, k, v, np.array([limit], np.int64))
    np.testing.assert_allclose(t, j, atol=ATOL, rtol=0)
    # limit 1 attends position 0 alone: the output is V's first row
    if limit == 1:
        want = np.repeat(v[:, :, :1], 2, axis=1)          # rep 2
        np.testing.assert_allclose(t[:, :, 0], want[:, :, 0], atol=ATOL)


def test_row_with_an_empty_prompt():
    """prompt_length 0: the row's only real positions are its generated
    ones, from prompt_slots on."""
    q, k, v = _inputs(20, 2, 4, 2, 64, 16)
    limits = np.array([[35], [35]], np.int64)
    pl = np.array([0, 12], np.int32)
    j, t = _both(q, k, v, limits, pl, 32)
    np.testing.assert_allclose(t, j, atol=ATOL, rtol=0)


def _jax_virtual(pool_l, table):
    """JAX's ``virtual`` (``decode_step_paged``): one layer's pages → the
    (b, kv, max_pages * ps, d) virtual dense rows."""
    a = pool_l[table].transpose(0, 2, 1, 3, 4)
    return a.reshape(a.shape[:2] + (table.shape[1] * a.shape[3],)
                     + a.shape[4:])


@pytest.mark.parametrize("ps", [4, 16])
def test_paged_through_a_shuffled_table(ps):
    """A pool layer read through a table of shuffled pages (unused entries
    on the sink, page 0) against JAX's virtual gather and _attend_cache,
    and the port's paged result equal to its dense one on the same
    positions."""
    rng = np.random.default_rng(ps)
    b, h, kv, d, mp = 3, 4, 2, 16, 64 // ps
    n_pages = b * mp
    pool_k = rng.standard_normal((n_pages + 1, kv, ps, d)).astype(np.float32)
    pool_v = rng.standard_normal((n_pages + 1, kv, ps, d)).astype(np.float32)
    perm = rng.permutation(np.arange(1, n_pages + 1)).astype(np.int32)
    table = perm.reshape(b, mp)
    table[2, mp // 2:] = 0                     # a short row: sink entries
    q = rng.standard_normal((b, h, 1, d)).astype(np.float32)
    limits = np.array([[64], [50], [ps * (mp // 2)]], np.int64)
    pl = np.array([20, 7, 5], np.int32)
    ps_row = np.array([32, 16, 8], np.int32)
    cfg = _cfg(h, kv, d)
    tab_j = jnp.asarray(table)
    j = jdec._attend_cache(
        cfg, jnp.asarray(q), _jax_virtual(jnp.asarray(pool_k), tab_j),
        _jax_virtual(jnp.asarray(pool_v), tab_j), jnp.asarray(limits),
        jnp.asarray(pl), jnp.asarray(ps_row))
    args = (torch.from_numpy(limits), torch.from_numpy(pl),
            torch.from_numpy(ps_row))
    t = tda.decode_attention(torch.from_numpy(q), torch.from_numpy(pool_k),
                             torch.from_numpy(pool_v), *args,
                             table=torch.from_numpy(table))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL, rtol=0)
    dense_k = tda.virtual_rows(torch.from_numpy(pool_k),
                               torch.from_numpy(table))
    dense_v = tda.virtual_rows(torch.from_numpy(pool_v),
                               torch.from_numpy(table))
    dense = tda.decode_attention(torch.from_numpy(q), dense_k, dense_v, *args)
    assert torch.equal(dense, t)


def test_attend_cache_dispatches_by_device_and_config():
    """``models/decode.py``'s _attend_cache is the dispatcher: a CPU tensor
    takes the plain version; ``use_kernel=True`` sends it to the kernel
    wrapper, which takes only CUDA tensors."""
    q, k, v = _inputs(30, 2, 4, 2, 32, 16)
    args = (torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            torch.tensor([20]))
    cfg = SimpleNamespace(use_kernel=None)
    ref = tda.decode_attention_reference(*args)
    assert torch.equal(tdec._attend_cache(cfg, *args), ref)
    before = tda.decode_attention_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        tdec._attend_cache(SimpleNamespace(use_kernel=True), *args)
    assert tda.decode_attention_cuda.launches == before


@pytest.mark.parametrize("shape,match", [
    # the case's id is the one it had when the kernel refused c = 2
    pytest.param((2, 4, tda.MAX_CHUNK + 1, 16),
                 rf"MAX_CHUNK = {tda.MAX_CHUNK} query positions a row, not "
                 rf"c = {tda.MAX_CHUNK + 1}", id="shape0-c = 2"),
    ((2, 4, 1, 80), r"head_dim in \(16, 32, 64, 128\); got 80"),
])
def test_kernel_refuses_a_chunk_and_an_unsupported_head_dim(shape, match):
    """The kernel takes a chunk of at most MAX_CHUNK query positions a row
    and the listed head dims; it raises with the reason before it touches
    the device."""
    b, c, d = shape[0], shape[2], shape[3]
    q = torch.zeros(shape)
    k = torch.zeros((b, 2, 32, d))
    with pytest.raises(ValueError, match=match):
        tda.decode_attention_cuda(q, k, k, torch.arange(c) + 4)


@pytest.mark.parametrize("dtype,d,rep,route", [
    (torch.bfloat16, 128, 2, "tc"),     # llama-1b
    (torch.bfloat16, 128, 1, "tc"),     # llama-7b
    (torch.bfloat16, 128, 8, "tc"),     # llama-70b
    (torch.bfloat16, 64, 2, "tc"),      # moe-1b
    (torch.bfloat16, 64, 16, "tc"),     # the widest group the tc kernel takes
    (torch.bfloat16, 128, 32, "simt"),  # wider: the CUDA cores
    (torch.bfloat16, 16, 2, "simt"),    # llama-test
    (torch.bfloat16, 32, 1, "simt"),
    (torch.float32, 128, 2, "simt"),    # f32 never takes the tensor cores
    (torch.float32, 64, 8, "simt"),
])
def test_route_by_dtype_head_dim_and_group(dtype, d, rep, route):
    """One rule picks a call's kernel, as the flash wrappers' ``_route``
    does: bf16 at head_dim 64 or 128 with at most 16 query heads a KV
    head on the tensor cores, everything else on the CUDA cores."""
    assert tda._route(dtype, d, rep) == route


@pytest.mark.parametrize("dtype,d,rep,route", [
    (torch.float32, 128, 2, "tc"),
    (torch.bfloat16, 32, 2, "tc"),
    (torch.bfloat16, 128, 32, "tc"),
    (torch.bfloat16, 128, 2, "wgmma"),
])
def test_a_route_that_cannot_take_the_call_raises_before_the_device(
        dtype, d, rep, route):
    """A forced route that does not take the dtype, head_dim or group (or
    does not exist) raises with the reason before any device check, and
    launches nothing; "simt" takes every call the wrapper takes."""
    kv = 2
    q = torch.zeros((2, rep * kv, 1, d), dtype=dtype)
    k = torch.zeros((2, kv, 32, d), dtype=dtype)
    before = dict(tda.decode_attention_cuda.route_launches)
    with pytest.raises(ValueError, match=f"route '{route}' does not take"):
        tda.decode_attention_cuda(q, k, k, torch.tensor([4]), route=route)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tda.decode_attention_cuda(q, k, k, torch.tensor([4]), route="simt")
    assert tda.decode_attention_cuda.route_launches == before


def test_launch_counts_carry_both_routes():
    """``ops.launch_counts`` reads the decode-attention wrapper's launches
    in all and by route, as it does the flash and grouped wrappers'."""
    ops = importlib.import_module("tpu_kubernetes_torch.ops")
    counts = ops.launch_counts()
    assert {"decode_attention", "decode_attention.tc",
            "decode_attention.simt"} <= set(counts)


def _int8_cache(seed, b, kv, S, d):
    """An int8 K/V cache as the reference stores it: (q int8, f32 scale a
    position and KV head), from a seeded normal draw."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        x = rng.standard_normal((b, kv, S, d)).astype(np.float32)
        q, sc = jdec._quantize_kv(jnp.asarray(x))
        out += [np.asarray(q), np.asarray(sc)]
    return out


@pytest.mark.parametrize("c", [1, 9])
@pytest.mark.parametrize("paged", [False, True])
def test_int8_cache_matches_jax_attend_cache_with_scales(paged, c):
    """The plain version over an int8 cache (``k_scale``/``v_scale``)
    against JAX's ``_attend_cache`` with its scales, a ragged slot batch
    (a pad gap a row, chunk limits a row), GQA 2; paged through a
    shuffled table against JAX's ``virtual`` gather of the pool. The
    port's quantizer is JAX's on the same K/V: the same int8 values and
    scales."""
    b, h, kv, S, d, ps = 3, 4, 2, 64, 16, 8
    k8, ks, v8, vs = _int8_cache(5, b, kv, S, d)
    tq8, tks = tdec._quantize_kv(torch.from_numpy(
        np.random.default_rng(5).standard_normal((b, kv, S, d)).astype(
            np.float32)))
    np.testing.assert_array_equal(tq8.numpy(), k8)
    np.testing.assert_array_equal(tks.numpy(), ks)
    rng = np.random.default_rng(6)
    q = rng.standard_normal((b, h, c, d)).astype(np.float32)
    pl = np.array([5, 12, 0], np.int32)
    pslots = np.array([16, 16, 8], np.int32)
    pos = np.array([40, 20, 50], np.int64)
    limits = pos[:, None] + 1 + np.arange(c)[None, :]
    cfg = _cfg(h, kv, d)
    want = np.asarray(jdec._attend_cache(
        cfg, jnp.asarray(q), jnp.asarray(k8), jnp.asarray(v8),
        jnp.asarray(limits), jnp.asarray(pl), jnp.asarray(pslots),
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs)))
    args = [torch.from_numpy(a) for a in (k8, v8, ks, vs)]
    table = None
    if paged:
        mp = S // ps
        perm = np.random.default_rng(7).permutation(b * mp) + 1
        table = perm.reshape(b, mp).astype(np.int32)

        def pool(a):
            out = np.zeros((b * mp + 1, kv, ps) + a.shape[3:], a.dtype)
            for i in range(b):
                for j in range(mp):
                    out[table[i, j]] = a[i, :, j * ps:(j + 1) * ps]
            return torch.from_numpy(out)

        args = [pool(a) for a in (k8, v8, ks, vs)]
        table = torch.from_numpy(table)
    got = tda.decode_attention(
        torch.from_numpy(q), args[0], args[1], torch.from_numpy(limits),
        torch.from_numpy(pl), torch.from_numpy(pslots), table,
        k_scale=args[2], v_scale=args[3])
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d,rep", [(16, 2), (32, 1), (64, 2), (128, 16),
                                   (128, 32)])
def test_an_int8_cache_takes_the_q8_route(dtype, d, rep):
    """An int8 cache takes the tensor cores' "tc8" route with bf16 q at
    head_dim 64 or 128 and at most 16 query heads a KV head, the CUDA
    cores' "q8" route at every other dtype, head_dim and group the wrapper
    takes; a forced bf16 route over it, or scales with a bf16 cache, are
    refused before the device, launching nothing."""
    tensor_cores = dtype == torch.bfloat16 and d in (64, 128) and rep <= 16
    assert tda._route(dtype, d, rep, torch.int8) == (
        "tc8" if tensor_cores else "q8")
    assert tda._route(dtype, d, rep, dtype) in ("tc", "simt")
    q = torch.zeros((2, rep * 2, 1, d), dtype=dtype)
    k8 = torch.zeros((2, 2, 32, d), dtype=torch.int8)
    before = dict(tda.decode_attention_cuda.route_launches)
    for route in ("tc", "simt"):
        with pytest.raises(ValueError, match=f"route '{route}' does not"):
            tda.decode_attention_cuda(q, k8, k8, torch.tensor([4]),
                                      route=route)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tda.decode_attention_cuda(q, k8, k8, torch.tensor([4]))
    assert tda.decode_attention_cuda.route_launches == before


@pytest.mark.parametrize("dtype,d,rep,route,ok", [
    # the tc8 route's calls: forced to the CUDA cores' q8, or their own
    (torch.bfloat16, 128, 2, "q8", True),
    (torch.bfloat16, 64, 16, "tc8", True),
    # q8's own calls cannot be forced onto the tensor cores
    (torch.float32, 128, 2, "tc8", False),
    (torch.bfloat16, 16, 2, "tc8", False),
    (torch.bfloat16, 128, 32, "tc8", False),
    # nor an int8 cache onto a bf16 route, nor a bf16 cache onto tc8
    (torch.bfloat16, 128, 2, "tc", False),
])
def test_forcing_a_route_over_an_int8_cache(dtype, d, rep, route, ok):
    """``route="q8"`` forces the CUDA-core kernel on a call the tensor
    cores take (the comparisons); a route that does not take the call
    raises with the reason before any device check. Neither launches
    anything on the CPU."""
    q = torch.zeros((2, rep * 2, 1, d), dtype=dtype)
    k8 = torch.zeros((2, 2, 32, d), dtype=torch.int8)
    sc = torch.ones((2, 2, 32))
    before = dict(tda.decode_attention_cuda.route_launches)
    match = "CUDA tensors" if ok else f"route '{route}' does not take"
    with pytest.raises(ValueError, match=match):
        tda.decode_attention_cuda(q, k8, k8, torch.tensor([4]), route=route,
                                  k_scale=sc, v_scale=sc)
    if route == "tc8":
        kb = torch.zeros((2, 2, 32, d), dtype=dtype)
        with pytest.raises(ValueError, match="route 'tc8' does not take"):
            tda.decode_attention_cuda(q, kb, kb, torch.tensor([4]),
                                      route="tc8")
    assert tda.decode_attention_cuda.route_launches == before


def test_launch_counts_carry_the_int8_tensor_core_route():
    """``ops.launch_counts`` reads decode attention's "tc8" launches and
    its chunks beside the other routes'."""
    ops = importlib.import_module("tpu_kubernetes_torch.ops")
    counts = ops.launch_counts()
    assert {"decode_attention.tc8", "decode_attention.tc8.chunk",
            "decode_attention.q8", "decode_attention.q8.chunk"} <= set(counts)
    assert set(tda.decode_attention_cuda.route_launches) == set(
        tda.decode_attention_cuda.chunk_launches) == {"tc", "simt", "q8",
                                                      "tc8"}
