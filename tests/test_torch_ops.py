"""The port's ops against their JAX originals on the CPU: RMSNorm, RoPE
(all three ``positions`` forms), the plain attention and the flash
dispatcher (the JAX side runs its Pallas kernels in interpret mode), the
attention gradients (the plain backward and autograd through the
dispatcher against the JAX custom VJP) and the next-token loss, from the
same numpy inputs, in float32. The CUDA kernels' own tests are in
``tests/test_torch_kernel_cuda.py``."""

import functools
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_kubernetes import ops as jops
from tpu_kubernetes_torch import ops as tops

# the package re-exports the function under the module's name
tfa = importlib.import_module("tpu_kubernetes_torch.ops.flash_attention")

# float32 on both sides: only summation order and transcendental ulps differ
TOL = dict(atol=1e-5, rtol=1e-5)


def _arr(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_rms_norm_matches_jax():
    x, w = _arr(0, (3, 5, 64)), _arr(1, (64,))
    ref = jops.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6)
    got = tops.rms_norm(_t(x), _t(w), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("d", [64, 2048, 80])
def test_rms_norm_rows_do_not_depend_on_the_batch(d):
    """A row normalises to the same bits alone, in a batch of 8 and in
    one of 72 (the slot engine's rows against the solo lane's), at widths
    that take the chunked sum and at one (80) that does not."""
    x, w = _t(_arr(2, (72, d))), _t(_arr(3, (d,)))
    x = x.to(torch.bfloat16)
    full = tops.rms_norm(x, w, 1e-6)
    for b in (1, 8):
        parts = torch.cat([tops.rms_norm(x[i:i + b], w, 1e-6)
                           for i in range(0, 72, b)])
        assert torch.equal(parts, full)


def test_rope_frequencies_match_jax():
    cos_j, sin_j = jops.rope_frequencies(16, 128, 10000.0)
    cos_t, sin_t = tops.rope_frequencies(16, 128, 10000.0, device="cpu")
    np.testing.assert_allclose(cos_t.numpy(), np.asarray(cos_j), **TOL)
    np.testing.assert_allclose(sin_t.numpy(), np.asarray(sin_j), **TOL)


@pytest.mark.parametrize("form", ["none", "shared", "per_row"])
def test_apply_rope_matches_jax(form):
    b, h, s, d = 2, 3, 8, 16
    x = _arr(2, (b, h, s, d))
    positions = {
        "none": None,
        "shared": np.arange(5, 5 + s, dtype=np.int32),
        "per_row": np.stack([np.arange(3, 3 + s), np.arange(11, 11 + s)])
        .astype(np.int32),
    }[form]
    cos_j, sin_j = jops.rope_frequencies(d, 64)
    cos_t, sin_t = tops.rope_frequencies(d, 64, device="cpu")
    ref = jops.apply_rope(jnp.asarray(x), cos_j, sin_j,
                          None if positions is None else jnp.asarray(positions))
    got = tops.apply_rope(_t(x), cos_t, sin_t,
                          None if positions is None else _t(positions))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    assert got.is_contiguous()


def test_apply_rope_rotates_split_halves():
    """Channel i pairs with channel i + d/2, not with its neighbour."""
    d = 8
    x = torch.zeros(1, 1, 1, d)
    x[..., 0] = 1.0
    cos, sin = tops.rope_frequencies(d, 4, device="cpu")
    out = tops.apply_rope(x, cos, sin, torch.tensor([1]))
    assert out[..., 0].item() == pytest.approx(math.cos(1.0), abs=1e-6)
    assert out[..., d // 2].item() == pytest.approx(math.sin(1.0), abs=1e-6)
    assert out[..., 1].item() == 0.0


# (b, h, seq_q, seq_k, d): square, offset (seq_q < seq_k) and a GQA-shaped
# query block
ATTN_SHAPES = [(2, 3, 128, 128, 16), (1, 2, 64, 128, 32), (2, 4, 64, 64, 16)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", ATTN_SHAPES)
def test_attention_reference_matches_jax(shape, causal):
    b, h, sq, sk, d = shape
    q, k, v = _arr(3, (b, h, sq, d)), _arr(4, (b, h, sk, d)), _arr(5, (b, h, sk, d))
    ref = jops.attention_reference(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal)
    got = tops.attention_reference(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", ATTN_SHAPES)
def test_flash_dispatcher_matches_jax_kernel(shape, causal):
    """The JAX Pallas kernel (interpret mode) against the port's
    dispatcher, which on CPU tensors takes the plain version."""
    b, h, sq, sk, d = shape
    q, k, v = _arr(6, (b, h, sq, d)), _arr(7, (b, h, sk, d)), _arr(8, (b, h, sk, d))
    ref = jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=causal, block_q=64, block_k=64,
                               interpret=True)
    got = tops.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                               block_q=64, block_k=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_gqa_repeat_is_repeat_interleave():
    """Query head i reads KV head i // rep, as ``jnp.repeat`` does."""
    from tpu_kubernetes_torch.models.llama import repeat_kv

    x = _arr(9, (2, 3, 4, 8))
    ref = np.asarray(jnp.repeat(jnp.asarray(x), 2, axis=1))
    np.testing.assert_array_equal(repeat_kv(_t(x), 2).numpy(), ref)


def test_fit_block_matches_jax():
    from tpu_kubernetes.ops.flash_attention import _fit_block as jfit

    for block, seq in [(512, 768), (512, 640), (512, 2048), (512, 8),
                       (512, 1000), (128, 12), (96, 96), (512, 16)]:
        assert tfa._fit_block(block, seq) == jfit(block, seq)


def test_kernel_lane_block_errors_match_jax():
    """The kernel lane raises the reference's divisibility error for the
    same lengths and blocks, before any device check."""
    q = _t(_arr(10, (1, 2, 1000, 16)))
    with pytest.raises(ValueError, match="divisible"):
        tops.flash_attention(q, q, q, block_q=512, block_k=512,
                             use_kernel=True)
    q = _t(_arr(11, (1, 2, 256, 16)))
    with pytest.raises(ValueError, match="divisible"):
        tops.flash_attention(q, q, q, block_q=96, block_k=100,
                             use_kernel=True)


def test_kernel_lane_refuses_cpu_tensors():
    """No silent fallback: asking for the kernel with CPU tensors raises,
    and does not count a launch."""
    q = _t(_arr(12, (1, 2, 64, 16)))
    before = tfa.flash_fwd_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        tops.flash_attention(q, q, q, use_kernel=True)
    assert tfa.flash_fwd_cuda.launches == before


@pytest.mark.parametrize("dtype,head_dim,route", [
    (torch.bfloat16, 64, "tc"), (torch.bfloat16, 128, "tc"),
    (torch.bfloat16, 16, "simt"), (torch.bfloat16, 32, "simt"),
    (torch.float32, 16, "simt"), (torch.float32, 32, "simt"),
    (torch.float32, 64, "simt"), (torch.float32, 128, "simt"),
])
def test_forward_route_follows_dtype_and_head_dim(dtype, head_dim, route):
    """The tensor-core kernel serves bf16 at head_dim 64/128; f32 (no
    TF32) and the narrow heads stay on the CUDA-core kernel."""
    assert tfa._route(dtype, head_dim) == route
    assert tfa.FWD_ENTRY[route] in ("flash_fwd_tc", "flash_fwd")


@pytest.mark.parametrize("dtype,route,match", [
    (torch.bfloat16, None, "CUDA"), (torch.bfloat16, "tc", "CUDA"),
    (torch.bfloat16, "simt", "CUDA"), (torch.float32, "tc", "route"),
    (torch.float32, "wgmma", "route"),
])
def test_forward_wrapper_refuses_before_any_launch(dtype, route, match):
    """CPU tensors on every route, and a route that does not take the
    inputs, raise before anything is built or launched."""
    q = _t(_arr(16, (1, 2, 128, 64))).to(dtype)
    before = (tfa.flash_fwd_cuda.launches,
              dict(tfa.flash_fwd_cuda.route_launches))
    with pytest.raises(ValueError, match=match):
        tfa.flash_fwd_cuda(q, q, q, True, 0.125, route=route)
    assert (tfa.flash_fwd_cuda.launches,
            tfa.flash_fwd_cuda.route_launches) == before


@pytest.mark.parametrize("dtype,head_dim,route", [
    (torch.bfloat16, 64, "tc"), (torch.bfloat16, 128, "tc"),
    (torch.bfloat16, 16, "simt"), (torch.bfloat16, 32, "simt"),
    (torch.float32, 16, "simt"), (torch.float32, 32, "simt"),
    (torch.float32, 64, "simt"), (torch.float32, 128, "simt"),
])
def test_dkv_route_follows_dtype_and_head_dim(dtype, head_dim, route):
    """The dK/dV kernel's route follows the forward's rule: dtype and
    head_dim only."""
    assert tfa._route(dtype, head_dim) == route
    assert tfa.DKV_ENTRY[route] in ("flash_bwd_dkv_tc", "flash_bwd_dkv")


@pytest.mark.parametrize("dtype,head_dim,route", [
    (torch.bfloat16, 64, "tc"), (torch.bfloat16, 128, "tc"),
    (torch.bfloat16, 16, "simt"), (torch.bfloat16, 32, "simt"),
    (torch.float32, 16, "simt"), (torch.float32, 32, "simt"),
    (torch.float32, 64, "simt"), (torch.float32, 128, "simt"),
])
def test_dq_route_follows_dtype_and_head_dim(dtype, head_dim, route):
    """The dQ kernel's route follows the forward's rule too: bf16 at
    head_dim 64/128 on the tensor cores, f32 and the narrow heads on the
    CUDA-core kernel."""
    assert tfa._route(dtype, head_dim) == route
    assert tfa.DQ_ENTRY[route] in ("flash_bwd_dq_tc", "flash_bwd_dq")


@pytest.fixture()
def no_build(monkeypatch):
    """Fail any attempt to build or load a kernel library."""
    from tpu_kubernetes_torch.ops import _build

    def refuse(*args, **kwargs):
        raise AssertionError(f"a library was loaded: {args}")

    monkeypatch.setattr(_build, "load", refuse)


_REFUSED = [
    (torch.bfloat16, 64, None, "CUDA"), (torch.bfloat16, 64, "tc", "CUDA"),
    (torch.bfloat16, 64, "simt", "CUDA"), (torch.float32, 64, None, "CUDA"),
    (torch.float32, 64, "tc", "route"), (torch.bfloat16, 32, "tc", "route"),
    (torch.bfloat16, 64, "wgmma", "route"),
]


# each case against the dK/dV wrapper (ids as pytest makes them, dtype0 …)
# and against the dQ wrapper (ids dq-…)
@pytest.mark.parametrize("kernel,dtype,d,route,match", [
    *(pytest.param("dkv", *c, id=f"dtype{i}-{c[1]}-{c[2]}-{c[3]}")
      for i, c in enumerate(_REFUSED)),
    *(pytest.param("dq", *c, id=f"dq-{str(c[0])[6:]}-{c[1]}-{c[2]}-{c[3]}")
      for c in _REFUSED),
])
def test_dkv_wrapper_refuses_before_any_build(no_build, kernel, dtype, d,
                                              route, match):
    """CPU tensors on every route, and a route that does not take the
    inputs, raise before a library is built or a launch counted: the dK/dV
    and the dQ wrapper alike."""
    fn = {"dkv": tfa.flash_bwd_dkv_cuda, "dq": tfa.flash_bwd_dq_cuda}[kernel]
    q = _t(_arr(41, (1, 2, 64, d))).to(dtype)
    lse = torch.zeros(1, 2, 64)
    before = (fn.launches, dict(fn.route_launches))
    with pytest.raises(ValueError, match=match):
        fn(q, q, q, q, lse, lse, True, 0.125, route=route)
    assert (fn.launches, fn.route_launches) == before


@pytest.mark.parametrize("route,entry,ints", [
    ("simt", "flash_bwd_dkv", 6), ("tc", "flash_bwd_dkv_tc", 5),
    ("simt", "flash_bwd_dq", 6), ("tc", "flash_bwd_dq_tc", 5)])
def test_load_bwd_kernels_binds_pointers_as_void_pointers(monkeypatch, route,
                                                          entry, ints):
    """Each backward entry point is bound with c_void_p for every pointer
    and the stream (a c_int would cut a 64-bit pointer), without building:
    ``load_bwd_kernels(route)`` binds the dQ (7 pointers) and the dK/dV (8)
    entry of ``route``, the tc ones without ``is_bf16``."""
    import ctypes

    from tpu_kubernetes_torch.ops import _build

    seen = {}
    monkeypatch.setattr(_build, "load", lambda symbol, argtypes, library=None:
                        seen.setdefault(symbol, (argtypes, library)))
    tfa.load_bwd_kernels(route)
    assert set(seen) == {tfa.DQ_ENTRY[route], tfa.DKV_ENTRY[route]}
    pointers = 7 if entry.startswith("flash_bwd_dq") else 8
    tail = [ctypes.c_int] * ints + [ctypes.c_float, ctypes.c_void_p]
    assert seen[entry] == ([ctypes.c_void_p] * pointers + tail, "flash_bwd")


def test_dispatcher_uses_plain_version_on_cpu():
    q, k, v = (_t(_arr(s, (1, 2, 64, 16))) for s in (13, 14, 15))
    out = tops.flash_attention(q, k, v)
    ref = tops.attention_reference(q, k, v)
    assert torch.equal(out, ref)


# -- the backward ---------------------------------------------------------------

# float32 on both sides; the JAX side runs its two Pallas backward kernels
# in interpret mode block by block, the port one product over the whole
# sequence: summation order only (measured at most 1.7e-6 here)
@functools.lru_cache(maxsize=None)
def _jax_attention_grads(shape, causal):
    """(q, k, v, dO) from a seed, and jax.grad of sum(flash_attention·dO)
    through the JAX custom VJP (the Pallas dQ and dK/dV kernels)."""
    b, h, sq, sk, d = shape
    q, k, v = _arr(20, (b, h, sq, d)), _arr(21, (b, h, sk, d)), _arr(22, (b, h, sk, d))
    do = _arr(23, (b, h, sq, d))

    def f(q, k, v):
        o = jops.flash_attention(q, k, v, causal=causal, block_q=64,
                                 block_k=64, interpret=True)
        return jnp.sum(o * do)

    grads = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v))
    return (q, k, v, do), tuple(np.asarray(g) for g in grads)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", ATTN_SHAPES)
def test_attention_bwd_reference_matches_jax_kernels(shape, causal):
    """The plain version of both backward kernels, fed the plain forward's
    O and LSE, against the JAX Pallas backward."""
    (q, k, v, do), ref = _jax_attention_grads(shape, causal)
    q, k, v, do = (_t(x) for x in (q, k, v, do))
    scale = 1.0 / math.sqrt(shape[-1])
    o = tops.attention_reference(q, k, v, causal=causal)
    lse = tfa.logsumexp_reference(q, k, causal, scale)
    assert lse.shape == q.shape[:3] and lse.dtype == torch.float32
    got = tops.attention_bwd_reference(q, k, v, o, lse, do, causal, scale)
    for g, r, name in zip(got, ref, ("dq", "dk", "dv")):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), r, **TOL, err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", ATTN_SHAPES)
def test_flash_dispatcher_grads_match_jax_kernels(shape, causal):
    """Autograd through the port's dispatcher (the plain lane on CPU)
    against the JAX custom VJP."""
    (q, k, v, do), ref = _jax_attention_grads(shape, causal)
    q, k, v = (_t(x).requires_grad_(True) for x in (q, k, v))
    out = tops.flash_attention(q, k, v, causal=causal, block_q=64, block_k=64)
    got = torch.autograd.grad(out, (q, k, v), _t(do))
    for g, r, name in zip(got, ref, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), r, **TOL, err_msg=name)


def test_bwd_reference_bf16_writes_input_dtypes():
    q, k, v, do = (_t(_arr(30 + i, (1, 2, 64, 16))).bfloat16() for i in range(4))
    o = tops.attention_reference(q, k, v)
    lse = tfa.logsumexp_reference(q, k, True, 0.25)
    dq, dk, dv = tops.attention_bwd_reference(q, k, v, o, lse, do, True, 0.25)
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    assert all(bool(torch.isfinite(g.float()).all()) for g in (dq, dk, dv))


def test_backward_wrappers_refuse_cpu_tensors():
    """No silent fallback in the backward either: the kernel wrappers
    raise on CPU tensors and count no launch."""
    q = _t(_arr(40, (1, 2, 64, 16)))
    lse = torch.zeros(1, 2, 64)
    before = (tfa.flash_bwd_dq_cuda.launches, tfa.flash_bwd_dkv_cuda.launches)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_bwd_cuda(q, q, q, q, lse, q, True, 0.25)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_bwd_dkv_cuda(q, q, q, q, lse, lse, True, 0.25)
    assert (tfa.flash_bwd_dq_cuda.launches,
            tfa.flash_bwd_dkv_cuda.launches) == before


@pytest.mark.parametrize("shape", [(2, 5, 256), (3, 7, 32)])
def test_next_token_nll_matches_jax(shape):
    logits = _arr(50, shape) * 3.0
    targets = np.random.default_rng(51).integers(
        0, shape[-1], shape[:2]).astype(np.int32)
    ref = jops.next_token_nll(jnp.asarray(logits), jnp.asarray(targets))
    got = tops.next_token_nll(_t(logits), _t(targets))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(got.item(), float(ref), **TOL)
    # bf16 logits are taken in float32, as the reference's callers pass them
    got16 = tops.next_token_nll(_t(logits).bfloat16(), _t(targets))
    assert got16.dtype == torch.float32
