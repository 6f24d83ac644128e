"""The port's grouped matmul on the CPU against the JAX package's Pallas
kernels run in interpret mode, from the same numpy inputs: the plain
versions of both kernels (``grouped_matmul_reference`` against
``_gmm_call``, ``gmm_drhs_reference`` against ``_gmm_drhs_call``, empty
groups zero) over the reference test's size patterns, the CPU lane's
gradients against ``jax.grad`` of the interpret-mode kernel, and the
dispatcher's refusals, message for message. The CUDA kernels themselves
run in tests/test_torch_kernel_cuda.py (gpu)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# the modules, not the dispatchers that each ops/__init__ re-exports by name
jgmm_mod = importlib.import_module("tpu_kubernetes.ops.grouped_matmul")
tgmm = importlib.import_module("tpu_kubernetes_torch.ops.grouped_matmul")

# the reference test's size patterns (tests/test_grouped_matmul.py), M = 256
SIZE_PATTERNS = [
    [64, 64, 64, 64],          # balanced, block-aligned
    [0, 100, 0, 156],          # empty groups
    [256, 0, 0, 0],            # one group takes everything
    [1, 2, 3, 250],            # tiny groups inside one block
    [37, 99, 13, 107],         # boundaries split blocks arbitrarily
]
# (m, k, n, sizes, (block_m, block_n, block_k)) for the Pallas call
CASES = [
    *((256, 128, 256, s, (64, 128, 128)) for s in SIZE_PATTERNS),
    (128, 512, 256, [50, 14, 0, 64], (32, 128, 128)),    # K over 4 K-blocks
    (256, 128, 128, [40, 0, 77, 100, 39], (64, 128, 128)),   # E = 5
    (128, 256, 384, [1, 2, 0, 1, 1, 1, 1, 121], (128, 128, 128)),  # decode-like
]
# float32 on both sides: the same products, summed in another order
TOL = dict(atol=1e-4, rtol=1e-4)


def _inputs(m, k, n, sizes, seed=0):
    rng = np.random.default_rng(seed)
    lhs = rng.standard_normal((m, k)).astype(np.float32)
    rhs = rng.standard_normal((len(sizes), k, n)).astype(np.float32)
    dout = rng.standard_normal((m, n)).astype(np.float32)
    return lhs, rhs, dout, np.asarray(sizes, np.int32)


@pytest.mark.parametrize("m,k,n,sizes,blocks", CASES)
def test_plain_forward_matches_the_pallas_kernel(m, k, n, sizes, blocks):
    lhs, rhs, _, gs = _inputs(m, k, n, sizes)
    ref = jgmm_mod._gmm_call(jnp.asarray(lhs), jnp.asarray(rhs),
                             jnp.asarray(gs), *blocks, True)
    got = tgmm.grouped_matmul_reference(torch.from_numpy(lhs),
                                        torch.from_numpy(rhs),
                                        torch.from_numpy(gs))
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("m,k,n,sizes,blocks", CASES)
def test_plain_drhs_matches_the_pallas_kernel(m, k, n, sizes, blocks):
    lhs, _, dout, gs = _inputs(m, k, n, sizes)
    ref = jgmm_mod._gmm_drhs_call(
        jnp.asarray(lhs), jnp.asarray(dout), jnp.asarray(gs), len(sizes),
        *blocks, True, jnp.float32)
    got = tgmm.gmm_drhs_reference(torch.from_numpy(lhs),
                                  torch.from_numpy(dout),
                                  torch.from_numpy(gs), len(sizes),
                                  torch.float32)
    assert got.shape == (len(sizes), k, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    for e, size in enumerate(sizes):
        if size == 0:
            assert not got[e].any(), f"empty group {e} is not zero"


def test_plain_drhs_casts_to_out_dtype():
    lhs, _, dout, gs = _inputs(64, 128, 128, [40, 24])
    got = tgmm.gmm_drhs_reference(torch.from_numpy(lhs).bfloat16(),
                                  torch.from_numpy(dout).bfloat16(),
                                  torch.from_numpy(gs), 2, torch.bfloat16)
    assert got.dtype == torch.bfloat16


@pytest.mark.parametrize("sizes", [[32, 32, 32, 32], [0, 60, 0, 68],
                                   [1, 2, 3, 122]])
def test_cpu_lane_gradients_match_jax_grad_of_the_kernel(sizes):
    """dlhs and drhs of the port's CPU lane (autograd through the plain
    version) against jax.grad of the interpret-mode kernel (its custom
    VJP: the forward kernel on rhsᵀ and the drhs kernel)."""
    lhs, rhs, cot, gs = _inputs(128, 128, 256, sizes, seed=1)

    def f(lh, rh):
        out = jgmm_mod.grouped_matmul(lh, rh, jnp.asarray(gs), block_m=32,
                                      block_n=128, interpret=True)
        return jnp.sum(out * jnp.asarray(cot))

    gl, gr = jax.grad(f, argnums=(0, 1))(jnp.asarray(lhs), jnp.asarray(rhs))
    tl = torch.from_numpy(lhs).requires_grad_(True)
    tr = torch.from_numpy(rhs).requires_grad_(True)
    out = tgmm.grouped_matmul(tl, tr, torch.from_numpy(gs))
    dl, dr = torch.autograd.grad(out, (tl, tr), torch.from_numpy(cot))
    np.testing.assert_allclose(dl.numpy(), np.asarray(gl), **TOL)
    np.testing.assert_allclose(dr.numpy(), np.asarray(gr), **TOL)


def test_rows_past_the_sum_are_zero():
    lhs, rhs, _, gs = _inputs(64, 128, 128, [30, 10])
    out = tgmm.grouped_matmul(torch.from_numpy(lhs), torch.from_numpy(rhs),
                              torch.from_numpy(gs))
    assert not out[40:].any()


# (lhs shape, rhs shape, n_groups): each refused by the kernel lane's
# checks in the reference's order, before any device is looked at
REFUSALS = [
    ((128, 128), (4, 128, 128), 5),      # shape mismatch (group_sizes)
    ((128, 128), (4, 256, 128), 4),      # shape mismatch (K)
    ((200, 128), (4, 128, 128), 4),      # M not divisible by block_m
    ((128, 128), (4, 128, 200), 4),      # N not divisible by block_n
    ((128, 64), (4, 64, 128), 4),        # K not a multiple of 128
    ((128, 128), (4, 128, 192), 4),      # N not a multiple of 128
]


@pytest.mark.parametrize("lhs_shape,rhs_shape,groups", REFUSALS)
def test_dispatcher_refuses_as_the_reference(lhs_shape, rhs_shape, groups):
    """use_kernel=True on CPU tensors: the same ValueError, word for word,
    as the reference's kernel lane (interpret mode)."""
    gs = np.zeros(groups, np.int32)
    gs[0] = lhs_shape[0]
    with pytest.raises(ValueError) as ref:
        jgmm_mod.grouped_matmul(jnp.zeros(lhs_shape), jnp.zeros(rhs_shape),
                                jnp.asarray(gs), interpret=True)
    with pytest.raises(ValueError) as got:
        tgmm.grouped_matmul(torch.zeros(lhs_shape), torch.zeros(rhs_shape),
                            torch.from_numpy(gs), use_kernel=True)
    assert str(got.value) == str(ref.value)


def test_shape_mismatch_refused_on_the_plain_lane_too():
    with pytest.raises(ValueError, match="shape mismatch"):
        tgmm.grouped_matmul(torch.zeros(128, 128), torch.zeros(4, 128, 128),
                            torch.zeros(5, dtype=torch.int32),
                            use_kernel=False)


def test_kernel_lane_on_cpu_tensors_raises_without_launching():
    """Shapes the kernel takes, on the CPU: the wrapper refuses (there is
    no fallback to the plain version) and counts nothing."""
    lhs, rhs, dout, gs = (torch.from_numpy(a) for a in
                          _inputs(128, 128, 128, [64, 64]))
    before = (tgmm.gmm_cuda.launches, tgmm.gmm_drhs_cuda.launches)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tgmm.grouped_matmul(lhs, rhs, gs, use_kernel=True)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tgmm.gmm_drhs_cuda(lhs, dout, gs)
    assert (tgmm.gmm_cuda.launches, tgmm.gmm_drhs_cuda.launches) == before


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "tc"),
                                         (torch.float32, "simt")])
def test_forward_route_follows_dtype(dtype, route):
    """bf16 goes to the tensor-core kernel; f32 (no TF32) stays on the
    CUDA-core kernel."""
    assert tgmm._route(dtype) == route


@pytest.mark.parametrize("dtype,route,match", [
    (torch.bfloat16, None, "needs CUDA tensors"),
    (torch.bfloat16, "tc", "needs CUDA tensors"),
    (torch.bfloat16, "simt", "needs CUDA tensors"),
    (torch.float32, "tc", "route"), (torch.float32, "wgmma", "route"),
])
def test_forward_wrapper_refuses_before_any_launch(dtype, route, match):
    lhs, rhs, _, gs = (torch.from_numpy(a) for a in
                       _inputs(128, 128, 128, [64, 64]))
    lhs, rhs = lhs.to(dtype), rhs.to(dtype)
    before = (tgmm.gmm_cuda.launches, dict(tgmm.gmm_cuda.route_launches))
    with pytest.raises(ValueError, match=match):
        tgmm.gmm_cuda(lhs, rhs, gs, route=route)
    with pytest.raises(ValueError, match=match):
        tgmm.gmm_cuda(lhs, rhs, gs, trans_rhs=True, route=route)
    assert (tgmm.gmm_cuda.launches, tgmm.gmm_cuda.route_launches) == before


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "tc"),
                                         (torch.float32, "simt")])
def test_drhs_route_follows_dtype(dtype, route):
    """The weight gradient takes the forward's rule: bf16 on the tensor
    cores, f32 on the CUDA-core kernel."""
    assert tgmm._route(dtype) == route
    assert tgmm.DRHS_ENTRY[route] in ("gmm_drhs_tc", "gmm_drhs")


@pytest.mark.parametrize("dtype,route,match", [
    (torch.bfloat16, None, "needs CUDA tensors"),
    (torch.bfloat16, "tc", "needs CUDA tensors"),
    (torch.bfloat16, "simt", "needs CUDA tensors"),
    (torch.float32, None, "needs CUDA tensors"),
    (torch.float32, "tc", "route"), (torch.bfloat16, "wgmma", "route"),
])
def test_drhs_wrapper_refuses_before_any_build(monkeypatch, dtype, route,
                                               match):
    """CPU tensors on every route, and a route that does not take the
    dtype, raise before a library is built or a launch counted."""
    from tpu_kubernetes_torch.ops import _build

    def refuse(*args, **kwargs):
        raise AssertionError(f"a library was loaded: {args}")

    monkeypatch.setattr(_build, "load", refuse)
    lhs, _, dout, gs = (torch.from_numpy(a) for a in
                        _inputs(128, 128, 128, [64, 64]))
    lhs, dout = lhs.to(dtype), dout.to(dtype)
    before = (tgmm.gmm_drhs_cuda.launches,
              dict(tgmm.gmm_drhs_cuda.route_launches))
    with pytest.raises(ValueError, match=match):
        tgmm.gmm_drhs_cuda(lhs, dout, gs, route=route)
    assert (tgmm.gmm_drhs_cuda.launches,
            tgmm.gmm_drhs_cuda.route_launches) == before


@pytest.mark.parametrize("route,fwd_ints", [("simt", 6), ("tc", 5)])
def test_load_kernels_binds_pointers_as_void_pointers(monkeypatch, route,
                                                      fwd_ints):
    """Both entry points of ``route`` are bound with c_void_p for every
    pointer and the stream, without building: the forward (4 pointers) and
    the weight gradient (4 pointers, one int fewer: no trans_rhs)."""
    import ctypes

    from tpu_kubernetes_torch.ops import _build

    seen = {}
    monkeypatch.setattr(_build, "load", lambda symbol, argtypes, library=None:
                        seen.setdefault(symbol, (argtypes, library)))
    tgmm.load_kernels(route)
    ptrs = [ctypes.c_void_p] * 4
    assert seen == {
        tgmm.GMM_ENTRY[route]: (ptrs + [ctypes.c_int] * fwd_ints
                                + [ctypes.c_void_p], "grouped_matmul"),
        tgmm.DRHS_ENTRY[route]: (ptrs + [ctypes.c_int] * (fwd_ints - 1)
                                 + [ctypes.c_void_p], "grouped_matmul")}


def test_ops_exports_the_dispatcher_and_its_plain_version():
    from tpu_kubernetes_torch import ops

    assert ops.grouped_matmul is tgmm.grouped_matmul
    assert ops.grouped_matmul_reference is tgmm.grouped_matmul_reference
