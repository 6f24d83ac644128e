"""The port's CUDA kernels on the card (the flash-attention forward and
its two backward kernels, the grouped matmul and its weight gradient),
against their plain versions. These tests need
a CUDA card and ``nvcc`` (the kernels have no CPU mode) and skip without
one. They import no JAX, so they run on a machine
that has only PyTorch:

    python -m pytest --noconftest -m gpu tests/test_torch_kernel_cuda.py
"""

import importlib
import math

import pytest
import torch

tfa = importlib.import_module("tpu_kubernetes_torch.ops.flash_attention")

pytestmark = pytest.mark.gpu


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _qkv(device, shape, dtype, seed=0):
    b, h, sq, sk, d = shape
    g = torch.Generator(device=device).manual_seed(seed)
    return tuple(torch.randn((b, h, n, d), generator=g, device=device)
                 .to(dtype) for n in (sq, sk, sk))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("shape,causal", [
    ((2, 4, 64, 64, 16), True), ((1, 4, 256, 512, 128), True),
    ((2, 2, 200, 200, 64), True), ((1, 2, 96, 160, 32), False),
    # the HTTP path at llama-test: one row bucketed to 16 or 32 tokens, a
    # q tile that is mostly padding; then the same with an offset
    ((1, 4, 16, 16, 16), True), ((1, 4, 32, 32, 16), True),
    ((1, 4, 16, 48, 16), True),
])
def test_kernel_matches_plain(cuda_device, shape, causal, dtype, tol):
    """O and LSE against the plain version. bf16 differs by more than
    summation order: the plain version rounds P to bf16 before P·V, the
    kernel keeps it in f32, so O may land a bf16 ulp apart."""
    b, h, sq, sk, d = shape
    q, k, v = _qkv(cuda_device, shape, dtype)
    scale = 1.0 / math.sqrt(d)
    o, lse = tfa.flash_fwd_cuda(q, k, v, causal, scale)
    torch.cuda.synchronize()
    assert o.dtype == dtype and lse.shape == (b, h, sq)
    ref = tfa.attention_reference(q, k, v, causal=causal, sm_scale=scale)
    torch.testing.assert_close(o.float(), ref.float(), atol=tol, rtol=tol)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        keep = torch.ones(sq, sk, dtype=torch.bool, device=cuda_device)
        s = s.masked_fill(~keep.tril(sk - sq), tfa.NEG_INF)
    torch.testing.assert_close(lse, torch.logsumexp(s, dim=-1),
                               atol=1e-4, rtol=1e-4)


def test_dispatcher_launches_the_kernel_on_cuda(cuda_device):
    q, k, v = _qkv(cuda_device, (1, 2, 128, 128, 64), torch.float32)
    before = tfa.flash_fwd_cuda.launches
    out = tfa.flash_attention(q, k, v, block_q=512, block_k=512)
    assert tfa.flash_fwd_cuda.launches == before + 1
    ref = tfa.flash_attention(q, k, v, use_kernel=False)
    assert tfa.flash_fwd_cuda.launches == before + 1
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("bad", ["head_dim", "dtype", "strides"])
def test_wrapper_refuses_what_the_kernel_cannot_take(cuda_device, bad):
    q, k, v = _qkv(cuda_device, (1, 2, 64, 64, 64), torch.float32)
    if bad == "head_dim":
        q, k, v = _qkv(cuda_device, (1, 2, 64, 64, 48), torch.float32)
    elif bad == "dtype":
        q, k, v = (t.half() for t in (q, k, v))
    else:
        q = q.transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises((ValueError, TypeError)):
        tfa.flash_fwd_cuda(q, k, v, True, 0.125)


# -- the backward kernels ----------------------------------------------------------

def _bwd_inputs(device, shape, dtype, causal, seed=1):
    """q, k, v, dO, and the forward kernel's O and LSE."""
    b, h, sq, sk, d = shape
    q, k, v = _qkv(device, shape, dtype, seed)
    g = torch.Generator(device=device).manual_seed(seed + 100)
    do = torch.randn((b, h, sq, d), generator=g, device=device).to(dtype)
    o, lse = tfa.flash_fwd_cuda(q, k, v, causal, 1.0 / math.sqrt(d))
    return q, k, v, do, o, lse


# |kernel − plain| ≤ tol·(1 + |plain|). f32: summation order only. bf16:
# both sides read the same bf16 inputs and compute in f32; dq, dk, dv are
# rounded to bf16 at the end on both sides, so they may land one bf16 ulp
# apart (2^-8 relative), plus the summation-order difference before it.
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape,causal", [
    ((2, 4, 64, 64, 16), True), ((1, 4, 256, 512, 128), True),
    ((2, 2, 200, 200, 64), True), ((1, 2, 96, 160, 32), False),
    ((1, 4, 200, 328, 32), True), ((1, 4, 16, 48, 16), True),
])
def test_backward_kernels_match_plain(cuda_device, shape, causal, dtype, tol):
    d = shape[-1]
    scale = 1.0 / math.sqrt(d)
    q, k, v, do, o, lse = _bwd_inputs(cuda_device, shape, dtype, causal)
    got = tfa.flash_bwd_cuda(q, k, v, o, lse, do, causal, scale)
    torch.cuda.synchronize()
    ref = tfa.attention_bwd_reference(q, k, v, o, lse, do, causal, scale)
    for g, r, name in zip(got, ref, ("dq", "dk", "dv")):
        assert g.dtype == dtype and g.shape == r.shape, name
        torch.testing.assert_close(g.float(), r.float(), atol=tol, rtol=tol,
                                   msg=name)


def test_cuda_output_carries_a_gradient_through_the_kernels(cuda_device):
    """The kernel lane under autograd: the output has a grad_fn and one
    backward launches each backward kernel once, with gradients equal to
    the plain lane's."""
    q, k, v = (t.requires_grad_(True) for t in
               _qkv(cuda_device, (1, 2, 128, 128, 64), torch.float32, 3))
    counts = lambda: (tfa.flash_fwd_cuda.launches,               # noqa: E731
                      tfa.flash_bwd_dq_cuda.launches,
                      tfa.flash_bwd_dkv_cuda.launches)
    before = counts()
    out = tfa.flash_attention(q, k, v)
    assert out.grad_fn is not None
    # the gradient arrives as a strided view, as through the model's
    # attn.transpose(1, 2)
    do = torch.randn(1, 128, 2, 64, device=cuda_device).transpose(1, 2)
    grads = torch.autograd.grad(out, (q, k, v), do)
    assert counts() == (before[0] + 1, before[1] + 1, before[2] + 1)
    ref = torch.autograd.grad(tfa.flash_attention(q, k, v, use_kernel=False),
                              (q, k, v), do)
    assert counts() == (before[0] + 1, before[1] + 1, before[2] + 1)
    for g, r in zip(grads, ref):
        torch.testing.assert_close(g, r, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("bad", ["head_dim", "dtype", "device", "lse"])
def test_backward_wrappers_refuse_without_launching(cuda_device, bad):
    shape = (1, 2, 64, 64, 48 if bad == "head_dim" else 64)
    q, k, v = _qkv(cuda_device, shape, torch.float32)
    lse = torch.zeros(q.shape[:3], device=cuda_device)
    do = q
    if bad == "dtype":
        q, k, v, do = (t.half() for t in (q, k, v, do))
    elif bad == "device":
        do = do.cpu()
    elif bad == "lse":
        lse = lse.double()
    before = (tfa.flash_bwd_dq_cuda.launches, tfa.flash_bwd_dkv_cuda.launches)
    with pytest.raises((ValueError, TypeError)):
        tfa.flash_bwd_dq_cuda(q, k, v, do, lse, lse, True, 0.125)
    with pytest.raises((ValueError, TypeError)):
        tfa.flash_bwd_dkv_cuda(q, k, v, do, lse, lse, True, 0.125)
    assert (tfa.flash_bwd_dq_cuda.launches,
            tfa.flash_bwd_dkv_cuda.launches) == before


# -- the grouped-matmul kernels ------------------------------------------------

tgmm = importlib.import_module("tpu_kubernetes_torch.ops.grouped_matmul")

# the reference test's size patterns (tests/test_grouped_matmul.py), M = 256
SIZE_PATTERNS = [
    [64, 64, 64, 64],          # balanced, block-aligned
    [0, 100, 0, 156],          # empty groups
    [256, 0, 0, 0],            # one group takes everything
    [1, 2, 3, 250],            # tiny groups inside one block
    [37, 99, 13, 107],         # boundaries split blocks arbitrarily
]
# |kernel − plain| ≤ tol·(1 + |plain|). f32: both sides sum the same f32
# products in another order, an error that grows like √K (1e-4 at K = 128;
# measured 1e-4 absolute at K = 3584 against outputs near 0). bf16: the
# same, then both round to bf16, so the two may land one bf16 ulp apart
# (2^-8 relative).
def _gmm_tol(dtype, k):
    return 1e-4 * math.sqrt(k / 128) if dtype == torch.float32 else 1e-2


def _gmm_inputs(device, m, k, n, sizes, dtype, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    lhs = torch.randn((m, k), generator=g, device=device).to(dtype)
    rhs = torch.randn((len(sizes), k, n), generator=g, device=device).to(dtype)
    dout = torch.randn((m, n), generator=g, device=device).to(dtype)
    gs = torch.tensor(sizes, dtype=torch.int32, device=device)
    return lhs, rhs, dout, gs


def _close(got, ref, dtype, k, msg=""):
    tol = _gmm_tol(dtype, k)
    torch.testing.assert_close(got.float(), ref.float(), atol=tol, rtol=tol,
                               msg=msg)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n,sizes", [
    *((256, 128, 256, s) for s in SIZE_PATTERNS),
    (128, 512, 256, [50, 14, 0, 64]),           # K over several slices
    (256, 128, 128, [40, 0, 77, 100, 39]),      # E = 5
    (128, 1024, 3584, [1, 2, 0, 1, 1, 1, 1, 121]),   # decode: 8 rows + 120 pad
    (200, 128, 128, [30, 10]),                  # rows past the sum are zero
])
def test_grouped_kernels_match_plain(cuda_device, m, k, n, sizes, dtype):
    lhs, rhs, dout, gs = _gmm_inputs(cuda_device, m, k, n, sizes, dtype)
    out = tgmm.gmm_cuda(lhs, rhs, gs)
    dlhs = tgmm.gmm_cuda(dout, rhs, gs, trans_rhs=True)
    drhs = tgmm.gmm_drhs_cuda(lhs, dout, gs)
    torch.cuda.synchronize()
    assert out.dtype == dlhs.dtype == drhs.dtype == dtype
    _close(out, tgmm.grouped_matmul_reference(lhs, rhs, gs), dtype, k, "out")
    _close(dlhs, tgmm.grouped_matmul_reference(
        dout, rhs.transpose(1, 2).contiguous(), gs), dtype, n, "dlhs")
    ref = tgmm.gmm_drhs_reference(lhs, dout, gs, len(sizes), dtype)
    _close(drhs, ref, dtype, m, "drhs")
    for e, size in enumerate(sizes):
        if size == 0:
            assert not drhs[e].any(), f"empty group {e} is not zero"


def test_grouped_matmul_autograd_launches_each_kernel_once(cuda_device):
    """The kernel lane under autograd: one forward launch, then one dlhs
    launch (the forward kernel) and one drhs launch; gradients equal to
    the plain lane's."""
    lhs, rhs, dout, gs = _gmm_inputs(cuda_device, 256, 256, 128,
                                     [37, 99, 13, 107], torch.float32, 3)
    lhs.requires_grad_(True)
    rhs.requires_grad_(True)
    counts = lambda: (tgmm.gmm_cuda.launches,                    # noqa: E731
                      tgmm.gmm_drhs_cuda.launches)
    before = counts()
    out = tgmm.grouped_matmul(lhs, rhs, gs, block_m=64, block_n=128)
    assert out.grad_fn is not None
    assert counts() == (before[0] + 1, before[1])
    grads = torch.autograd.grad(out, (lhs, rhs), dout)
    assert counts() == (before[0] + 2, before[1] + 1)
    ref_out = tgmm.grouped_matmul(lhs, rhs, gs, use_kernel=False)
    ref = torch.autograd.grad(ref_out, (lhs, rhs), dout)
    assert counts() == (before[0] + 2, before[1] + 1)
    torch.testing.assert_close(out, ref_out, atol=1e-4, rtol=1e-4)
    for g, r in zip(grads, ref):
        torch.testing.assert_close(g, r, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("bad", ["device", "dtype", "k", "sizes_dtype",
                                 "strides"])
def test_grouped_wrappers_refuse_without_launching(cuda_device, bad):
    k = 96 if bad == "k" else 128
    lhs, rhs, dout, gs = _gmm_inputs(cuda_device, 128, k, 128, [64, 64],
                                     torch.float32)
    if bad == "device":
        rhs, dout = rhs.cpu(), dout.cpu()
    elif bad == "dtype":
        rhs, dout = rhs.bfloat16(), dout.bfloat16()
    elif bad == "sizes_dtype":
        gs = gs.long()
    elif bad == "strides":
        lhs = lhs.t().contiguous().t()
    before = (tgmm.gmm_cuda.launches, tgmm.gmm_drhs_cuda.launches)
    with pytest.raises((ValueError, TypeError)):
        tgmm.gmm_cuda(lhs, rhs, gs)
    with pytest.raises((ValueError, TypeError)):
        tgmm.gmm_drhs_cuda(lhs, dout, gs)
    assert (tgmm.gmm_cuda.launches, tgmm.gmm_drhs_cuda.launches) == before
