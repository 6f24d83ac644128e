"""The port's CUDA flash-attention forward on the card, against its plain
version. These tests need a CUDA card and ``nvcc`` (the kernel has no CPU
mode) and skip without one. They import no JAX, so they run on a machine
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
