"""The port's CUDA kernels on the card (the flash-attention forward and
its dQ and dK/dV kernels; the grouped matmul and its weight gradient;
each on both of its routes; the fused AdamW update; decode attention,
dense and paged, one position or a verify window a row), against their
plain versions, the speculative paths' graphed rounds against the plain
engine and generate, the optimizer
update's and the engines' replays' freedom from device syncs, and the
sampled programs' draws and the eval graph against their eager bodies,
and the serving operations layer (fault sites before a capture, the
watchdog's restart over the same graphs, a segment and a verify round
with the layer on and no sync, the engine segment's roofline).
These tests need
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
    # the tensor-core route's edges (bf16 at d 64/128): seq not a multiple
    # of its 128-row tiles, seq_q < seq_k, non-causal, and more kv tiles
    # than its ring has stages
    ((1, 2, 200, 200, 128), True), ((1, 2, 100, 300, 64), True),
    ((1, 2, 130, 250, 128), False), ((2, 2, 96, 160, 64), False),
    ((1, 2, 1024, 1024, 64), True), ((1, 2, 640, 1000, 128), True),
])
def test_kernel_matches_plain(cuda_device, shape, causal, dtype, tol):
    """O and LSE against the plain version, through the route that
    ``_route`` picks. bf16 differs by more than summation order: the
    plain version rounds the normalised P to bf16 before P·V; the CUDA-core
    kernel keeps P in f32, the tensor-core kernel rounds the unnormalised P
    to bf16, so O may land a bf16 ulp apart."""
    b, h, sq, sk, d = shape
    q, k, v = _qkv(cuda_device, shape, dtype)
    scale = 1.0 / math.sqrt(d)
    route = tfa._route(dtype, d)
    before = dict(tfa.flash_fwd_cuda.route_launches)
    o, lse = tfa.flash_fwd_cuda(q, k, v, causal, scale)
    torch.cuda.synchronize()
    assert tfa.flash_fwd_cuda.route_launches == {
        r: n + (r == route) for r, n in before.items()}
    assert o.dtype == dtype and lse.shape == (b, h, sq)
    ref = tfa.attention_reference(q, k, v, causal=causal, sm_scale=scale)
    torch.testing.assert_close(o.float(), ref.float(), atol=tol, rtol=tol)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        keep = torch.ones(sq, sk, dtype=torch.bool, device=cuda_device)
        s = s.masked_fill(~keep.tril(sk - sq), tfa.NEG_INF)
    torch.testing.assert_close(lse, torch.logsumexp(s, dim=-1),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("shape,causal", [
    ((1, 4, 2048, 2048, 128), True), ((2, 4, 1024, 1024, 64), True),
    ((1, 2, 640, 1000, 128), True), ((1, 2, 130, 250, 128), False),
])
def test_tensor_core_forward_within_its_roundings(cuda_device, shape, causal):
    """flash_fwd_tc against the same attention in f32 on the same bf16
    inputs, over many kv tiles through its ring, four launches. A bf16
    rounding moves a value by at most 2^-8 of it, so rounding each
    unnormalised P moves O by at most 2^-8 of the P-weighted mean of |V|
    (attention over |V|), and the final rounding by 2^-8 of |O|; the bound
    is their sum, tight enough to catch one V tile read from the wrong
    rows (about 16 / n of |V| for a row of n keys)."""
    q, k, v = _qkv(cuda_device, shape, torch.bfloat16, seed=9)
    scale = 1.0 / math.sqrt(shape[-1])
    qf, kf, vf = q.float(), k.float(), v.float()
    ref = tfa.attention_reference(qf, kf, vf, causal=causal, sm_scale=scale)
    mean_abs_v = tfa.attention_reference(qf, kf, vf.abs(), causal=causal,
                                         sm_scale=scale)
    bound = 2.0 ** -8 * (ref.abs() + mean_abs_v) + 1e-6
    before = tfa.flash_fwd_cuda.route_launches["tc"]
    for i in range(4):
        o, _ = tfa.flash_fwd_cuda(q, k, v, causal, scale)
        torch.cuda.synchronize()
        excess = ((o.float() - ref).abs() / bound).max().item()
        assert excess <= 1, f"launch {i}: {excess:.3f} of the bound"
    assert tfa.flash_fwd_cuda.route_launches["tc"] == before + 4


@pytest.mark.parametrize("shape,causal", [((1, 4, 256, 512, 128), True),
                                          ((2, 2, 200, 200, 64), False)])
def test_cuda_core_route_still_takes_bf16(cuda_device, shape, causal):
    """The CUDA-core kernel, forced onto bf16 at d 64/128 (chip_smoke.py
    times it there beside the tensor-core kernel), against the plain
    version and the tensor-core route."""
    q, k, v = _qkv(cuda_device, shape, torch.bfloat16, seed=5)
    scale = 1.0 / math.sqrt(shape[-1])
    before = dict(tfa.flash_fwd_cuda.route_launches)
    o_simt, lse_simt = tfa.flash_fwd_cuda(q, k, v, causal, scale, route="simt")
    o_tc, lse_tc = tfa.flash_fwd_cuda(q, k, v, causal, scale)
    torch.cuda.synchronize()
    assert tfa.flash_fwd_cuda.route_launches == {
        "tc": before["tc"] + 1, "simt": before["simt"] + 1}
    ref = tfa.attention_reference(q, k, v, causal=causal, sm_scale=scale)
    for o in (o_simt, o_tc):
        torch.testing.assert_close(o.float(), ref.float(), atol=3e-2, rtol=3e-2)
    torch.testing.assert_close(lse_tc, lse_simt, atol=1e-4, rtol=1e-4)


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
    # the tensor-core route's edges: M not a multiple of its 128-row tiles
    # with rows past the sum, an empty last group, one group after empty
    # ones, and more k-slices over the items than its ring has stages
    (300, 256, 256, [100, 0, 150, 20]),
    (200, 128, 128, [60, 70, 0]),
    (384, 1024, 384, [0, 0, 384]),
    (640, 384, 256, [90, 0, 170, 33, 1, 200, 100, 46]),
])
def test_grouped_kernels_match_plain(cuda_device, m, k, n, sizes, dtype):
    lhs, rhs, dout, gs = _gmm_inputs(cuda_device, m, k, n, sizes, dtype)
    route = tgmm._route(dtype)
    before = dict(tgmm.gmm_cuda.route_launches)
    out = tgmm.gmm_cuda(lhs, rhs, gs)
    dlhs = tgmm.gmm_cuda(dout, rhs, gs, trans_rhs=True)
    drhs = tgmm.gmm_drhs_cuda(lhs, dout, gs)
    torch.cuda.synchronize()
    assert tgmm.gmm_cuda.route_launches == {
        r: c + 2 * (r == route) for r, c in before.items()}
    assert out.dtype == dlhs.dtype == drhs.dtype == dtype
    _close(out, tgmm.grouped_matmul_reference(lhs, rhs, gs), dtype, k, "out")
    _close(dlhs, tgmm.grouped_matmul_reference(
        dout, rhs.transpose(1, 2).contiguous(), gs), dtype, n, "dlhs")
    ref = tgmm.gmm_drhs_reference(lhs, dout, gs, len(sizes), dtype)
    _close(drhs, ref, dtype, m, "drhs")
    for e, size in enumerate(sizes):
        if size == 0:
            assert not drhs[e].any(), f"empty group {e} is not zero"


@pytest.mark.parametrize("trans_rhs", [False, True])
@pytest.mark.parametrize("m,k,n,sizes", [
    # every SM busy: 296 items of 32 k-slices over 132 SMs, about 14 laps
    (4096, 2048, 1024, [700, 300, 0, 548, 1000, 12, 900, 636]),
    # 6 CTAs of 128 k-slices (25 laps) on operands that stay in L2 from
    # one launch to the next: the loads outrun the wgmma, so the producer
    # refills a stage as soon as it is released
    (256, 8192, 256, [100, 156]),
])
def test_tensor_core_ring_laps_within_one_rounding(cuda_device, m, k, n,
                                                   sizes, trans_rhs):
    """gmm_forward_tc where each CTA laps its 5-stage ring many times,
    eight launches, each against the same product in f32 on the same bf16
    inputs: within 2^-8 of |f32| (the most its one bf16 rounding moves a
    value) plus 1e-4·K/128 for the tensor cores' f32 accumulation, which
    drifts from a rounded f32 sum by more than _gmm_tol's √K allows as K
    grows (on an H100, an error 1.38 times the bound built on it at
    K = 8192). A k-slice read from a refilled stage moves an output by
    several units, dozens of bf16 ulps."""
    lhs, rhs, dout, gs = _gmm_inputs(cuda_device, m, k, n, sizes,
                                     torch.bfloat16, 6)
    a = dout if trans_rhs else lhs
    b = rhs.transpose(1, 2).contiguous() if trans_rhs else rhs
    ref = tgmm.grouped_matmul_reference(a.float(), b.float(), gs)
    bound = 2.0 ** -8 * ref.abs() + 1e-4 * b.shape[1] / 128
    before = tgmm.gmm_cuda.route_launches["tc"]
    for i in range(8):
        out = tgmm.gmm_cuda(a, rhs, gs, trans_rhs=trans_rhs)
        torch.cuda.synchronize()
        excess = ((out.float() - ref).abs() / bound).max().item()
        assert excess <= 1, f"launch {i}: {excess:.3f} of the bound"
    assert tgmm.gmm_cuda.route_launches["tc"] == before + 8


@pytest.mark.parametrize("trans_rhs", [False, True])
def test_grouped_cuda_core_route_still_takes_bf16(cuda_device, trans_rhs):
    """The CUDA-core forward, forced onto bf16 (chip_smoke.py times it
    there beside the tensor-core kernel), against the plain version and
    the tensor-core route."""
    lhs, rhs, dout, gs = _gmm_inputs(cuda_device, 256, 256, 384,
                                     [37, 99, 13, 100], torch.bfloat16, 4)
    a = dout if trans_rhs else lhs
    before = dict(tgmm.gmm_cuda.route_launches)
    simt = tgmm.gmm_cuda(a, rhs, gs, trans_rhs=trans_rhs, route="simt")
    tc = tgmm.gmm_cuda(a, rhs, gs, trans_rhs=trans_rhs)
    torch.cuda.synchronize()
    assert tgmm.gmm_cuda.route_launches == {
        "tc": before["tc"] + 1, "simt": before["simt"] + 1}
    b = rhs.transpose(1, 2).contiguous() if trans_rhs else rhs
    ref = tgmm.grouped_matmul_reference(a, b, gs)
    depth = b.shape[1]
    _close(simt, ref, torch.bfloat16, depth, "simt")
    _close(tc, ref, torch.bfloat16, depth, "tc")


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


# -- the tensor-core backward kernels ---------------------------------------------

# All three are held to the f32 result of the same bf16 inputs. A bf16
# rounding moves a value by at most 2^-8 of it. flash_bwd_dkv_tc rounds each
# Pᵀ (dSᵀ) to bf16 before dV += Pᵀ·dO (dK += dSᵀ·Q), which moves an output
# by at most 2^-8·Σ|Pᵀ|·|dO| (2^-8·Σ|dSᵀ|·|Q|), and rounds the output once,
# 2^-8 of it; the bound is their sum (1e-6 for values near 0).
# flash_bwd_dq_tc likewise rounds dS before dQ += dS·K: 2^-8·Σ|dS|·|K|,
# plus 2^-8 of the output. Both sides also sum dP = dO·Vᵀ in f32 in
# another order, each within γ_d·Σ_d|dO|·|V| (γ_d = d·2^-24), and dP −
# delta cancels where P sits on one key (row 0 under causal masking, whose
# O is V[0]): there dS is f32 noise no share of |dS| covers, so dQ's bound
# adds 2·γ_d·sm_scale·Σ P·Σ_d|dO|·|V|·|K|.
# gmm_drhs_tc rounds once: 2^-8·|f32|, plus 1e-4 per 128 rows of its
# group for the tensor cores' f32 accumulation (gmm_forward_tc's bound).
TC_REL = 2.0 ** -8


def _dkv_bounds(q, k, v, do, lse, delta, causal, scale):
    """((dk, its bound), (dv, its bound)) in f32 from the same inputs."""
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    p, ds = tfa._probs_and_ds(qf, kf, vf, dof, lse, delta, causal, scale)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    dk_spread = torch.einsum("bhqk,bhqd->bhkd", ds.abs(), qf.abs())
    dv_spread = torch.einsum("bhqk,bhqd->bhkd", p, dof.abs())
    return ((dk, TC_REL * (dk.abs() + dk_spread) + 1e-6),
            (dv, TC_REL * (dv.abs() + dv_spread) + 1e-6))


@pytest.mark.parametrize("shape,causal", [
    ((1, 2, 200, 200, 128), True), ((1, 2, 300, 700, 64), True),
    ((1, 2, 130, 250, 128), False), ((2, 2, 256, 384, 64), False),
    ((2, 2, 64, 64, 64), True), ((1, 4, 1024, 1024, 128), True),
    # K/V tile 0 walks 32 q tiles through the 3-stage ring: about 10 laps
    ((1, 2, 2048, 2048, 64), True),
])
def test_dkv_tensor_core_within_its_roundings(cuda_device, shape, causal):
    """flash_bwd_dkv_tc (the route bf16 at d 64/128 takes) against the f32
    dK, dV of the same bf16 inputs, lse and delta, three launches: seq off
    the 128-row K/V tiles and the 64-row q tiles, seq_q < seq_k,
    non-causal, and a ring that laps many times."""
    d = shape[-1]
    scale = 1.0 / math.sqrt(d)
    q, k, v, do, o, lse = _bwd_inputs(cuda_device, shape, torch.bfloat16,
                                      causal, seed=11)
    delta = (do.float() * o.float()).sum(-1)
    bounds = _dkv_bounds(q, k, v, do, lse, delta, causal, scale)
    assert tfa._route(torch.bfloat16, d) == "tc"
    before = dict(tfa.flash_bwd_dkv_cuda.route_launches)
    for i in range(3):
        got = tfa.flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal, scale)
        torch.cuda.synchronize()
        for name, g, (ref, bound) in zip(("dk", "dv"), got, bounds):
            assert g.dtype == torch.bfloat16 and g.shape == ref.shape
            excess = ((g.float() - ref).abs() / bound).max().item()
            assert excess <= 1, f"launch {i} {name}: {excess:.3f} of the bound"
    assert tfa.flash_bwd_dkv_cuda.route_launches == {
        "tc": before["tc"] + 3, "simt": before["simt"]}


@pytest.mark.parametrize("shape,causal", [((1, 4, 256, 512, 128), True),
                                          ((2, 2, 200, 200, 64), False)])
def test_dkv_cuda_core_route_still_takes_bf16(cuda_device, shape, causal):
    """The CUDA-core dK/dV kernel, forced onto bf16 at d 64/128
    (chip_smoke.py times it there): it keeps P and dS in f32 and is
    bit-equal to the plain version; the tensor-core route stays within
    the plain version's tolerance."""
    d = shape[-1]
    scale = 1.0 / math.sqrt(d)
    q, k, v, do, o, lse = _bwd_inputs(cuda_device, shape, torch.bfloat16,
                                      causal, seed=12)
    delta = (do.float() * o.float()).sum(-1)
    before = dict(tfa.flash_bwd_dkv_cuda.route_launches)
    simt = tfa.flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal, scale,
                                  route="simt")
    tc = tfa.flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal, scale)
    torch.cuda.synchronize()
    assert tfa.flash_bwd_dkv_cuda.route_launches == {
        "tc": before["tc"] + 1, "simt": before["simt"] + 1}
    plain = tfa.attention_bwd_dkv_reference(q, k, v, do, lse, delta, causal,
                                            scale)
    for name, s_, t_, p_ in zip(("dk", "dv"), simt, tc, plain):
        assert torch.equal(s_, p_), name
        torch.testing.assert_close(t_.float(), p_.float(), atol=2e-2,
                                   rtol=2e-2, msg=name)


def _dq_bound(q, k, v, do, lse, delta, causal, scale):
    """(dq, its bound) in f32 from the same inputs."""
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    p, ds = tfa._probs_and_ds(qf, kf, vf, dof, lse, delta, causal, scale)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf)
    spread = torch.einsum("bhqk,bhkd->bhqd", ds.abs(), kf.abs())
    dp_abs = torch.einsum("bhqd,bhkd->bhqk", dof.abs(), vf.abs())
    noise = (2 * q.shape[-1] * 2.0 ** -24 * scale
             * torch.einsum("bhqk,bhkd->bhqd", p * dp_abs, kf.abs()))
    return dq, TC_REL * (dq.abs() + spread) + noise + 1e-6


@pytest.mark.parametrize("shape,causal", [
    ((1, 2, 200, 200, 128), True), ((1, 2, 300, 700, 64), True),
    ((1, 2, 130, 250, 128), False), ((2, 2, 256, 384, 64), False),
    ((2, 2, 64, 64, 64), True), ((1, 4, 1024, 1024, 128), True),
    # offset 64, a multiple of the 64-row K/V tiles: the lower warpgroup of
    # each q tile skips the CTA's last tile; seq_q 160 leaves the upper
    # warpgroup of the last q tile with no row at all
    ((1, 2, 160, 224, 128), True),
    # the last q tile walks 32 K/V tiles through the 3-stage ring
    ((1, 2, 2048, 2048, 64), True),
])
def test_dq_tensor_core_within_its_roundings(cuda_device, shape, causal):
    """flash_bwd_dq_tc (the route bf16 at d 64/128 takes) against the f32
    dQ of the same bf16 inputs, lse and delta, one launch: seq off the
    128-row q tiles and the 64-row K/V tiles, seq_q < seq_k causal (the
    diagonal offset) and not, and a ring that laps many times."""
    d = shape[-1]
    scale = 1.0 / math.sqrt(d)
    q, k, v, do, o, lse = _bwd_inputs(cuda_device, shape, torch.bfloat16,
                                      causal, seed=16)
    delta = (do.float() * o.float()).sum(-1)
    ref, bound = _dq_bound(q, k, v, do, lse, delta, causal, scale)
    assert tfa._route(torch.bfloat16, d) == "tc"
    before = dict(tfa.flash_bwd_dq_cuda.route_launches)
    got = tfa.flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal, scale)
    torch.cuda.synchronize()
    assert tfa.flash_bwd_dq_cuda.route_launches == {
        "tc": before["tc"] + 1, "simt": before["simt"]}
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    excess = ((got.float() - ref).abs() / bound).max().item()
    assert excess <= 1, f"{excess:.3f} of the bound"


@pytest.mark.parametrize("shape,causal", [((1, 4, 256, 512, 128), True),
                                          ((2, 2, 200, 200, 64), False)])
def test_dq_cuda_core_route_still_takes_bf16(cuda_device, shape, causal):
    """The CUDA-core dQ kernel, forced onto bf16 at d 64/128
    (chip_smoke.py times it there): it keeps dS in f32 and is bit-equal to
    the plain version; the tensor-core route stays within the plain
    version's tolerance."""
    d = shape[-1]
    scale = 1.0 / math.sqrt(d)
    q, k, v, do, o, lse = _bwd_inputs(cuda_device, shape, torch.bfloat16,
                                      causal, seed=17)
    delta = (do.float() * o.float()).sum(-1)
    before = dict(tfa.flash_bwd_dq_cuda.route_launches)
    simt = tfa.flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal, scale,
                                 route="simt")
    tc = tfa.flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal, scale)
    torch.cuda.synchronize()
    assert tfa.flash_bwd_dq_cuda.route_launches == {
        "tc": before["tc"] + 1, "simt": before["simt"] + 1}
    plain = tfa.attention_bwd_dq_reference(q, k, v, do, lse, delta, causal,
                                           scale)
    assert torch.equal(simt, plain)
    torch.testing.assert_close(tc.float(), plain.float(), atol=2e-2,
                               rtol=2e-2)


def test_train_step_update_does_not_sync(cuda_device):
    """AdamW.update on CUDA leaves, a bf16 and an f32 one as in a MoE
    model, waits for the device nowhere: under
    ``torch.cuda.set_sync_debug_mode("error")`` any synchronizing call
    raises. Two steps, the first with gradients above grad_clip (clipped),
    the second below; the result equals the same update on the CPU up to
    the f32 summation order of the global norm, which may move a bf16
    value by one ulp (at most 2^-7 of it)."""
    from tpu_kubernetes_torch.train.trainer import AdamW, tree_leaves, tree_map

    opt = AdamW(learning_rate=1e-2, warmup_steps=1, b1=0.9, b2=0.95,
                weight_decay=0.1, grad_clip=1.0)
    g = torch.Generator(device=cuda_device).manual_seed(18)

    def rand(shape, dtype, mult):
        return (torch.randn(shape, generator=g, device=cuda_device)
                * mult).to(dtype)

    params = {"w": rand((64, 128), torch.bfloat16, 1.0),
              "layers": {"w_router": rand((128, 8), torch.float32, 1.0)}}
    big = tree_map(lambda p: rand(p.shape, p.dtype, 1.0), params)
    small = tree_map(lambda p: rand(p.shape, p.dtype, 1e-3), params)
    state = opt.init(params)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        p1, s1 = opt.update(big, state, params)
        p2, s2 = opt.update(small, s1, p1)
    finally:
        torch.cuda.set_sync_debug_mode(0)

    def cpu(tree):
        return tree_map(lambda x: x.cpu(), tree)

    c1, cs1 = opt.update(cpu(big), opt.init(cpu(params)), cpu(params))
    c2, cs2 = opt.update(cpu(small), cs1, c1)
    for got, ref in ((p2, c2), (s2["mu"], cs2["mu"]), (s2["nu"], cs2["nu"])):
        for x, y in zip(tree_leaves(got), tree_leaves(ref)):
            torch.testing.assert_close(x.cpu().float(), y.float(), atol=1e-6,
                                       rtol=2 ** -7)


def _drhs_bound(ref32, sizes):
    """2^-8·|f32| + 1e-4 per 128 rows of each group, (E, 1, 1) broadcast."""
    rows = torch.tensor([max(x, 0) for x in sizes], dtype=torch.float32,
                        device=ref32.device)
    return TC_REL * ref32.abs() + (1e-4 * rows / 128)[:, None, None]


@pytest.mark.parametrize("m,k,n,sizes", [
    # group boundaries off the 64-row slices
    (256, 128, 256, [37, 99, 13, 107]),
    (300, 256, 256, [100, 0, 150, 20]),
    # a 1-row group, empty groups, an empty first and last group
    (256, 128, 256, [0, 1, 0, 200, 55, 0]),
    # rows past sum(group_sizes) belong to no group
    (640, 384, 256, [90, 0, 170, 33, 1, 200, 100, 0]),
    # moe-1b's two orientations (w_gate/w_up, w_down) under a router split
    (4096, 1024, 3584, [700, 300, 0, 548, 1000, 12, 900, 636]),
    (4096, 3584, 1024, [700, 300, 0, 548, 1000, 12, 900, 636]),
    # a group of more than 5 × 64 × 8 rows: 43 slices an item, every CTA
    # laps its 5-stage ring many times
    (3200, 1024, 1024, [2700, 400, 100]),
])
def test_drhs_tensor_core_within_its_roundings(cuda_device, m, k, n, sizes):
    """gmm_drhs_tc (the route bf16 takes) against the f32 weight gradient
    of the same bf16 inputs, four launches; empty groups exactly zero."""
    lhs, _, dout, gs = _gmm_inputs(cuda_device, m, k, n, sizes,
                                   torch.bfloat16, 7)
    ref = tgmm.gmm_drhs_reference(lhs.float(), dout.float(), gs, len(sizes),
                                  torch.float32)
    bound = _drhs_bound(ref, sizes)
    empty = [e for e, x in enumerate(sizes) if x == 0]
    full = [e for e, x in enumerate(sizes) if x > 0]
    assert tgmm._route(torch.bfloat16) == "tc"
    before = dict(tgmm.gmm_drhs_cuda.route_launches)
    for i in range(4):
        got = tgmm.gmm_drhs_cuda(lhs, dout, gs)
        torch.cuda.synchronize()
        assert got.dtype == torch.bfloat16 and got.shape == ref.shape
        for e in empty:
            assert not got[e].any(), f"launch {i}: empty group {e} not zero"
        excess = ((got[full].float() - ref[full]).abs()
                  / bound[full]).max().item()
        assert excess <= 1, f"launch {i}: {excess:.3f} of the bound"
    assert tgmm.gmm_drhs_cuda.route_launches == {
        "tc": before["tc"] + 4, "simt": before["simt"]}


def test_drhs_tensor_core_nonfinite_dout_in_the_next_group(cuda_device):
    """A NaN in dout at row 103, a row of group 1 inside group 0's last
    64-row slice (rows 64..127). Like the plain version (and the Pallas
    kernel), the kernel masks lhs and not dout, so 0·NaN reaches group 0's
    product: groups 0 and 1 are NaN exactly where the plain version is.
    Group 2's slices (rows 160..255) never hold the row; the plain version,
    a masked full product, is NaN in that column for every group, so
    group 2 is compared where the plain version is finite."""
    sizes = [100, 60, 96]
    lhs, _, dout, gs = _gmm_inputs(cuda_device, 256, 128, 128, sizes,
                                   torch.bfloat16, 8)
    dout[103, 5] = float("nan")
    got = tgmm.gmm_drhs_cuda(lhs, dout, gs)
    torch.cuda.synchronize()
    ref = tgmm.gmm_drhs_reference(lhs.float(), dout.float(), gs, 3,
                                  torch.float32)
    for e in (0, 1):
        assert torch.equal(got[e].isnan(), ref[e].isnan()), e
        assert bool(got[e][:, 5].isnan().all()), e
    finite = ~ref.isnan()
    diff = (got.float() - ref).abs()
    assert bool((diff[finite] <= _drhs_bound(ref, sizes)[finite]).all())


def test_drhs_cuda_core_route_still_takes_bf16(cuda_device):
    """The CUDA-core weight gradient, forced onto bf16 (chip_smoke.py times
    it there), against the plain version; both routes zero an empty
    group."""
    sizes = [37, 0, 99, 120]
    lhs, _, dout, gs = _gmm_inputs(cuda_device, 256, 256, 384, sizes,
                                   torch.bfloat16, 9)
    before = dict(tgmm.gmm_drhs_cuda.route_launches)
    simt = tgmm.gmm_drhs_cuda(lhs, dout, gs, route="simt")
    tc = tgmm.gmm_drhs_cuda(lhs, dout, gs)
    torch.cuda.synchronize()
    assert tgmm.gmm_drhs_cuda.route_launches == {
        "tc": before["tc"] + 1, "simt": before["simt"] + 1}
    ref = tgmm.gmm_drhs_reference(lhs, dout, gs, len(sizes), torch.bfloat16)
    _close(simt, ref, torch.bfloat16, 256, "simt")
    _close(tc, ref, torch.bfloat16, 256, "tc")
    assert not simt[1].any() and not tc[1].any()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_autograd_backward_takes_the_route_of_its_dtype(cuda_device, dtype):
    """One backward of each kernel lane launches the dQ, the dK/dV and the
    weight-gradient kernel once each, on the route the dtype picks."""
    route = "tc" if dtype == torch.bfloat16 else "simt"
    q, k, v = (t.requires_grad_(True) for t in
               _qkv(cuda_device, (1, 2, 256, 256, 64), dtype, 13))
    before = (dict(tfa.flash_bwd_dq_cuda.route_launches),
              dict(tfa.flash_bwd_dkv_cuda.route_launches))
    out = tfa.flash_attention(q, k, v)
    torch.autograd.grad(out, (q, k, v), torch.ones_like(out))
    assert tfa.flash_bwd_dq_cuda.route_launches == {
        r: c + (r == route) for r, c in before[0].items()}
    assert tfa.flash_bwd_dkv_cuda.route_launches == {
        r: c + (r == route) for r, c in before[1].items()}

    lhs, rhs, dout, gs = _gmm_inputs(cuda_device, 256, 256, 128,
                                     [37, 99, 13, 107], dtype, 14)
    lhs.requires_grad_(True)
    rhs.requires_grad_(True)
    before = (dict(tgmm.gmm_drhs_cuda.route_launches),
              dict(tgmm.gmm_cuda.route_launches))
    out = tgmm.grouped_matmul(lhs, rhs, gs, block_m=64, block_n=128)
    torch.autograd.grad(out, (lhs, rhs), dout)
    assert tgmm.gmm_drhs_cuda.route_launches == {
        r: c + (r == route) for r, c in before[0].items()}
    assert tgmm.gmm_cuda.route_launches == {
        r: c + 2 * (r == route) for r, c in before[1].items()}


@pytest.mark.parametrize("dtype,d", [(torch.float32, 64),
                                     (torch.bfloat16, 32)])
def test_backward_wrappers_refuse_a_route_that_does_not_take_the_input(
        cuda_device, dtype, d):
    """route="tc" on f32 (the port runs no f32 product on TF32) or on
    head_dim 32 raises before anything is launched."""
    q, k, v = _qkv(cuda_device, (1, 2, 64, 64, d), dtype)
    lse = torch.zeros(q.shape[:3], device=cuda_device)
    lhs, _, dout, gs = _gmm_inputs(cuda_device, 128, 128, 128, [64, 64], dtype)
    before = (dict(tfa.flash_bwd_dq_cuda.route_launches),
              dict(tfa.flash_bwd_dkv_cuda.route_launches),
              dict(tgmm.gmm_drhs_cuda.route_launches))
    with pytest.raises(ValueError, match="route"):
        tfa.flash_bwd_dq_cuda(q, k, v, q, lse, lse, True, 0.125, route="tc")
    with pytest.raises(ValueError, match="route"):
        tfa.flash_bwd_dkv_cuda(q, k, v, q, lse, lse, True, 0.125, route="tc")
    if dtype == torch.float32:
        with pytest.raises(ValueError, match="route"):
            tgmm.gmm_drhs_cuda(lhs, dout, gs, route="tc")
    assert (tfa.flash_bwd_dq_cuda.route_launches,
            tfa.flash_bwd_dkv_cuda.route_launches,
            tgmm.gmm_drhs_cuda.route_launches) == before


# -- the fused AdamW kernel and the compiled programs -------------------------

def _adamw_leaves(device, seed):
    """Leaves as a model's, and the edges of the kernel's walk: a bf16
    leaf over several 16,384-element blocks with a tail of 13, a bf16
    leaf whose tensors start off 16-byte alignment (one element at a
    time), an f32 leaf (MoE's router) and an f32 leaf of 77 elements."""
    g = torch.Generator(device=device).manual_seed(seed)

    def rand(numel, dtype, scale, offset=0):
        x = torch.randn(numel + offset, generator=g, device=device) * scale
        return x.to(dtype)[offset:]

    shapes = [(2 * 16384 + 13, torch.bfloat16, 0), (3000, torch.bfloat16, 1),
              (1024 * 8, torch.float32, 0), (77, torch.float32, 0)]
    grads = [rand(n, dt, 0.3, off) for n, dt, off in shapes]
    params = [rand(n, dt, 1.0, off) for n, dt, off in shapes]
    mus = [rand(n, dt, 0.1, off) for n, dt, off in shapes]
    nus = [rand(n, dt, 0.01, off).abs() for n, dt, off in shapes]
    return grads, params, mus, nus


@pytest.mark.parametrize("grad_clip", [1e3, 1.0])
def test_fused_adamw_equals_plain_bit_for_bit(cuda_device, grad_clip):
    """adamw_sumsq against the plain global norm: the same non-negative
    squares summed in f32 in another order, within 1e-5 relative, and the
    same bits at every launch; adamw_update from that norm against the
    plain update on copies: params, mu and nu equal bit for bit, on every
    leaf, clipped (grad_clip 1.0, the norm is about 60) and not."""
    from tpu_kubernetes_torch.ops import adamw as tadamw
    from tpu_kubernetes_torch.train.trainer import AdamW

    opt = AdamW(learning_rate=1e-2, warmup_steps=2, b1=0.9, b2=0.95,
                weight_decay=0.1, grad_clip=grad_clip)
    grads, params, mus, nus = _adamw_leaves(cuda_device, 21)
    assert params[1].data_ptr() % 16 != 0
    scalars = opt.scalars(torch.full((), 3, dtype=torch.int32,
                                     device=cuda_device))
    before = (tadamw.global_norm_cuda.launches,
              tadamw.adamw_update_cuda_.launches)
    norm = tadamw.global_norm_cuda(grads)
    again = tadamw.global_norm_cuda(grads)
    plain_norm = tadamw.global_norm_reference(grads)
    assert torch.equal(norm, again)
    assert abs(norm.item() - plain_norm.item()) <= 1e-5 * plain_norm.item()
    assert (norm.item() < grad_clip) == (grad_clip > 100)
    copies = [[t.clone() for t in group] for group in (params, mus, nus)]
    tadamw.adamw_update_reference_(grads, *copies, norm, scalars,
                                   opt.hyper())
    tadamw.adamw_update_cuda_(grads, params, mus, nus, norm, scalars,
                              opt.hyper())
    torch.cuda.synchronize()
    assert (tadamw.global_norm_cuda.launches,
            tadamw.adamw_update_cuda_.launches) == (before[0] + 2,
                                                    before[1] + 1)
    for got, want in zip((params, mus, nus), copies):
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def test_fused_adamw_refuses_what_it_cannot_take(cuda_device):
    from tpu_kubernetes_torch.ops import adamw as tadamw

    grads, params, mus, nus = _adamw_leaves(cuda_device, 22)
    before = tadamw.adamw_update_cuda_.launches
    scalars = torch.ones(3, device=cuda_device)
    norm = torch.ones((), device=cuda_device)
    h = tadamw.Hyper(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
                     grad_clip=1.0)
    with pytest.raises(TypeError, match="alike"):
        tadamw.adamw_update_cuda_(grads, [p.float() for p in params], mus,
                                  nus, norm, scalars, h)
    with pytest.raises(ValueError, match="one tensor per leaf"):
        tadamw.adamw_update_cuda_(grads, params[:-1], mus, nus, norm,
                                  scalars, h)
    with pytest.raises(ValueError, match="scalars"):
        tadamw.adamw_update_cuda_(grads, params, mus, nus, norm,
                                  scalars[:2], h)
    with pytest.raises(ValueError, match="CUDA"):
        tadamw.adamw_update_cuda_([g.cpu() for g in grads], params, mus,
                                  nus, norm, scalars, h)
    assert tadamw.adamw_update_cuda_.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_graph_replay_equals_eager(cuda_device, dtype):
    """The greedy lane's CUDA graphs (prefill, segments of 8, a tail of 7)
    against the same bodies run eagerly, three requests of one bucket:
    identical tokens; each key captured once, replayed after; the flash
    forward's launches per prefill replay counted from its capture."""
    from dataclasses import replace

    from tpu_kubernetes_torch.models import CONFIGS, init_params
    from tpu_kubernetes_torch.serve.server import GreedyLane
    from tpu_kubernetes_torch.util import graphs

    cfg = replace(CONFIGS["llama-test"], dtype=dtype)
    params = init_params(cfg, torch.Generator(device=cuda_device)
                         .manual_seed(0), cuda_device)
    rows = torch.randint(0, 256, (3, 16), device=cuda_device,
                         dtype=torch.int32,
                         generator=torch.Generator(device=cuda_device)
                         .manual_seed(1))
    lengths = torch.tensor([16, 9, 4], dtype=torch.int32, device=cuda_device)
    eager = GreedyLane(params, cfg, graphs=False)
    graphed = GreedyLane(params, cfg)
    for _ in range(3):
        want, _ = eager.run(rows, lengths, [24] * 3, 24, 8)
        got, _ = graphed.run(rows, lengths, [24] * 3, 24, 8)
        assert got == want
    keys = {("prefill", 3, 16, 40), ("decode", 3, 16, 40, 8),
            ("decode", 3, 16, 40, 7)}
    assert graphed.programs.captures == {k: 1 for k in keys}
    assert graphed.programs.replays == {("prefill", 3, 16, 40): 2,
                                        ("decode", 3, 16, 40, 8): 5,
                                        ("decode", 3, 16, 40, 7): 2}
    prefill = graphed.programs._programs[("prefill", 3, 16, 40)]
    assert prefill.launches == {"flash_fwd": cfg.n_layers,
                                "flash_fwd.simt": cfg.n_layers}
    assert graphs.REPLAYED.get("flash_fwd", 0) >= 2 * cfg.n_layers


def test_dropped_lanes_free_their_graphs_while_others_capture(cuda_device):
    """Greedy lanes built, run (their graphs captured, then replayed) and
    dropped one after another, with the garbage collector running at
    almost every allocation, captures included: each dropped lane's
    graphs are destroyed at once by reference count, none is left for a
    collection in the middle of the next lane's capture (which would
    invalidate it), and every lane gives the eager lane's tokens."""
    import gc
    import weakref
    from dataclasses import replace

    from tpu_kubernetes_torch.models import CONFIGS, init_params
    from tpu_kubernetes_torch.serve.server import GreedyLane

    cfg = replace(CONFIGS["llama-test"], dtype=torch.bfloat16)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    params = init_params(cfg, gen, cuda_device)
    rows = torch.randint(0, 256, (3, 16), device=cuda_device,
                         dtype=torch.int32, generator=gen)
    lengths = torch.tensor([16, 9, 4], dtype=torch.int32, device=cuda_device)
    want, _ = GreedyLane(params, cfg, graphs=False).run(
        rows, lengths, [24] * 3, 24, 8)
    thresholds = gc.get_threshold()
    gc.collect()
    gc.set_threshold(1)
    try:
        for _ in range(4):
            lane = GreedyLane(params, cfg)
            for _ in range(2):                 # the captures, then replays
                got, _ = lane.run(rows, lengths, [24] * 3, 24, 8)
                assert got == want
            refs = [weakref.ref(p.graph)
                    for p in lane.programs._programs.values()]
            assert len(refs) == 3
            gc.disable()
            try:
                del lane
                assert [r() for r in refs] == [None] * 3
            finally:
                gc.enable()
    finally:
        gc.set_threshold(*thresholds)


def test_the_collector_is_off_while_a_graph_captures(cuda_device):
    """A program's owner left in a reference cycle (a server's state is
    held by its handler class) leaves its graphs to a garbage collection,
    which would invalidate a capture it ran inside: the collector is off
    while the body captures, on again after, and on for the warm-up."""
    import gc

    from tpu_kubernetes_torch.util.graphs import Program

    seen = []
    x = torch.zeros(4, device=cuda_device)

    def body():
        seen.append(gc.isenabled())
        x.add_(1.0)

    program = Program(body, cuda_device)
    program()                        # the warm-up, then the capture
    program()                        # a replay runs no Python
    torch.cuda.synchronize()
    assert seen == [True, False] and gc.isenabled()
    assert x.tolist() == [2.0] * 4


def test_replays_do_not_sync(cuda_device):
    """A replay of the prefill and of a decode segment, and of a captured
    train step, under torch.cuda.set_sync_debug_mode("error"): no call on
    their path waits for the device."""
    from dataclasses import replace

    from tpu_kubernetes_torch.models import CONFIGS, init_params
    from tpu_kubernetes_torch.serve.server import GreedyLane
    from tpu_kubernetes_torch.train import (
        TrainConfig,
        init_state,
        make_train_step,
    )

    cfg = replace(CONFIGS["llama-test"], dtype=torch.float32)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    lane = GreedyLane(init_params(cfg, gen, cuda_device), cfg)
    rows = torch.randint(0, 256, (2, 16), device=cuda_device,
                         dtype=torch.int32, generator=gen)
    lengths = torch.tensor([16, 5], dtype=torch.int32, device=cuda_device)
    lane.run(rows, lengths, [9, 9], 9, 8)          # captures both
    state = init_state(gen, cfg, TrainConfig(warmup_steps=2), cuda_device)
    step = make_train_step(cfg, TrainConfig(warmup_steps=2), state, (2, 33))
    batch = torch.randint(0, 256, (2, 33), device=cuda_device,
                          dtype=torch.int32, generator=gen)
    step(batch)                                    # captures
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        st = lane.prefill(rows, lengths, 25)
        lane.decode(st, 8)
        step(batch)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert lane.programs.replays == {("prefill", 2, 16, 25): 1,
                                     ("decode", 2, 16, 25, 8): 1}
    assert step.program.replays == 1


@pytest.mark.parametrize("model", ["llama-test", "moe-test"])
def test_graphed_train_step_equals_eager(cuda_device, model):
    """make_train_step as a CUDA graph against its body run eagerly, from
    copies of one f32 state, four steps on the same batches: losses within
    1e-5 relative and params within f32 noise (the embedding's and the
    MoE gathers' backward add with atomics, in an order that changes from
    run to run); the step captured once, replayed three times."""
    from dataclasses import replace

    from tpu_kubernetes_torch.models import CONFIGS
    from tpu_kubernetes_torch.train import (
        TrainConfig,
        init_state,
        make_train_step,
    )
    from tpu_kubernetes_torch.train.trainer import tree_leaves

    cfg = replace(CONFIGS[model], dtype=torch.float32)
    tc = TrainConfig(warmup_steps=2)
    states = [init_state(torch.Generator(device=cuda_device).manual_seed(0),
                         cfg, tc, cuda_device) for _ in range(2)]
    eager = make_train_step(cfg, tc, states[0], (4, 65), graphs=False)
    graphed = make_train_step(cfg, tc, states[1], (4, 65))
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    for _ in range(4):
        batch = torch.randint(0, cfg.vocab_size, (4, 65), device=cuda_device,
                              dtype=torch.int32, generator=gen)
        want = eager(batch).item()
        got = graphed(batch).item()
        assert got == pytest.approx(want, rel=1e-5)
    for a, b in zip(tree_leaves(states[1]["params"]),
                    tree_leaves(states[0]["params"])):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    assert int(states[1]["opt_state"]["count"]) == 4
    assert graphed.program.captures == 1 and graphed.program.replays == 3


@pytest.mark.parametrize("kind", ["adafactor", "lora"])
def test_adafactor_and_lora_steps_graphed_equal_eager_without_sync(
        cuda_device, kind):
    """make_train_step with Adafactor (at d_model 128, where the matmul
    weights factor) and make_lora_step, each as a CUDA graph against its
    body run eagerly from copies of one f32 state, four steps on the same
    batches: losses within 1e-5 relative, the trained tensors within f32
    noise; captured once, replayed three times; then one more replay
    under set_sync_debug_mode("error"): the in-place update reads its
    count, decay and learning rate on the device."""
    from dataclasses import replace

    from tpu_kubernetes_torch.models import CONFIGS, init_params
    from tpu_kubernetes_torch.train import (
        LoraConfig,
        TrainConfig,
        init_lora_state,
        init_state,
        make_lora_step,
        make_train_step,
    )
    from tpu_kubernetes_torch.train.trainer import tree_leaves

    def gen(seed):
        return torch.Generator(device=cuda_device).manual_seed(seed)

    if kind == "adafactor":
        cfg = replace(CONFIGS["llama-test"], dtype=torch.float32,
                      d_model=128, d_ff=256)
        tc = TrainConfig(warmup_steps=2, optimizer="adafactor")
        states = [init_state(gen(0), cfg, tc, cuda_device) for _ in range(2)]
        steps = [make_train_step(cfg, tc, states[0], (4, 65), graphs=False),
                 make_train_step(cfg, tc, states[1], (4, 65))]
        trained = [s["params"] for s in states]
    else:
        cfg = replace(CONFIGS["llama-test"], dtype=torch.float32)
        lc = LoraConfig(rank=4)
        base = init_params(cfg, gen(0), cuda_device)
        states = [init_lora_state(gen(1), base, cfg, lc, learning_rate=5e-3)
                  for _ in range(2)]
        steps = [make_lora_step(cfg, lc, states[0], base, (4, 65),
                                learning_rate=5e-3, graphs=False),
                 make_lora_step(cfg, lc, states[1], base, (4, 65),
                                learning_rate=5e-3)]
        trained = [s["adapters"] for s in states]
    draw = gen(5)
    for _ in range(4):
        batch = torch.randint(0, cfg.vocab_size, (4, 65), device=cuda_device,
                              dtype=torch.int32, generator=draw)
        want = steps[0](batch).item()
        assert steps[1](batch).item() == pytest.approx(want, rel=1e-5)
    for a, b in zip(tree_leaves(trained[1]), tree_leaves(trained[0])):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    assert steps[1].program.captures == 1 and steps[1].program.replays == 3
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        steps[1](batch)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert int(states[1]["opt_state"]["count"]) == 5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_engine_graphs_equal_eager_and_a_segment_replay_does_not_sync(
        cuda_device, dtype):
    """The continuous slot engine with its insert, segment and clear
    programs as CUDA graphs against the same bodies run eagerly: six
    requests of three widths through four slots (rows admitted
    mid-decode, slots recycled), identical tokens; each key captured
    once; then, with the engine idle, an upload of the slot state and a
    segment replay under set_sync_debug_mode("error")."""
    import threading
    import time
    from dataclasses import replace

    from tpu_kubernetes_torch.models import CONFIGS, init_params
    from tpu_kubernetes_torch.serve.server import (
        ContinuousEngine,
        GreedyLane,
    )

    cfg = replace(CONFIGS["llama-test"], dtype=dtype)
    params = init_params(cfg, torch.Generator(device=cuda_device)
                         .manual_seed(0), cuda_device)
    rng = torch.Generator().manual_seed(3)
    requests = [(torch.randint(1, 256, (n,), generator=rng).tolist(), new)
                for n, new in ((5, 20), (40, 9), (17, 30), (3, 2), (60, 12),
                               (16, 17))]
    tokens = {}
    engines = {}
    for graphed in (False, True):
        eng = engines[graphed] = ContinuousEngine(
            GreedyLane(params, cfg, graphs=graphed), slots=4, seg_steps=8)
        eng.warm()
        entries = []

        def submit(ids, new):
            entries.append(eng.enqueue(ids, new))

        threads = [threading.Thread(target=submit, args=r) for r in requests]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert all(e["event"].wait(120) for e in entries)
        tokens[graphed] = sorted((tuple(e["ids"]), tuple(e["tokens"]))
                                 for e in entries)
    assert tokens[True] == tokens[False]
    eng = engines[True]
    programs = eng.lane.programs
    assert set(programs.captures.values()) == {1}
    assert {("slot_segment", 8), ("slot_clear",)} <= set(programs.replays)
    deadline = time.monotonic() + 30
    while eng.stats()["occupied"] and time.monotonic() < deadline:
        time.sleep(0.01)
    assert eng.stats()["occupied"] == 0
    with eng._lock:
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            eng.launch_segment()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    for e in engines.values():
        e.close()


# -- decode attention (csrc/decode_attention.cu) --------------------------------

tda = importlib.import_module("tpu_kubernetes_torch.ops.decode_attention")


def _assert_decode_close(got, ref):
    """Within one ulp of the plain version's o at its largest magnitude:
    bf16, one bf16 ulp (both round an f32 result once, summed in other
    orders, so an element may land one ulp of its own apart); f32, 2e-6
    of it."""
    assert got.dtype == ref.dtype and got.shape == ref.shape
    scale = ref.abs().max().item()
    err = (got.float() - ref.float()).abs().max().item()
    if got.dtype == torch.bfloat16:
        assert err <= 2.0 ** (math.floor(math.log2(scale)) - 7), err
    else:
        assert err <= 2e-6 * scale, err


def _decode_inputs(device, b, h, kv, S, d, dtype, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn((b, h, 1, d), generator=g, device=device).to(dtype)
    k = torch.randn((b, kv, S, d), generator=g, device=device).to(dtype)
    v = torch.randn((b, kv, S, d), generator=g, device=device).to(dtype)
    return q, k, v


def _paged_from_dense(k, ps, seed):
    """The same positions as a page pool: row i's page j lands at a
    shuffled pool page ``table[i, j]`` (page 0, the sink, left random) →
    (pool layer (b * S / ps + 1, kv, ps, d), table (b, S / ps) int32)."""
    b, kv, S, d = k.shape
    mp = S // ps
    perm = torch.randperm(b * mp, generator=torch.Generator().manual_seed(
        seed)) + 1
    table = perm.reshape(b, mp).to(torch.int32).to(k.device)
    pool = torch.randn((b * mp + 1, kv, ps, d), device=k.device).to(k.dtype)
    pages = k.reshape(b, kv, mp, ps, d).transpose(1, 2)    # (b, mp, kv, ps, d)
    pool[table.long().reshape(-1)] = pages.reshape(b * mp, kv, ps, d)
    return pool, table


# (b, h, kv, S, d): llama-test's d 16, moe-1b's 64 and llama-1b's 128 with
# GQA, a span of several splits, and d 32
DECODE_SHAPES = [(3, 4, 2, 128, 16), (4, 16, 16, 640, 64),
                 (4, 16, 8, 1088, 128), (2, 8, 2, 320, 32)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", DECODE_SHAPES)
def test_decode_attention_matches_plain_dense_and_paged(cuda_device, shape,
                                                        dtype):
    """Ragged limits and pad gaps (a per-row prompt width, one row whose
    gap covers whole splits, a row at limit 1), dense and through a
    shuffled page table: each within its tolerance of the plain version,
    and the paged output bitwise the dense one (the same positions in the
    same order)."""
    b, h, kv, S, d = shape
    q, k, v = _decode_inputs(cuda_device, b, h, kv, S, d, dtype, seed=S)
    limits = torch.tensor([S, S // 2 + 3, 1, S - 5][:b],
                          device=cuda_device)[:, None]
    pl = torch.tensor([S // 8, 3, 0, 0][:b], dtype=torch.int32,
                      device=cuda_device)
    ps = torch.tensor([S - 8 if S > 300 else S // 2, 16, 0, S // 2][:b],
                      dtype=torch.int32, device=cuda_device)
    before = tda.decode_attention_cuda.launches
    got = tda.decode_attention_cuda(q, k, v, limits, pl, ps)
    torch.cuda.synchronize()
    assert tda.decode_attention_cuda.launches == before + 1
    ref = tda.decode_attention_reference(q, k, v, limits, pl, ps)
    _assert_decode_close(got, ref)
    for page_size in (16, 64):
        pk, table = _paged_from_dense(k, page_size, seed=1)
        pv = pk.clone()
        pv[table.long().reshape(-1)] = v.reshape(
            b, kv, S // page_size, page_size, d).transpose(1, 2).reshape(
            -1, kv, page_size, d)
        paged = tda.decode_attention_cuda(q, pk, pv, limits, pl, ps,
                                          table=table)
        assert torch.equal(paged, got)
        _assert_decode_close(paged, tda.decode_attention_reference(
            q, pk, pv, limits, pl, ps, table=table))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_attention_uniform_lane_shapes(cuda_device, dtype):
    """The solo lane's calls: limits (1,) shared with no ragged prompt,
    and (b, 1) broadcast from one slot with an int prompt_slots."""
    b, h, kv, S, d = 4, 16, 8, 1088, 128
    q, k, v = _decode_inputs(cuda_device, b, h, kv, S, d, dtype, seed=5)
    lim = torch.tensor([1030], device=cuda_device)
    _assert_decode_close(tda.decode_attention_cuda(q, k, v, lim),
                         tda.decode_attention_reference(q, k, v, lim))
    pl = torch.tensor([1024, 1000, 777, 333], dtype=torch.int32,
                      device=cuda_device)
    bl = (lim)[None, :].expand(b, 1)
    _assert_decode_close(
        tda.decode_attention_cuda(q, k, v, bl, pl, 1024),
        tda.decode_attention_reference(q, k, v, bl, pl, 1024))


def test_decode_attention_refuses_what_it_cannot_take(cuda_device):
    """A chunk of c = MAX_CHUNK + 1, head_dim 80, mixed dtypes and a CPU
    cache raise with the reason and launch nothing."""
    q, k, v = _decode_inputs(cuda_device, 2, 4, 2, 64, 16, torch.float32, 0)
    lim = torch.tensor([10], device=cuda_device)
    before = tda.decode_attention_cuda.launches
    c = tda.MAX_CHUNK + 1
    with pytest.raises(ValueError, match=f"c = {c}"):
        tda.decode_attention_cuda(q.expand(2, 4, c, 16), k, v,
                                  torch.arange(c, device=cuda_device) + 10)
    q80, k80, v80 = _decode_inputs(cuda_device, 2, 4, 2, 64, 80,
                                   torch.float32, 0)
    with pytest.raises(ValueError, match="head_dim"):
        tda.decode_attention_cuda(q80, k80, v80, lim)
    with pytest.raises(TypeError, match="one dtype"):
        tda.decode_attention_cuda(q, k.bfloat16(), v, lim)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tda.decode_attention_cuda(q, k.cpu(), v, lim)
    assert tda.decode_attention_cuda.launches == before


@pytest.mark.parametrize("d_model,route", [(64, "simt"), (256, "tc")])
def test_paged_engine_graphs_equal_dense_and_a_segment_replay_does_not_sync(
        cuda_device, d_model, route):
    """The paged engine with its insert, segment and clear programs as
    CUDA graphs against the dense graphed engine (its tokens equal) on
    six requests through four slots, in bf16; each key captured once;
    then a paged segment replay under set_sync_debug_mode("error"), with
    the decode-attention kernel among its launches, on the route of
    llama-test's head_dim 16 (simt) and of a llama-test 4 times as wide
    (head_dim 64: tc)."""
    import time
    from dataclasses import replace

    from tpu_kubernetes_torch.models import CONFIGS, init_params
    from tpu_kubernetes_torch.serve.server import (
        ContinuousEngine,
        GreedyLane,
    )
    from tpu_kubernetes_torch.util import graphs

    cfg = replace(CONFIGS["llama-test"], dtype=torch.bfloat16,
                  d_model=d_model)
    assert tda._route(cfg.dtype, cfg.head_dim,
                      cfg.n_heads // cfg.n_kv_heads) == route
    params = init_params(cfg, torch.Generator(device=cuda_device)
                         .manual_seed(0), cuda_device)
    rng = torch.Generator().manual_seed(3)
    requests = [(torch.randint(1, 256, (n,), generator=rng).tolist(), new)
                for n, new in ((5, 20), (40, 9), (17, 30), (3, 2), (60, 12),
                               (16, 17))]
    tokens = {}
    engines = {}
    for pool_mb in (0.0, 0.5):
        eng = engines[pool_mb] = ContinuousEngine(
            GreedyLane(params, cfg), slots=4, seg_steps=8, pool_mb=pool_mb)
        eng.warm()
        entries = [eng.enqueue(*r) for r in requests]
        assert all(e["event"].wait(120) for e in entries)
        tokens[pool_mb] = [e["tokens"] for e in entries]
    assert tokens[0.5] == tokens[0.0]
    eng = engines[0.5]
    programs = eng.lane.programs
    assert set(programs.captures.values()) == {1}
    assert {("paged_segment", 8), ("page_clear", 8)} <= set(programs.replays)
    deadline = time.monotonic() + 30
    while eng.stats()["occupied"] and time.monotonic() < deadline:
        time.sleep(0.01)
    pages = eng.stats()["pages"]
    assert pages["free"] == pages["total"]
    with eng._lock:
        torch.cuda.synchronize()
        graphs.reset_launches()
        torch.cuda.set_sync_debug_mode("error")
        try:
            eng.launch_segment()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    assert graphs.REPLAYED["decode_attention"] == 8 * cfg.n_layers
    assert graphs.REPLAYED[f"decode_attention.{route}"] == 8 * cfg.n_layers
    for e in engines.values():
        e.close()


# -- the tensor-core route (csrc/decode_attention_tc.cu) ---------------------------


def _paged_pair(k, v, ps, seed=1):
    """k and v as two pools read through one shuffled table of ``ps``-position
    pages → (pool k, pool v, table)."""
    b, kv, S, d = k.shape
    pk, table = _paged_from_dense(k, ps, seed)
    pv = pk.clone()
    pv[table.long().reshape(-1)] = v.reshape(
        b, kv, S // ps, ps, d).transpose(1, 2).reshape(-1, kv, ps, d)
    return pk, pv, table


def _tc_call(q, k, v, limits, pl=None, ps=None, table=None):
    """One call on the tc route, counted on it → o."""
    before = dict(tda.decode_attention_cuda.route_launches)
    o = tda.decode_attention_cuda(q, k, v, limits, pl, ps, table=table)
    torch.cuda.synchronize()
    assert tda.decode_attention_cuda.route_launches == {
        **before, "tc": before["tc"] + 1}
    return o


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("rep", [1, 2, 4, 8])
def test_decode_attention_tc_route_at_every_group_width(cuda_device, rep, d):
    """bf16 at head_dim 64 and 128 with 1, 2, 4 and 8 query heads a KV head
    (llama-7b's 1, llama-1b's 2, llama-70b's 8) takes the tensor-core
    route: ragged limits and pad gaps within one bf16 ulp of the plain
    version, dense and through tables of 16- and 64-position pages, the
    paged output bitwise the dense one; the CUDA-core route, forced on the
    same inputs, within the same tolerance."""
    b, kv, S = 4, 2, 1024
    q, k, v = _decode_inputs(cuda_device, b, rep * kv, kv, S, d,
                             torch.bfloat16, seed=rep * d)
    limits = torch.tensor([S, S // 2 + 3, 1, S - 5],
                          device=cuda_device)[:, None]
    pl = torch.tensor([S // 8, 3, 0, 70], dtype=torch.int32,
                      device=cuda_device)
    ps = torch.tensor([S - 8, 16, 0, 200], dtype=torch.int32,
                      device=cuda_device)
    assert tda._route(q.dtype, d, rep) == "tc"
    got = _tc_call(q, k, v, limits, pl, ps)
    ref = tda.decode_attention_reference(q, k, v, limits, pl, ps)
    _assert_decode_close(got, ref)
    _assert_decode_close(tda.decode_attention_cuda(q, k, v, limits, pl, ps,
                                                   route="simt"), ref)
    for page in (16, 64):
        pk, pv, table = _paged_pair(k, v, page)
        assert torch.equal(_tc_call(q, pk, pv, limits, pl, ps, table), got)


@pytest.mark.parametrize("span", [1, 63, 64, 65, 1000, 2048, 4096])
def test_decode_attention_tc_spans(cuda_device, span):
    """Spans of one position, one short of a tile, one tile, one past it,
    one that no tile or page size divides (1000 = 15.6 tiles), the
    engine's 2,048 and llama-70b's 4,096, at llama-1b's group (16 query
    heads over 8 KV heads, d 128): every row at the full span and at
    about half of it, against the plain version; paged through 16- and
    64-position pages wherever they divide the span, bitwise the dense
    output."""
    b, h, kv, d = 2, 16, 8, 128
    q, k, v = _decode_inputs(cuda_device, b, h, kv, span, d, torch.bfloat16,
                             seed=span)
    limits = torch.tensor([span, max(1, span // 2)],
                          device=cuda_device)[:, None]
    got = _tc_call(q, k, v, limits)
    _assert_decode_close(got, tda.decode_attention_reference(q, k, v,
                                                             limits))
    for page in (16, 64):
        if span % page == 0:
            pk, pv, table = _paged_pair(k, v, page)
            assert torch.equal(_tc_call(q, pk, pv, limits, table=table), got)


def test_decode_attention_tc_small_pages(cuda_device):
    """Pages of 1, 2, 4 and 8 positions (the engine takes any power of two
    up to 16; a TMA box is then a part of a swizzle atom): the paged
    output bitwise the dense one, ragged rows and gaps included."""
    b, h, kv, S, d = 3, 8, 4, 256, 128
    q, k, v = _decode_inputs(cuda_device, b, h, kv, S, d, torch.bfloat16,
                             seed=11)
    limits = torch.tensor([S, 131, 77], device=cuda_device)[:, None]
    pl = torch.tensor([40, 5, 0], dtype=torch.int32, device=cuda_device)
    ps = torch.tensor([64, 97, 33], dtype=torch.int32, device=cuda_device)
    dense = _tc_call(q, k, v, limits, pl, ps)
    _assert_decode_close(dense, tda.decode_attention_reference(
        q, k, v, limits, pl, ps))
    for page in (1, 2, 4, 8):
        pk, pv, table = _paged_pair(k, v, page, seed=page)
        assert torch.equal(_tc_call(q, pk, pv, limits, pl, ps, table), dense)


def test_decode_attention_tc_edge_rows(cuda_device):
    """A row whose only admitted position is its last (its whole width a
    gap), a row whose whole prompt sits in the pad gap (prompt length 0),
    a gap from one tile edge to the next, a gap inside one tile, and a
    row of a few positions at a span of 2,048: within the tolerance of the
    plain version, dense and paged alike; masked positions hold NaN in
    both caches, which no admitted output may see."""
    b, h, kv, S, d = 5, 16, 8, 2048, 128
    q, k, v = _decode_inputs(cuda_device, b, h, kv, S, d, torch.bfloat16,
                             seed=21)
    rows = [(1500, 0, 1499), (150, 0, 100), (700, 128, 512), (300, 70, 90),
            (5, 2, 3)]
    limits = torch.tensor([r[0] for r in rows], device=cuda_device)[:, None]
    pl = torch.tensor([r[1] for r in rows], dtype=torch.int32,
                      device=cuda_device)
    ps = torch.tensor([r[2] for r in rows], dtype=torch.int32,
                      device=cuda_device)
    ref = tda.decode_attention_reference(q, k, v, limits, pl, ps)
    pos = torch.arange(S, device=cuda_device)
    masked = ~((pos < limits) & ((pos < pl[:, None]) | (pos >= ps[:, None])))
    nan_k = k.masked_fill(masked[:, None, :, None], float("nan"))
    nan_v = v.masked_fill(masked[:, None, :, None], float("nan"))
    got = _tc_call(q, nan_k, nan_v, limits, pl, ps)
    assert not torch.isnan(got).any()
    _assert_decode_close(got, ref)
    pk, pv, table = _paged_pair(nan_k, nan_v, 16)
    assert torch.equal(_tc_call(q, pk, pv, limits, pl, ps, table), got)


def test_decode_attention_tc_graph_replays_are_bitwise_equal(cuda_device):
    """The tc route captured in a CUDA graph, paged, with per-row limits
    and gaps read on the device: two replays give the same bits, and the
    same bits as the eager call."""
    b, h, kv, S, d = 8, 16, 8, 2048, 128
    q, k, v = _decode_inputs(cuda_device, b, h, kv, S, d, torch.bfloat16,
                             seed=31)
    pk, pv, table = _paged_pair(k, v, 16)
    limits = torch.tensor([2048, 1000, 17, 600, 1999, 64, 65, 300],
                          device=cuda_device)[:, None]
    pl = torch.tensor([512, 40, 3, 100, 1024, 0, 64, 250], dtype=torch.int32,
                      device=cuda_device)
    ps = torch.tensor([512, 64, 16, 128, 1024, 32, 64, 256],
                      dtype=torch.int32, device=cuda_device)
    eager = _tc_call(q, pk, pv, limits, pl, ps, table)
    out = torch.empty_like(eager)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        out.copy_(tda.decode_attention_cuda(q, pk, pv, limits, pl, ps,
                                            table=table))
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out.copy_(tda.decode_attention_cuda(q, pk, pv, limits, pl, ps,
                                            table=table))
    replays = []
    for _ in range(2):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        replays.append(out.clone())
    assert torch.equal(replays[0], replays[1])
    assert torch.equal(replays[0], eager)


def test_decode_attention_route_launches_by_route(cuda_device):
    """Each call counts one launch, on the route it took: bf16 at d 128 on
    tc, f32 and d 16 on simt, bf16 at d 128 forced to simt; a route that
    does not take the call raises and launches nothing."""
    lim = torch.tensor([50], device=cuda_device)
    calls = [((2, 8, 4, 64, 128, torch.bfloat16), None, "tc"),
             ((2, 8, 4, 64, 128, torch.float32), None, "simt"),
             ((2, 4, 2, 64, 16, torch.bfloat16), None, "simt"),
             ((2, 8, 4, 64, 128, torch.bfloat16), "simt", "simt")]
    for (b, h, kv, S, d, dtype), route, took in calls:
        q, k, v = _decode_inputs(cuda_device, b, h, kv, S, d, dtype, seed=0)
        before = dict(tda.decode_attention_cuda.route_launches)
        total = tda.decode_attention_cuda.launches
        tda.decode_attention_cuda(q, k, v, lim, route=route)
        assert tda.decode_attention_cuda.launches == total + 1
        assert tda.decode_attention_cuda.route_launches == {
            r: n + (r == took) for r, n in before.items()}
    q, k, v = _decode_inputs(cuda_device, 2, 8, 4, 64, 128, torch.float32, 0)
    before = dict(tda.decode_attention_cuda.route_launches)
    with pytest.raises(ValueError, match="route 'tc'"):
        tda.decode_attention_cuda(q, k, v, lim, route="tc")
    assert tda.decode_attention_cuda.route_launches == before


# -- the chunk route: speculative verify windows (c <= MAX_CHUNK) --------------


def _chunk_rows(device, b, S, c, seed):
    """b ragged rows of a verify window of c at their own positions: (the
    (b, c) limits pos + 1 + j, prompt lengths, prompt widths, the (b, S)
    mask of the slots some column admits), with row 0 at the end of the
    span, row 1 a short prompt and a long gap, the rest drawn from a
    seed."""
    g = torch.Generator().manual_seed(seed)
    rows = [(S - c, S // 4, S // 2), (40, 3, 32)]
    while len(rows) < b:
        ps = int(torch.randint(16, S // 2, (1,), generator=g))
        pl = int(torch.randint(1, ps + 1, (1,), generator=g))
        pos = int(torch.randint(ps, S - c + 1, (1,), generator=g))
        rows.append((pos, pl, ps))
    pos = torch.tensor([r[0] for r in rows], device=device)
    limits = pos[:, None] + 1 + torch.arange(c, device=device)
    pl = torch.tensor([r[1] for r in rows], dtype=torch.int32, device=device)
    ps = torch.tensor([r[2] for r in rows], dtype=torch.int32, device=device)
    slot = torch.arange(S, device=device)
    admitted = (slot < limits[:, -1:]) & ((slot < pl[:, None])
                                         | (slot >= ps[:, None]))
    return limits, pl, ps, admitted


@pytest.mark.parametrize("rep", [1, 2, 8, 16])
@pytest.mark.parametrize("c", [2, 9, 16])
@pytest.mark.parametrize("route", ["tc", "simt"])
def test_decode_attention_chunk_route_matches_plain(cuda_device, route, c,
                                                    rep):
    """A verify window of c positions a row over a ragged cache, each chunk
    row j admitting the slots below pos + 1 + j: the tensor-core route
    (bf16, d 128) and the CUDA-core route (f32, d 16) within the
    decode-attention tolerance of the plain version, with NaN in every
    slot no column admits (the rejected window of an earlier round, the
    pad gap, the span past the window); through a shuffled table of
    16-position pages bitwise the dense output."""
    dtype, d = ((torch.bfloat16, 128) if route == "tc"
                else (torch.float32, 16))
    b, kv, S = 4, 2, 512
    q, k, v = _decode_inputs(cuda_device, b, rep * kv, kv, S, d, dtype,
                             seed=c * rep)
    q = torch.randn((b, rep * kv, c, d), generator=torch.Generator(
        device=cuda_device).manual_seed(c), device=cuda_device).to(dtype)
    limits, pl, ps, admitted = _chunk_rows(cuda_device, b, S, c, seed=c)
    ref = tda.decode_attention_reference(q, k, v, limits, pl, ps)
    nan = ~admitted[:, None, :, None]
    k, v = k.masked_fill(nan, float("nan")), v.masked_fill(nan, float("nan"))
    before = dict(tda.decode_attention_cuda.route_launches)
    got = tda.decode_attention_cuda(q, k, v, limits, pl, ps, route=route)
    torch.cuda.synchronize()
    assert tda.decode_attention_cuda.route_launches[route] == \
        before[route] + 1
    assert got.shape == (b, rep * kv, c, d) and not torch.isnan(got).any()
    _assert_decode_close(got, ref)
    pk, pv, table = _paged_pair(k, v, 16, seed=c)
    assert torch.equal(tda.decode_attention_cuda(q, pk, pv, limits, pl, ps,
                                                 table=table, route=route),
                       got)


@pytest.mark.parametrize("route", ["tc", "simt"])
def test_decode_attention_chunk_route_uniform_limits(cuda_device, route):
    """A uniform chunk (limits (c,) shared across the batch, no pad gap),
    as ``decode_chunk`` gives a uniform cache, at a window ending at slot
    300 (no tile or page size divides it): within the tolerance of the
    plain version on both routes, and the (b, c) broadcast of the same
    limits gives the same bits."""
    dtype, d = ((torch.bfloat16, 128) if route == "tc"
                else (torch.float32, 16))
    b, h, kv, S, c = 3, 16, 8, 512, 9
    q, k, v = _decode_inputs(cuda_device, b, h, kv, S, d, dtype, seed=3)
    q = torch.randn((b, h, c, d), generator=torch.Generator(
        device=cuda_device).manual_seed(c), device=cuda_device).to(dtype)
    limits = 300 - c + 1 + torch.arange(c, device=cuda_device)
    got = tda.decode_attention_cuda(q, k, v, limits, route=route)
    _assert_decode_close(got, tda.decode_attention_reference(q, k, v,
                                                             limits))
    wide = limits[None, :].expand(b, c)
    assert torch.equal(tda.decode_attention_cuda(q, k, v, wide, route=route),
                       got)


def _tc_model(cuda_device, dtype=torch.bfloat16):
    """llama-test four times as wide (d 256: head_dim 64, the tensor-core
    route in bf16) and 512 positions long, random weights from seed 0."""
    from dataclasses import replace

    from tpu_kubernetes_torch.models import CONFIGS, init_params

    cfg = replace(CONFIGS["llama-test"], dtype=dtype, d_model=256,
                  max_seq=512)
    params = init_params(cfg, torch.Generator(device=cuda_device)
                         .manual_seed(0), cuda_device)
    return cfg, params


def test_decode_chunk_ending_at_300_on_the_chunk_route(cuda_device):
    """A uniform verify chunk of 9 ending at slot 300 (its end neither a
    power of two nor a multiple of 16: the flash forward's block fit
    refused it before the chunk route) and a ragged one over the same
    prompt: each layer launches the decode-attention kernel once on the
    tensor-core route, no flash forward, and the logits agree with the
    plain lane's."""
    from dataclasses import replace

    from tpu_kubernetes_torch.models import decode as tdec

    cfg, params = _tc_model(cuda_device)
    plain = replace(cfg, use_kernel=False)
    g = torch.Generator(device=cuda_device).manual_seed(5)
    prompt = torch.randint(0, 256, (2, 291), generator=g, device=cuda_device)
    chunk = torch.randint(0, 256, (2, 9), generator=g, device=cuda_device)
    for lengths in (None, torch.tensor([291, 200], device=cuda_device)):
        out = {}
        for lane, c in (("kernel", cfg), ("plain", plain)):
            _, cache = tdec.prefill(params, prompt, c, max_seq=320,
                                    lengths=lengths)
            before = dict(tda.decode_attention_cuda.route_launches)
            flash = tfa.flash_fwd_cuda.launches
            out[lane], cache = tdec.decode_chunk(params, cache, chunk, c)
            torch.cuda.synchronize()
            assert cache.length == 300
            if lane == "kernel":
                assert tfa.flash_fwd_cuda.launches == flash
                assert tda.decode_attention_cuda.route_launches["tc"] == \
                    before["tc"] + cfg.n_layers
        # bf16: the two lanes round attention in other places
        err = (out["kernel"] - out["plain"]).abs().max().item()
        assert err <= 3e-2 * out["plain"].abs().max().item(), err


def test_verify_rounds_graphed_dense_and_paged_equal_the_plain_engine(
        cuda_device):
    """The slot engine with n-gram speculation (dense and paged, verify
    rounds as CUDA graphs on the chunk route) against the plain graphed
    engine on the same requests: the same tokens, each program key
    captured once, and a verify replay under set_sync_debug_mode("error")
    whose decode-attention launches are one a layer."""
    from tpu_kubernetes_torch.serve.server import (
        ContinuousEngine,
        GreedyLane,
    )
    from tpu_kubernetes_torch.util import graphs

    cfg, params = _tc_model(cuda_device, torch.float32)
    rng = torch.Generator().manual_seed(3)
    pattern = torch.randint(1, 256, (6,), generator=rng).tolist()
    requests = [(pattern * 6, 40), (torch.randint(1, 256, (40,),
                                                  generator=rng).tolist(), 9),
                (pattern * 2 + [7], 30), ([3, 4], 2), (pattern * 9, 12)]
    tokens = {}
    for name, kw in (("plain", {}), ("dense", {"spec": "ngram"}),
                     ("paged", {"spec": "ngram", "pool_mb": 4.0})):
        eng = ContinuousEngine(GreedyLane(params, cfg), slots=4, seg_steps=4,
                               draft_k=8, **kw)
        eng.warm()
        entries = [eng.enqueue(*r) for r in requests]
        assert all(e["event"].wait(120) for e in entries)
        tokens[name] = [e["tokens"] for e in entries]
        assert set(eng.lane.programs.captures.values()) == {1}
        if name != "plain":
            assert eng.spec_totals["accepted"] > 0
            with eng._lock:
                torch.cuda.synchronize()
                graphs.reset_launches()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    eng.launch_segment()
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                torch.cuda.synchronize()
            assert graphs.REPLAYED["decode_attention"] == cfg.n_layers
        eng.close()
    assert tokens["dense"] == tokens["plain"]
    assert tokens["paged"] == tokens["plain"]


def test_speculative_generate_graphed_equals_generate(cuda_device):
    """speculative_generate (a perfect draft: the target itself, and a
    random one) and prompt_lookup_generate as graphed rounds over the
    prompt padded to its width bucket (37 → 64, a ragged cache) equal the
    target's greedy generate at the reference's span, in f32 on the
    tensor-core model's widths; the perfect draft emits k + 1 tokens a
    round."""
    from tpu_kubernetes_torch.models import (
        generate,
        init_params,
        prompt_lookup_generate,
        speculative_generate,
    )

    cfg, params = _tc_model(cuda_device, torch.float32)
    other = init_params(cfg, torch.Generator(device=cuda_device)
                        .manual_seed(9), cuda_device)
    prompt = torch.randint(0, 256, (1, 37), generator=torch.Generator(
        device=cuda_device).manual_seed(1), device=cuda_device)
    k, new = 4, 21
    want = generate(params, prompt, cfg, new, cache_span=37 + new + k)
    out, stats = speculative_generate(params, params, prompt, cfg, cfg, new,
                                      draft_k=k)
    assert torch.equal(out, want)
    assert stats.rounds == -(-(new - 1) // (k + 1))
    out, _ = speculative_generate(params, other, prompt, cfg, cfg, new,
                                  draft_k=k)
    assert torch.equal(out, want)
    out, _ = prompt_lookup_generate(params, prompt, cfg, new, draft_k=k)
    assert torch.equal(out, want)


# -- the prefix cache's warm prefill: a chunk through the flash forward --------

def _rounding_bound(q, k, v, causal, scale):
    """The tensor-core forward's bound against f32 attention on its bf16
    inputs (see test_tensor_core_forward_within_its_roundings)."""
    qf, kf, vf = q.float(), k.float(), v.float()
    ref = tfa.attention_reference(qf, kf, vf, causal=causal, sm_scale=scale)
    mean_abs_v = tfa.attention_reference(qf, kf, vf.abs(), causal=causal,
                                         sm_scale=scale)
    return ref, 2.0 ** -8 * (ref.abs() + mean_abs_v) + 1e-6


@pytest.mark.parametrize("shape,dtype", [
    # llama-1b's warm prefill: 1,024 suffix rows against a 2,048 cache
    ((1, 16, 1024, 2048, 128), torch.bfloat16),
    # a ragged q tile with the diagonal off the tile grid (offset 16)
    ((1, 16, 1008, 1024, 128), torch.bfloat16),
    # llama-test's warm shape on the CUDA-core route
    ((1, 4, 48, 64, 16), torch.float32),
    # offsets off the 128-row tile on both routes
    ((1, 2, 112, 1000, 64), torch.bfloat16),
    ((2, 2, 240, 333, 128), torch.bfloat16),
    ((1, 4, 80, 200, 32), torch.float32),
])
def test_flash_forward_at_the_warm_shapes(cuda_device, shape, dtype):
    """seq_q < seq_k, causal, the diagonal offset by the cached positions:
    O within the tensor-core route's roundings of f32 attention (bf16), or
    1e-4 of the plain version (f32), and LSE within 1e-4."""
    b, h, sq, sk, d = shape
    q, k, v = _qkv(cuda_device, shape, dtype, seed=sq)
    scale = 1.0 / math.sqrt(d)
    route = tfa._route(dtype, d)
    before = tfa.flash_fwd_cuda.route_launches[route]
    o, lse = tfa.flash_fwd_cuda(q, k, v, True, scale)
    torch.cuda.synchronize()
    assert tfa.flash_fwd_cuda.route_launches[route] == before + 1
    if dtype == torch.bfloat16:
        ref, bound = _rounding_bound(q, k, v, True, scale)
        excess = ((o.float() - ref).abs() / bound).max().item()
        assert excess <= 1, f"{excess:.3f} of the bound"
    else:
        ref = tfa.attention_reference(q, k, v, causal=True, sm_scale=scale)
        torch.testing.assert_close(o, ref, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(
        lse, tfa.logsumexp_reference(q.float(), k.float(), True, scale),
        atol=1e-4, rtol=1e-4)


def _warm_cfg(dtype):
    """llama-test in f32 (the CUDA-core route, head_dim 16), or widened to
    head_dim 64 in bf16 (the tensor-core route), two query heads a KV
    head."""
    from dataclasses import replace

    from tpu_kubernetes_torch.models import CONFIGS

    cfg = replace(CONFIGS["llama-test"], dtype=dtype, max_seq=512)
    if dtype == torch.bfloat16:
        cfg = replace(cfg, d_model=256)
    return cfg


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prefill_resume_kernel_lane_equals_plain_lane(cuda_device, dtype):
    """prefill_resume of a 128-wide ragged suffix after 64 cached
    positions, on the card: the kernel lane launches the flash forward once
    a layer on its route and no decode attention; logits and cache equal
    the plain lane's (f32: within 1e-4; bf16: within 3e-2 of the largest).
    Over the resumed (ragged) cache, a chunk of more than MAX_CHUNK
    positions raises before anything launches; a chunk of 4 takes decode
    attention's chunk route once a layer and no flash forward, with logits
    equal to the plain lane's within the same tolerance."""
    from dataclasses import replace

    from tpu_kubernetes_torch.models import decode as tdec
    from tpu_kubernetes_torch.models import init_params

    cfg = _warm_cfg(dtype)
    params = init_params(cfg, torch.Generator(device=cuda_device)
                         .manual_seed(0), cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    tokens = torch.randint(0, 256, (2, 192), device=cuda_device,
                           dtype=torch.int32, generator=gen)
    lens = torch.tensor([128, 77], dtype=torch.int32, device=cuda_device)
    route = tfa._route(dtype, cfg.head_dim)
    out = {}
    for lane, c in (("plain", replace(cfg, use_kernel=False)),
                    ("kernel", cfg)):
        _, base = tdec.prefill(params, tokens[:, :64], c, max_seq=256)
        fwd = dict(tfa.flash_fwd_cuda.route_launches)
        dattn = tda.decode_attention_cuda.launches
        out[lane] = tdec.prefill_resume(params, tokens[:, 64:], c, base,
                                        lengths=lens)
        torch.cuda.synchronize()
        n = cfg.n_layers if lane == "kernel" else 0
        assert tfa.flash_fwd_cuda.route_launches == {
            r: fwd[r] + n * (r == route) for r in fwd}
        assert tda.decode_attention_cuda.launches == dattn
    (pl, pc), (kl, kc) = out["plain"], out["kernel"]
    assert kc.prompt_lengths.tolist() == [192, 141] and kc.length == 192
    for got, want in ((kl, pl), (kc.k, pc.k), (kc.v, pc.v)):
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
        else:
            err = (got.float() - want.float()).abs().max().item()
            assert err <= 3e-2 * want.float().abs().max().item()
    before = tfa.flash_fwd_cuda.launches, tda.decode_attention_cuda.launches
    long = tda.MAX_CHUNK + 1
    with pytest.raises(ValueError, match=rf"more than MAX_CHUNK = "
                                         rf"{tda.MAX_CHUNK} positions"):
        tdec.decode_chunk(params, kc, tokens[:, :long], cfg)
    assert (tfa.flash_fwd_cuda.launches,
            tda.decode_attention_cuda.launches) == before
    kl, _ = tdec.decode_chunk(params, kc, tokens[:, :4], cfg)
    pl, _ = tdec.decode_chunk(params, pc, tokens[:, :4],
                              replace(cfg, use_kernel=False))
    torch.cuda.synchronize()
    assert tfa.flash_fwd_cuda.launches == before[0]
    assert tda.decode_attention_cuda.chunk_launches[
        tda._route(dtype, cfg.head_dim, cfg.n_heads // cfg.n_kv_heads)] >= \
        cfg.n_layers
    assert tda.decode_attention_cuda.launches == before[1] + cfg.n_layers
    if dtype == torch.float32:
        torch.testing.assert_close(kl, pl, atol=1e-4, rtol=1e-4)
    else:
        err = (kl - pl).abs().max().item()
        assert err <= 3e-2 * pl.abs().max().item()


def test_graphed_warm_prefill_replays_bitwise_without_syncs(cuda_device):
    """The greedy lane's warm program ("prefill_warm", b, q, width, span)
    on the tensor-core route: captured at its first call, then replayed
    twice under torch.cuda.set_sync_debug_mode("error") (nothing on its
    path waits for the device), bitwise equal replays, the first token
    the eager body's, the flash forward recorded once a layer, and the
    slots past the width zeros, as after a cold prefill."""
    from tpu_kubernetes_torch.models import init_params
    from tpu_kubernetes_torch.serve.server import GreedyLane

    cfg = _warm_cfg(torch.bfloat16)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    params = init_params(cfg, gen, cuda_device)
    a = torch.randint(1, 256, (1, 64), device=cuda_device, dtype=torch.int32,
                      generator=gen)
    b = a.clone()
    b[:, 40:] = torch.randint(1, 256, (1, 24), device=cuda_device,
                              dtype=torch.int32, generator=gen)
    rows = b.expand(2, 64).contiguous()
    lengths = torch.tensor([60, 60], dtype=torch.int32, device=cuda_device)
    lane, eager = GreedyLane(params, cfg), GreedyLane(params, cfg,
                                                      graphs=False)
    st = lane.prefill(a, torch.tensor([50], dtype=torch.int32,
                                      device=cuda_device), 72)
    seg_k = st.cache.k[:, :, :, :50].clone()
    seg_v = st.cache.v[:, :, :, :50].clone()
    want = eager.prefill_warm(rows, lengths, seg_k, seg_v, 32, 72)
    lane.prefill_warm(rows, lengths, seg_k, seg_v, 32, 72)     # captures
    torch.cuda.synchronize()
    replays = []
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            got = lane.prefill_warm(rows, lengths, seg_k, seg_v, 32, 72)
            replays.append((got.logits.clone(), got.token.clone(),
                            got.cache.k.clone(), got.cache.v.clone()))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    key = ("prefill_warm", 2, 32, 64, 72)
    assert lane.programs.captures[key] == 1 and lane.programs.replays[key] == 2
    assert lane.programs._programs[key].launches == {
        "flash_fwd": cfg.n_layers, "flash_fwd.tc": cfg.n_layers}
    for x, y in zip(*replays):
        assert torch.equal(x, y)
    logits, token, k, v = replays[0]
    assert torch.equal(token, want.token)
    assert not k[:, :, :, 64:].any() and not v[:, :, :, 64:].any()
    assert torch.equal(k[:, :, :, :32], seg_k[:, :, :, :32].expand(
        -1, 2, -1, -1, -1))
    err = (logits - want.logits).abs().max().item()
    assert err <= 3e-2 * want.logits.abs().max().item()


@pytest.mark.parametrize("knobs", [dict(temperature=0.8, top_k=50, top_p=0.9),
                                   dict(temperature=1.2)])
def test_sampled_programs_draw_the_eager_tokens_on_every_call(cuda_device,
                                                              knobs):
    """Graph-safe draws: the sampled lane's generate program, graphed,
    gives the eager body's tokens for one seed at its first call (the
    warm-up, then the capture), its second and its tenth, and the
    stream's draw and step programs yield them too; a replay of the
    generate and of the step program runs under
    torch.cuda.set_sync_debug_mode("error"), and another seed draws other
    tokens."""
    from tpu_kubernetes_torch.models import CONFIGS, init_params
    from tpu_kubernetes_torch.serve.server import (
        GreedyLane,
        SampledLane,
        _pad_rows,
    )

    cfg = CONFIGS["llama-test"]
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    params = init_params(cfg, gen, cuda_device)
    rows = torch.randint(1, 256, (3, 32), device=cuda_device,
                         dtype=torch.int32, generator=gen)
    lengths = torch.tensor([32, 20, 7], dtype=torch.int32, device=cuda_device)
    eager = SampledLane(GreedyLane(params, cfg, graphs=False))
    lane = SampledLane(GreedyLane(params, cfg))
    want = eager.generate(rows, lengths, 16, 48, seed=7, **knobs)
    calls = [lane.generate(rows, lengths, 16, 48, seed=7, **knobs)
             for _ in range(10)]
    for i in (0, 1, 9):
        assert torch.equal(calls[i], want), f"call {i + 1}"
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = lane.generate(rows, lengths, 16, 48, seed=7, **knobs)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(again, want)
    assert not torch.equal(
        lane.generate(rows, lengths, 16, 48, seed=8, **knobs), want)
    ids = rows[2, :7].tolist()
    solo = eager.generate(_pad_rows([ids], 16), lengths[2:], 16, 32, seed=3,
                          **knobs)[0].tolist()
    for _ in range(3):
        assert list(lane.stream(ids, 16, 32, seed=3, **knobs)) == solo
    assert all(n == 1 for n in lane.programs.captures.values())
    st = lane.greedy.slots(1, 16, 32)
    step = lane._sampler("step", st, next(
        k[-1] for k in lane.programs.captures if k[0] == "step"))
    st.start.fill_(20)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


@pytest.mark.parametrize("model", ["llama-test", "moe-test"])
def test_graphed_eval_step_equals_eager(cuda_device, model):
    """make_eval_step as a CUDA graph against its body run eagerly on the
    same f32 params and batches: the same loss bit for bit at its first
    call and at replays, a replay under set_sync_debug_mode("error"), and
    the params untouched."""
    from dataclasses import replace

    from tpu_kubernetes_torch.models import CONFIGS, init_params
    from tpu_kubernetes_torch.train import make_eval_step
    from tpu_kubernetes_torch.train.trainer import tree_leaves

    cfg = replace(CONFIGS[model], dtype=torch.float32)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    params = init_params(cfg, gen, cuda_device)
    before = [p.clone() for p in tree_leaves(params)]
    graphed = make_eval_step(cfg, params, (2, 65))
    eager = make_eval_step(cfg, params, (2, 65), graphs=False)
    for i in range(4):
        batch = torch.randint(0, cfg.vocab_size, (2, 65), generator=gen,
                              device=cuda_device, dtype=torch.int32)
        want = eager(batch).clone()
        if i == 3:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            got = graphed(batch).clone()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert torch.equal(got, want), i
    assert graphed.program.captures == 1 and graphed.program.replays == 3
    assert all(torch.equal(a, b) for a, b in zip(before,
                                                 tree_leaves(params)))


# -- the serving operations layer on the card ----------------------------------


def _ops_engine_factory(cuda_device):
    """llama-test bf16 weights from seed 0 → a maker of slot engines (4
    slots, segments of 8) over a fresh graphed lane each."""
    from dataclasses import replace

    from tpu_kubernetes_torch.models import CONFIGS, init_params
    from tpu_kubernetes_torch.serve.server import ContinuousEngine, GreedyLane

    cfg = replace(CONFIGS["llama-test"], dtype=torch.bfloat16)
    params = init_params(cfg, torch.Generator(device=cuda_device)
                         .manual_seed(0), cuda_device)

    def make(**kw):
        return ContinuousEngine(GreedyLane(params, cfg), slots=4,
                                seg_steps=8, **kw)
    return make


_OPS_REQUESTS = [([7, 3, 9, 1, 4], 20), (list(range(1, 41)), 9),
                 ([5] * 17, 30), ([2, 8, 6], 12)]


def _ops_turn(eng, requests=_OPS_REQUESTS):
    """Every request at once → each one's tokens, or its error."""
    entries = [eng.enqueue(list(ids), new) for ids, new in requests]
    assert all(e["event"].wait(120) for e in entries)
    return [e["tokens"] if e["error"] is None else e["error"]
            for e in entries]


def test_segment_fault_at_a_first_call_never_enters_the_capture(
        cuda_device):
    """``serve.segment`` armed before an engine's first segment: the
    requests fail out and the segment program's first call (the warm-up
    and the capture) never began; disarmed, the next turn captures it
    once, replays it, and its tokens are a clean engine's."""
    from tpu_kubernetes_torch.obs.faults import injected

    make = _ops_engine_factory(cuda_device)
    clean = make()
    want = _ops_turn(clean)
    clean.close()
    eng = make()
    key = ("slot_segment", 8)
    try:
        with injected("serve.segment:1.0"):
            failed = _ops_turn(eng)
        assert all(isinstance(r, RuntimeError) for r in failed)
        assert key not in eng.lane.programs.captures
        assert _ops_turn(eng) == want
        assert eng.lane.programs.captures[key] == 1
        replays = eng.lane.programs.replays[key]
        assert _ops_turn(eng) == want
        assert eng.lane.programs.replays[key] > replays
    finally:
        eng.close()


def test_watchdog_restart_replays_the_same_graphs(cuda_device):
    """A scheduler thread killed by an escape past its loop's handler: the
    watchdog restarts it cold (cache and slot state wiped in place), every
    program replays on (its replay count grows, nothing captures again)
    and the tokens are those before the restart."""
    import threading
    import time

    from tpu_kubernetes_torch.serve.resilience import Watchdog

    make = _ops_engine_factory(cuda_device)
    eng = make()
    eng.warm()
    want = _ops_turn(eng)
    captures = dict(eng.lane.programs.captures)
    replays = dict(eng.lane.programs.replays)
    dead = threading.Event()

    def boom():
        del eng.__dict__["_reap"]
        dead.set()
        raise SystemExit("injected scheduler death")

    dog = Watchdog(eng.is_alive, eng.restart, max_restarts=2,
                   interval_s=0.05).start()
    try:
        eng.__dict__["_reap"] = boom
        victim = eng.enqueue([1, 2, 3], 4)
        assert dead.wait(30) and victim["event"].wait(30)
        assert isinstance(victim["error"], Exception)
        deadline = time.monotonic() + 30
        while eng.restarts < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert eng.restarts == 1 and eng.is_alive()
        assert not eng._cache.k.any()
        assert _ops_turn(eng) == want
    finally:
        dog.stop()
        eng.close()
    assert eng.lane.programs.captures == captures
    after = eng.lane.programs.replays
    assert all(after[k] > n for k, n in replays.items()
               if k[0] in ("slot_segment", "slot_insert"))


@pytest.mark.parametrize("spec", [None, "ngram"])
def test_segment_and_verify_round_with_the_layer_on_do_not_sync(
        cuda_device, spec):
    """A whole engine segment (and, speculating, its verify rounds) with
    the fault sites armed at probability 0, the ledger counting, the
    profiler recording and the tracer linking a request's trace, under
    set_sync_debug_mode("error"), but for the segment's own readback."""
    import random

    from tpu_kubernetes_torch.obs import tracing
    from tpu_kubernetes_torch.obs.faults import injected
    from tpu_kubernetes_torch.obs.ledger import LEDGER
    from tpu_kubernetes_torch.serve.server import ContinuousEngine
    from tpu_kubernetes_torch.util.trace import TRACER

    make = _ops_engine_factory(cuda_device)
    eng = make(spec=spec, draft_k=4)
    eng.warm()
    _ops_turn(eng)                  # every program captured
    ran = []

    def readback(out):
        # the segment's own sync, in whatever mode the caller ran
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        try:
            return out.cpu().numpy()
        finally:
            torch.cuda.set_sync_debug_mode(mode)

    def once():
        del eng.__dict__["_run_segment"]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            ContinuousEngine._run_segment(eng)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        ran.append(1)

    eng.__dict__["_readback"] = readback
    ctx = tracing.TraceContext(tracing.new_trace_id(random.Random(5)),
                               tracing.new_span_id(random.Random(6)), True)
    emitted = LEDGER.snapshot(timeline=0)["emitted"]
    try:
        with injected("serve.segment:0.0,serve.spec_verify:0.0"):
            eng.__dict__["_run_segment"] = once
            with tracing.trace_scope(ctx):
                entry = eng.enqueue(list(range(1, 30)), 40)
            assert entry["event"].wait(120)
    finally:
        eng.close()
    assert ran and entry["error"] is None and len(entry["tokens"]) == 40
    assert LEDGER.snapshot(timeline=0)["emitted"] > emitted
    assert any(s.name == "segment" and ctx.trace_id in s.meta["links"]
               for s in TRACER.spans)


def test_roofline_utilization_of_the_engine_segment(cuda_device):
    """The analytic roofline of the engine's segments on the card: the
    device kind is the card's, utilization non-null and at most 1."""
    from tpu_kubernetes_torch.serve.server import PROFILER

    make = _ops_engine_factory(cuda_device)
    eng = make()
    eng.warm()
    _ops_turn(eng)
    PROFILER.reset()
    PROFILER.device = cuda_device
    try:
        _ops_turn(eng)
    finally:
        eng.close()
    roof = PROFILER.roofline()
    assert roof["device_kind"] == torch.cuda.get_device_name(0)
    decode = roof["programs"]["decode"]
    assert decode["utilization"] is not None
    assert 0 < decode["utilization"] <= 1.0
    assert decode["flops_per_token"] > 0 and decode["bytes_per_token"] > 0


def test_profiler_phase_on_the_card_is_event_timed_without_a_sync(
        cuda_device):
    """An event-timed phase records its CUDA events and returns without
    waiting (under set_sync_debug_mode("error")); the summary then reads
    the device seconds and the allocator's memory."""
    from tpu_kubernetes_torch.obs.metrics import Registry
    from tpu_kubernetes_torch.obs.profile import (
        PhaseProfiler,
        _block_until_ready,
    )

    p = PhaseProfiler(registry=Registry(), device=cuda_device)
    x = torch.randn((1024, 1024), device=cuda_device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            with p.phase("mm", key="k") as h:
                y = h.sync(x @ x)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    s = p.summary()
    assert s["phases"]["mm"]["compile"]["count"] == 1
    assert s["phases"]["mm"]["execute"]["count"] == 1
    assert s["phases"]["mm"]["execute"]["total_seconds"] > 0
    assert s["hbm"]["bytes_limit"] > s["hbm"]["bytes_in_use"] > 0
    _block_until_ready((y, {"x": x}))


# -- int8 serving: the weight-only int8 matmul (tc, gemv) and decode
# attention over an int8 cache (tc8, q8) ------------------------------------

tw8 = importlib.import_module("tpu_kubernetes_torch.ops.w8_matmul")
tda8 = importlib.import_module("tpu_kubernetes_torch.ops.decode_attention")


def _w8_leaf(device, K, N, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    w = torch.randn((K, N), generator=g, device=device) * 0.02
    from tpu_kubernetes_torch.models.quant import _quantize_leaf

    return _quantize_leaf(w)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("K,N", [(2048, 2048), (2048, 1024), (2048, 5632),
                                 (5632, 2048), (2048, 32000), (64, 64),
                                 (64, 32), (64, 128), (128, 64), (64, 256)])
def test_w8_matmul_matches_plain_and_rows_are_independent(cuda_device, K, N,
                                                          dtype):
    """The CUDA-core kernel (route "gemv", forced for bf16, f32's own)
    against the plain version (the dequantized weight in x's dtype, then x
    @ W): bf16 within one bf16 ulp of each output (of at least 1% of its
    row's largest: the two f32 sum orders differ by about K * 2^-24 of the
    summands, below a bf16 ulp of the row's scale but not of a cancelled
    near-zero output), f32 within 1e-5 of its row's largest; a 72-row call
    equals the 8-row call on its first 8 rows bit for bit (the sum order
    depends on K and N alone)."""
    leaf = _w8_leaf(cuda_device, K, N)
    g = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.randn((72, K), generator=g, device=cuda_device).to(dtype)
    before = tw8.w8_matmul_cuda.launches
    gemv = tw8.w8_matmul_cuda.route_launches["gemv"]
    y72 = tw8.w8_matmul_cuda(x, leaf["q"], leaf["s"], route="gemv")
    y8 = tw8.w8_matmul_cuda(x[:8].clone(), leaf["q"], leaf["s"], route="gemv")
    y4 = tw8.w8_matmul_cuda(x[:4].clone(), leaf["q"], leaf["s"], route="gemv")
    torch.cuda.synchronize()
    assert tw8.w8_matmul_cuda.launches == before + 3
    assert tw8.w8_matmul_cuda.route_launches["gemv"] == gemv + 3
    assert torch.equal(y72[:8], y8) and torch.equal(y8[:4], y4)
    _assert_w8_close(y72, tw8.w8_matmul_reference(x, leaf["q"], leaf["s"]))


def _assert_w8_close(got, ref):
    """bf16: within one bf16 ulp of each output, of at least 1% of its
    row's largest; f32: within 1e-5 of its row's largest (the tolerance
    the w8 tests state)."""
    assert got.dtype == ref.dtype and got.shape == ref.shape
    bf16 = ref.dtype == torch.bfloat16
    got, ref = got.float(), ref.float()
    rowmax = ref.abs().amax(dim=1, keepdim=True)
    if bf16:
        tol = torch.finfo(torch.bfloat16).eps * torch.maximum(ref.abs(),
                                                              1e-2 * rowmax)
    else:
        tol = 1e-5 * rowmax
    assert bool(((got - ref).abs() <= tol).all())


@pytest.mark.parametrize("K,N", [(2048, 2048), (2048, 1024), (2048, 5632),
                                 (5632, 2048), (2048, 32000), (64, 64),
                                 (64, 32), (128, 64), (64, 256), (96, 48),
                                 (1040, 272), (320, 64)])
def test_w8_matmul_tc_matches_plain_and_rows_are_independent(cuda_device, K,
                                                             N):
    """bf16 rows take the tensor-core kernel (route "tc"): within one bf16
    ulp of the plain version (the tolerance above), 72 rows = 8 rows = 4
    rows = 1 row bit for bit (every tile, ring stage and cluster split
    follows from K and N alone; an MMA's result for one row does not
    depend on the others), at llama-1b's five weight shapes, llama-test's,
    and widths that leave a partial ring stage or an empty cluster block;
    repeated, the same bits (several blocks share a multiprocessor, and a
    stage is refilled only after its readers' proxy fence)."""
    leaf = _w8_leaf(cuda_device, K, N)
    g = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.randn((72, K), generator=g, device=cuda_device).to(
        torch.bfloat16)
    before = dict(tw8.w8_matmul_cuda.route_launches)
    ys = {m: tw8.w8_matmul_cuda(x[:m].clone(), leaf["q"], leaf["s"])
          for m in (72, 8, 4, 1)}
    again = tw8.w8_matmul_cuda(x, leaf["q"], leaf["s"])
    torch.cuda.synchronize()
    assert tw8.w8_matmul_cuda.route_launches == {
        **before, "tc": before["tc"] + 5}
    assert torch.equal(ys[72][:8], ys[8]) and torch.equal(ys[8][:4], ys[4])
    assert torch.equal(ys[4][:1], ys[1]) and torch.equal(again, ys[72])
    _assert_w8_close(ys[72], tw8.w8_matmul_reference(x, leaf["q"], leaf["s"]))


def test_w8_matmul_tc_forms_the_references_weight_bit_for_bit(cuda_device):
    """Rows of x that each pick one weight row (a one-hot x) give back the
    reference's bf16 weight, round_bf16(q * round_bf16(s)), bit for bit:
    the int8 to bf16 widening is exact and the scale's product correctly
    rounded, at every row of a 1,040 x 272 weight (a partial stage, a
    cluster of 8) and against the CUDA-core route."""
    K, N = 1040, 272
    leaf = _w8_leaf(cuda_device, K, N, seed=3)
    want = leaf["q"].to(torch.bfloat16) * leaf["s"].to(torch.bfloat16)
    for k0 in range(0, K, 128):
        rows = torch.arange(k0, min(K, k0 + 128), device=cuda_device)
        x = torch.zeros((len(rows), K), dtype=torch.bfloat16,
                        device=cuda_device)
        x[torch.arange(len(rows)), rows] = 1
        got = tw8.w8_matmul_cuda(x, leaf["q"], leaf["s"])
        assert torch.equal(got, want[rows])
        assert torch.equal(got, tw8.w8_matmul_cuda(x, leaf["q"], leaf["s"],
                                                   route="gemv"))


def test_w8_matmul_prefill_rows_take_the_dequant_route(cuda_device):
    """More than MAX_ROWS rows: the weight dequantized into a temporary and
    torch.matmul, counted by route and not as a kernel launch."""
    leaf = _w8_leaf(cuda_device, 128, 64)
    x = torch.randn((2, 100, 128), device=cuda_device)
    before = (tw8.w8_matmul_cuda.launches,
              dict(tw8.w8_matmul_cuda.route_launches))
    y = tw8.w8_matmul(x, leaf["q"], leaf["s"])
    assert torch.equal(y, tw8.w8_matmul_reference(x, leaf["q"], leaf["s"]))
    assert tw8.w8_matmul_cuda.launches == before[0]
    assert tw8.w8_matmul_cuda.route_launches["dequant"] == \
        before[1]["dequant"] + 1


def _q8_case(device, b, h, kv, S, d, c, dtype, ps=None, seed=0):
    """q, an int8 cache and its scales (dense, and with ``ps`` the same
    positions in a pool behind a shuffled table), ragged limits."""
    from tpu_kubernetes_torch.models.decode import _quantize_kv

    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn((b, h, c, d), generator=g, device=device).to(dtype)
    k8, ks = _quantize_kv(torch.randn((b, kv, S, d), generator=g,
                                      device=device))
    v8, vs = _quantize_kv(torch.randn((b, kv, S, d), generator=g,
                                      device=device))
    pos = torch.randint(c, S - c + 1, (b,), generator=g, device=device)
    limits = pos[:, None] + 1 + torch.arange(c, device=device)[None, :]
    pl = (pos // 3).to(torch.int32)
    pslot = (pos // 2).to(torch.int32)
    dense = (k8, v8, ks, vs)
    paged = table = None
    if ps is not None:
        mp = S // ps
        perm = torch.randperm(b * mp, generator=torch.Generator().manual_seed(
            seed)) + 1
        table = perm.reshape(b, mp).to(torch.int32).to(device)
        paged = tuple(_int8_pool(a, ps, table, 0) for a in dense)
    return q, dense, paged, table, limits, pl, pslot


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,h,kv,S,d,c", [
    (8, 16, 8, 2048, 128, 1), (8, 16, 8, 2048, 128, 9),   # llama-1b
    (8, 16, 8, 512, 64, 1),                               # moe-1b d 64
    (4, 4, 2, 128, 16, 1), (4, 4, 2, 128, 16, 9),         # llama-test
    (2, 32, 2, 256, 32, 16),
])
def test_decode_attention_q8_matches_plain_paged_equals_dense(
        cuda_device, b, h, kv, S, d, c, dtype):
    """The q8 route (the CUDA cores; forced where the call is tc8's) against
    the plain version with scales (bf16: one ulp at max |o|; f32: 2e-6 of
    it, as the other routes), dense and through a page table; the paged
    output equals the dense one bit for bit."""
    q, dense, paged, table, limits, pl, pslot = _q8_case(
        cuda_device, b, h, kv, S, d, c, dtype, ps=16)
    before = tda8.decode_attention_cuda.route_launches["q8"]
    got = tda8.decode_attention_cuda(q, dense[0], dense[1], limits, pl, pslot,
                                     route="q8", k_scale=dense[2],
                                     v_scale=dense[3])
    got_p = tda8.decode_attention_cuda(q, paged[0], paged[1], limits, pl,
                                       pslot, table, route="q8",
                                       k_scale=paged[2], v_scale=paged[3])
    torch.cuda.synchronize()
    assert tda8.decode_attention_cuda.route_launches["q8"] == before + 2
    ref = tda8.decode_attention_reference(q, dense[0], dense[1], limits, pl,
                                          pslot, k_scale=dense[2],
                                          v_scale=dense[3])
    _assert_decode_close(got, ref)
    assert torch.equal(got, got_p)


# (b, h, kv, S, d, c): llama-1b's d 128 at one position a row, a verify
# window of 9 (two column groups) and of 16, moe-1b's d 64, and groups of
# 16 query heads a KV head
TC8_SHAPES = [(8, 16, 8, 2048, 128, 1), (8, 16, 8, 2048, 128, 9),
              (4, 16, 8, 1024, 128, 16), (8, 16, 8, 512, 64, 1),
              (4, 16, 8, 512, 64, 9), (2, 32, 2, 256, 64, 1),
              (2, 32, 2, 256, 128, 1)]


def _tc8_call(q, k8, v8, ks, vs, limits, pl=None, pslot=None, table=None):
    """One call on the tc8 route, counted on it (and as a chunk when c >
    1) → o."""
    before = dict(tda8.decode_attention_cuda.route_launches)
    chunks = tda8.decode_attention_cuda.chunk_launches["tc8"]
    o = tda8.decode_attention_cuda(q, k8, v8, limits, pl, pslot, table,
                                   k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert tda8.decode_attention_cuda.route_launches == {
        **before, "tc8": before["tc8"] + 1}
    assert tda8.decode_attention_cuda.chunk_launches["tc8"] == chunks + (
        q.shape[2] > 1)
    return o


@pytest.mark.parametrize("page", [1, 2, 4, 16, 64])
@pytest.mark.parametrize("shape", TC8_SHAPES)
def test_decode_attention_tc8_matches_plain_paged_equals_dense(
        cuda_device, shape, page):
    """bf16 q over an int8 cache at head_dim 64 or 128 takes the tensor
    cores (route "tc8"): ragged limits and pad gaps within one bf16 ulp of
    max |o| of the plain version (the reference's dequantize on read), one
    position a row and chunks of 9 and 16; through pages of 1 (at d 64 a
    box TMA cannot place, copied by cp.async), 2 and 4 (scales by
    cp.async), 16 and 64 positions (scales by TMA), the paged output bitwise
    the dense one."""
    b, h, kv, S, d, c = shape
    q, dense, paged, table, limits, pl, pslot = _q8_case(
        cuda_device, b, h, kv, S, d, c, torch.bfloat16, ps=page, seed=page)
    assert tda8._route(q.dtype, d, h // kv, torch.int8) == "tc8"
    got = _tc8_call(q, *dense, limits, pl, pslot)
    ref = tda8.decode_attention_reference(q, dense[0], dense[1], limits, pl,
                                          pslot, k_scale=dense[2],
                                          v_scale=dense[3])
    _assert_decode_close(got, ref)
    assert torch.equal(_tc8_call(q, *paged, limits, pl, pslot, table), got)


def _int8_pool(a, ps, table, fill):
    """Dense rows (b, kv, S[, d]) of an int8 cache or its scales as a pool
    layer behind ``table``, every page no row owns (the sink included)
    holding ``fill``."""
    b, kv, S = a.shape[:3]
    mp = S // ps
    out = torch.full((b * mp + 1, kv, ps) + tuple(a.shape[3:]), fill,
                     dtype=a.dtype, device=a.device)
    pages = a.reshape(b, kv, mp, ps, *a.shape[3:]).transpose(1, 2)
    out[table.long().reshape(-1)] = pages.reshape(b * mp, kv, ps,
                                                  *a.shape[3:])
    return out


@pytest.mark.parametrize("d", [64, 128])
def test_decode_attention_tc8_masked_positions_see_no_garbage(cuda_device,
                                                              d):
    """Masked positions hold int8 garbage and NaN scales (a stale or
    unwritten pool page's scales may be anything), in the dense cache and
    in a pool whose unowned pages' scales are NaN too: no NaN reaches the
    output, which stays within one ulp of the plain version over the clean
    cache, paged bitwise dense. Rows as the tc route's edge test: a row
    whose only admitted position is its last, a whole prompt in the gap,
    gaps from tile edge to tile edge and inside one tile, a row of five
    positions."""
    from tpu_kubernetes_torch.models.decode import _quantize_kv

    b, h, kv, S = 5, 16, 8, 2048
    g = torch.Generator(device=cuda_device).manual_seed(d)
    q = torch.randn((b, h, 1, d), generator=g, device=cuda_device).to(
        torch.bfloat16)
    k8, ks = _quantize_kv(torch.randn((b, kv, S, d), generator=g,
                                      device=cuda_device))
    v8, vs = _quantize_kv(torch.randn((b, kv, S, d), generator=g,
                                      device=cuda_device))
    rows = [(1500, 0, 1499), (150, 0, 100), (700, 128, 512), (300, 70, 90),
            (5, 2, 3)]
    limits = torch.tensor([r[0] for r in rows], device=cuda_device)[:, None]
    pl = torch.tensor([r[1] for r in rows], dtype=torch.int32,
                      device=cuda_device)
    pslot = torch.tensor([r[2] for r in rows], dtype=torch.int32,
                         device=cuda_device)
    ref = tda8.decode_attention_reference(q, k8, v8, limits, pl, pslot,
                                          k_scale=ks, v_scale=vs)
    pos = torch.arange(S, device=cuda_device)
    masked = ~((pos < limits) & ((pos < pl[:, None]) | (pos >= pslot[:, None])))
    nan = float("nan")
    bad = (k8.masked_fill(masked[:, None, :, None], 127),
           v8.masked_fill(masked[:, None, :, None], -128),
           ks.masked_fill(masked[:, None, :], nan),
           vs.masked_fill(masked[:, None, :], nan))
    got = _tc8_call(q, *bad, limits, pl, pslot)
    assert not torch.isnan(got).any()
    _assert_decode_close(got, ref)
    table = torch.randperm(b * S // 16, generator=torch.Generator().manual_seed(
        d)).reshape(b, S // 16).to(torch.int32).to(cuda_device) + 1
    pool = [_int8_pool(t, 16, table, f)
            for t, f in zip(bad, (99, -77, nan, nan))]
    assert torch.equal(_tc8_call(q, *pool, limits, pl, pslot, table), got)


def test_decode_attention_tc8_graph_replays_are_bitwise_equal(cuda_device):
    """The tc8 route captured in a CUDA graph, paged, per-row limits and
    gaps read on the device: two replays give the same bits as the eager
    call."""
    q, dense, paged, table, limits, pl, pslot = _q8_case(
        cuda_device, 8, 16, 8, 2048, 128, 1, torch.bfloat16, ps=16, seed=31)
    eager = _tc8_call(q, *paged, limits, pl, pslot, table)
    out = torch.empty_like(eager)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        out.copy_(tda8.decode_attention_cuda(q, paged[0], paged[1], limits, pl,
                                             pslot, table, k_scale=paged[2],
                                             v_scale=paged[3]))
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out.copy_(tda8.decode_attention_cuda(q, paged[0], paged[1], limits, pl,
                                             pslot, table, k_scale=paged[2],
                                             v_scale=paged[3]))
    replays = []
    for _ in range(2):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        replays.append(out.clone())
    assert torch.equal(replays[0], replays[1])
    assert torch.equal(replays[0], eager)


def test_int8_routes_forced_and_refused(cuda_device):
    """On the card: bf16 x forced to "gemv" and an int8 cache forced to
    "q8" run the CUDA-core kernels, each counted on its route; a route that
    does not take the call ("tc" for f32 x, "tc8" for f32 q) raises before
    any launch."""
    leaf = _w8_leaf(cuda_device, 128, 64)
    x = torch.randn((4, 128), device=cuda_device)
    before = dict(tw8.w8_matmul_cuda.route_launches)
    tw8.w8_matmul_cuda(x.bfloat16(), leaf["q"], leaf["s"], route="gemv")
    with pytest.raises(ValueError, match="route 'tc' does not take"):
        tw8.w8_matmul_cuda(x, leaf["q"], leaf["s"], route="tc")
    torch.cuda.synchronize()
    assert tw8.w8_matmul_cuda.route_launches == {
        **before, "gemv": before["gemv"] + 1}
    q, dense, _, _, limits, pl, pslot = _q8_case(
        cuda_device, 2, 4, 2, 128, 64, 1, torch.bfloat16)
    before = dict(tda8.decode_attention_cuda.route_launches)
    tda8.decode_attention_cuda(q, dense[0], dense[1], limits, pl, pslot,
                               route="q8", k_scale=dense[2],
                               v_scale=dense[3])
    with pytest.raises(ValueError, match="route 'tc8' does not take"):
        tda8.decode_attention_cuda(q.float(), dense[0], dense[1], limits, pl,
                                   pslot, route="tc8", k_scale=dense[2],
                                   v_scale=dense[3])
    torch.cuda.synchronize()
    assert tda8.decode_attention_cuda.route_launches == {
        **before, "q8": before["q8"] + 1}


def test_rms_norm_rows_do_not_depend_on_the_batch_on_the_card(cuda_device):
    """On the card a row normalises to the same bits alone, in the slot
    engine's 8 rows and in a prefill's thousands (a whole-row reduction's
    plan follows the number of rows; the chunked sum's does not), over
    2,000 rows of llama-1b's width."""
    from tpu_kubernetes_torch.ops.norms import rms_norm

    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = (torch.randn((20000, 2048), generator=g, device=cuda_device) * 3).to(
        torch.bfloat16)
    w = torch.randn(2048, generator=g, device=cuda_device).to(torch.bfloat16)
    full = rms_norm(x, w)
    for b in (1, 4, 8, 16):
        parts = torch.cat([rms_norm(x[i:i + b], w) for i in range(0, 2000, b)])
        assert torch.equal(parts, full[:2000])
