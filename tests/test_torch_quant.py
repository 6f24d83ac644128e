"""The port's weight-only int8 quantization (``models/quant.py``) and its
matmul (``ops/w8_matmul.py``) against the JAX package's
``tpu_kubernetes/models/quant.py`` on the CPU.

``tests/test_quant.py`` re-run against the port, each case also held to
the JAX package's result from the same numpy weights; ``quantize_for_decode``
bit-identical to JAX's (``q`` and ``s``) for both families; the weight
bridge keeps an int8 leaf's int8 and f32 under a ``dtype`` override; the
plain matmul against JAX's ``y @ weight(leaf)`` (float32 within 1e-5:
the same weights, summation order only; bf16 within a bf16 ulp of the
output); the byte counts equal. The kernel is held to the plain version
on the card (``tests/test_torch_kernel_cuda.py``)."""

import importlib
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_kubernetes.models import CONFIGS as JCONFIGS
from tpu_kubernetes.models import decode as jdec
from tpu_kubernetes.models import init_params as jinit
from tpu_kubernetes.models import quant as jq
from tpu_kubernetes_torch.models import CONFIGS as TCONFIGS
from tpu_kubernetes_torch.models import decode as tdec
from tpu_kubernetes_torch.models import param_count
from tpu_kubernetes_torch.models import quant as tq
from tpu_kubernetes_torch.models.from_jax import params_from_numpy

# the module, not the dispatcher that ops/__init__ re-exports by its name
tw8 = importlib.import_module("tpu_kubernetes_torch.ops.w8_matmul")

FAMILIES = ("llama-test", "moe-test")
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)   # f32 through two layers


def _cfgs(name):
    return (replace(JCONFIGS[name], dtype=jnp.float32),
            replace(TCONFIGS[name], dtype=torch.float32))


def _port(tree, dtype=None):
    return params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu",
                             dtype=dtype)


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    """(name, JAX cfg, port cfg, JAX params, the same as port tensors)."""
    jcfg, tcfg = _cfgs(request.param)
    jp = jinit(jax.random.PRNGKey(4), jcfg)
    return request.param, jcfg, tcfg, jp, _port(jp)


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _walk(a, b):
    """Pairs of leaves of two trees with the same keys."""
    for k in a:
        if isinstance(a[k], dict):
            yield from _walk(a[k], b[k])
        else:
            yield k, a[k], b[k]


# -- tests/test_quant.py, against the port ---------------------------------

def test_roundtrip_error_bounded_by_half_scale():
    w = np.array(jax.random.normal(jax.random.PRNGKey(0), (3, 64, 32),
                                   jnp.float32))
    q = tq._quantize_leaf(torch.from_numpy(w))
    assert q["q"].dtype == torch.int8
    assert q["s"].shape == (3, 1, 32) and q["s"].dtype == torch.float32
    bound = float(q["s"].max()) / 2 + 1e-7
    assert tq.max_abs_error(torch.from_numpy(w)) <= bound
    assert tq.max_abs_error(torch.from_numpy(w)) == jq.max_abs_error(
        jnp.asarray(w))


def test_zero_channel_quantizes_to_zero():
    q = tq._quantize_leaf(torch.zeros((4, 8)))
    assert torch.equal(q["q"], torch.zeros((4, 8), dtype=torch.int8))
    assert torch.equal(q["s"], torch.ones((1, 8)))
    assert torch.equal(tq.weight(q, torch.float32), torch.zeros((4, 8)))


def test_export_shape_and_byte_halving():
    jcfg, tcfg = _cfgs("llama-test")
    jp = jinit(jax.random.PRNGKey(1), jcfg)
    params = _port(jp)
    qparams = tq.quantize_for_decode(params, tcfg)
    assert set(qparams) == set(params)
    assert tq.is_quantized(qparams["lm_head"])
    assert tq.is_quantized(qparams["layers"]["wq"])
    assert not tq.is_quantized(qparams["layers"]["attn_norm"])
    assert qparams["embed"] is params["embed"]
    assert (tq.quantized_param_bytes(qparams)
            < tq.quantized_param_bytes(params) * 0.6)
    assert tq.quantized_param_bytes(qparams) == jq.quantized_param_bytes(
        jq.quantize_for_decode(jp, jcfg))


def test_prefill_logits_close_to_unquantized():
    jcfg, tcfg = _cfgs("llama-test")
    params = _port(jinit(jax.random.PRNGKey(2), jcfg))
    qparams = tq.quantize_for_decode(params, tcfg)
    tokens = torch.from_numpy(_tokens(3, (2, 12), tcfg.vocab_size))
    ref, _ = tdec.prefill(params, tokens, tcfg)
    got, _ = tdec.prefill(qparams, tokens, tcfg)
    err = float((got - ref).abs().max())
    assert err / (float(ref.abs().max()) + 1e-6) < 0.05, err


def test_quantized_prefill_logits_match_jax(family):
    """int8 weights, both families (MoE: the expert stacks dequantized
    before the routed layer, as the reference does): the logits of a
    ragged prefill within the f32 tolerance of JAX's."""
    _, jcfg, tcfg, jp, params = family
    qparams = tq.quantize_for_decode(params, tcfg)
    tokens = _tokens(3, (2, 12), tcfg.vocab_size)
    lengths = np.array([12, 7], np.int32)
    got, _ = tdec.prefill(qparams, torch.from_numpy(tokens), tcfg,
                          lengths=torch.from_numpy(lengths))
    want, _ = jdec.prefill(jq.quantize_for_decode(jp, jcfg),
                           jnp.asarray(tokens), jcfg,
                           lengths=jnp.asarray(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)


def test_generate_runs_quantized_both_families(family):
    """int8 weights through generate, both families: (2, 5) int32 tokens,
    the JAX package's own from the same weights."""
    _, jcfg, tcfg, jp, params = family
    qparams = tq.quantize_for_decode(params, tcfg)
    prompt = _tokens(5, (2, 6), tcfg.vocab_size)
    out = tdec.generate(qparams, torch.from_numpy(prompt), tcfg,
                        max_new_tokens=5)
    assert out.shape == (2, 5) and out.dtype == torch.int32
    ref = jdec.generate(jq.quantize_for_decode(jp, jcfg), jnp.asarray(prompt),
                        jcfg, max_new_tokens=5)
    assert out.tolist() == np.asarray(ref).tolist()


def test_quantized_generate_mostly_agrees_with_reference():
    jcfg, tcfg = _cfgs("llama-test")
    jp = jinit(jax.random.PRNGKey(6), jcfg)
    params = _port(jp)
    qparams = tq.quantize_for_decode(params, tcfg)
    prompt = torch.from_numpy(_tokens(7, (4, 8), tcfg.vocab_size))
    ref = tdec.generate(params, prompt, tcfg, max_new_tokens=8)
    got = tdec.generate(qparams, prompt, tcfg, max_new_tokens=8)
    assert float((ref == got).float().mean()) >= 0.75
    jgot = jdec.generate(jq.quantize_for_decode(jp, jcfg),
                         jnp.asarray(prompt.numpy()), jcfg, max_new_tokens=8)
    assert got.tolist() == np.asarray(jgot).tolist()


def test_param_count_unaffected_by_quantization_accessor():
    jcfg, tcfg = _cfgs("llama-test")
    params = _port(jinit(jax.random.PRNGKey(8), jcfg))
    assert param_count(params) > 0
    w = tq.weight(tq.quantize_for_decode(params, tcfg)["layers"]["wq"],
                  torch.float32)
    assert w.shape == params["layers"]["wq"].shape


# -- bit identity with the JAX package's export ----------------------------

def test_quantize_for_decode_bit_identical_to_jax(family):
    """The same numpy weights → the same int8 values and f32 scales, bit
    for bit, at every quantized leaf (every expert of an MoE stack); the
    untouched leaves stay as they were."""
    _, jcfg, tcfg, jp, params = family
    got = tq.quantize_for_decode(params, tcfg)
    want = jq.quantize_for_decode(jp, jcfg)
    n = 0
    for name, g, w in _walk(got, jax.tree.map(np.asarray, want)):
        assert g.dtype == {np.int8: torch.int8, np.float32: torch.float32}[
            w.dtype.type], name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
        n += 1
    assert n == len(jax.tree_util.tree_leaves(want))


def test_bf16_export_bit_identical_to_jax():
    """In the preset's bf16 the absmax, the scale and the rounding see the
    same bf16 weights widened to f32: the same bits."""
    jcfg, tcfg = JCONFIGS["llama-test"], TCONFIGS["llama-test"]
    jp = jinit(jax.random.PRNGKey(2), jcfg)
    got = tq.quantize_for_decode(_port(jp), tcfg)
    want = jax.tree.map(np.asarray, jq.quantize_for_decode(jp, jcfg))
    for name, g, w in _walk(got, want):
        if g.dtype == torch.bfloat16:
            g = g.float()
            w = w.astype(np.float32)
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bridge_keeps_int8_and_f32_under_a_dtype_override(dtype):
    """``params_from_numpy(tree, dtype=...)`` casts the float leaves and
    leaves a quantized leaf's int8 values and f32 scales as they are."""
    jcfg, _ = _cfgs("llama-test")
    jqp = jq.quantize_for_decode(jinit(jax.random.PRNGKey(0), jcfg), jcfg)
    tp = _port(jqp, dtype=dtype)
    assert tp["embed"].dtype == dtype
    assert tp["layers"]["attn_norm"].dtype == dtype
    for leaf in (tp["lm_head"], tp["layers"]["wq"], tp["layers"]["w_down"]):
        assert leaf["q"].dtype == torch.int8
        assert leaf["s"].dtype == torch.float32
    np.testing.assert_array_equal(tp["layers"]["wq"]["q"].numpy(),
                                  np.asarray(jqp["layers"]["wq"]["q"]))


def test_layer_params_slice_quantized_leaves(family):
    _, _, tcfg, _, params = family
    qp = tq.quantize_for_decode(params, tcfg)
    layer = tdec.layer_params(qp, 1)
    assert torch.equal(layer["wq"]["q"], qp["layers"]["wq"]["q"][1])
    assert torch.equal(layer["wq"]["s"], qp["layers"]["wq"]["s"][1])
    assert torch.equal(layer["attn_norm"], qp["layers"]["attn_norm"][1])


# -- the matmul -------------------------------------------------------------

@pytest.mark.parametrize("shape", [(8, 64), (2, 9, 64), (1, 1, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matmul_w_matches_jax(shape, dtype):
    """``matmul_w`` and the plain version equal JAX's ``y @ weight(leaf,
    dtype)`` from the same numpy weight and rows: f32 within 1e-5, bf16
    within a bf16 ulp of the output's magnitude; 2-D and 3-D rows."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((64, 96)).astype(np.float32) * 0.1
    x = rng.standard_normal(shape).astype(np.float32)
    jleaf = jq._quantize_leaf(jnp.asarray(w))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = np.asarray((jnp.asarray(x).astype(jdt) @ jq.weight(jleaf, jdt))
                      .astype(jnp.float32))
    leaf = tq._quantize_leaf(torch.from_numpy(w))
    xt = torch.from_numpy(x).to(dtype)
    got = tq.matmul_w(xt, leaf)
    plain = tw8.w8_matmul_reference(xt, leaf["q"], leaf["s"])
    assert got.dtype == dtype and got.shape == (*shape[:-1], 96)
    assert torch.equal(got, plain)
    tol = (dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32 else
           dict(atol=2 ** -7 * float(np.abs(want).max()), rtol=0))
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


def test_matmul_w_passes_a_plain_weight_through():
    """A plain tensor multiplies as ``x @ w``, autograd and all (the
    training path)."""
    w = torch.randn(8, 4, requires_grad=True)
    x = torch.randn(3, 8)
    y = tq.matmul_w(x, w)
    assert torch.equal(y, x @ w)
    y.sum().backward()
    assert w.grad is not None


def test_quantized_param_bytes_equal_jax(family):
    name, jcfg, tcfg, jp, params = family
    got = tq.quantize_for_decode(params, tcfg)
    want = jq.quantize_for_decode(jp, jcfg)
    assert tq.quantized_param_bytes(got) == jq.quantized_param_bytes(want)
    assert tq.quantized_param_bytes(params) == jq.quantized_param_bytes(jp)
    # the roofline's weight term: the matmul leaves alone
    from tpu_kubernetes_torch.obs.profile import weight_bytes
    assert tq.matmul_weight_bytes(params) == weight_bytes(tcfg)
    assert tq.matmul_weight_bytes(got) < weight_bytes(tcfg) * 0.3


@pytest.mark.parametrize("K,N,splits", [
    (2048, 2048, 8), (2048, 1024, 8), (2048, 5632, 4), (5632, 2048, 8),
    (2048, 32000, 1), (64, 64, 1), (128, 64, 2)])
def test_k_split_depends_on_k_and_n_only(K, N, splits):
    """The kernel's split of K over a cluster (the sum order of every
    output element) is a function of the weight's shape: every row count
    sums alike. A power of two up to 8 blocks, each at least 64 positions,
    a multiple of 16, that cover K."""
    got, kb = tw8.k_split(K, N)
    assert got == splits and got & (got - 1) == 0 and got <= 8
    assert kb % 16 == 0 and kb >= min(K, 64)
    assert got * kb >= K > (got - 1) * kb


@pytest.mark.parametrize("K,N,splits", [
    (2048, 2048, 8), (2048, 1024, 8), (2048, 5632, 4), (5632, 2048, 8),
    (2048, 32000, 1), (64, 64, 1), (128, 64, 2), (1040, 272, 8),
    (320, 64, 4)])
def test_tc_split_depends_on_k_and_n_only(K, N, splits):
    """The tensor-core kernel's split of K over a cluster, like the
    CUDA-core kernel's, is a function of the weight's shape alone, so every
    row count sums in one order: a power of two up to 8 blocks, each range
    a whole number of 64-position ring stages, that cover K (the last
    block's range may run past it, or hold nothing)."""
    got, kb = tw8.tc_split(K, N)
    assert got == splits and got & (got - 1) == 0 and got <= tw8.MAX_CLUSTER
    assert kb % tw8.TC_KT == 0 and got * kb >= K
    assert -(-N // tw8.TC_COLS) * got <= max(tw8.TARGET_BLOCKS,
                                             -(-N // tw8.TC_COLS))
    assert tw8.tc_split(K, N) == (got, kb)


@pytest.mark.parametrize("dtype,rows,K,N,route", [
    (torch.bfloat16, 1, 2048, 2048, "tc"),      # a decode step
    (torch.bfloat16, 8, 5632, 2048, "tc"),
    (torch.bfloat16, 72, 2048, 32000, "tc"),    # a verify window of 9 x 8
    (torch.bfloat16, 128, 64, 256, "tc"),       # llama-test's widths
    (torch.bfloat16, 129, 2048, 2048, "dequant"),  # a prefill
    (torch.bfloat16, 8, 2048, 40, "gemv"),      # N not a multiple of 16
    (torch.bfloat16, 8, 100, 64, "gemv"),       # K not a multiple of 16
    (torch.float32, 8, 2048, 2048, "gemv"),     # f32 x: the CUDA cores
    (torch.float32, 4096, 64, 64, "dequant"),
])
def test_route_by_dtype_rows_and_shape(dtype, rows, K, N, route):
    """One rule picks a call's route: more than MAX_ROWS rows dequantize;
    bf16 x by a weight whose K and N are multiples of 16 takes the tensor
    cores; every other call the CUDA cores."""
    assert tw8._route(dtype, rows, K, N) == route


@pytest.mark.parametrize("dtype,rows,route,ok", [
    (torch.bfloat16, 8, "gemv", True),      # forced onto the CUDA cores
    (torch.bfloat16, 8, "tc", True),
    (torch.float32, 8, "tc", False),        # f32 x never takes tc
    (torch.bfloat16, 200, "tc", False),     # past MAX_ROWS
    (torch.bfloat16, 8, "dequant", False),
    (torch.float32, 8, "gemv", True),
])
def test_forcing_a_w8_route(dtype, rows, route, ok):
    """``route="gemv"`` forces the CUDA-core kernel on a call the tensor
    cores take; a route that does not take the call raises with the
    reason, before the device check; nothing launches on the CPU."""
    leaf = tq._quantize_leaf(torch.randn(64, 32))
    x = torch.randn(rows, 64).to(dtype)
    before = (tw8.w8_matmul_cuda.launches,
              dict(tw8.w8_matmul_cuda.route_launches))
    match = "CUDA tensors" if ok else f"route '{route}' does not take"
    with pytest.raises(ValueError, match=match):
        tw8.w8_matmul_cuda(x, leaf["q"], leaf["s"], route=route)
    assert (tw8.w8_matmul_cuda.launches,
            dict(tw8.w8_matmul_cuda.route_launches)) == before


def test_cpu_tensors_take_the_plain_version_and_never_the_kernel():
    """The dispatcher runs the plain version for CPU tensors; the wrapper
    refuses them (no fallback lane) and counts nothing."""
    leaf = tq._quantize_leaf(torch.randn(16, 8))
    x = torch.randn(2, 16)
    before = (tw8.w8_matmul_cuda.launches,
              dict(tw8.w8_matmul_cuda.route_launches))
    assert torch.equal(tw8.w8_matmul(x, leaf["q"], leaf["s"]),
                       tw8.w8_matmul_reference(x, leaf["q"], leaf["s"]))
    with pytest.raises(ValueError, match="CUDA tensors"):
        tw8.w8_matmul_cuda(x, leaf["q"], leaf["s"])
    with pytest.raises(TypeError, match="int8 weight"):
        tw8.w8_matmul_cuda(x, leaf["q"].float(), leaf["s"])
    assert (tw8.w8_matmul_cuda.launches,
            dict(tw8.w8_matmul_cuda.route_launches)) == before


def test_launch_counts_carry_the_int8_kernels():
    """``ops.launch_counts`` reads the int8 matmul's kernel launches and
    its routes, and decode attention's "q8" and "tc8" routes."""
    from tpu_kubernetes_torch import ops

    counts = ops.launch_counts()
    assert {"w8_matmul", "w8_matmul.tc", "w8_matmul.gemv",
            "w8_matmul.dequant", "decode_attention.q8",
            "decode_attention.q8.chunk", "decode_attention.tc8",
            "decode_attention.tc8.chunk"} <= set(counts)
