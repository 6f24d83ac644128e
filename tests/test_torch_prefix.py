"""The port's chunked entry points (``models/decode.py``: ``prefill_resume``,
``prefill_chunked``, ``decode_chunk``) against the JAX package's on
``llama-test`` and ``moe-test``, from the same weights and numpy tokens,
in float32: logits within 1e-5, cache K/V within 1e-6, the resumed
cache's metadata equal to a cold ragged prefill's.

Beside them, the chunk route the card takes (``_attend_chunk``: the
flash forward over the cache's first ``end`` slots, widened to the query
heads, the diagonal offset by the cached positions) is held to the
reference's masked decode attention through the flash dispatcher's plain
version, and the kernel lane's control flow runs on the CPU with the CUDA
wrappers stood in for by their plain versions: one flash launch a layer
a chunk of more than MAX_CHUNK positions at seq_q = c < seq_k = end, none
of decode attention; a shorter chunk, over a ragged cache too, through
decode attention's chunk route; a longer one over a ragged cache refused
before anything launches."""

import importlib
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_kubernetes.models import decode as jdec
from tpu_kubernetes.models import llama as jllama
from tpu_kubernetes.models import moe as jmoe
from tpu_kubernetes_torch import models as tmodels
from tpu_kubernetes_torch.models import decode as tdec
from tpu_kubernetes_torch.models import llama as tllama
from tpu_kubernetes_torch.models import moe as tmoe
from tpu_kubernetes_torch.models.from_jax import params_from_numpy

tfa = importlib.import_module("tpu_kubernetes_torch.ops.flash_attention")
tda = importlib.import_module("tpu_kubernetes_torch.ops.decode_attention")

# float32 through two layers: summation order (XLA vs ATen) and
# transcendental ulps only
LOGIT_TOL = dict(atol=1e-5, rtol=1e-5)
CACHE_TOL = dict(atol=1e-6, rtol=1e-6)
# MoE served drop-free, as tests/test_decode.py serves it: every chunk
# routes its tokens under a capacity that never binds
MODELS = {
    "llama-test": (replace(jllama.CONFIGS["llama-test"], dtype=jnp.float32),
                   replace(tllama.CONFIGS["llama-test"],
                           dtype=torch.float32)),
    "moe-test": (replace(jmoe.MOE_CONFIGS["moe-test"], dtype=jnp.float32,
                         capacity_factor=4.0),
                 replace(tmoe.MOE_CONFIGS["moe-test"], dtype=torch.float32,
                         capacity_factor=4.0)),
}
INIT = {"llama-test": jllama.init_params, "moe-test": jmoe.init_params}


@pytest.fixture(scope="module", params=list(MODELS))
def model(request):
    """(name, JAX cfg, port cfg, JAX params, the same weights as port
    tensors on the CPU)."""
    name = request.param
    jc, tc = MODELS[name]
    jp = INIT[name](jax.random.PRNGKey(0), jc)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return name, jc, tc, jp, tp


def _tokens(seed, shape, vocab=256):
    return np.random.default_rng(seed).integers(
        0, vocab, shape).astype(np.int32)


def _j(a):
    return jnp.asarray(a)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _assert_cache(tc, jc):
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), **CACHE_TOL)
    np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc.v), **CACHE_TOL)
    assert tc.length == int(jc.length)


@pytest.mark.parametrize("ragged", [False, True])
def test_prefill_resume_matches_jax(model, ragged):
    """A uniform 16-position prefix resumed with a 32-wide suffix (ragged:
    real suffix lengths 32 and 20), span 64: logits, the whole cache and
    its metadata, which a cold ragged prefill of the whole prompt would
    give."""
    _, jcfg, tcfg, jp, tp = model
    p, c, span = 16, 32, 64
    tokens = _tokens(0, (2, p + c))
    lens = np.array([32, 20], np.int32) if ragged else None
    _, jbase = jdec.prefill(jp, _j(tokens[:, :p]), jcfg, max_seq=span)
    _, tbase = tdec.prefill(tp, _t(tokens[:, :p]), tcfg, max_seq=span)
    jl, jc = jdec.prefill_resume(jp, _j(tokens[:, p:]), jcfg, jbase,
                                 lengths=None if lens is None else _j(lens))
    tl, tc = tdec.prefill_resume(tp, _t(tokens[:, p:]), tcfg, tbase,
                                 lengths=None if lens is None else _t(lens))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    _assert_cache(tc, jc)
    assert tc.k.data_ptr() == tbase.k.data_ptr()      # written in place
    if lens is None:
        assert tc.prompt_lengths is None and tc.prompt_slots is None
        return
    _, cold = tdec.prefill(tp, _t(tokens), tcfg, max_seq=span,
                           lengths=_t(p + lens))
    assert tc.length == tc.prompt_slots == cold.length == cold.prompt_slots
    assert tc.prompt_lengths.dtype == torch.int32
    assert tc.prompt_lengths.tolist() == cold.prompt_lengths.tolist() \
        == np.asarray(jc.prompt_lengths).tolist() == [48, 36]
    assert int(jc.prompt_slots) == tc.prompt_slots


def test_prefill_resume_refusals(model):
    """A ragged base cache and a suffix wider than the span are refused,
    as by JAX's; so is a suffix that would run past the span."""
    _, jcfg, tcfg, jp, tp = model
    tokens = _tokens(1, (2, 16))
    lens = np.array([16, 9], np.int32)
    _, jragged = jdec.prefill(jp, _j(tokens), jcfg, max_seq=32,
                              lengths=_j(lens))
    _, tragged = tdec.prefill(tp, _t(tokens), tcfg, max_seq=32,
                              lengths=_t(lens))
    for dec, params, cfg, cache, tok in (
            (jdec, jp, jcfg, jragged, _j(tokens)),
            (tdec, tp, tcfg, tragged, _t(tokens))):
        with pytest.raises(ValueError, match="needs a uniform cache"):
            dec.prefill_resume(params, tok, cfg, cache)
    _, tbase = tdec.prefill(tp, _t(tokens), tcfg, max_seq=32)
    with pytest.raises(ValueError, match="exceeds cache max_seq 32"):
        tdec.prefill_resume(tp, _t(_tokens(2, (2, 33))), tcfg, tbase)
    with pytest.raises(ValueError, match="cannot take 17 positions after 16"):
        tdec.prefill_resume(tp, _t(_tokens(2, (2, 17))), tcfg, tbase)


def test_prefill_chunked_matches_jax_and_prefill(model):
    """64 positions in chunks of 16 at span 80: JAX's chunked prefill
    within the stated tolerances, and the port's own whole-prompt prefill
    within summation order."""
    _, jcfg, tcfg, jp, tp = model
    tokens = _tokens(3, (2, 64))
    jl, jc = jdec.prefill_chunked(jp, _j(tokens), jcfg, max_seq=80,
                                  chunk=16)
    tl, tc = tdec.prefill_chunked(tp, _t(tokens), tcfg, max_seq=80,
                                  chunk=16)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    _assert_cache(tc, jc)
    assert tc.prompt_lengths is None
    pl, pc = tdec.prefill(tp, _t(tokens), tcfg, max_seq=80)
    np.testing.assert_allclose(tl.numpy(), pl.numpy(), **LOGIT_TOL)
    np.testing.assert_allclose(tc.k.numpy(), pc.k.numpy(), **CACHE_TOL)
    np.testing.assert_allclose(tc.v.numpy(), pc.v.numpy(), **CACHE_TOL)


@pytest.mark.parametrize("plen,max_seq,match", [
    (60, 80, "chunk 16"),                    # not a multiple of the chunk
    (64, 48, "exceeds cache max_seq 48"),
    (144, 160, "exceeds model max_seq 128"),
])
def test_prefill_chunked_rejections(model, plen, max_seq, match):
    """JAX's three ValueErrors, raised by both before any work."""
    _, jcfg, tcfg, jp, tp = model
    tokens = _tokens(4, (1, plen))
    for dec, params, cfg, tok in ((jdec, jp, jcfg, _j(tokens)),
                                  (tdec, tp, tcfg, _t(tokens))):
        with pytest.raises(ValueError, match=match):
            dec.prefill_chunked(params, tok, cfg, max_seq=max_seq, chunk=16)


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("c", [1, 4])
def test_decode_chunk_matches_jax(model, ragged, c):
    """Chunks of c positions after a uniform or ragged prefill of 12, twice
    in a row: every chunk position's logits and the cache."""
    _, jcfg, tcfg, jp, tp = model
    tokens, nxt = _tokens(5, (2, 12)), _tokens(6, (2, 2 * c))
    lens = np.array([7, 12], np.int32) if ragged else None
    kw = ({} if lens is None else {"lengths": lens})
    _, jc = jdec.prefill(jp, _j(tokens), jcfg, max_seq=24,
                         **{k: _j(v) for k, v in kw.items()})
    _, tc = tdec.prefill(tp, _t(tokens), tcfg, max_seq=24,
                         **{k: _t(v) for k, v in kw.items()})
    for i in range(2):
        chunk = nxt[:, i * c:(i + 1) * c]
        jl, jc = jdec.decode_chunk(jp, jc, _j(chunk), jcfg)
        tl, tc = tdec.decode_chunk(tp, tc, _t(chunk), tcfg)
        assert tuple(tl.shape) == (2, c, tcfg.vocab_size)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL,
                                   err_msg=f"chunk {i}")
        _assert_cache(tc, jc)
    assert (tc.prompt_lengths is None) == (lens is None)


# -- the chunk route of the card ---------------------------------------------------


@pytest.mark.parametrize("rep", [1, 2])
@pytest.mark.parametrize("p,c", [(0, 32), (16, 48), (100, 28), (130, 126)])
def test_chunk_route_equals_the_masked_decode_attention(rep, p, c):
    """``_attend_chunk`` on the flash dispatcher's plain version against
    ``decode_attention_reference`` with the chunk's ``limits``: the cache
    sliced at ``end = p + c`` (garbage past it, which neither may read),
    the KV heads widened, the diagonal offset by p, including offsets and
    ends off the 128-row tile."""
    kv, d, S = 2, 16, 320
    cfg = replace(tllama.CONFIGS["llama-test"], dtype=torch.float32,
                  n_heads=kv * rep, n_kv_heads=kv, use_kernel=False)
    g = torch.Generator().manual_seed(p * 1000 + c + rep)
    q = torch.randn((2, kv * rep, c, d), generator=g)
    k = torch.randn((2, kv, S, d), generator=g)
    v = torch.randn((2, kv, S, d), generator=g)
    got = tdec._attend_chunk(cfg, q, k, v, p + c)
    limits = torch.arange(p, p + c) + 1
    want = tda.decode_attention_reference(q, k, v, limits)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6,
                               rtol=1e-6)


@pytest.fixture()
def plain_kernels(monkeypatch):
    """The flash forward and decode attention's CUDA wrappers stood in for
    by their plain versions, counting launches and the flash shapes, so
    the kernel lane's control flow runs on the CPU."""
    seen = {"flash": [], "decode_attention": 0}

    def fwd(q, k, v, causal, scale):
        assert causal and q.is_contiguous() and k.is_contiguous() \
            and v.is_contiguous()
        seen["flash"].append((q.shape[2], k.shape[2]))
        return (tfa.attention_reference(q, k, v, causal, scale),
                tfa.logsumexp_reference(q, k, causal, scale))

    def dattn(q, k, v, limits, prompt_lengths=None, prompt_slots=None,
              table=None, k_scale=None, v_scale=None):
        seen["decode_attention"] += 1
        return tda.decode_attention_reference(q, k, v, limits,
                                              prompt_lengths, prompt_slots,
                                              table, k_scale, v_scale)

    monkeypatch.setattr(tfa, "flash_fwd_cuda", fwd)
    monkeypatch.setattr(tda, "decode_attention_cuda", dattn)
    return seen


def test_kernel_lane_resume_takes_the_flash_route(model, plain_kernels):
    """prefill_resume on the kernel lane: one flash launch a layer at
    seq_q = c against seq_k = p + c, no decode attention, and logits and
    cache equal to the plain lane's; a decode step after it takes decode
    attention once a layer."""
    name, _, tcfg, _, tp = model
    p, c, span = 16, 96, 128
    tokens = _t(_tokens(7, (2, p + c)))
    lens = _t(np.array([96, 50], np.int32))
    out = {}
    for lane, cfg in (("plain", tcfg), ("kernel",
                                        replace(tcfg, use_kernel=True))):
        _, base = tdec.prefill(tp, tokens[:, :p], cfg, max_seq=span)
        plain_kernels["flash"].clear()
        out[lane] = tdec.prefill_resume(tp, tokens[:, p:], cfg, base,
                                        lengths=lens)
    L = tcfg.n_layers
    assert plain_kernels["flash"] == [(c, p + c)] * L
    assert plain_kernels["decode_attention"] == 0
    (pl, pc), (kl, kc) = out["plain"], out["kernel"]
    np.testing.assert_allclose(kl.numpy(), pl.numpy(), **LOGIT_TOL)
    np.testing.assert_allclose(kc.k.numpy(), pc.k.numpy(), **CACHE_TOL)
    np.testing.assert_allclose(kc.v.numpy(), pc.v.numpy(), **CACHE_TOL)
    kcfg = replace(tcfg, use_kernel=True)
    tdec.decode_step(tp, kc, torch.argmax(kl, -1).to(torch.int32), kcfg)
    assert plain_kernels["decode_attention"] == L
    assert len(plain_kernels["flash"]) == L


def test_kernel_lane_ragged_chunk_raises_before_any_launch(model,
                                                          plain_kernels):
    """A chunk of more than MAX_CHUNK positions over a ragged cache on the
    kernel lane raises a ValueError naming the limit before it launches
    or writes anything; a chunk of 4 (a verify window) and c = 1 over the
    same cache take decode attention's chunk route, once a layer each,
    and never the flash forward."""
    _, _, tcfg, _, tp = model
    cfg = replace(tcfg, use_kernel=True)
    tokens = _t(_tokens(8, (2, 16)))
    _, cache = tdec.prefill(tp, tokens, tcfg, max_seq=40,
                            lengths=_t(np.array([16, 9], np.int32)))
    before = cache.k.clone()
    long = tda.MAX_CHUNK + 1
    with pytest.raises(ValueError, match=rf"more than MAX_CHUNK = "
                                         rf"{tda.MAX_CHUNK} positions"):
        tdec.decode_chunk(tp, cache, _t(_tokens(9, (2, long))), cfg)
    assert plain_kernels == {"flash": [], "decode_attention": 0}
    assert torch.equal(cache.k, before)
    _, cache = tdec.decode_chunk(tp, cache, _t(_tokens(9, (2, 4))), cfg)
    assert plain_kernels["decode_attention"] == tcfg.n_layers
    tdec.decode_chunk(tp, cache, _t(_tokens(9, (2, 1))), cfg)
    assert plain_kernels == {"flash": [],
                             "decode_attention": 2 * tcfg.n_layers}


def test_entry_points_are_exported():
    for name in ("prefill_resume", "prefill_chunked", "decode_chunk"):
        assert getattr(tmodels, name) is getattr(tdec, name)
