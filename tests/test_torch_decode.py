"""The port's dense model and KV-cache inference against the JAX package
on ``llama-test``, from the same weights (carried over by
``models.from_jax``) and the same numpy tokens: float32 logits within a
stated tolerance, greedy ``generate`` / ``decode_segment`` token-identical
(uniform, ragged, with EOS), bf16 logits within a looser one."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_kubernetes.models import decode as jdec
from tpu_kubernetes.models import llama as jllama
from tpu_kubernetes_torch.models import decode as tdec
from tpu_kubernetes_torch.models import llama as tllama
from tpu_kubernetes_torch.models.from_jax import params_from_numpy

JCFG = replace(jllama.CONFIGS["llama-test"], dtype=jnp.float32)
TCFG = replace(tllama.CONFIGS["llama-test"], dtype=torch.float32)
# float32 through two layers: summation order (XLA vs ATen matmuls) and
# transcendental ulps only
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def params():
    """(JAX params, the same weights as port tensors on the CPU)."""
    jp = jllama.init_params(jax.random.PRNGKey(0), JCFG)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(
        0, TCFG.vocab_size, shape).astype(np.int32)


def _j(a):
    return jnp.asarray(a)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_bridge_keeps_keys_layout_and_values(params):
    jp, tp = params
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    assert tllama.param_count(tp) == jllama.param_count(jp)
    for path, leaf in flat_j:
        t = tp
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == leaf.shape
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))


def test_bridge_carries_bf16_exactly():
    """ml_dtypes bfloat16 leaves go through float32 and back: exact."""
    jp = jllama.init_params(jax.random.PRNGKey(1), jllama.CONFIGS["llama-test"])
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    assert tp["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        tp["layers"]["wq"].float().numpy(),
        np.asarray(jp["layers"]["wq"]).astype(np.float32),
    )


def test_forward_logits_match_jax(params):
    jp, tp = params
    tokens = _tokens(0, (2, 16))
    ref = jllama.forward(jp, _j(tokens), JCFG)
    got = tllama.forward(tp, _t(tokens), TCFG)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **LOGIT_TOL)


@pytest.mark.parametrize("ragged", [False, True])
def test_prefill_logits_and_cache_match_jax(params, ragged):
    jp, tp = params
    tokens = _tokens(1, (3, 16))
    lengths = np.array([16, 5, 11], np.int32) if ragged else None
    jl, jc = jdec.prefill(jp, _j(tokens), JCFG, max_seq=24,
                          lengths=None if lengths is None else _j(lengths))
    tl, tc = tdec.prefill(tp, _t(tokens), TCFG, max_seq=24,
                          lengths=None if lengths is None else _t(lengths))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), **LOGIT_TOL)
    np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc.v), **LOGIT_TOL)
    assert tc.length == int(jc.length) == 16
    if ragged:
        assert tc.prompt_slots == int(jc.prompt_slots)
        assert tc.prompt_lengths.tolist() == np.asarray(jc.prompt_lengths).tolist()


@pytest.mark.parametrize("ragged", [False, True])
def test_decode_step_logits_match_jax(params, ragged):
    """Several decode steps after a (ragged) prefill: per-row positions,
    the pad-slot mask and the in-place cache writes all line up."""
    jp, tp = params
    tokens = _tokens(2, (2, 16))
    nxt = _tokens(3, (2, 4))
    lengths = np.array([9, 16], np.int32) if ragged else None
    _, jc = jdec.prefill(jp, _j(tokens), JCFG, max_seq=20,
                         lengths=None if lengths is None else _j(lengths))
    _, tc = tdec.prefill(tp, _t(tokens), TCFG, max_seq=20,
                         lengths=None if lengths is None else _t(lengths))
    for t in range(4):
        jl, jc = jdec.decode_step(jp, jc, _j(nxt[:, t]), JCFG)
        tl, tc = tdec.decode_step(tp, tc, _t(nxt[:, t]), TCFG)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL,
                                   err_msg=f"step {t}")
    assert tc.length == int(jc.length) == 20
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), **LOGIT_TOL)


def test_decode_steps_match_teacher_forcing(params):
    """The port's own invariant: prefill + decode_step reproduce its full
    forward at every position (tests/test_decode.py's check)."""
    _, tp = params
    seq = _t(_tokens(4, (2, 16)))
    full = tllama.forward(tp, seq, TCFG)
    logits, cache = tdec.prefill(tp, seq[:, :8], TCFG)
    torch.testing.assert_close(logits, full[:, 7], atol=2e-4, rtol=2e-4)
    for t in range(8, 16):
        logits, cache = tdec.decode_step(tp, cache, seq[:, t], TCFG)
        torch.testing.assert_close(logits, full[:, t], atol=3e-4, rtol=3e-4)


@pytest.mark.parametrize("lengths", [None, [5, 8], [8, 3]])
def test_greedy_generate_token_identical_to_jax(params, lengths):
    jp, tp = params
    prompt = _tokens(5, (2, 8))
    lj = None if lengths is None else _j(np.array(lengths, np.int32))
    lt = None if lengths is None else _t(np.array(lengths, np.int32))
    ref = jdec.generate(jp, _j(prompt), JCFG, max_new_tokens=10,
                        prompt_lengths=lj)
    got = tdec.generate(tp, _t(prompt), TCFG, max_new_tokens=10,
                        prompt_lengths=lt)
    assert got.dtype == torch.int32
    assert got.tolist() == np.asarray(ref).tolist()


def test_ragged_rows_match_unpadded_rows(params):
    """A right-padded batch generates what each row generates alone."""
    _, tp = params
    rows = [_tokens(30 + i, (1, n)) for i, n in enumerate([5, 8])]
    padded = np.zeros((2, 8), np.int32)
    for i, r in enumerate(rows):
        padded[i, :r.shape[1]] = r[0]
    got = tdec.generate(tp, _t(padded), TCFG, max_new_tokens=6,
                        prompt_lengths=torch.tensor([5, 8], dtype=torch.int32))
    for i, r in enumerate(rows):
        alone = tdec.generate(tp, _t(r), TCFG, max_new_tokens=6)
        assert got[i].tolist() == alone[0].tolist()


def test_eos_token_identical_to_jax(params):
    jp, tp = params
    prompt = _tokens(6, (2, 6))
    free = np.asarray(jdec.generate(jp, _j(prompt), JCFG, max_new_tokens=8))
    eos = int(free[0, 2])
    ref = jdec.generate(jp, _j(prompt), JCFG, max_new_tokens=8, eos_id=eos,
                        pad_id=-1)
    got = tdec.generate(tp, _t(prompt), TCFG, max_new_tokens=8, eos_id=eos,
                        pad_id=-1)
    assert got.tolist() == np.asarray(ref).tolist()
    row = got[0].tolist()
    assert eos in row[:3] and all(t == -1 for t in row[row.index(eos) + 1:])


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("use_eos", [False, True])
def test_decode_segment_token_identical_to_jax(params, ragged, use_eos):
    """Segments of decode_segment, chained as the server's early-exit loop
    chains them, against the JAX segments and the fused generate."""
    jp, tp = params
    prompt = _tokens(7, (2, 16))
    lengths = np.array([7, 16], np.int32) if ragged else None
    span, total = 28, 12
    ref_gen = np.asarray(jdec.generate(
        jp, _j(prompt), JCFG, max_new_tokens=total, cache_span=span,
        prompt_lengths=None if lengths is None else _j(lengths)))
    eos = int(ref_gen[0, 4]) if use_eos else None
    jl, jc = jdec.prefill(jp, _j(prompt), JCFG, max_seq=span,
                          lengths=None if lengths is None else _j(lengths))
    tl, tc = tdec.prefill(tp, _t(prompt), TCFG, max_seq=span,
                          lengths=None if lengths is None else _t(lengths))
    jtok = jnp.argmax(jl, axis=-1).astype(jnp.int32)
    ttok = torch.argmax(tl, dim=-1).to(torch.int32)
    jdone = (jtok == eos) if eos is not None else jnp.zeros((2,), bool)
    tdone = (ttok == eos) if eos is not None else torch.zeros(2, dtype=torch.bool)
    jout, tout = [np.asarray(jtok)[:, None]], [ttok[:, None]]
    for steps in (4, 4, 3):
        jt, jtok, jdone, jc = jdec.decode_segment(
            jp, jc, jtok, jdone, JCFG, steps, eos_id=eos)
        tt, ttok, tdone, tc = tdec.decode_segment(
            tp, tc, ttok, tdone, TCFG, steps, eos_id=eos)
        jout.append(np.asarray(jt))
        tout.append(tt)
        assert tdone.tolist() == np.asarray(jdone).tolist()
    got = torch.cat(tout, dim=1).tolist()
    assert got == np.concatenate(jout, axis=1).tolist()
    if eos is None:
        assert got == ref_gen.tolist()


def test_generate_rejects_overflow(params):
    _, tp = params
    with pytest.raises(ValueError, match="exceeds max_seq"):
        tdec.generate(tp, torch.zeros((1, 100), dtype=torch.int32), TCFG,
                      max_new_tokens=100)


def test_sampling_controls(params):
    """Sampled tokens are in range; top_k=1 and a vanishing nucleus
    degenerate to greedy; seeds explore differently (draws are not
    jax.random's, so they are never compared with JAX)."""
    _, tp = params
    prompt = _t(_tokens(9, (2, 8)))

    def gen(seed, **kw):
        g = torch.Generator().manual_seed(seed)
        return tdec.generate(tp, prompt, TCFG, max_new_tokens=8,
                             generator=g, **kw)

    a, b = gen(1, temperature=1.0), gen(2, temperature=1.0)
    assert ((a >= 0) & (a < TCFG.vocab_size)).all()
    assert not torch.equal(a, b)
    greedy = gen(0)
    assert torch.equal(gen(3, temperature=0.7, top_k=1), greedy)
    assert torch.equal(gen(4, temperature=0.7, top_p=1e-9), greedy)
    assert torch.equal(gen(5, temperature=1.0, top_p=1.0),
                       gen(5, temperature=1.0))


def test_top_k_keeps_only_the_k_best():
    logits = torch.tensor([[0.0, 5.0, 1.0, 4.0, 2.0]])
    seen = set()
    g = torch.Generator().manual_seed(0)
    for _ in range(200):
        seen.add(int(tdec.draw(tdec.filter_logits(logits, 1.0, top_k=2),
                               g)[0]))
    assert seen == {1, 3}


BF16_TOL = dict(atol=0.1, rtol=0.05)


def test_bf16_logits_close_to_jax():
    """bf16 weights and activations on both sides: the frameworks round at
    different places (XLA vs ATen bf16 matmul accumulation and output
    rounding, silu in bf16), so logits agree only to a few bf16 ulps
    through the two layers."""
    jcfg = jllama.CONFIGS["llama-test"]
    tcfg = tllama.CONFIGS["llama-test"]
    jp = jllama.init_params(jax.random.PRNGKey(2), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    tokens = _tokens(10, (2, 16))
    lengths = np.array([16, 9], np.int32)
    jl, _ = jdec.prefill(jp, _j(tokens), jcfg, lengths=_j(lengths))
    tl, _ = tdec.prefill(tp, _t(tokens), tcfg, lengths=_t(lengths))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **BF16_TOL)
    np.testing.assert_allclose(
        tllama.forward(tp, _t(tokens), tcfg).numpy(),
        np.asarray(jllama.forward(jp, _j(tokens), jcfg)), **BF16_TOL)
