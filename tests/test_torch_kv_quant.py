"""The port's int8 KV cache (``kv_quant=True``, ``models/decode.py``)
against the JAX package's on the CPU, dense and paged.

The reference's int8 cases of ``tests/test_decode.py`` (``TestKVQuant``
and the ``kv_quant`` parametrisations of the warm resume, the slot
insert/clear round trip, the slot decode identity, the paged round trip,
the paged decode identity and the verify rounds) re-run against the port,
each held to the JAX package on the same float32 ``llama-test`` weights
and numpy tokens: logits within 1e-4 (f32 through two layers, summation
order only), greedy tokens identical, caches' int8 values equal but for
rare one-step flips at a rounding boundary and their f32 scales within
1e-6 relative (the absmax of K/V that differ in their last ulps). Where
both sides start from the same bytes (a JAX row grafted into either
side's cache or pool) the caches are equal bit for bit. The int8 weights
(``SERVE_QUANT``) compose with all of it."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_kubernetes.models import decode as jdec
from tpu_kubernetes.models import llama as jllama
from tpu_kubernetes.models import quant as jq
from tpu_kubernetes_torch.models import decode as tdec
from tpu_kubernetes_torch.models import llama as tllama
from tpu_kubernetes_torch.models import quant as tq
from tpu_kubernetes_torch.models.from_jax import params_from_numpy

JCFG = replace(jllama.CONFIGS["llama-test"], dtype=jnp.float32)
TCFG = replace(tllama.CONFIGS["llama-test"], dtype=torch.float32)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
SCALE_TOL = dict(atol=0, rtol=1e-6)
FIELDS = ("tok", "pos", "remaining", "prompt_lengths", "prompt_slots")


def _port(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


@pytest.fixture(scope="module", params=["f32", "int8 weights"])
def params(request):
    """(JAX params, the same weights as port tensors): float32, or both
    int8-exported (``quantize_for_decode`` on each side)."""
    jp = jllama.init_params(jax.random.PRNGKey(0), JCFG)
    if request.param == "f32":
        return jp, _port(jp)
    return jq.quantize_for_decode(jp, JCFG), tq.quantize_for_decode(
        _port(jp))


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(
        0, JCFG.vocab_size, shape).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_cache_close(tc, jc):
    """int8 values equal but for rare flips of one step at a rounding
    boundary (K/V that differ in their last f32 ulp round to neighbouring
    int8 values; at most 1 in 1,000), scales within SCALE_TOL, dtypes
    int8 / f32."""
    assert tc.k.dtype == torch.int8 and tc.k_scale.dtype == torch.float32
    for name in ("k", "v"):
        diff = np.abs(getattr(tc, name).numpy().astype(np.int32)
                      - np.asarray(getattr(jc, name)).astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, name
    for name in ("k_scale", "v_scale"):
        np.testing.assert_allclose(getattr(tc, name).numpy(),
                                   np.asarray(getattr(jc, name)),
                                   **SCALE_TOL, err_msg=name)


def _assert_cache_equal(tc, jc):
    for name in ("k", "v", "k_scale", "v_scale"):
        np.testing.assert_array_equal(getattr(tc, name).numpy(),
                                      np.asarray(getattr(jc, name)), name)


def _row_from_jax(jrow):
    """A JAX (int8) row cache → the port's, the same bytes."""
    return tdec.KVCache(_t(jrow.k), _t(jrow.v), int(jrow.length),
                        k_scale=_t(jrow.k_scale), v_scale=_t(jrow.v_scale))


# -- TestKVQuant (tests/test_decode.py), against the port -----------------

def test_prefill_identical_decode_close(params):
    """Prefill attends full precision, so its logits are the unquantized
    prefill's bit for bit; decode drifts only by the int8 rounding; each
    step's logits and cache within the f32 tolerance of JAX's."""
    jp, tp = params
    tokens = _tokens(8, (2, 12))
    lo_e, c_e = tdec.prefill(tp, _t(tokens), TCFG, max_seq=20)
    lo_q, c_q = tdec.prefill(tp, _t(tokens), TCFG, max_seq=20, kv_quant=True)
    assert torch.equal(lo_e, lo_q)
    _, jc = jdec.prefill(jp, jnp.asarray(tokens), JCFG, max_seq=20,
                         kv_quant=True)
    _assert_cache_close(c_q, jc)
    tok = torch.argmax(lo_e, -1).to(torch.int32)
    for _ in range(4):
        le, c_e = tdec.decode_step(tp, c_e, tok, TCFG)
        lq, c_q = tdec.decode_step(tp, c_q, tok, TCFG)
        jl, jc = jdec.decode_step(jp, jc, jnp.asarray(tok.numpy()), JCFG)
        torch.testing.assert_close(lq, le, atol=0.08, rtol=0.05)
        np.testing.assert_allclose(lq.numpy(), np.asarray(jl), **LOGIT_TOL)
        tok = torch.argmax(le, -1).to(torch.int32)
    _assert_cache_close(c_q, jc)


def test_cache_is_int8_and_half_the_bytes(params):
    _, tp = params
    tokens = torch.zeros((2, 8), dtype=torch.int32)
    _, exact = tdec.prefill(tp, tokens, TCFG, max_seq=16)
    _, quant = tdec.prefill(tp, tokens, TCFG, max_seq=16, kv_quant=True)
    assert quant.k.dtype == torch.int8 and quant.v.dtype == torch.int8
    assert quant.k_scale.shape == quant.k.shape[:-1]
    exact_bytes = exact.k.numel() * exact.k.element_size() * 2
    quant_bytes = (quant.k.numel() + quant.k_scale.numel() * 4) * 2
    assert quant_bytes < 0.6 * exact_bytes
    # past the prompt: q 0, scale 1, as a cold cache
    cold = tdec.init_cache(TCFG, 2, 16, kv_quant=True, device="cpu")
    jcold = jdec.init_cache(JCFG, 2, 16, kv_quant=True)
    _assert_cache_equal(cold, jcold)
    assert torch.equal(quant.k[:, :, :, 8:], cold.k[:, :, :, 8:])
    assert torch.equal(quant.k_scale[:, :, :, 8:], cold.k_scale[:, :, :, 8:])


def test_generate_and_chunked_prefill_run(params):
    """generate and prefill_chunked on the int8 cache: JAX's tokens, its
    chunked logits and cache (each chunk attends the quantized history on
    both sides)."""
    jp, tp = params
    prompt = _tokens(9, (2, 8))
    out = tdec.generate(tp, _t(prompt), TCFG, max_new_tokens=5,
                        kv_quant=True)
    jout = jdec.generate(jp, jnp.asarray(prompt), JCFG, max_new_tokens=5,
                         kv_quant=True)
    assert out.tolist() == np.asarray(jout).tolist()
    lo, cache = tdec.prefill_chunked(tp, _t(prompt), TCFG, max_seq=16,
                                     chunk=4, kv_quant=True)
    jlo, jcache = jdec.prefill_chunked(jp, jnp.asarray(prompt), JCFG,
                                       max_seq=16, chunk=4, kv_quant=True)
    np.testing.assert_allclose(lo.numpy(), np.asarray(jlo), **LOGIT_TOL)
    _assert_cache_close(cache, jcache)
    lg, _ = tdec.decode_step(tp, cache, torch.argmax(lo, -1).to(torch.int32),
                             TCFG)
    assert torch.isfinite(lg).all()


def test_ragged_rows_match_unpadded_rows(params):
    """Quantization is per (position, head): padding cannot change a real
    row's scales, so the ragged identity holds on the int8 cache, and the
    tokens are JAX's."""
    jp, tp = params
    lengths = [5, 8]
    plen = max(lengths)
    rows = [_tokens(50 + i, (1, n)) for i, n in enumerate(lengths)]
    padded = np.stack([np.pad(r[0], (0, plen - r.shape[1])) for r in rows])
    got = tdec.generate(tp, _t(padded), TCFG, max_new_tokens=6,
                        kv_quant=True,
                        prompt_lengths=torch.tensor(lengths,
                                                    dtype=torch.int32))
    jgot = jdec.generate(jp, jnp.asarray(padded), JCFG, max_new_tokens=6,
                         kv_quant=True,
                         prompt_lengths=jnp.asarray(lengths, jnp.int32))
    assert got.tolist() == np.asarray(jgot).tolist()
    for i, r in enumerate(rows):
        ref = tdec.generate(tp, _t(r), TCFG, max_new_tokens=6, kv_quant=True,
                            cache_span=plen + 6)
        assert got[i].tolist() == ref[0].tolist()


# -- the kv_quant parametrisations, their int8 cases ----------------------

def test_warm_resume_identity_with_cold_prefill_int8(params):
    """prefill_resume over a stored int8 prefix: the cold ragged prefill's
    geometry, JAX's logits and cache, and the greedy continuation of JAX's
    resumed cache token for token."""
    jp, tp = params
    n, q, width, new = 24, 16, 32, 6
    span = width + new
    ids = _tokens(60, (1, n))
    padded = np.zeros((1, width), np.int32)
    padded[0, :n] = ids[0]
    lens = np.array([n - q], np.int32)
    _, jpre = jdec.prefill(jp, jnp.asarray(padded[:, :q]), JCFG,
                           max_seq=span, kv_quant=True)
    _, tpre = tdec.prefill(tp, _t(padded[:, :q]), TCFG, max_seq=span,
                           kv_quant=True)
    _assert_cache_close(tpre, jpre)
    jl, jc = jdec.prefill_resume(jp, jnp.asarray(padded[:, q:]), JCFG, jpre,
                                 lengths=jnp.asarray(lens))
    tl, tc = tdec.prefill_resume(tp, _t(padded[:, q:]), TCFG, tpre,
                                 lengths=_t(lens))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    _assert_cache_close(tc, jc)
    assert tc.length == int(jc.length) == width
    assert tc.prompt_slots == int(jc.prompt_slots)
    assert tc.prompt_lengths.tolist() == np.asarray(jc.prompt_lengths).tolist()
    jtok = jnp.argmax(jl, -1).astype(jnp.int32)
    ttok = torch.argmax(tl, -1).to(torch.int32)
    jt, *_ = jdec.decode_segment(jp, jc, jtok, jnp.zeros((1,), bool), JCFG,
                                 new - 1)
    tt, *_ = tdec.decode_segment(tp, tc, ttok, torch.zeros((1,), dtype=bool),
                                 TCFG, new - 1)
    assert tt.tolist() == np.asarray(jt).tolist()


def test_cache_insert_clear_row_roundtrip_int8(params):
    """insert then clear leaves the int8 slot bitwise cold (q 0, scale 1)
    and the other rows untouched; the insert is JAX's bit for bit."""
    jp, _ = params
    _, jrow = jdec.prefill(jp, jnp.asarray(_tokens(3, (1, 8))), JCFG,
                           max_seq=16, kv_quant=True)
    trow = _row_from_jax(jrow)
    cache = tdec.init_cache(TCFG, 3, 32, kv_quant=True, device="cpu")
    jcache = jdec.init_cache(JCFG, 3, 32, kv_quant=True)
    tdec.cache_insert_row(cache, trow, 1)
    jcache = jdec.cache_insert_row(jcache, jrow, 1)
    _assert_cache_equal(cache, jcache)
    tdec.cache_clear_row(cache, torch.tensor(1))
    _assert_cache_equal(cache, jdec.init_cache(JCFG, 3, 32, kv_quant=True))
    with pytest.raises(ValueError,
                       match=r"cache/row kv-quant mismatch \(one has int8 "
                             r"scales\)"):
        tdec.cache_insert_row(tdec.init_cache(TCFG, 3, 32, device="cpu"),
                              trow, 0)
    with pytest.raises(ValueError, match="kv-quant mismatch"):
        jdec.cache_insert_row(jdec.init_cache(JCFG, 3, 32), jrow, 0)


def _slot_batch(tp, jp, widths, plens, budgets, span, seed):
    """Rows prefilled at their own widths (each side its own), grafted
    into an int8 (slots, span) batch cache → (port cache, port state, JAX
    cache, JAX state, solo tokens of each row on the port)."""
    b = len(widths)
    cache = tdec.init_cache(TCFG, b, span, kv_quant=True, device="cpu")
    jcache = jdec.init_cache(JCFG, b, span, kv_quant=True)
    st = np.zeros((5, b), np.int32)
    solo = []
    for i, (w, n, budget) in enumerate(zip(widths, plens, budgets)):
        padded = np.zeros((1, w), np.int32)
        padded[0, :n] = _tokens(seed + i, (1, n))[0]
        lens = np.array([n], np.int32)
        tl, trow = tdec.prefill(tp, _t(padded), TCFG, max_seq=w,
                                lengths=_t(lens), kv_quant=True)
        _, jrow = jdec.prefill(jp, jnp.asarray(padded), JCFG, max_seq=w,
                               lengths=jnp.asarray(lens), kv_quant=True)
        tdec.cache_insert_row(cache, trow, i)
        jcache = jdec.cache_insert_row(jcache, jrow, i)
        st[:, i] = (int(torch.argmax(tl[0])), w, budget - 1, n, w)
        solo.append(tdec.generate(
            tp, _t(padded), TCFG, budget, kv_quant=True, cache_span=span,
            prompt_lengths=_t(lens))[0].tolist())
    tst = tdec.SlotState(*(_t(a) for a in st))
    jst = jdec.SlotState(*map(jnp.asarray, st))
    return cache, tst, jcache, jst, solo


def test_slot_decode_identity_with_solo_decode_int8(params):
    """Rows of different widths decoded as one mixed int8 batch emit
    exactly what each emits solo on an int8 cache of the same span, and
    JAX's tokens, slot state and cache."""
    jp, tp = params
    budgets = [7, 5, 9]
    cache, tst, jcache, jst, solo = _slot_batch(
        tp, jp, [8, 16, 16], [6, 11, 16], budgets, 48, 70)
    tt, tst, _ = tdec.decode_segment_slots(tp, cache, tst, TCFG, 8)
    jt, jst, jcache = jdec.decode_segment_slots(jp, jcache, jst, JCFG, 8)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tst, f).numpy(),
                                      np.asarray(getattr(jst, f)), f)
    _assert_cache_close(cache, jcache)
    for i, budget in enumerate(budgets):
        assert solo[i][1:budget] == tt[i, :budget - 1].tolist()


@pytest.mark.parametrize("ps", [4, 8, 16])
def test_paged_decode_equals_the_dense_slots_int8(params, ps):
    """Paged int8 decode is the dense int8 slot engine bit for bit at
    every page size (the same positions, scales and sums), and JAX's
    tokens."""
    jp, tp = params
    span = 48
    cache, tst, _, jst, _ = _slot_batch(tp, jp, [8, 16], [5, 13], [9, 9],
                                        span, 90)
    mp = span // ps
    pool = tdec.init_paged_pool(TCFG, 2 * mp, ps, kv_quant=True,
                                device="cpu")
    table = torch.zeros((2, mp), dtype=torch.int32)
    rng = np.random.default_rng(ps)
    pages = rng.permutation(np.arange(1, 2 * mp + 1)).reshape(2, mp)
    for i in range(2):
        table[i] = torch.from_numpy(pages[i].astype(np.int32))
        row = tdec.KVCache(cache.k[:, i:i + 1], cache.v[:, i:i + 1], span,
                           k_scale=cache.k_scale[:, i:i + 1],
                           v_scale=cache.v_scale[:, i:i + 1])
        tdec.paged_insert_row(pool, row, table[i])
    pst = tdec.SlotState(*(getattr(tst, f).clone() for f in FIELDS))
    dl, _ = tdec.decode_step_slots(tp, cache, tst, TCFG)
    pl, _ = tdec.decode_step_paged(tp, pool, table, pst, TCFG)
    assert torch.equal(dl, pl)
    tt, _, _ = tdec.decode_segment_slots(tp, cache, tst, TCFG, 6)
    pt, _, _ = tdec.decode_segment_paged(tp, pool, table, pst, TCFG, 6)
    assert torch.equal(tt, pt)
    for i in range(2):
        got = tdec.gather_pages(pool, table[i])
        assert torch.equal(got.k[:, 0], cache.k[:, i])
        assert torch.equal(got.k_scale[:, 0], cache.k_scale[:, i])


def test_paged_insert_gather_clear_roundtrip_int8(params):
    """paged_insert_row → gather_pages reproduces the int8 row and its
    scales bitwise (the pools equal JAX's on the usable pages), untouched
    pages stay cold, and a padded paged_clear_pages returns the pool to
    cold (q 0, scale 1)."""
    jp, _ = params
    ps = 8
    _, jrow = jdec.prefill(jp, jnp.asarray(_tokens(4, (1, 16))), JCFG,
                           max_seq=16, kv_quant=True)
    trow = _row_from_jax(jrow)
    pool = tdec.init_paged_pool(TCFG, 6, ps, kv_quant=True, device="cpu")
    jpool = jdec.init_paged_pool(JCFG, 6, ps, kv_quant=True)
    pages = [5, 2]
    tdec.paged_insert_row(pool, trow, torch.tensor(pages))
    jpool = jdec.paged_insert_row(jpool, jrow, jnp.asarray(pages, jnp.int32))
    for name in ("k", "v", "k_scale", "v_scale"):
        np.testing.assert_array_equal(getattr(pool, name)[:, 1:].numpy(),
                                      np.asarray(getattr(jpool, name))[:, 1:])
    got = tdec.gather_pages(pool, torch.tensor(pages))
    _assert_cache_equal(got, jdec.gather_pages(jpool, jnp.asarray(pages)))
    _assert_cache_equal(got, jrow)
    tdec.paged_clear_pages(pool, torch.tensor([5, 2, 99, 99]))
    cold = tdec.init_paged_pool(TCFG, 6, ps, kv_quant=True, device="cpu")
    for name in ("k", "v", "k_scale", "v_scale"):
        assert torch.equal(getattr(pool, name), getattr(cold, name)), name
    with pytest.raises(ValueError,
                       match=r"pool/row kv-quant mismatch \(one has int8 "
                             r"scales\)"):
        tdec.paged_insert_row(tdec.init_paged_pool(TCFG, 6, ps,
                                                   device="cpu"),
                              trow, torch.tensor(pages))


@pytest.mark.parametrize("paged", [False, True])
def test_spec_verify_identity_int8(params, paged):
    """Verify rounds over an int8 cache, dense and paged, drafts good one
    round and adversarial the next: JAX's emitted tokens and slot state
    each round (rejected quantized writes are masked, then rewritten)."""
    jp, tp = params
    span, k = 48, 3
    cache, tst, jcache, jst, solo = _slot_batch(
        tp, jp, [8, 16], [7, 12], [12, 10], span, 110)
    if paged:
        ps, mp = 8, span // 8
        pool = tdec.init_paged_pool(TCFG, 2 * mp, ps, kv_quant=True,
                                    device="cpu")
        jpool = jdec.init_paged_pool(JCFG, 2 * mp, ps, kv_quant=True)
        table = np.arange(1, 2 * mp + 1, dtype=np.int32).reshape(2, mp)
        for i in range(2):
            row = tdec.KVCache(cache.k[:, i:i + 1], cache.v[:, i:i + 1], span,
                               k_scale=cache.k_scale[:, i:i + 1],
                               v_scale=cache.v_scale[:, i:i + 1])
            tdec.paged_insert_row(pool, row, _t(table[i]))
            jrow = jdec.KVCache(
                k=jcache.k[:, i:i + 1], v=jcache.v[:, i:i + 1],
                length=jnp.asarray(span, jnp.int32),
                k_scale=jcache.k_scale[:, i:i + 1],
                v_scale=jcache.v_scale[:, i:i + 1])
            jpool = jdec.paged_insert_row(jpool, jrow, jnp.asarray(table[i]))
    emitted = [[], []]
    for rnd in range(4):
        good = np.array([solo[i][len(emitted[i]) + 1:
                                 len(emitted[i]) + 1 + k] for i in range(2)],
                        dtype=object)
        drafts = np.zeros((2, k), np.int32)
        for i in range(2):
            g = list(good[i]) + [0] * (k - len(good[i]))
            drafts[i] = g if rnd % 2 == 0 else [(t + 1) % 256 for t in g]
        if paged:
            tt, tst, _ = tdec.decode_verify_paged(tp, pool, _t(table), tst,
                                                  _t(drafts), TCFG)
            jt, jst, jpool = jdec.decode_verify_paged(
                jp, jpool, jnp.asarray(table), jst, jnp.asarray(drafts), JCFG)
        else:
            tt, tst, _ = tdec.decode_verify_slots(tp, cache, tst, _t(drafts),
                                                  TCFG)
            jt, jst, jcache = jdec.decode_verify_slots(
                jp, jcache, jst, jnp.asarray(drafts), JCFG)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(tst, f).numpy(),
                                          np.asarray(getattr(jst, f)), f)
        for i in range(2):
            emitted[i] += [t for t in tt[i].tolist()][:int(
                (tt[i] != 0).sum())]
    for i in range(2):
        n = len(emitted[i])
        assert emitted[i] == solo[i][1:1 + n]


# -- sizes --------------------------------------------------------------

def test_page_bytes_and_cache_bytes_int8():
    """page_bytes with its scale term equals JAX's; at llama-1b a
    16-position page is 540,672 bytes and an 8 x 2,048 cache 553,648,128
    (int8 K/V and an f32 scale a position and KV head), against
    1,048,576 and 1,073,741,824 in bf16."""
    from tpu_kubernetes_torch.models import CONFIGS

    for t, j in ((TCFG, JCFG), (CONFIGS["llama-1b"],
                                jllama.CONFIGS["llama-1b"])):
        assert (tdec.page_bytes(t, 16, kv_quant=True)
                == jdec.page_bytes(j, 16, kv_quant=True))
    big = CONFIGS["llama-1b"]
    assert tdec.page_bytes(big, 16, kv_quant=True) == 540_672
    assert tdec.page_bytes(big, 16) == 1_048_576
    shape = (big.n_layers, 8, big.n_kv_heads, 2048, big.head_dim)
    int8_bytes = 2 * (np.prod(shape) + 4 * np.prod(shape[:-1]))
    assert int8_bytes == 553_648_128
    assert 2 * 2 * np.prod(shape) == 1_073_741_824
    small = tdec.init_cache(TCFG, 2, 16, kv_quant=True, device="cpu")
    assert (sum(t.numel() * t.element_size() for t in (
        small.k, small.v, small.k_scale, small.v_scale))
        == 2 * tdec.page_bytes(TCFG, 16, kv_quant=True))
