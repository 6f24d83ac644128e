"""The port's speculative verify primitives (``models/decode.py``:
``_verify_accept``, ``decode_verify_slots``, ``decode_verify_paged``, and
decode attention's chunk of ``k + 1`` positions a row) against the JAX
package's on ``llama-test`` in float32, from the same weights (carried
over by ``models.from_jax``) and numpy inputs.

* The plain decode attention at c > 1 against JAX's ``_attend_cache``,
  uniform, ragged and paged (through JAX's ``virtual`` gather): within
  1e-5 (f32 scores and softmax on both sides, summed in their orders).
* ``_verify_accept`` against JAX's on random greedy / draft / state
  triples, with an EOS at every index, budget clips and dead rows:
  exactly equal tokens and state.
* Verify rounds to the end over three rows of mixed widths, dense and
  paged, with perfect, random, partially matching and n-gram drafts:
  every round's emitted tokens and state equal JAX's, the cache within
  1e-6, the tokens equal to each row decoded solo.
* A drained row at the end of the span: its window never lands outside
  its own row (dense, the whole cache equals JAX's, whose out-of-range
  writes drop; paged, every page but the sink).
* The kernel lane's dispatch with decode attention's CUDA wrapper stood
  in for by its plain version: a verify round is one decode-attention
  call a layer with (b, k + 1) limits, never the flash forward."""

import importlib
from dataclasses import replace
from types import SimpleNamespace

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
from tpu_kubernetes_torch.models.speculative import ngram_propose_host

tda = importlib.import_module("tpu_kubernetes_torch.ops.decode_attention")
tfa = importlib.import_module("tpu_kubernetes_torch.ops.flash_attention")

JCFG = replace(jllama.CONFIGS["llama-test"], dtype=jnp.float32)
TCFG = replace(tllama.CONFIGS["llama-test"], dtype=torch.float32)
ATOL = 1e-5                     # f32 attention: summation order, exp ulps
CACHE_TOL = dict(atol=1e-6, rtol=1e-6)
K = 4                           # draft_k of the verify loops
PLENS, WIDTHS, BUDGETS = [6, 11, 9], [8, 16, 16], [9, 4, 6]
PAGE = 8


@pytest.fixture(scope="module")
def params():
    """(JAX params, the same weights as port tensors on the CPU)."""
    jp = jllama.init_params(jax.random.PRNGKey(0), JCFG)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _j(a):
    return jnp.asarray(a)


def _t(a):
    return torch.from_numpy(np.array(a))


# -- decode attention at c > 1 ---------------------------------------------------


def _virtual(pool, table):
    """JAX's ``virtual`` gather (``decode_verify_paged``) in numpy."""
    a = pool[table]                              # (b, mp, kv, ps, d)
    a = a.transpose(0, 2, 1, 3, 4)
    return a.reshape(a.shape[:2] + (-1, a.shape[4]))


@pytest.mark.parametrize("c", [2, 5, 9])
@pytest.mark.parametrize("kind", ["uniform", "ragged", "paged"])
def test_chunk_attention_matches_jax_attend_cache(kind, c):
    """q (b, h, c, d) against a cache with (c,) or per-row (b, c) limits,
    the pad gap of each row and, paged, a shuffled table of 8-position
    pages: the port's plain decode attention and JAX's ``_attend_cache``
    within ATOL."""
    rng = np.random.default_rng(c)
    b, h, kv, S, d = 3, 4, 2, 64, 16
    q = rng.standard_normal((b, h, c, d)).astype(np.float32)
    k = rng.standard_normal((b, kv, S, d)).astype(np.float32)
    v = rng.standard_normal((b, kv, S, d)).astype(np.float32)
    cfg = SimpleNamespace(n_heads=h, n_kv_heads=kv, head_dim=d)
    pl = ps = table = None
    if kind == "uniform":
        limits = (40 + np.arange(c)).astype(np.int64)
    else:
        pos = np.array([S - c, 20, 33])
        limits = pos[:, None] + 1 + np.arange(c)[None, :]
        pl = np.array([16, 3, 9], np.int32)
        ps = np.array([32, 16, 16], np.int32)
    jk, jv = k, v
    if kind == "paged":
        mp = S // PAGE
        table = (rng.permutation(b * mp) + 1).reshape(b, mp).astype(np.int32)
        pool_k = rng.standard_normal((b * mp + 1, kv, PAGE, d)).astype(
            np.float32)
        pool_v = pool_k.copy()
        pool_k[table.reshape(-1)] = k.reshape(b, kv, mp, PAGE, d).transpose(
            0, 2, 1, 3, 4).reshape(-1, kv, PAGE, d)
        pool_v[table.reshape(-1)] = v.reshape(b, kv, mp, PAGE, d).transpose(
            0, 2, 1, 3, 4).reshape(-1, kv, PAGE, d)
        jk, jv = _virtual(pool_k, table), _virtual(pool_v, table)
        k, v = pool_k, pool_v
    want = jdec._attend_cache(cfg, _j(q), _j(jk), _j(jv), _j(limits),
                              None if pl is None else _j(pl),
                              None if ps is None else _j(ps))
    got = tda.decode_attention(
        _t(q), _t(k), _t(v), _t(limits), None if pl is None else _t(pl),
        None if ps is None else _t(ps),
        None if table is None else _t(table))
    assert tuple(got.shape) == (b, h, c, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


# -- _verify_accept ------------------------------------------------------------------


def _state(tok, pos, rem, pl, ps):
    return (jdec.SlotState(*(_j(np.asarray(a, np.int32))
                             for a in (tok, pos, rem, pl, ps))),
            tdec.SlotState(*(_t(np.asarray(a, np.int32))
                             for a in (tok, pos, rem, pl, ps))))


def _assert_state(tst, jst):
    for name in ("tok", "pos", "remaining", "prompt_lengths",
                 "prompt_slots"):
        np.testing.assert_array_equal(getattr(tst, name).numpy(),
                                      np.asarray(getattr(jst, name)),
                                      err_msg=name)


@pytest.mark.parametrize("eos_at", [None, 0, 1, 2, 3, 4])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_verify_accept_matches_jax(seed, eos_at):
    """Random windows over 8 rows whose drafts match a random prefix of
    the target's greedy tokens, budgets from 0 (a dead row) past the
    window, and an EOS placed at index ``eos_at`` of every greedy row (or
    none): the emitted tokens and every state field equal JAX's."""
    rng = np.random.default_rng(seed)
    b, c = 8, K + 1
    greedy = rng.integers(1, 50, (b, c)).astype(np.int32)
    drafts = rng.integers(1, 50, (b, K)).astype(np.int32)
    for i in range(b):
        m = int(rng.integers(0, K + 1))          # the matched prefix
        drafts[i, :m] = greedy[i, :m]
    eos_id = None
    if eos_at is not None:
        eos_id = 99
        greedy[:, eos_at] = eos_id
    rem = rng.integers(0, c + 3, b)
    rem[0], rem[1] = 0, 1                        # a dead row, a last token
    pos = rng.integers(10, 40, b)
    jst, tst = _state(rng.integers(1, 50, b), pos, rem, pos - 3, pos - 1)
    want, jst = jdec._verify_accept(_j(greedy), _j(drafts), jst,
                                    eos_id=eos_id, pad_id=7)
    got = tdec._verify_accept(_t(greedy), _t(drafts), tst, eos_id=eos_id,
                              pad_id=7)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _assert_state(tst, jst)


# -- verify rounds to the end ---------------------------------------------------------


def _prompts():
    return [np.random.default_rng(60 + i).integers(
        0, TCFG.vocab_size, (1, n)).astype(np.int32)
        for i, n in enumerate(PLENS)]


def _solo_refs(jp):
    """Each row decoded alone by JAX at its own width (the tokens every
    speculative schedule must emit)."""
    refs = []
    for i, prompt in enumerate(_prompts()):
        padded = np.pad(prompt, ((0, 0), (0, WIDTHS[i] - PLENS[i])))
        logits, cache = jdec.prefill(jp, _j(padded), JCFG, max_seq=JCFG.max_seq,
                                     lengths=_j(np.array([PLENS[i]],
                                                         np.int32)))
        first = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        toks, _, _, _ = jdec.decode_segment(
            jp, cache, first, jnp.zeros((1,), bool), JCFG,
            steps=BUDGETS[i] - 1)
        refs.append([int(first[0])] + np.asarray(toks)[0].tolist())
    return refs


def _setup(jp, tp, paged):
    """Both frameworks' slot state and cache (dense, or a pool of 8-position
    pages with every row's whole span in the table) holding the three
    prefilled rows. → (JAX state, port state, JAX store, port store, JAX
    table, port table, first tokens)."""
    jrows, trows, firsts = [], [], []
    for i, prompt in enumerate(_prompts()):
        padded = np.pad(prompt, ((0, 0), (0, WIDTHS[i] - PLENS[i])))
        lens = np.array([PLENS[i]], np.int32)
        logits, jrow = jdec.prefill(jp, _j(padded), JCFG,
                                    max_seq=WIDTHS[i], lengths=_j(lens))
        _, trow = tdec.prefill(tp, _t(padded), TCFG, max_seq=WIDTHS[i],
                               lengths=_t(lens))
        jrows.append(jrow)
        trows.append(trow)
        firsts.append(int(np.argmax(np.asarray(logits)[0])))
    w = np.array(WIDTHS)
    jst, tst = _state(firsts, w, np.array(BUDGETS) - 1, PLENS, w)
    n = len(PLENS)
    if not paged:
        jc = jdec.init_cache(JCFG, n, JCFG.max_seq)
        tc = tdec.init_cache(TCFG, n, TCFG.max_seq, device="cpu")
        for i in range(n):
            jc = jdec.cache_insert_row(jc, jrows[i], i)
            tdec.cache_insert_row(tc, trows[i], i)
        return jst, tst, jc, tc, None, None, firsts
    mp = JCFG.max_seq // PAGE
    jpool = jdec.init_paged_pool(JCFG, n * mp + 1, PAGE)
    tpool = tdec.init_paged_pool(TCFG, n * mp + 1, PAGE, device="cpu")
    table = np.arange(1, n * mp + 1, dtype=np.int32).reshape(n, mp)
    for i in range(n):
        pages = table[i, :WIDTHS[i] // PAGE]
        jpool = jdec.paged_insert_row(jpool, jrows[i], _j(pages))
        tdec.paged_insert_row(tpool, trows[i], _t(pages))
    return jst, tst, jpool, tpool, _j(table), _t(table), firsts


def _assert_store(tstore, jstore, paged):
    # paged, the sink page 0 is where colliding frozen writes land: compare
    # the pool's pages 1..n
    lo = 1 if paged else 0
    for name in ("k", "v"):
        np.testing.assert_allclose(
            getattr(tstore, name).numpy()[:, lo:],
            np.asarray(getattr(jstore, name))[:, lo:], **CACHE_TOL,
            err_msg=name)


def _drafts(kind, rnd, refs, collected, rng):
    """A round's (3, K) drafts: the solo continuation (perfect), random
    tokens, the continuation with one token wrong (partial), or n-gram
    lookup and garbage in turns (the reference's loop)."""
    out = np.zeros((len(refs), K), np.int32)
    for i, ref in enumerate(refs):
        n = len(collected[i])
        cont = (ref[n:] + [0] * K)[:K]
        if kind == "perfect":
            out[i] = cont
        elif kind == "random":
            out[i] = rng.integers(0, TCFG.vocab_size, K)
        elif kind == "partial":
            out[i] = cont
            out[i, (rnd + i) % K] = (cont[(rnd + i) % K] + 1) % 256
        elif rnd % 2:
            out[i] = TCFG.vocab_size - 1
        else:
            ctx = _prompts()[i][0].tolist() + collected[i]
            out[i] = ngram_propose_host(ctx, 2, K, collected[i][-1])
    return out


@pytest.mark.parametrize("kind", ["perfect", "random", "partial", "ngram"])
@pytest.mark.parametrize("paged", [False, True])
def test_verify_rounds_match_jax(params, paged, kind):
    """decode_verify_slots / decode_verify_paged round by round to the end
    over three rows of mixed widths: each round's emitted tokens and state
    equal JAX's (the same drafts on both sides), the cache within
    CACHE_TOL; the rows' tokens equal each row decoded solo, and a perfect
    draft emits k + 1 tokens a live row a round until the budget clips."""
    jp, tp = params
    refs = _solo_refs(jp)
    jst, tst, jstore, tstore, jtab, ttab, firsts = _setup(jp, tp, paged)
    collected = [[f] for f in firsts]
    rng = np.random.default_rng(3)
    rnd = 0
    while int(tst.remaining.sum()) > 0:
        assert rnd < 32
        drafts = _drafts(kind, rnd, refs, collected, rng)
        old_pos, old_rem = tst.pos.numpy().copy(), tst.remaining.numpy()
        old_rem = old_rem.copy()
        if paged:
            want, jst, jstore = jdec.decode_verify_paged(
                jp, jstore, jtab, jst, _j(drafts), JCFG, eos_id=None,
                pad_id=0)
            got, _, _ = tdec.decode_verify_paged(tp, tstore, ttab, tst,
                                                 _t(drafts), TCFG)
        else:
            want, jst, jstore = jdec.decode_verify_slots(
                jp, jstore, jst, _j(drafts), JCFG, eos_id=None, pad_id=0)
            got, _, _ = tdec.decode_verify_slots(tp, tstore, tst,
                                                 _t(drafts), TCFG)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=f"round {rnd}")
        _assert_state(tst, jst)
        _assert_store(tstore, jstore, paged)
        emitted = tst.pos.numpy() - old_pos
        if kind == "perfect":
            np.testing.assert_array_equal(
                emitted, np.minimum(K + 1, old_rem))
        for i in range(len(refs)):
            collected[i] += got.numpy()[i, :emitted[i]].tolist()
        rnd += 1
    assert collected == refs


@pytest.mark.parametrize("paged", [False, True])
def test_a_drained_row_window_stays_in_its_own_row(params, paged):
    """A drained row frozen two slots short of the span (its window of
    k + 1 reaches past it) beside live rows: the reference drops the
    writes past the span (dense) or past the table (paged: its gather
    fills, its scatter drops); the port's dense verify writes them to the
    row's own first window slot with the value that slot takes anyway, so
    the whole cache equals JAX's, and its paged verify to the sink page,
    so every other page does: nothing lands on another row's
    positions."""
    jp, tp = params
    jst, tst, jstore, tstore, jtab, ttab, _ = _setup(jp, tp, paged)
    S = JCFG.max_seq
    tok, pos = [5, 6, 7], [S - 2, 16, 16]
    rem, pl, ps = [0, 3, 3], PLENS, WIDTHS
    jst, tst = _state(tok, pos, rem, pl, ps)
    drafts = np.full((3, K), 9, np.int32)
    before = tstore.k.clone()
    if paged:
        _, jst, jstore = jdec.decode_verify_paged(
            jp, jstore, jtab, jst, _j(drafts), JCFG, eos_id=None, pad_id=0)
        tdec.decode_verify_paged(tp, tstore, ttab, tst, _t(drafts), TCFG)
        # row 0 wrote its own last page (slots 126, 127) and the sink
        changed = (tstore.k != before).any(dim=(0, 2, 3, 4)).nonzero()
        pages = {int(p) for p in changed[:, 0]}
        live = set(ttab[1].tolist()) | set(ttab[2].tolist())
        assert pages - live == {0, int(ttab[0, -1])}
    else:
        _, jst, jstore = jdec.decode_verify_slots(
            jp, jstore, jst, _j(drafts), JCFG, eos_id=None, pad_id=0)
        tdec.decode_verify_slots(tp, tstore, tst, _t(drafts), TCFG)
        # row 0 wrote only its last two slots
        changed = (tstore.k[:, 0] != before[:, 0]).any(dim=(0, 1, 3))
        assert changed.nonzero()[:, 0].tolist() == [S - 2, S - 1]
    _assert_state(tst, jst)
    _assert_store(tstore, jstore, paged)


# -- the kernel lane's dispatch ----------------------------------------------------


@pytest.fixture()
def counted(monkeypatch):
    """Decode attention's and the flash forward's CUDA wrappers stood in
    for by their plain versions, recording the limits' shapes."""
    seen = {"decode_attention": [], "flash": 0}

    def dattn(q, k, v, limits, prompt_lengths=None, prompt_slots=None,
              table=None, k_scale=None, v_scale=None):
        seen["decode_attention"].append(tuple(limits.shape))
        return tda.decode_attention_reference(q, k, v, limits,
                                              prompt_lengths, prompt_slots,
                                              table, k_scale, v_scale)

    def fwd(*args, **kw):
        seen["flash"] += 1
        raise AssertionError("a verify round took the flash forward")

    monkeypatch.setattr(tda, "decode_attention_cuda", dattn)
    monkeypatch.setattr(tfa, "flash_fwd_cuda", fwd)
    return seen


@pytest.mark.parametrize("paged", [False, True])
def test_kernel_lane_verify_takes_the_chunk_route(params, counted, paged):
    """On the kernel lane a verify round is one decode-attention call a
    layer with per-row (3, k + 1) limits, dense or through the table, and
    its tokens equal the plain lane's."""
    _, tp = params
    out = {}
    for lane, cfg in (("plain", TCFG), ("kernel",
                                        replace(TCFG, use_kernel=True))):
        _, tst, _, tstore, _, ttab, _ = _setup(params[0], tp, paged)
        drafts = _t(np.full((3, K), 3, np.int32))
        counted["decode_attention"].clear()
        if paged:
            out[lane] = tdec.decode_verify_paged(tp, tstore, ttab, tst,
                                                 drafts, cfg)[0]
        else:
            out[lane] = tdec.decode_verify_slots(tp, tstore, tst, drafts,
                                                 cfg)[0]
    assert counted["decode_attention"] == [(3, K + 1)] * TCFG.n_layers
    assert counted["flash"] == 0
    assert torch.equal(out["kernel"], out["plain"])
