"""The port's paged KV cache against the JAX package's on the CPU.

The primitives of ``models/decode.py`` (``init_paged_pool``,
``paged_insert_row``, ``gather_pages``, ``paged_clear_pages``,
``decode_step_paged``, ``decode_segment_paged``) take the same numpy
weights and rows as ``tpu_kubernetes/models/decode.py``'s and give the
same pools on the usable pages 1..n exactly (the port redirects a clear's
out-of-range padding to the sink page 0, which the reference's scatter
drops; no live row weights the sink), the same logits in float32 and the
same greedy tokens: the reference's tests of ``tests/test_decode.py``,
the round trip, the warm-start ``skip``, the four refusals and the paged
lifecycle with a row admitted mid-stream into recycled pages, re-run
against the port. ``serve/pages.py``'s ``PagePool`` is held to the
reference's on the same sequence of calls."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_kubernetes.models import decode as jdec
from tpu_kubernetes.models import llama as jllama
from tpu_kubernetes.serve.pages import PagePool as JPagePool
from tpu_kubernetes_torch.models import decode as tdec
from tpu_kubernetes_torch.models import llama as tllama
from tpu_kubernetes_torch.models.from_jax import params_from_numpy
from tpu_kubernetes_torch.serve.pages import PagePool

JCFG = replace(jllama.CONFIGS["llama-test"], dtype=jnp.float32)
TCFG = replace(tllama.CONFIGS["llama-test"], dtype=torch.float32)
# float32 through two layers: summation order and transcendental ulps only
LOGIT_TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def params():
    jp = jllama.init_params(jax.random.PRNGKey(0), JCFG)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(
        0, JCFG.vocab_size, (1, n)).astype(np.int32)


def _rows(params, prompt, width, lengths=None):
    """A batch-1 row prefilled by JAX, and the same bytes as the port's row
    (so the pools can be compared exactly) → (JAX row, port row, JAX
    logits)."""
    jl, jrow = jdec.prefill(
        params[0], jnp.asarray(prompt), JCFG, max_seq=width,
        lengths=None if lengths is None else jnp.asarray(lengths))
    trow = tdec.KVCache(torch.from_numpy(np.array(jrow.k)),
                        torch.from_numpy(np.array(jrow.v)), width)
    return jrow, trow, jl


def _assert_pool_equal(tpool, jpool, pages):
    for p in pages:
        np.testing.assert_array_equal(tpool.k[:, p].numpy(),
                                      np.asarray(jpool.k[:, p]))
        np.testing.assert_array_equal(tpool.v[:, p].numpy(),
                                      np.asarray(jpool.v[:, p]))


def test_page_bytes_and_cold_pool_equal_jax():
    assert tdec.page_bytes(TCFG, 16) == jdec.page_bytes(JCFG, 16)
    tbf = tllama.CONFIGS["llama-1b"]
    assert tdec.page_bytes(tbf, 16) == jdec.page_bytes(
        jllama.CONFIGS["llama-1b"], 16) == 2 ** 20
    tpool = tdec.init_paged_pool(TCFG, 8, 8, device="cpu")
    jpool = jdec.init_paged_pool(JCFG, 8, 8)
    assert tuple(tpool.k.shape) == jpool.k.shape
    _assert_pool_equal(tpool, jpool, range(9))
    for bad, match in (((0, 8), "num_pages"), ((4, 0), "page_size")):
        with pytest.raises(ValueError, match=match):
            tdec.init_paged_pool(TCFG, *bad, device="cpu")
        with pytest.raises(ValueError, match=match):
            jdec.init_paged_pool(JCFG, *bad)


def test_paged_insert_gather_clear_roundtrip(params):
    """paged_insert_row then gather_pages gives the inserted row back
    exactly; the insert touches only its pages; a clear through a PADDED
    page list wipes them back to cold: the pools equal JAX's on pages
    1..n at every stage."""
    jrow, trow, _ = _rows(params, _prompt(70, 16), 16)
    jpool = jdec.init_paged_pool(JCFG, 8, 8)
    tpool = tdec.init_paged_pool(TCFG, 8, 8, device="cpu")
    jpool = jdec.paged_insert_row(jpool, jrow, jnp.asarray([3, 5], jnp.int32))
    k_before = tpool.k
    assert tdec.paged_insert_row(tpool, trow, torch.tensor([3, 5])).k \
        is k_before                                 # in place
    _assert_pool_equal(tpool, jpool, range(1, 9))
    for other in (0, 1, 2, 4, 6, 7, 8):
        assert not tpool.k[:, other].any() and not tpool.v[:, other].any()
    got = tdec.gather_pages(tpool, torch.tensor([3, 5], dtype=torch.int32))
    assert got.length == 16
    assert torch.equal(got.k, trow.k) and torch.equal(got.v, trow.v)
    jgot = jdec.gather_pages(jpool, jnp.asarray([3, 5], jnp.int32))
    np.testing.assert_array_equal(got.k.numpy(), np.asarray(jgot.k))
    # padded clear: the sentinels (>= n_pages + 1) go to the sink
    pad = [3, 5, 99, 99]
    jpool = jdec.paged_clear_pages(jpool, jnp.asarray(pad, jnp.int32))
    tdec.paged_clear_pages(tpool, torch.tensor(pad))
    _assert_pool_equal(tpool, jpool, range(1, 9))
    assert not tpool.k.any() and not tpool.v.any()


def test_paged_insert_skip_never_writes_shared_pages(params):
    """An insert with ``skip`` leaves the skipped (shared) pages untouched
    and scatters the suffix pages exactly as a full insert does."""
    jrow, trow, _ = _rows(params, _prompt(71, 32), 32)
    full = tdec.paged_insert_row(
        tdec.init_paged_pool(TCFG, 8, 8, device="cpu"), trow,
        torch.tensor([1, 2, 3, 4]))
    warm = tdec.paged_insert_row(
        tdec.init_paged_pool(TCFG, 8, 8, device="cpu"), trow,
        torch.tensor([5, 6, 3, 4]), skip=16)
    jwarm = jdec.paged_insert_row(
        jdec.init_paged_pool(JCFG, 8, 8), jrow,
        jnp.asarray([5, 6, 3, 4], jnp.int32), skip=16)
    for p in (3, 4):
        assert torch.equal(warm.k[:, p], full.k[:, p])
        assert torch.equal(warm.v[:, p], full.v[:, p])
    for p in (5, 6):
        assert not warm.k[:, p].any() and not warm.v[:, p].any()
    _assert_pool_equal(warm, jwarm, range(1, 9))


def test_paged_insert_refusals_match_jax(params):
    """The four refusals, with the reference's messages: a width that is
    not the pages' span, a batch of two rows, an unaligned skip, and a
    row of another kind (the reference's int8 rows; here another dtype)."""
    jp = params[0]
    jrow, trow, _ = _rows(params, _prompt(72, 16), 16)
    tpool = tdec.init_paged_pool(TCFG, 4, 8, device="cpu")
    jpool = jdec.init_paged_pool(JCFG, 4, 8)
    two = [1, 2]
    cases = [("pages x page_size", trow, jrow, [1], 0),
             ("page-aligned", trow, jrow, two, 4)]
    jwide, twide, _ = _rows(params, np.tile(_prompt(72, 16), (2, 1)), 16)
    cases.append(("batch-1", twide, jwide, two, 0))
    for match, t, j, pages, skip in cases:
        with pytest.raises(ValueError, match=match):
            tdec.paged_insert_row(tpool, t, torch.tensor(pages), skip=skip)
        with pytest.raises(ValueError, match=match):
            jdec.paged_insert_row(jpool, j, jnp.asarray(pages, jnp.int32),
                                  skip=skip)
    _, jq = jdec.prefill(jp, jnp.asarray(_prompt(72, 16)), JCFG, max_seq=16,
                         kv_quant=True)
    with pytest.raises(ValueError, match="kv-quant mismatch"):
        jdec.paged_insert_row(jpool, jq, jnp.asarray(two, jnp.int32))
    bf = tdec.KVCache(trow.k.bfloat16(), trow.v.bfloat16(), 16)
    with pytest.raises(ValueError, match="kv-quant mismatch"):
        tdec.paged_insert_row(tpool, bf, torch.tensor(two))


def _paged_batch(params, ps, steps):
    """The same two admitted rows on both sides (slots 0 and 2 of 3), in
    pools of 32 pages of ``ps``, each row's table covering its prompt and
    ``steps`` more positions with shuffled pages (the rest on the sink)
    → (JAX pool, JAX table, JAX state, port pool, port table, port
    state)."""
    mp = JCFG.max_seq // ps
    jpool = jdec.init_paged_pool(JCFG, 32, ps)
    tpool = tdec.init_paged_pool(TCFG, 32, ps, device="cpu")
    table = np.zeros((3, mp), np.int32)
    st = np.zeros((5, 3), np.int32)
    pages = list(np.random.default_rng(ps).permutation(np.arange(1, 33)))
    for slot, (plen, width, seed) in ((0, (11, 16, 80)), (2, (6, 8, 81))):
        prompt = np.zeros((1, width), np.int32)
        prompt[0, :plen] = _prompt(seed, plen)
        jrow, trow, jl = _rows(params, prompt, width,
                               np.array([plen], np.int32))
        n = width // ps
        mine = np.array([pages.pop() for _ in range(-(-(width + steps)
                                                       // ps))], np.int32)
        jpool = jdec.paged_insert_row(jpool, jrow, jnp.asarray(mine[:n]))
        tdec.paged_insert_row(tpool, trow, torch.from_numpy(mine[:n]))
        table[slot, :len(mine)] = mine
        st[:, slot] = (int(np.argmax(np.asarray(jl)[0])), width, 6, plen,
                       width)
    return (jpool, jnp.asarray(table), jdec.SlotState(*map(jnp.asarray, st)),
            tpool, torch.from_numpy(table),
            tdec.SlotState(*(torch.from_numpy(a.copy()) for a in st)))


@pytest.mark.parametrize("ps", [4, 8])
def test_decode_step_paged_logits_and_pool_match_jax(params, ps):
    jp, tp = params
    jpool, jtab, jst, tpool, ttab, tst = _paged_batch(params, ps, 1)
    jl, jpool = jdec.decode_step_paged(jp, jpool, jtab, jst, JCFG)
    tl, tpool2 = tdec.decode_step_paged(tp, tpool, ttab, tst, TCFG)
    assert tpool2.k is tpool.k                        # written in place
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    for p in range(1, 33):
        np.testing.assert_allclose(tpool.k[:, p].numpy(),
                                   np.asarray(jpool.k[:, p]), **LOGIT_TOL)
        np.testing.assert_allclose(tpool.v[:, p].numpy(),
                                   np.asarray(jpool.v[:, p]), **LOGIT_TOL)


def test_decode_segment_paged_equals_jax_and_the_dense_slots(params):
    """Six paged steps: the same tokens and slot state as JAX's, and the
    same logits-derived tokens as the port's dense slot engine on the same
    rows (its attention reads the same positions)."""
    jp, tp = params
    jpool, jtab, jst, tpool, ttab, tst = _paged_batch(params, 8, 6)
    jt, jst, _ = jdec.decode_segment_paged(jp, jpool, jtab, jst, JCFG, 6)
    dense_st = tdec.SlotState(*(getattr(tst, f).clone()
                                for f in jdec.SlotState._fields))
    cache = tdec.init_cache(TCFG, 3, TCFG.max_seq, device="cpu")
    for slot in (0, 2):
        row = tdec.gather_pages(tpool, ttab[slot])
        tdec.cache_insert_row(cache, row, slot)
    tt, tst, _ = tdec.decode_segment_paged(tp, tpool, ttab, tst, TCFG, 6)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    for name in jdec.SlotState._fields:
        np.testing.assert_array_equal(getattr(tst, name).numpy(),
                                      np.asarray(getattr(jst, name)),
                                      err_msg=name)
    dt, _, _ = tdec.decode_segment_slots(tp, cache, dense_st, TCFG, 6)
    assert torch.equal(dt, tt)


def test_paged_decode_identity_with_solo_decode(params):
    """The reference's lifecycle test, on the port and on JAX side by
    side: rows decoded through a page table emit exactly the tokens each
    emits decoded solo, including a row admitted MID-STREAM into the
    pages just recycled from a drained row (cleared, then reused in
    another slot)."""
    jp, tp = params
    ps = 8
    max_pages = JCFG.max_seq // ps
    plens, widths, budgets = [6, 11, 9], [8, 16, 16], [9, 4, 6]
    prompts = [_prompt(80 + i, n) for i, n in enumerate(plens)]

    refs = []
    for i in range(3):
        padded = np.zeros((1, widths[i]), np.int32)
        padded[0, :plens[i]] = prompts[i][0]
        out = tdec.generate(tp, torch.from_numpy(padded), TCFG, budgets[i],
                            prompt_lengths=torch.tensor([plens[i]],
                                                        dtype=torch.int32))
        refs.append(out[0].tolist())

    rows, firsts = [], []
    for i in range(3):
        padded = np.zeros((1, widths[i]), np.int32)
        padded[0, :plens[i]] = prompts[i][0]
        jrow, trow, jl = _rows(params, padded, widths[i],
                               np.array([plens[i]], np.int32))
        rows.append((jrow, trow))
        firsts.append(int(np.argmax(np.asarray(jl)[0])))

    jpool = jdec.init_paged_pool(JCFG, 32, ps)
    tpool = tdec.init_paged_pool(TCFG, 32, ps, device="cpu")
    table = np.zeros((4, max_pages), np.int32)
    st = np.zeros((5, 4), np.int32)

    def admit(jpool, i, slot, pages):
        n = widths[i] // ps
        jpool = jdec.paged_insert_row(jpool, rows[i][0],
                                      jnp.asarray(pages[:n], jnp.int32))
        tdec.paged_insert_row(tpool, rows[i][1], torch.tensor(pages[:n]))
        table[slot, :len(pages)] = pages
        st[:, slot] = (firsts[i], widths[i], budgets[i] - 1, plens[i],
                       widths[i])
        return jpool

    run0, run1 = list(range(1, 17)), list(range(17, 33))
    jpool = admit(jpool, 0, 2, run0)
    jpool = admit(jpool, 1, 0, run1)
    collected = {0: [firsts[0]], 1: [firsts[1]]}
    slot_of = {0: 2, 1: 0}
    admitted_third = False
    while True:
        jst = jdec.SlotState(*map(jnp.asarray, st))
        tst = tdec.SlotState(*(torch.from_numpy(a.copy()) for a in st))
        jt, jst, jpool = jdec.decode_segment_paged(
            jp, jpool, jnp.asarray(table), jst, JCFG, steps=3)
        tt, tst, _ = tdec.decode_segment_paged(
            tp, tpool, torch.from_numpy(table), tst, TCFG, 3)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        new = np.stack([getattr(tst, f).numpy()
                        for f in jdec.SlotState._fields])
        for name, a in zip(jdec.SlotState._fields, new):
            np.testing.assert_array_equal(a, np.asarray(getattr(jst, name)))
        toks = tt.numpy()
        for i, s in slot_of.items():
            collected[i].extend(toks[s][:new[1, s] - st[1, s]].tolist())
        st[:] = new
        if not admitted_third and st[2, slot_of[1]] <= 0:
            table[slot_of[1], :] = 0
            jpool = jdec.paged_clear_pages(jpool, jnp.asarray(run1, jnp.int32))
            tdec.paged_clear_pages(tpool, torch.tensor(run1))
            jpool = admit(jpool, 2, 3, run1)
            collected[2] = [firsts[2]]
            slot_of[2] = 3
            admitted_third = True
            continue
        if admitted_third and st[2].max() <= 0:
            break
    for i in range(3):
        assert collected[i] == refs[i], f"paged row {i} diverged"
    np.testing.assert_allclose(tpool.k[:, 1:].numpy(),
                               np.asarray(jpool.k[:, 1:]), **LOGIT_TOL)


# -- the host's page accounting ---------------------------------------------


def _pool_calls(pool):
    """One lifecycle on either PagePool → what each call returned."""
    out = [pool.allocate(3), pool.allocate(2), pool.stats()]
    a, b = out[0], out[1]
    pool.ref(a[:2])                       # a second reader of two pages
    out.append(pool.release(a))           # only a[2] frees
    pool.pin(a[:1])                       # a store owns a[0]
    out += [pool.stats(), pool.release(a[:2]), pool.stats()]
    out += [pool.allocate(9), pool.stats()]      # more than free: a stall
    out += [pool.unpin(a[:1]), pool.release(b), pool.stats(),
            pool.free_count()]
    return out


def test_page_pool_equals_the_reference_and_conserves():
    """The same calls on the port's PagePool and the reference's: the same
    pages, the same frees (FIFO reuse) and stats, free + live + pinned ==
    total at every step."""
    got, want = _pool_calls(PagePool(8)), _pool_calls(JPagePool(8))
    assert got == want
    for s in (x for x in got if isinstance(x, dict)):
        assert s["free"] + s["live"] + s["pinned"] == s["total"] == 8
    assert got[-1] == 8 and got[-2]["stalls"] == 1


def test_page_pool_refcounts_and_pins_refuse_misuse():
    pool = PagePool(4)
    with pytest.raises(ValueError, match=">= 1 page"):
        PagePool(0)
    with pytest.raises(ValueError, match="cannot allocate -1"):
        pool.allocate(-1)
    pages = pool.allocate(2)
    assert pages == [1, 2] and pool.allocate(3) is None
    assert pool.stats()["stalls"] == 1
    with pytest.raises(RuntimeError, match="non-resident page 3"):
        pool.pin([3])
    pool.pin(pages)
    assert pool.release(pages) == []      # pinned: kept off the free list
    assert pool.stats() == {"total": 4, "free": 2, "live": 0, "pinned": 2,
                            "stalls": 1}
    with pytest.raises(RuntimeError, match="below zero"):
        pool.release([1])
    assert pool.unpin(pages) == [1, 2]
    assert pool.allocate(4) == [3, 4, 1, 2]     # FIFO reuse
