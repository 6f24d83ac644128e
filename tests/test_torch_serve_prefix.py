"""The port's prefix cache in the server (``SERVE_PREFIX_CACHE_MB``)
against the JAX package's on the CPU, in float32, from the JAX server's
weights: the warm/cold identity matrix of ``tests/test_serve_prefix.py``
(a cold fill, an exact re-ask, an extension, a diverging sibling) and the
warm cases
of ``tests/test_serve_continuous.py`` on the solo lane, the round
batcher, the streamed path, the dense slot engine and the paged engine,
each equal to the JAX cache-free server's response; the hit / partial /
miss counts; LRU eviction under the byte cap, equal to the JAX store's;
``/healthz``'s ``prefix_cache``; the paged engine's store (pinned pages
referenced by warm admissions, unpinned and wiped on eviction, pages
conserved); a stored segment left unchanged by the next prefill into
the same program's cache; and a closed paged engine with a store freed by
reference count (the store reaches its engine weakly)."""

import gc
import http.client
import json
import threading
import time
import weakref

import jax
import numpy as np
import pytest
import torch

from tpu_kubernetes.models import llama as jllama
from tpu_kubernetes.serve.server import ServingState as JState
from tpu_kubernetes_torch.models.from_jax import params_from_numpy
from tpu_kubernetes_torch.serve import job as tjob
from tpu_kubernetes_torch.serve import server as tserver
from tests.torch_ops_support import keep_jax_ledger  # noqa: F401 — autouse
from tests.torch_ops_support import black_box_dirs  # noqa: F401 — autouse

ENV = {
    "SERVE_MODEL": "llama-test",
    "SERVE_MAX_NEW": "16",
    "SERVE_DTYPE": "float32",    # bf16 ties could break exact-id comparisons
}
# >= MIN_PREFIX_TOKENS bytes, so completions are stored; long enough that
# the matched prefix floors to a useful power of two (43 → 32)
PROMPT = "the quick brown fox jumps over the lazy dog"
EXTENSION = PROMPT + " and never looks back"        # extends it: a hit
PARTIAL = "the quick brown fox jumps over the lazy cat"  # diverges at 40
PROMPTS = [
    PROMPT,                                          # bucket 64
    "pack my box",                                   # bucket 16
    "sphinx of black quartz judge my vow",           # bucket 64
    "jived fox nymph grabs quick waltz",             # bucket 64
]
BUDGETS = [12, 3, 5, 8]
ENGINE = dict(SERVE_CONTINUOUS_BATCHING="1", SERVER_BATCH="4")
# llama-test in float32: a 16-position page is 8 KiB, 0.5 MB 64 pages
PAGED = dict(ENGINE, SERVE_KV_POOL_MB="0.5", SERVE_KV_PAGE_SIZE="16")


def _jax_weights(cfg, generator, device):
    """Stands in for the port's init_params: the JAX server's weights."""
    jp = jllama.init_params(jax.random.PRNGKey(0),
                            jllama.CONFIGS["llama-test"])
    return params_from_numpy(jax.tree.map(np.asarray, jp), device=device)


def _torch_state(**extra):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tjob, "init_params", _jax_weights)
        st = tserver.ServingState(dict(ENV, SERVE_DEVICE="cpu", **extra))
    st.warm()
    return st


@pytest.fixture(scope="module")
def jax_solo():
    """The JAX server without a prefix cache and without early exit: the
    run-to-max reference every identity test compares against."""
    st = JState(dict(ENV, SERVE_EARLY_EXIT_STEPS="0"))
    st.warm()
    return st


@pytest.fixture(scope="module")
def warm():
    return _torch_state(SERVE_PREFIX_CACHE_MB="8")


def _settle(pred, timeout=10.0):
    """A row's event fires before its slot is cleared: poll briefly."""
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.005)
    assert pred()


def _fan_out(state, prompts, budgets):
    """Every request from its own thread: one mixed, staggered batch."""
    outs = [None] * len(prompts)

    def worker(i):
        outs[i] = state.complete(prompts[i], max_new_tokens=budgets[i])

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    return outs


def _conserved(state):
    """Wait until no row is resident; the pool's partition sums to its
    size, and no page is live → the pages partition."""
    eng = state._engine
    _settle(lambda: eng.stats()["occupied"] == 0)
    pages = eng.stats()["pages"]
    assert pages["free"] + pages["live"] + pages["pinned"] == pages["total"]
    assert pages["live"] == 0
    return pages


def _identity_matrix(state, jax_solo):
    """Cold fill, exact re-ask and extension (hits), a sibling diverging
    inside the stored prompt (a partial): each equal to the JAX cache-free
    server's response."""
    for prompt in (PROMPT, PROMPT, EXTENSION, PARTIAL):
        assert (state.complete(prompt, max_new_tokens=8)
                == jax_solo.complete(prompt, max_new_tokens=8)), prompt


# -- the solo lane -------------------------------------------------------------


def test_warm_prefix_identity_with_cold_prefill(jax_solo, warm):
    """The identity matrix on the solo lane; the re-ask, the extension and
    the sibling resume warm (their program's key), from 32 reused
    positions."""
    lookups = dict(warm.greedy.prefix_lookups)
    _identity_matrix(warm, jax_solo)
    assert warm.prefix_cache.stats()["entries"] >= 1
    got = warm.greedy.prefix_lookups
    assert {k: got[k] - lookups[k] for k in got} == {
        "miss": 1, "hit": 2, "partial": 1}
    assert ("prefill_warm", 1, 32, 64, 72) in warm.greedy.programs.captures
    # the extension REPLACED the shorter entry
    q, entry = warm.prefix_cache.lookup(warm.encode(EXTENSION))
    assert q == len(entry.ids) == len(warm.encode(EXTENSION))


def test_prefix_cache_counts_hit_partial_miss(warm):
    """"miss" for a prompt nothing shares 16 tokens with, "partial" for a
    sibling that diverges inside the stored prompt, "hit" for a prompt
    that extends a stored one."""
    before = dict(warm.greedy.prefix_lookups)
    warm.complete("completely unrelated prompt text", max_new_tokens=2)
    warm.complete("completely unrelated prompt but different tail",
                  max_new_tokens=2)
    warm.complete("completely unrelated prompt text, extended",
                  max_new_tokens=2)
    got = warm.greedy.prefix_lookups
    assert {k: got[k] - before[k] for k in got} == {
        "miss": 1, "partial": 1, "hit": 1}


def test_short_prompts_are_neither_stored_nor_reused(warm):
    """Below MIN_PREFIX_TOKENS a prompt is not stored, and a match below it
    is not reused: the prompt prefills cold."""
    entries = warm.prefix_cache.stats()["entries"]
    warm.complete("pack my box", max_new_tokens=2)           # 11 tokens
    assert warm.prefix_cache.stats()["entries"] == entries
    assert tserver._pow2_floor(15) == 0
    assert [tserver._pow2_floor(n) for n in (16, 31, 32, 63, 64)] == [
        16, 16, 32, 32, 64]


def test_streamed_and_batched_requests_resume_warm(jax_solo):
    """A streamed request and a round-batched one of a stored prompt
    prefill warm (the round's b identical rows through one program) and
    answer as the JAX cache-free server does."""
    st = _torch_state(SERVE_PREFIX_CACHE_MB="8", SERVER_BATCH="4")
    ref = jax_solo.complete(EXTENSION, max_new_tokens=8)
    assert st.complete(PROMPT, max_new_tokens=8) == jax_solo.complete(
        PROMPT, max_new_tokens=8)
    assert st.complete(EXTENSION, max_new_tokens=8) == ref
    assert ("prefill_warm", 4, 32, 64, 72) in st.greedy.programs.captures
    finish = {}
    streamed = "".join(st.stream(PROMPT + " again", max_new_tokens=8,
                                 finish=finish))
    assert streamed == jax_solo.complete(PROMPT + " again",
                                         max_new_tokens=8)["text"]
    assert ("prefill_warm", 1, 32, 64, 72) in st.greedy.programs.captures
    # a mixed round prefills cold and stores every row's prompt
    outs = _fan_out(st, PROMPTS, BUDGETS)
    assert outs == [jax_solo.complete(p, max_new_tokens=b)
                    for p, b in zip(PROMPTS, BUDGETS)]
    for p in PROMPTS:
        ids = st.encode(p)
        if len(ids) >= tserver.MIN_PREFIX_TOKENS:
            assert st.prefix_cache.lookup(ids)[0] == len(ids)


def test_lru_eviction_keeps_bytes_under_cap_like_the_jax_store():
    """A 0.05 MB cap holds two 48-position segments: the oldest prompts are
    evicted, the bytes stay under the cap and equal the stored tensors'
    bytes, and the port's store keeps the entries the JAX store keeps."""
    st = _torch_state(SERVE_PREFIX_CACHE_MB="0.05")
    jst = JState(dict(ENV, SERVE_PREFIX_CACHE_MB="0.05"))
    jst.warm()
    prompts = [f"{i} eviction probe padded out to fill its own bucket"
               for i in range(4)]
    for p in prompts:
        st.complete(p, max_new_tokens=2)
        jst.complete(p, max_new_tokens=2)
    stats, jstats = st.prefix_cache.stats(), jst.prefix_cache.stats()
    assert 1 <= stats["entries"] < 4
    assert stats["bytes"] <= stats["max_bytes"]
    assert {k: stats[k] for k in ("entries", "bytes", "max_bytes")} == {
        k: jstats[k] for k in ("entries", "bytes", "max_bytes")}
    assert st.prefix_cache.lookup(st.encode(prompts[0]))[1] is None
    q, entry = st.prefix_cache.lookup(st.encode(prompts[-1]))
    assert entry is not None and q == len(entry.ids)
    assert stats["bytes"] == sum(
        a.numel() * a.element_size()
        for e in st.prefix_cache._entries.values()
        for a in e.arrays.values())
    for p in prompts:
        assert ((st.prefix_cache.lookup(st.encode(p))[1] is None)
                == (jst.prefix_cache.lookup(jst.encode(p))[1] is None))


def test_stored_segment_survives_the_next_prefill(warm):
    """The store keeps clones: the next prefill into the same program's
    cache (same width and span) leaves a stored segment as it was, and
    the segment is what a fresh prefill of its prompt computes."""
    prompt = "a stored segment must outlive the next prefill"
    ids = warm.encode(prompt)
    warm.complete(prompt, max_new_tokens=8)                 # cold, stored
    q, entry = warm.prefix_cache.lookup(ids)
    assert q == len(ids) == len(entry.ids)
    kept = {k: a.clone() for k, a in entry.arrays.items()}
    slots = warm.greedy.slots(1, 64, 72)
    assert entry.arrays["k"].data_ptr() != slots.cache.k.data_ptr()
    warm.complete("z" * 46, max_new_tokens=8)      # same width, same span
    for k, a in entry.arrays.items():
        assert torch.equal(a, kept[k])
    assert not torch.equal(slots.cache.k[:, :, :, :len(ids)],
                           kept["k"][:, :, :, :len(ids)])
    fresh = warm.greedy.prefill(tserver._pad_rows([ids], 64),
                                torch.tensor([len(ids)], dtype=torch.int32),
                                72)
    assert torch.equal(fresh.cache.k[:, :, :, :len(ids)], kept["k"])
    assert torch.equal(fresh.cache.v[:, :, :, :len(ids)], kept["v"])


def test_warm_cache_outside_the_real_slots_is_a_cold_one(warm):
    """After a warm prefill the slots past the width are zeros, as after a
    cold one, and the prefix positions are the stored segment's."""
    ids = warm.encode(EXTENSION)
    warm.complete(PROMPT, max_new_tokens=8)
    q, entry = warm.greedy.prefix_lookup(ids)
    st = warm.greedy.prefill_warm(
        tserver._pad_rows([ids], 64),
        torch.tensor([len(ids)], dtype=torch.int32),
        entry.arrays["k"], entry.arrays["v"], q, 72)
    assert not st.cache.k[:, :, :, 64:].any()
    assert not st.cache.v[:, :, :, 64:].any()
    assert torch.equal(st.cache.k[:, :, :, :q], entry.arrays["k"][..., :q, :])
    assert st.cache.prompt_slots == 64 and st.length == 64
    assert st.lengths.tolist() == [len(ids)]
    with pytest.raises(ValueError, match="0 < q < width"):
        warm.greedy.prefill_warm(tserver._pad_rows([ids], 64),
                                 torch.tensor([len(ids)], dtype=torch.int32),
                                 entry.arrays["k"], entry.arrays["v"], 64, 72)


# -- the slot engines ----------------------------------------------------------


def test_continuous_identity_warm_prefix(jax_solo):
    """A prefix hit lands in a dense slot through the lane's policy point:
    warm rows, alone and co-resident with cold ones in a mixed batch,
    answer as the JAX cache-free server."""
    st = _torch_state(SERVE_PREFIX_CACHE_MB="8", **ENGINE)
    _identity_matrix(st, jax_solo)
    assert st.greedy.prefix_lookups["hit"] >= 1
    assert ("prefill_warm", 1, 32, 64, 64) in st.greedy.programs.captures
    outs = _fan_out(st, PROMPTS, BUDGETS)
    assert outs == [jax_solo.complete(p, max_new_tokens=b)
                    for p, b in zip(PROMPTS, BUDGETS)]
    st._engine.close()


def test_paged_identity_warm_prefix(jax_solo):
    """The paged engine's own store: an admitted prompt's whole pages are
    pinned; a warm admission references them and scatters only the
    suffix's pages; warm and cold rows answer as the JAX cache-free server,
    and the pool's pages are conserved."""
    st = _torch_state(SERVE_PREFIX_CACHE_MB="8", **PAGED)
    eng = st._engine
    assert st.complete(PROMPT, max_new_tokens=8) == jax_solo.complete(
        PROMPT, max_new_tokens=8)
    _settle(lambda: len(eng._prefix) == 1)
    pages = _conserved(st)
    assert pages["pinned"] == 2 and pages["prefix_entries"] == 1
    # the lane's byte store is the solo paths' alone
    assert st.prefix_cache.stats()["entries"] == 0
    _identity_matrix(st, jax_solo)
    assert st.greedy.prefix_lookups["hit"] >= 1
    # 32 reused positions: two shared pages skipped by the scatter
    keys = st.greedy.programs.captures
    assert ("paged_insert", 64, 32) in keys
    assert ("prefill_warm", 1, 32, 64, 64) in keys
    outs = _fan_out(st, PROMPTS, BUDGETS)
    assert outs == [jax_solo.complete(p, max_new_tokens=b)
                    for p, b in zip(PROMPTS, BUDGETS)]
    pages = _conserved(st)
    assert pages["pinned"] > 0
    eng.close()


def test_warm_admission_references_pinned_pages(jax_solo):
    """While a warm row is resident its table starts with the store's
    pinned pages (referenced, not copied); when it retires they stay
    pinned."""
    st = _torch_state(SERVE_PREFIX_CACHE_MB="8", **PAGED)
    eng = st._engine
    st.complete(PROMPT, max_new_tokens=2)
    _settle(lambda: len(eng._prefix) == 1)
    stored = list(next(iter(eng._prefix._entries.values())).pages)
    # hold the scheduler back after the admission, before its segment
    gate, inner = threading.Event(), eng._run_segment

    def run():
        gate.wait(30)
        inner()

    eng._run_segment = run           # the scheduler calls it by attribute
    e = eng.enqueue(st.encode(EXTENSION), 16)
    assert e["dispatched"].wait(30)
    slot = eng._entries.index(e)
    assert eng._slot_pages[slot][:2] == stored
    assert eng._table[slot, :2].tolist() == stored
    assert eng._pages._refs[stored[0]] == 1 and stored[0] in eng._pages._pinned
    gate.set()
    assert e["event"].wait(60)
    want = jax_solo.complete(EXTENSION, max_new_tokens=16)
    assert st.decode_text(tserver._Batcher.result(e)) == want["text"]
    pages = _conserved(st)
    assert set(stored) <= set(eng._pages._pinned)
    assert pages["pinned"] == len(eng._pages._pinned)
    eng.close()


def test_paged_store_eviction_unpins_and_wipes():
    """A cap of 24 KiB holds one two-page entry: storing a second prompt
    evicts the first, whose pages are unpinned, wiped to zeros and freed;
    free + live + pinned == total throughout."""
    st = _torch_state(SERVE_PREFIX_CACHE_MB=str(24 / 1024), **PAGED)
    eng = st._engine
    st.complete(PROMPT, max_new_tokens=2)
    _settle(lambda: len(eng._prefix) == 1)
    first = list(next(iter(eng._prefix._entries.values())).pages)
    assert _conserved(st)["pinned"] == 2
    assert eng._pool.k[:, first].abs().sum() > 0
    st.complete("another prompt of more than thirty-two bytes",
                max_new_tokens=2)
    _settle(lambda: not set(first) & set(eng._pages._pinned))
    pages = _conserved(st)
    assert pages["pinned"] == 2 and pages["prefix_entries"] == 1
    assert set(first) <= set(eng._pages._free)
    assert not eng._pool.k[:, first].any()
    assert not eng._pool.v[:, first].any()
    eng.close()


def test_pool_pressure_reclaims_the_store_first(jax_solo):
    """With a pool of 8 pages (one full row), the store's pinned pages are
    reclaimed before an admission waits on live rows; responses stay the
    JAX cache-free server's and pages are conserved."""
    st = _torch_state(SERVE_PREFIX_CACHE_MB="8", **dict(
        PAGED, SERVE_KV_POOL_MB=str(8 * 8192 / 2 ** 20)))
    eng = st._engine
    assert eng._pages.total == 8
    for p, b in ((PROMPT, 8), (PROMPTS[2], 8), (PROMPTS[3], 8)):
        assert st.complete(p, max_new_tokens=b) == jax_solo.complete(
            p, max_new_tokens=b)
    pages = _conserved(st)
    assert pages["stalls"] > 0
    assert pages["pinned"] == 2 * len(eng._prefix)
    eng.close()


# -- HTTP -----------------------------------------------------------------------


@pytest.fixture(scope="module")
def prefix_server():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tjob, "init_params", _jax_weights)
        srv = tserver.make_server(dict(
            ENV, SERVE_DEVICE="cpu", SERVER_HOST="127.0.0.1",
            SERVER_PORT="0", SERVE_PREFIX_CACHE_MB="8"))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield srv
    srv.shutdown()
    srv.server_close()
    thread.join(timeout=10)


def _request(server, method, path, body=None):
    host, port = server.server_address[:2]
    conn = http.client.HTTPConnection(host, port, timeout=60)
    conn.request(method, path,
                 body=None if body is None else json.dumps(body),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, json.loads(data)


def test_http_healthz_carries_prefix_cache(jax_solo, prefix_server):
    """Cold, hit and partial prompts over HTTP answer as the JAX cache-free
    server; /healthz carries the store's stats, its signature and the
    lookups by outcome."""
    for prompt in (PROMPT, PROMPT, PARTIAL):
        status, body = _request(prefix_server, "POST", "/v1/completions",
                                {"prompt": prompt, "max_tokens": 8})
        assert status == 200
        assert body["text"] == jax_solo.complete(prompt,
                                                 max_new_tokens=8)["text"]
    status, health = _request(prefix_server, "GET", "/healthz")
    assert status == 200
    pc = health["prefix_cache"]
    assert pc["sig"] == ["llama-test", "float32", False]
    assert pc["max_bytes"] == 8 * 2 ** 20
    assert pc["entries"] == 2 and 0 < pc["bytes"] <= pc["max_bytes"]
    assert pc["lookups"] == {"miss": 1, "hit": 1, "partial": 1}


def test_knob_is_read_not_refused():
    assert "SERVE_PREFIX_CACHE_MB" not in tserver.LATER_KNOBS
    st = _torch_state()
    assert st.prefix_cache is None and st.greedy.prefix is None
    assert st.complete(PROMPT, max_new_tokens=2)["tokens"] == 2
    assert st.greedy.prefix_lookups == {"hit": 0, "partial": 0, "miss": 0}


def test_closed_paged_engine_with_a_store_dies_by_reference_count():
    """The paged store's eviction callback holds its engine weakly: a
    closed engine and its lane (whose graphs a later garbage collection
    must never destroy) go at their last reference, with no collection."""
    from tpu_kubernetes_torch.models import CONFIGS, init_params
    from tpu_kubernetes_torch.serve.prefix_cache import PrefixCache

    cfg = CONFIGS["llama-test"]
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    lane = tserver.GreedyLane(params, cfg, prefix=PrefixCache(1 << 20))
    eng = tserver.ContinuousEngine(lane, slots=2, seg_steps=4, pool_mb=0.5)
    assert eng._prefix is not None
    refs = weakref.ref(eng), weakref.ref(lane)
    eng.close()
    gc.disable()
    try:
        del eng, lane
        assert refs[0]() is None and refs[1]() is None
    finally:
        gc.enable()


def test_pins_are_counted_where_the_reference_frees_a_shared_page():
    """Two store entries own one page: evicting the first must keep it
    pinned for the second. The port counts pins; the reference's pinned
    set frees the page (for a wipe) while the second entry still serves
    it."""
    from tpu_kubernetes.serve.pages import PagePool as JPagePool
    from tpu_kubernetes_torch.serve.pages import PagePool

    pools = {"port": PagePool(4), "jax": JPagePool(4)}
    freed = {}
    for name, pool in pools.items():
        a = pool.allocate(2)
        pool.pin(a)                  # entry 1: both pages
        pool.pin(a[:1])              # entry 2 starts with the first
        assert pool.release(a) == []
        freed[name] = pool.unpin(a)  # entry 1 evicted
    assert freed == {"port": [2], "jax": [1, 2]}
    port = pools["port"]
    assert port.stats()["pinned"] == 1 and port.stats()["free"] == 3
    assert port.unpin([1]) == [1]    # entry 2 evicted: now it is free
    with pytest.raises(RuntimeError, match="unpinned but not pinned"):
        port.unpin([1])
    assert port.stats() == {"total": 4, "free": 4, "live": 0, "pinned": 0,
                            "stalls": 0}


def test_evicting_one_of_two_entries_keeps_their_shared_pages(jax_solo):
    """A warm admission's stored prompt shares its first pages with the
    entry it resumed from. Evicting that entry (a 40 KiB cap holds one
    four-page entry) leaves the shared pages pinned, unwiped and right:
    a later warm hit on them answers as the JAX cache-free server."""
    doc = "a document two pages long, shared by the prompts! "[:40]
    a = doc + "and then the first one ends its own way."[:24]
    b = doc + "while the second one goes somewhere else"[:24]
    c = doc + "and a third reads the shared pages again"[:24]
    st = _torch_state(SERVE_PREFIX_CACHE_MB=str(40 / 1024), **PAGED)
    eng = st._engine
    assert st.complete(a, max_new_tokens=8) == jax_solo.complete(
        a, max_new_tokens=8)
    _settle(lambda: len(eng._prefix) == 1)
    shared = list(next(iter(eng._prefix._entries.values())).pages[:2])
    kept = eng._pool.k[:, shared].clone()
    assert st.complete(b, max_new_tokens=8) == jax_solo.complete(
        b, max_new_tokens=8)           # warm from a's pages; a evicted
    _settle(lambda: eng._prefix.lookup(st.encode(a))[0] == 40)
    (entry,) = eng._prefix._entries.values()
    assert list(entry.pages[:2]) == shared
    assert all(eng._pages._pinned[p] == 1 for p in shared)
    assert torch.equal(eng._pool.k[:, shared], kept)
    assert st.complete(c, max_new_tokens=8) == jax_solo.complete(
        c, max_new_tokens=8)           # warm from the same pages
    pages = _conserved(st)
    assert pages["pinned"] == 4 and pages["prefix_entries"] == 1
    eng.close()
