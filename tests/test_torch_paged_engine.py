"""The port's paged slot engine (``SERVE_KV_POOL_MB`` > 0) against the JAX
package's on the CPU.

``serve/server.py``'s ``ContinuousEngine`` in paged mode runs the paged
tests of ``tests/test_serve_continuous.py`` against the JAX
``ServingState``s on the same weights, in float32: a mixed staggered batch
token-identical to the JAX solo server, to the JAX paged engine and to the
port's dense engine; a request admitted mid-decode into pages beside a
resident row; a pool of 8 pages that stalls a second request until the
first frees its pages; a pool that runs dry during a top-up, so the
youngest other row is preempted and re-emits its tokens identically; a
failed segment that resets the pool and its free list cold. Pages are
conserved (free + live + pinned == total) after every test, the knob
refusals carry the reference's messages, and a paged segment reads the
device back once."""

import threading
import time

import jax
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

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
# llama-test in float32: a 16-position page is 8 KiB, so 0.5 MB is a
# 64-page pool; the 128-position span is 8 pages a full row
PAGED_ENV = dict(SERVE_CONTINUOUS_BATCHING="1", SERVER_BATCH="4",
                 SERVE_KV_POOL_MB="0.5", SERVE_KV_PAGE_SIZE="16")
EIGHT_PAGES = str(8 * 8192 / 2 ** 20)     # the one-full-row floor
PROMPTS = [
    "the quick brown fox jumps over the lazy dog",   # bucket 64
    "pack my box",                                   # bucket 16
    "sphinx of black quartz judge my vow",           # bucket 64
    "jived fox nymph grabs quick waltz",             # bucket 64
]
BUDGETS = [12, 3, 5, 8]


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


def _jax_state(**extra):
    st = JState(dict(ENV, **extra))
    st.warm()
    return st


@pytest.fixture(scope="module")
def jax_solo():
    return _jax_state(SERVE_EARLY_EXIT_STEPS="0")


@pytest.fixture(scope="module")
def paged():
    return _torch_state(**PAGED_ENV)


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


def _idle_and_conserved(state):
    """Wait until no row is resident, then: every page is free again, and
    the partition sums to the pool."""
    eng = state._engine
    _settle(lambda: eng.stats()["occupied"] == 0)
    pages = eng.stats()["pages"]
    assert pages["free"] + pages["live"] + pages["pinned"] == pages["total"]
    assert pages["free"] == pages["total"] and not eng._table.any()
    return pages


def test_paged_identity_with_solo_dense_and_the_jax_paged_engine(jax_solo,
                                                                 paged):
    """A mixed staggered batch through the paged engine equals the JAX
    solo server's responses, the JAX paged engine's and the port's dense
    engine's, and every page comes back once the rows drain."""
    refs = [jax_solo.complete(p, max_new_tokens=b)
            for p, b in zip(PROMPTS, BUDGETS)]
    assert _fan_out(paged, PROMPTS, BUDGETS) == refs
    _idle_and_conserved(paged)
    jax_paged = _jax_state(**PAGED_ENV)
    assert _fan_out(jax_paged, PROMPTS, BUDGETS) == refs
    dense = _torch_state(SERVE_CONTINUOUS_BATCHING="1", SERVER_BATCH="4")
    assert _fan_out(dense, PROMPTS, BUDGETS) == refs
    dense._engine.close()


def test_paged_identity_mid_stream_admission(jax_solo, paged):
    """A row admitted while another decodes through its pages scatters
    into disjoint pages: neither perturbs the other."""
    eng = paged._engine
    ref_long = jax_solo.complete(PROMPTS[0], max_new_tokens=16)
    ref_late = jax_solo.complete(PROMPTS[1], max_new_tokens=4)
    e1 = eng.enqueue(paged.encode(PROMPTS[0]), 16)
    assert e1["dispatched"].wait(30)
    slot = eng._entries.index(e1)
    deadline = time.monotonic() + 30
    while (eng._pos[slot] <= eng._ps[slot] and e1 in eng._entries
           and time.monotonic() < deadline):
        time.sleep(0.001)
    e2 = eng.enqueue(paged.encode(PROMPTS[1]), 4)
    assert e1["event"].wait(60) and e2["event"].wait(60)
    assert (paged.decode_text(tserver._Batcher.result(e1)[:16])
            == ref_long["text"])
    assert (paged.decode_text(tserver._Batcher.result(e2)[:4])
            == ref_late["text"])
    _idle_and_conserved(paged)


def test_paged_admission_stalls_until_pages_free(jax_solo):
    """With a pool of 8 pages (one full row), a bucket-64 admission holds
    5 (4 prompt + 1 decode); a second one must WAIT (a stall, not a
    failure) until the first drains and returns its pages."""
    tiny = _torch_state(SERVE_CONTINUOUS_BATCHING="1", SERVER_BATCH="4",
                        SERVE_KV_POOL_MB=EIGHT_PAGES,
                        SERVE_KV_PAGE_SIZE="16")
    eng = tiny._engine
    assert eng._pages.total == 8
    ref_long = jax_solo.complete(PROMPTS[0], max_new_tokens=16)
    ref_late = jax_solo.complete(PROMPTS[2], max_new_tokens=4)
    e1 = eng.enqueue(tiny.encode(PROMPTS[0]), 16)
    assert e1["dispatched"].wait(30)
    e2 = eng.enqueue(tiny.encode(PROMPTS[2]), 4)
    assert e1["event"].wait(60) and e2["event"].wait(60)
    assert (tiny.decode_text(tserver._Batcher.result(e1)[:16])
            == ref_long["text"])
    assert (tiny.decode_text(tserver._Batcher.result(e2)[:4])
            == ref_late["text"])
    pages = _idle_and_conserved(tiny)
    assert pages["stalls"] > 0 and pages["preemptions"] == 0
    eng.close()


def test_preempted_row_re_emits_its_tokens():
    """Three rows of bucket 16 admitted together into 8 pages (2 each)
    grow to 4 pages each: a top-up finds the pool dry and preempts the
    youngest other row, which is requeued at the head and re-emits the
    same tokens as the JAX solo server."""
    env = dict(SERVE_MAX_NEW="48")
    prompts = ["abc", "hello there", "pack my box"]
    solo = _jax_state(SERVE_EARLY_EXIT_STEPS="0", **env)
    refs = [solo.complete(p, max_new_tokens=48) for p in prompts]
    tight = _torch_state(SERVE_CONTINUOUS_BATCHING="1", SERVER_BATCH="4",
                         SERVE_KV_POOL_MB=EIGHT_PAGES,
                         SERVE_KV_PAGE_SIZE="16", **env)
    eng = tight._engine
    # the scheduler blocks on the lock in its first prefill, then admits
    # the other two in the same pass: all three resident before a segment
    with eng._lock:
        entries = [eng.enqueue(tight.encode(p), 48) for p in prompts]
        time.sleep(0.05)
    for e in entries:
        assert e["event"].wait(60)
    got = [tight.decode_text(tserver._Batcher.result(e)) for e in entries]
    assert got == [r["text"] for r in refs]
    pages = _idle_and_conserved(tight)
    assert pages["preemptions"] >= 1 and pages["stalls"] >= 1
    eng.close()


def test_segment_failure_resets_the_pool_cold(jax_solo, paged, monkeypatch):
    """A failed paged segment errors the resident rows out and resets the
    pool, the table and the free list cold; the engine then serves a
    mixed batch token-identically."""
    eng = paged._engine
    inner = tserver.decode_segment_paged

    def failing(*args, **kwargs):
        raise RuntimeError("injected segment failure")

    monkeypatch.setattr(tserver, "decode_segment_paged", failing)
    e = eng.enqueue(paged.encode(PROMPTS[0]), 8)
    assert e["event"].wait(60)
    with pytest.raises(RuntimeError, match="injected segment failure"):
        tserver._Batcher.result(e)
    monkeypatch.setattr(tserver, "decode_segment_paged", inner)
    _settle(lambda: eng.stats()["occupied"] == 0)
    assert not eng._pool.k.any() and not eng._host_all.any()
    _idle_and_conserved(paged)
    refs = [jax_solo.complete(p, max_new_tokens=b)
            for p, b in zip(PROMPTS, BUDGETS)]
    assert _fan_out(paged, PROMPTS, BUDGETS) == refs
    _idle_and_conserved(paged)


class _HostReads(TorchFunctionMode):
    """Counts the tensor calls that read a value back to the host."""

    READS = {"cpu", "item", "tolist", "__bool__", "__int__", "__index__",
             "__float__"}

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if name in self.READS or (name == "to" and "cpu" in map(str, args)):
            self.seen.append(name)
        return func(*args, **(kwargs or {}))


def test_paged_segment_reads_the_device_back_once(paged, monkeypatch):
    """A paged segment's top-up, its table upload and the page wipes of
    the rows it drains read nothing back: the one read is the segment's
    output buffer."""
    eng = paged._engine
    inner = tserver.ContinuousEngine._run_segment
    reads = []

    def counted(self):
        with _HostReads() as mode:
            inner(self)
        reads.append(mode.seen)

    monkeypatch.setattr(tserver.ContinuousEngine, "_run_segment", counted)
    s0 = eng.segments
    _fan_out(paged, PROMPTS, BUDGETS)
    _settle(lambda: eng.stats()["occupied"] == 0
            and len(reads) == eng.segments - s0)
    monkeypatch.setattr(tserver.ContinuousEngine, "_run_segment", inner)
    assert len(reads) >= 2
    assert all(seen == ["cpu"] for seen in reads), reads


def test_paged_stats_and_warm_programs(paged):
    """stats() carries the pool's partition and counters; warm() ran the
    paged insert, segment and clear programs."""
    _fan_out(paged, PROMPTS[:2], [4, 4])
    pages = _idle_and_conserved(paged)
    assert set(pages) == {"page_size", "total", "free", "live", "pinned",
                          "stalls", "preemptions"}
    assert pages["page_size"] == 16 and pages["total"] == 64
    assert pages["live"] == pages["pinned"] == 0
    keys = set(paged.greedy.programs.captures)
    assert {("paged_insert", 16, 0), ("paged_segment", 8),
            ("page_clear", 8)} <= keys
    assert not any(k[0].startswith("slot_") for k in keys)


@pytest.mark.parametrize("extra,match", [
    (dict(PAGED_ENV, SERVE_KV_PAGE_SIZE="3"), "power of two dividing 16"),
    (dict(PAGED_ENV, SERVE_KV_PAGE_SIZE="32"), "power of two dividing 16"),
    (dict(PAGED_ENV, SERVE_KV_POOL_MB="0.01"),
     "one full-span row needs 8"),
    (dict(SERVE_KV_POOL_MB="0.5"), "needs SERVE_CONTINUOUS_BATCHING=1"),
])
def test_paged_knob_refusals_match_jax(extra, match):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tjob, "init_params", _jax_weights)
        with pytest.raises(ValueError, match=match):
            tserver.ServingState(dict(ENV, SERVE_DEVICE="cpu", **extra))
    with pytest.raises(ValueError, match=match):
        JState(dict(ENV, **extra))


def test_paged_engine_holds_its_pool_in_the_models_dtype(paged):
    eng = paged._engine
    assert eng._cache is None and eng._pool.k.dtype == torch.float32
    assert tuple(eng._pool.k.shape) == (2, 65, 2, 16, 16)
    assert eng._table.shape == (4, 8) and eng.max_pages == 8
