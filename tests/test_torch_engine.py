"""The port's continuous slot engine against the JAX package's on the CPU.

The slot primitives (``models/decode.py``: ``cache_insert_row``,
``cache_clear_row``, ``decode_step_slots``, ``decode_segment_slots``) are
held to the JAX functions on the same numpy arrays: the row graft and the
wipe exactly, the mixed-batch step's logits within
``tests/test_torch_decode.py``'s float32 tolerance, a segment's tokens
and slot state exactly, with and without EOS.

The engine (``serve/server.py`` ``ContinuousEngine``) runs the identity
matrix of ``tests/test_serve_continuous.py`` against the JAX
``ServingState``s on the same weights (the JAX ``init_params(PRNGKey(0),
cfg)`` tree carried over by ``models.from_jax``), in float32: concurrent
staggered requests, a request admitted mid-decode, a failed insert and a
failed segment (injected by patching the port's functions), MoE. The
engine's segment reads the device back once, which a host-read counter
pins."""

import threading
import time
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from tpu_kubernetes.models import decode as jdec
from tpu_kubernetes.models import llama as jllama
from tpu_kubernetes.models import moe as jmoe
from tpu_kubernetes.serve.server import ServingState as JState
from tpu_kubernetes_torch.models import decode as tdec
from tpu_kubernetes_torch.models import llama as tllama
from tpu_kubernetes_torch.models.from_jax import params_from_numpy
from tpu_kubernetes_torch.serve import job as tjob
from tpu_kubernetes_torch.serve import server as tserver
from tests.torch_ops_support import keep_jax_ledger  # noqa: F401 — autouse
from tests.torch_ops_support import black_box_dirs  # noqa: F401 — autouse

JCFG = replace(jllama.CONFIGS["llama-test"], dtype=jnp.float32)
TCFG = replace(tllama.CONFIGS["llama-test"], dtype=torch.float32)
# float32 through two layers: summation order and transcendental ulps only
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)

ENV = {
    "SERVE_MODEL": "llama-test",
    "SERVE_MAX_NEW": "16",
    "SERVE_DTYPE": "float32",    # bf16 ties could break exact-id comparisons
}
# distinct prompts at different widths, so slot rows sit at different
# buckets and positions: the mixed batch the engine exists for
PROMPTS = [
    "the quick brown fox jumps over the lazy dog",   # bucket 64
    "pack my box",                                   # bucket 16
    "sphinx of black quartz judge my vow",           # bucket 64
    "jived fox nymph grabs quick waltz",             # bucket 64
]
BUDGETS = [12, 3, 5, 8]


@pytest.fixture(scope="module")
def params():
    jp = jllama.init_params(jax.random.PRNGKey(0), JCFG)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


# -- the slot primitives ---------------------------------------------------------

def _rand(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("slot,s_row", [(0, 16), (2, 64), (3, 128)])
def test_cache_insert_and_clear_row_equal_jax(slot, s_row):
    """The graft (row positions copied, the span past the row zeroed) and
    the wipe, in place, against JAX's on the same arrays: exact."""
    rng = np.random.default_rng(slot)
    L, B, kv, S, hd = 2, 4, 2, 128, 16
    ck, cv = _rand(rng, (L, B, kv, S, hd)), _rand(rng, (L, B, kv, S, hd))
    rk, rv = _rand(rng, (L, 1, kv, s_row, hd)), _rand(rng, (L, 1, kv, s_row,
                                                             hd))
    jc = jdec.KVCache(k=jnp.asarray(ck), v=jnp.asarray(cv),
                      length=jnp.int32(0))
    jr = jdec.KVCache(k=jnp.asarray(rk), v=jnp.asarray(rv),
                      length=jnp.int32(s_row))
    tc = tdec.KVCache(torch.from_numpy(ck.copy()),
                      torch.from_numpy(cv.copy()), length=0)
    tr = tdec.KVCache(torch.from_numpy(rk), torch.from_numpy(rv),
                      length=s_row)
    jc = jdec.cache_insert_row(jc, jr, jnp.int32(slot))
    k_before = tc.k
    assert tdec.cache_insert_row(tc, tr, torch.tensor(slot)).k is k_before
    np.testing.assert_array_equal(tc.k.numpy(), np.asarray(jc.k))
    np.testing.assert_array_equal(tc.v.numpy(), np.asarray(jc.v))
    other = (slot + 1) % B
    jc = jdec.cache_clear_row(jc, jnp.int32(other))
    tdec.cache_clear_row(tc, other)
    np.testing.assert_array_equal(tc.k.numpy(), np.asarray(jc.k))
    np.testing.assert_array_equal(tc.v.numpy(), np.asarray(jc.v))
    assert not tc.k[:, other].any() and not tc.v[:, other].any()


def test_cache_insert_row_refusals_match_jax():
    zeros = lambda *s: torch.zeros(s)  # noqa: E731
    cache = tdec.KVCache(zeros(1, 2, 1, 16, 4), zeros(1, 2, 1, 16, 4), 0)
    jcache = jdec.init_cache(replace(JCFG, n_layers=1, n_kv_heads=1,
                                     n_heads=1, d_model=4), 2, 16)
    for shape, match in (((1, 1, 1, 32, 4), "exceeds engine max_seq"),
                         ((1, 2, 1, 16, 4), "must be batch-1")):
        row = tdec.KVCache(zeros(*shape), zeros(*shape), 0)
        jrow = jdec.KVCache(jnp.zeros(shape), jnp.zeros(shape),
                            jnp.int32(0))
        with pytest.raises(ValueError, match=match):
            tdec.cache_insert_row(cache, row, 0)
        with pytest.raises(ValueError, match=match):
            jdec.cache_insert_row(jcache, jrow, 0)
    row = tdec.KVCache(torch.zeros((1, 1, 1, 16, 4), dtype=torch.bfloat16),
                       torch.zeros((1, 1, 1, 16, 4), dtype=torch.bfloat16), 0)
    with pytest.raises(ValueError, match="mismatch"):
        tdec.cache_insert_row(cache, row, 0)


def test_init_slot_state_equals_jax():
    jst = jdec.init_slot_state(3)
    tst = tdec.init_slot_state(3, device="cpu")
    for name in jdec.SlotState._fields:
        got = getattr(tst, name)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(jst, name)))


# each row: (prompt length, its width bucket, decode steps already taken,
# remaining budget); one live row fresh from its prefill, two mid-decode,
# one dead (budget spent, pos frozen) and one empty slot
ROWS = [(40, 64, 0, 9), (5, 16, 3, 6), (16, 16, 10, 2), (23, 32, 4, 0), None]


def _slot_batch(params):
    """The same mixed slot batch on both sides: each row prefilled at its
    own width and grafted into its slot; the decode steps a row already
    took stand in as prompt tokens written past its width by a prefill of
    the longer row (what matters is its pos and its real slots).
    → (JAX cache, JAX SlotState, port cache, port SlotState)."""
    jp, tp = params
    n, S = len(ROWS), TCFG.max_seq
    jc = jdec.init_cache(JCFG, n, S)
    tc = tdec.init_cache(TCFG, n, S, device="cpu")
    st = np.zeros((5, n), np.int32)            # tok, pos, rem, pl, ps
    rng = np.random.default_rng(7)
    for i, row in enumerate(ROWS):
        if row is None:
            continue
        plen, width, done, rem = row
        ids = rng.integers(1, 256, plen + done).astype(np.int32)
        padded = np.zeros((1, width + done), np.int32)
        padded[0, :plen] = ids[:plen]
        padded[0, width:] = ids[plen:]
        lengths = np.array([plen], np.int32)
        jl, jrow = jdec.prefill(jp, jnp.asarray(padded), JCFG,
                                max_seq=width + done,
                                lengths=jnp.asarray(lengths))
        _, trow = tdec.prefill(tp, torch.from_numpy(padded), TCFG,
                               max_seq=width + done,
                               lengths=torch.from_numpy(lengths))
        jc = jdec.cache_insert_row(jc, jrow, i)
        tdec.cache_insert_row(tc, trow, i)
        st[:, i] = (int(np.argmax(np.asarray(jl)[0])), width + done, rem,
                    plen, width)
    jst = jdec.SlotState(*(jnp.asarray(a) for a in st))
    tst = tdec.SlotState(*(torch.from_numpy(a.copy()) for a in st))
    return jc, jst, tc, tst


def test_decode_step_slots_logits_match_jax(params):
    jp, tp = params
    jc, jst, tc, tst = _slot_batch(params)
    jl, jc = jdec.decode_step_slots(jp, jc, jst, JCFG)
    tl, tc2 = tdec.decode_step_slots(tp, tc, tst, TCFG)
    assert tc2.k is tc.k                          # written in place
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), **LOGIT_TOL)
    np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc.v), **LOGIT_TOL)


@pytest.mark.parametrize("with_eos", [False, True])
def test_decode_segment_slots_equal_jax(params, with_eos):
    """Eight steps over the mixed batch: the same tokens and the same slot
    state (the port's updated in place); with an EOS id taken from the
    free-running tokens, a live row stops there."""
    jp, tp = params
    eos = None
    if with_eos:
        jc, jst, _, _ = _slot_batch(params)
        free, _, _ = jdec.decode_segment_slots(jp, jc, jst, JCFG, 8)
        eos = int(np.asarray(free)[0, 2])
    jc, jst, tc, tst = _slot_batch(params)
    jt, jst, jc = jdec.decode_segment_slots(jp, jc, jst, JCFG, 8,
                                            eos_id=eos, pad_id=0)
    pos = tst.pos
    tt, tst2, _ = tdec.decode_segment_slots(tp, tc, tst, TCFG, 8,
                                            eos_id=eos, pad_id=0)
    assert tst2.pos is pos
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    for name in jdec.SlotState._fields:
        np.testing.assert_array_equal(getattr(tst, name).numpy(),
                                      np.asarray(getattr(jst, name)),
                                      err_msg=name)
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), **LOGIT_TOL)
    if with_eos:
        assert int(tst.remaining[0]) == 0


# -- the engine ----------------------------------------------------------------

def _jax_weights(cfg, generator, device):
    """Stands in for the port's init_params: the JAX server's weights."""
    if cfg.vocab_size == 256 and hasattr(cfg, "n_experts"):
        jp = jmoe.init_params(jax.random.PRNGKey(0),
                              jmoe.MOE_CONFIGS["moe-test"])
    else:
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
    """Engine off, early exit off: the run-to-max solo reference."""
    return _jax_state(SERVE_EARLY_EXIT_STEPS="0")


@pytest.fixture(scope="module")
def cont_state():
    """The port's engine: 4 slots, segments of 8."""
    return _torch_state(SERVE_CONTINUOUS_BATCHING="1", SERVER_BATCH="4")


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


def test_continuous_identity_with_solo_greedy(jax_solo, cont_state):
    """Four concurrent staggered-budget requests through the engine equal
    the JAX solo server's responses: different widths, different
    budgets, slots recycling as short rows drain."""
    refs = [jax_solo.complete(p, max_new_tokens=b)
            for p, b in zip(PROMPTS, BUDGETS)]
    eng = cont_state._engine
    r0 = eng.recycled
    assert _fan_out(cont_state, PROMPTS, BUDGETS) == refs
    _settle(lambda: eng.recycled >= r0 + len(PROMPTS))
    stats = eng.stats()
    assert stats == {"slots": 4, "occupied": 0, "queued": 0,
                     "segment_steps": 8, "recycled": stats["recycled"],
                     "restarts": 0}


def test_continuous_identity_mid_stream_admission(jax_solo, cont_state):
    """A request admitted while another row is mid-decode (its pos past
    its prompt bucket) does not perturb the resident row and decodes
    token-identically itself."""
    eng = cont_state._engine
    ref_long = jax_solo.complete(PROMPTS[0], max_new_tokens=16)
    ref_late = jax_solo.complete(PROMPTS[1], max_new_tokens=4)
    e1 = eng.enqueue(cont_state.encode(PROMPTS[0]), 16)
    assert e1["dispatched"].wait(30)
    slot = eng._entries.index(e1)
    deadline = time.monotonic() + 30
    while (eng._pos[slot] <= eng._ps[slot] and e1 in eng._entries
           and time.monotonic() < deadline):
        time.sleep(0.001)
    e2 = eng.enqueue(cont_state.encode(PROMPTS[1]), 4)
    assert e1["event"].wait(60) and e2["event"].wait(60)
    assert (cont_state.decode_text(tserver._Batcher.result(e1)[:16])
            == ref_long["text"])
    assert (cont_state.decode_text(tserver._Batcher.result(e2)[:4])
            == ref_late["text"])


def test_slot_recycled_after_insert_failure(jax_solo, cont_state,
                                            monkeypatch):
    """A request whose graft fails half-way (garbage written into its slot,
    then an error) fails out; its slot is scrubbed back to zeros and
    serves the next requests token-identically."""
    eng = cont_state._engine
    inner = tserver.cache_insert_row

    def half_graft(cache, row, slot):
        cache.k[:, int(slot)] = 7.0
        raise RuntimeError("injected insert failure")

    monkeypatch.setattr(tserver, "cache_insert_row", half_graft)
    e = eng.enqueue(cont_state.encode(PROMPTS[1]), 4)
    assert e["event"].wait(60)
    with pytest.raises(RuntimeError, match="injected insert failure"):
        tserver._Batcher.result(e)
    monkeypatch.setattr(tserver, "cache_insert_row", inner)
    # the entry fails out before the scrub runs on the scheduler thread
    _settle(lambda: not eng._cache.k[:, 0].any())
    assert eng.stats()["occupied"] == 0 and not eng._cache.v[:, 0].any()
    refs = [jax_solo.complete(p, max_new_tokens=4) for p in PROMPTS[:2]]
    assert _fan_out(cont_state, PROMPTS[:2], [4, 4]) == refs
    assert eng.restarts == 0


def test_token_identity_survives_segment_failure(jax_solo, cont_state,
                                                 monkeypatch):
    """A failed segment errors the resident rows out (a terminal state,
    not a hang) and resets the engine cold; a full mixed batch after it
    is still token-identical with JAX's solo decode."""
    eng = cont_state._engine
    inner = tserver.decode_segment_slots
    calls = []

    def failing(*args, **kwargs):
        calls.append(1)
        raise RuntimeError("injected segment failure")

    monkeypatch.setattr(tserver, "decode_segment_slots", failing)
    e = eng.enqueue(cont_state.encode(PROMPTS[0]), 8)
    assert e["event"].wait(60)
    with pytest.raises(RuntimeError, match="injected segment failure"):
        tserver._Batcher.result(e)
    monkeypatch.setattr(tserver, "decode_segment_slots", inner)
    _settle(lambda: eng.stats()["occupied"] == 0
            and eng.stats()["queued"] == 0)
    assert calls and eng.restarts == 1
    assert not eng._cache.k.any() and not eng._host.any()
    refs = [jax_solo.complete(p, max_new_tokens=b)
            for p, b in zip(PROMPTS, BUDGETS)]
    assert _fan_out(cont_state, PROMPTS, BUDGETS) == refs


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


def test_segment_reads_the_device_back_once(cont_state, monkeypatch):
    """Each segment's only host read is the one transfer of its output
    buffer (tokens, tok, pos, remaining), as the reference reads once a
    segment; the slot clears of the rows it drains read nothing."""
    eng = cont_state._engine
    inner = tserver.ContinuousEngine._run_segment
    reads = []

    def counted(self):
        with _HostReads() as mode:
            inner(self)
        reads.append(mode.seen)

    monkeypatch.setattr(tserver.ContinuousEngine, "_run_segment", counted)
    s0 = eng.segments
    _fan_out(cont_state, PROMPTS, BUDGETS)
    # the last segment hands its rows back before it returns
    _settle(lambda: eng.stats()["occupied"] == 0
            and len(reads) == eng.segments - s0)
    monkeypatch.setattr(tserver.ContinuousEngine, "_run_segment", inner)
    assert len(reads) >= 2
    assert all(seen == ["cpu"] for seen in reads), reads


def test_engine_warm_captures_its_programs_and_healthz(cont_state):
    """warm() ran the default insert, a segment and a clear: their keys
    are in the lane's programs before the first request."""
    keys = set(cont_state.greedy.programs.captures)
    assert {("slot_insert", 16), ("slot_segment", 8),
            ("slot_clear",)} <= keys
    fresh = tserver.ContinuousEngine(cont_state.greedy, slots=2,
                                     seg_steps=3)
    try:
        assert fresh.stats() == {"slots": 2, "occupied": 0, "queued": 0,
                                 "segment_steps": 3, "recycled": 0,
                                 "restarts": 0}
    finally:
        fresh.close()
    with pytest.raises(RuntimeError, match="closed"):
        fresh.enqueue([1, 2], 4)


def test_continuous_builds_for_moe():
    """MoE rides the slot engine (no round batcher), and its rows equal
    the JAX engine's on the same weights: both decode at the fixed slot
    batch, so expert capacity is the same shape on both sides."""
    ts = _torch_state(SERVE_MODEL="moe-test", SERVE_CONTINUOUS_BATCHING="1",
                      SERVER_BATCH="4")
    assert ts._engine is not None and ts._batcher is None
    js = JState(dict(ENV, SERVE_MODEL="moe-test",
                     SERVE_CONTINUOUS_BATCHING="1", SERVER_BATCH="4"))
    assert js._engine is not None and js._batcher is None
    js.warm()
    for p, b in zip(PROMPTS[:2], BUDGETS[:2]):
        assert ts.complete(p, b) == js.complete(p, b)


def test_moe_grouped_engine_equals_its_solo():
    """moe-test-grouped (dropless grouped dispatch) in float32: rows are
    independent, so the engine's tokens equal the port's solo lane's."""
    env = dict(ENV, SERVE_MODEL="moe-test-grouped", SERVE_DEVICE="cpu")
    solo = tserver.ServingState(dict(env, SERVE_EARLY_EXIT_STEPS="0"))
    cont = tserver.ServingState(dict(env, SERVE_CONTINUOUS_BATCHING="1",
                                     SERVER_BATCH="4"))
    cont.warm()
    refs = [solo.complete(p, b) for p, b in zip(PROMPTS, BUDGETS)]
    assert _fan_out(cont, PROMPTS, BUDGETS) == refs
