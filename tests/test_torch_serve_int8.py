"""The port's int8 serving (``SERVE_QUANT=int8``, ``SERVE_KV_QUANT``,
``SERVE_DRAFT_KV_QUANT``) against the JAX package's on the CPU.

The int8 cases of the reference's serving suites re-run against the
port's ``ServingState`` and ``run_serving`` on the same float32
``llama-test`` weights (the JAX server's ``init_params(PRNGKey(0))`` tree
carried over by ``models.from_jax``): the continuous engine, dense and
paged, the warm prefix, the engine's verify rounds (n-gram, and a draft
model on an int8 draft cache), the batch job and the refusals, each
response held to the JAX server's own (text and token count), and the
refusals to the reference's wording. ``/healthz`` carries ``kv_quant``."""

import http.client
import json
import threading
import time
from pathlib import Path

import jax
import numpy as np
import pytest

from tpu_kubernetes.models import llama as jllama
from tpu_kubernetes.serve import job as jjob
from tpu_kubernetes.serve.server import ServingState as JState
from tpu_kubernetes_torch.models.from_jax import params_from_numpy
from tpu_kubernetes_torch.serve import job as tjob
from tpu_kubernetes_torch.serve import server as tserver

from tests.torch_ops_support import clean_singletons  # noqa: F401 — autouse
from tests.torch_ops_support import keep_jax_ledger  # noqa: F401 — autouse
from tests.torch_ops_support import black_box_dirs  # noqa: F401 — autouse

ENV = {"SERVE_MODEL": "llama-test", "SERVE_MAX_NEW": "16",
       "SERVE_DTYPE": "float32"}
PROMPTS = [
    "the quick brown fox jumps over the lazy dog",   # bucket 64
    "pack my box",                                   # bucket 16
    "sphinx of black quartz judge my vow",           # bucket 64
    "jived fox nymph grabs quick waltz",             # bucket 64
]
BUDGETS = [12, 3, 5, 8]
ENGINE = dict(SERVE_CONTINUOUS_BATCHING="1", SERVER_BATCH="4")
# llama-test's int8 pool: 16 positions × (2 layers × 2 KV heads × (16 +
# 4)) × 2 = 2,560 bytes a page; 0.25 MB holds 102 pages, 8 a full row
PAGED = dict(ENGINE, SERVE_KV_POOL_MB="0.25", SERVE_KV_PAGE_SIZE="16")
KVQ = dict(SERVE_KV_QUANT="1")


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


def _fan_out(state, prompts=PROMPTS, budgets=BUDGETS):
    """Every request from its own thread: one mixed, staggered batch."""
    outs = [None] * len(prompts)

    def worker(i):
        outs[i] = state.complete(prompts[i], max_new_tokens=budgets[i])

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads)
    return outs


def _same(outs, refs):
    for out, ref in zip(outs, refs):
        assert out["text"] == ref["text"]
        assert out["tokens"] == ref["tokens"]


def _settle(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.005)
    assert pred()


@pytest.fixture(scope="module")
def jax_kv_solo():
    """The JAX server, int8 KV cache, engine off, early exit off."""
    return _jax_state(SERVE_EARLY_EXIT_STEPS="0", **KVQ)


def _refs(jax_state):
    return [jax_state.complete(p, max_new_tokens=b)
            for p, b in zip(PROMPTS, BUDGETS)]


def test_solo_int8_kv_quant_equals_jax(jax_kv_solo):
    """The solo lane on the int8 cache: the JAX server's responses."""
    st = _torch_state(SERVE_EARLY_EXIT_STEPS="0", **KVQ)
    assert st.greedy.kv_quant
    _same([st.complete(p, max_new_tokens=b)
           for p, b in zip(PROMPTS, BUDGETS)], _refs(jax_kv_solo))


def test_continuous_identity_int8_kv_quant(jax_kv_solo):
    """The engine's insert grafts k/v AND the per-slot scales, so its
    rows decode exactly like solo int8 rows (the JAX server's)."""
    st = _torch_state(**ENGINE, **KVQ)
    assert st._engine._cache.k_scale is not None
    _same(_fan_out(st), _refs(jax_kv_solo))
    st._engine.close()


def test_paged_identity_int8_kv_quant(jax_kv_solo):
    """The int8 pool's pages carry the int8 K/V AND their scales: paged
    int8 rows match the JAX server's solo int8 rows exactly, and the
    pool's pages are conserved; the page is sized with its scales."""
    st = _torch_state(**PAGED, **KVQ)
    eng = st._engine
    assert eng._page_nbytes == 2560
    assert eng._pool.k_scale is not None
    _same(_fan_out(st), _refs(jax_kv_solo))
    _settle(lambda: eng.stats()["occupied"] == 0)
    s = eng._pages.stats()
    assert s["free"] + s["live"] + s["pinned"] == s["total"]
    eng.close()


def test_round_batching_int8_kv_quant(jax_kv_solo):
    """The round batcher's ragged batch on the int8 cache: each row is its
    own solo int8 response."""
    st = _torch_state(SERVER_BATCH="4", SERVE_EARLY_EXIT_STEPS="0", **KVQ)
    _same(_fan_out(st), _refs(jax_kv_solo))


def test_warm_prefix_identity_int8_kv_quant():
    """The resume restores k/v AND the per-slot scales: the warm int8
    responses are the JAX server's warm int8 ones (a warm suffix attends
    the quantized prefix on both sides, where a cold prefill attends full
    precision); the store's signature says int8 and its entries carry the
    scales."""
    env = dict(SERVE_PREFIX_CACHE_MB="8", **KVQ)
    warm, jwarm = _torch_state(**env), _jax_state(**env)
    prompt = "the shared document prefix of this request"
    for p in (prompt, prompt, prompt + " again and again"):
        _same([warm.complete(p, max_new_tokens=8)],
              [jwarm.complete(p, max_new_tokens=8)])
    assert warm.prefix_cache.stats()["sig"][2] is True
    assert warm.greedy.prefix_lookups["hit"] >= 1
    entry = next(iter(warm.prefix_cache._entries.values()))
    assert set(entry.arrays) == {"k", "v", "k_scale", "v_scale"}


def test_paged_warm_prefix_int8_kv_quant():
    """The paged engine's store pins int8 pages with their scales: a warm
    admission gathers them and resumes; the tokens are the JAX paged
    engine's, store and all."""
    env = dict(SERVE_PREFIX_CACHE_MB="8", **PAGED, **KVQ)
    st, jst = _torch_state(**env), _jax_state(**env)
    doc = "a shared document every request starts with, "
    for p in (doc + "first", doc + "second", doc + "third"):
        _same([st.complete(p, max_new_tokens=6)],
              [jst.complete(p, max_new_tokens=6)])
    assert st.greedy.prefix_lookups["hit"] + \
        st.greedy.prefix_lookups["partial"] >= 1
    st._engine.close()


def test_spec_int8_identity_with_plain_engine():
    """Verify rounds over the int8 cache: rejected quantized writes are
    masked and rewritten before anything attends them, so the speculating
    int8 engine equals the JAX server's plain int8 engine."""
    spec = _torch_state(SERVE_PROMPT_LOOKUP="1", SERVE_DRAFT_K="4",
                        **ENGINE, **KVQ)
    plain = _jax_state(**ENGINE, **KVQ)
    _same(_fan_out(spec), _fan_out(plain))
    assert spec.spec_totals["rounds"] > 0
    spec._engine.close()


def test_spec_draft_model_int8_draft_cache_identity():
    """The int8-KV draft model proposes (SERVE_DRAFT_KV_QUANT quantizes
    the draft's cache alone); proposals never change tokens: the JAX
    server's solo full-precision responses."""
    st = _torch_state(SERVE_DRAFT_MODEL="llama-test", SERVE_DRAFT_K="4",
                      SERVE_DRAFT_KV_QUANT="1", **ENGINE)
    assert st._engine.spec_source == "draft"
    assert st.draft.kv_quant and not st.greedy.kv_quant
    refs = _refs(_jax_state(SERVE_EARLY_EXIT_STEPS="0"))
    _same(_fan_out(st), refs)
    st._engine.close()


def test_int8_weights_and_kv_engine_equals_jax():
    """SERVE_QUANT=int8 with the int8 KV cache through the paged engine:
    the JAX server's responses with both knobs."""
    extra = dict(SERVE_QUANT="int8", **KVQ)
    st = _torch_state(**PAGED, **extra)
    assert st.greedy.cost_opts["weight_nbytes"] is not None
    _same(_fan_out(st), _refs(_jax_state(SERVE_EARLY_EXIT_STEPS="0",
                                         **extra)))
    st._engine.close()


@pytest.mark.parametrize("extra,match", [
    (dict(SERVE_PROMPT_LOOKUP="1", **KVQ),
     r"SERVE_PROMPT_LOOKUP with SERVE_KV_QUANT needs "
     r"SERVE_CONTINUOUS_BATCHING=1 \(the solo verification cache is "
     r"full-precision\)"),
    (dict(SERVE_DRAFT_KV_QUANT="1"),
     r"SERVE_DRAFT_KV_QUANT needs a draft model \(SERVE_DRAFT_MODEL / "
     r"SERVE_DRAFT_HF_CHECKPOINT\)"),
])
def test_refusals_in_the_reference_wording(extra, match):
    with pytest.raises(ValueError, match=match):
        tserver.make_server(dict(ENV, SERVE_DEVICE="cpu", **extra))
    with pytest.raises(ValueError, match=match):
        JState(dict(ENV, **extra))


def test_healthz_reports_kv_quant():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tjob, "init_params", _jax_weights)
        srv = tserver.make_server(dict(ENV, SERVE_DEVICE="cpu",
                                       SERVER_PORT="0", **KVQ))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        host, port = srv.server_address[:2]
        conn = http.client.HTTPConnection(host, port, timeout=60)
        conn.request("GET", "/healthz")
        resp = conn.getresponse()
        body = json.loads(resp.read())
        assert resp.status == 200 and body["kv_quant"] is True
        conn.request("POST", "/v1/completions",
                     body=json.dumps({"prompt": "pack my box",
                                      "max_tokens": 3}),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200 and json.loads(resp.read())["tokens"] >= 1
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)


# -- the batch job (tests/test_serve_job.py), against the port -------------

JOB_PROMPTS = ["hello tpu", "rings of ici", "short"]


@pytest.fixture()
def prompts_file(tmp_path):
    p = tmp_path / "prompts.txt"
    p.write_text("\n".join(JOB_PROMPTS) + "\n")
    return p


def _job_env(prompts: Path, out: Path, **extra):
    env = {"SERVE_PROMPTS": str(prompts), "SERVE_OUT": str(out),
           "SERVE_MODEL": "llama-test", "SERVE_MAX_NEW": "6",
           "SERVE_BATCH": "2", "SERVE_DTYPE": "float32"}
    env.update(extra)
    return env


def _port_job(env):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tjob, "init_params", _jax_weights)
        return tjob.run_serving(dict(env, SERVE_DEVICE="cpu"))


def _jax_job(env):
    return jjob.run_serving(dict(env, SERVE_MESH="tensor=1"))


@pytest.mark.parametrize("extra", [
    dict(SERVE_QUANT="int8"),
    dict(SERVE_QUANT="int8", SERVE_KV_QUANT="1"),
    dict(SERVE_KV_QUANT="1"),
], ids=["int8", "kv_quant_mode_runs_and_composes_with_int8", "kv_quant"])
def test_job_int8_modes_equal_jax(tmp_path, prompts_file, extra):
    got = _port_job(_job_env(prompts_file, tmp_path / "t.txt", **extra))
    want = _jax_job(_job_env(prompts_file, tmp_path / "j.txt", **extra))
    assert len(got) == len(JOB_PROMPTS)
    assert got == want


def test_kv_quant_rejected_in_speculative_modes(tmp_path, prompts_file):
    for extra in (dict(SERVE_PROMPT_LOOKUP="1"),
                  dict(SERVE_DRAFT_MODEL="llama-test")):
        with pytest.raises(SystemExit,
                           match="SERVE_KV_QUANT is not supported in "
                                 "speculative/prompt-lookup modes"):
            _port_job(_job_env(prompts_file, tmp_path / "o.txt",
                               SERVE_KV_QUANT="1", **extra))


def test_draft_kv_quant_serving_runs_and_rejections(tmp_path, prompts_file):
    """SERVE_DRAFT_KV_QUANT quantizes the draft's cache alone: the
    completions are the JAX job's; without a draft model it is refused."""
    env = dict(SERVE_DRAFT_MODEL="llama-test", SERVE_DRAFT_KV_QUANT="1",
               SERVE_MAX_NEW="4")
    got = _port_job(_job_env(prompts_file, tmp_path / "o.txt", **env))
    want = _jax_job(_job_env(prompts_file, tmp_path / "j.txt", **env))
    assert got == want
    with pytest.raises(SystemExit, match="needs a draft model"):
        _port_job(_job_env(prompts_file, tmp_path / "o2.txt",
                           SERVE_PROMPT_LOOKUP="1",
                           SERVE_DRAFT_KV_QUANT="1"))


def test_serve_quant_other_values_are_refused(tmp_path, prompts_file):
    with pytest.raises(SystemExit, match="SERVE_QUANT must be 'int8'"):
        _port_job(_job_env(prompts_file, tmp_path / "o.txt",
                           SERVE_QUANT="fp8"))
