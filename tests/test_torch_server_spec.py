"""The port's speculative serving against the JAX package's on the CPU: the
lookup server (``tests/test_server.py:384-435``), the speculating slot
engine (``tests/test_serve_continuous.py:276,549-621``, less the int8
case) and the batch job's speculative modes (``tests/test_serve_job.py
:62-132``, less the int8 ones), re-run against the port.

Every port state serves ``llama-test`` in float32 on the JAX server's
weights (the port's ``init_params`` patched to them), so each response is
held to the JAX package's plain solo server (engine off, early exit off):
speculation moves the speed, never the tokens. The rounds' counts ride
``spec_totals``, the engine's ``stats()`` and ``/healthz``."""

import http.client
import json
import threading
import time

import jax
import numpy as np
import pytest

from tpu_kubernetes.models import llama as jllama
from tpu_kubernetes.serve import job as jjob
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
PROMPTS = [
    "the quick brown fox jumps over the lazy dog",   # bucket 64
    "pack my box",                                   # bucket 16
    "sphinx of black quartz judge my vow",           # bucket 64
    "jived fox nymph grabs quick waltz",             # bucket 64
]
BUDGETS = [12, 3, 5, 8]
SPEC_NGRAM = dict(SERVE_CONTINUOUS_BATCHING="1", SERVER_BATCH="4",
                  SERVE_PROMPT_LOOKUP="1", SERVE_DRAFT_K="4")


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
    st = JState(dict(ENV, SERVE_EARLY_EXIT_STEPS="0"))
    st.warm()
    return st


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
        t.join(120)
    assert not any(t.is_alive() for t in threads)
    return outs


def _same(out, ref):
    assert out["text"] == ref["text"] and out["tokens"] == ref["tokens"]


# -- the solo lookup lane (SERVE_PROMPT_LOOKUP) ------------------------------------


@pytest.fixture(scope="module")
def lookup_state():
    return _torch_state(SERVE_PROMPT_LOOKUP="1")


def test_lookup_completion_token_exact_vs_plain(jax_solo, lookup_state):
    """The speculative completion is exactly the JAX server's plain greedy
    response, with the request's speculation counts, and the totals grow
    by them (the prefill counted as one round, as the reference counts)."""
    req = dict(prompt="speculate speculate speculate", max_new_tokens=6)
    before = lookup_state.spec_totals
    spec = lookup_state.complete(**req)
    _same(spec, jax_solo.complete(**req))
    assert spec["spec"]["rounds"] >= 1
    assert 0 <= spec["spec"]["accepted"] <= spec["spec"]["drafted"]
    after = lookup_state.spec_totals
    assert after["rounds"] - before["rounds"] == spec["spec"]["rounds"]
    for p, b in zip(PROMPTS, BUDGETS):
        _same(lookup_state.complete(p, max_new_tokens=b),
              jax_solo.complete(p, max_new_tokens=b))


def test_lookup_streaming_matches_non_streamed(lookup_state):
    """A stream surfaces whole accepted rounds; their concatenation is the
    non-streamed speculative text, and the finish reason is set."""
    req = dict(prompt="stream and speculate", max_new_tokens=6)
    plain = lookup_state.complete(**req)
    finish = {}
    pieces = list(lookup_state.stream(**req, finish=finish))
    assert "".join(pieces) == plain["text"]
    assert finish["reason"] == plain["finish_reason"]
    assert finish["spec"]["rounds"] >= 1


def test_lookup_sampled_requests_bypass_speculation(lookup_state):
    """Sampling is not greedy: it takes the sampled lane (no spec counts)."""
    before = lookup_state.spec_totals
    data = lookup_state.complete("sample", max_new_tokens=4, temperature=0.9,
                                 seed=7)
    assert "spec" not in data and data["tokens"] >= 1
    assert lookup_state.spec_totals == before


def test_lookup_repetitive_prompt_accepts_drafts(jax_solo, lookup_state):
    """A periodic prompt: the proposals land, rounds emit more than one
    token, and the response is still the plain greedy one."""
    text = "ab" * 20
    out = lookup_state.complete(text, max_new_tokens=16)
    _same(out, jax_solo.complete(text, max_new_tokens=16))
    assert out["spec"]["rounds"] <= 16


def test_lookup_config_rejections():
    """Lookup with the round batcher, a MoE target, draft_k or ngram below
    1 and a verify window past the chunk route are refused, and so is the
    int8 KV cache without the slot engine (the reference's wording)."""
    for extra, match in (
            (dict(SERVER_BATCH="4"), "SERVER_BATCH"),
            (dict(SERVE_MODEL="moe-test"), "dense"),
            (dict(SERVE_DRAFT_K="0"), r"SERVE_DRAFT_K \(0\)"),
            (dict(SERVE_NGRAM="0"), r"SERVE_NGRAM \(0\)"),
            (dict(SERVE_DRAFT_K="16"), "MAX_CHUNK = 16"),
            (dict(SERVE_KV_QUANT="1"),
             r"SERVE_PROMPT_LOOKUP with SERVE_KV_QUANT needs "
             r"SERVE_CONTINUOUS_BATCHING=1")):
        with pytest.raises(ValueError, match=match):
            tserver.ServingState(dict(ENV, SERVE_DEVICE="cpu",
                                      SERVE_PROMPT_LOOKUP="1", **extra))


def test_lookup_reserves_draft_k_positions():
    """Every request reserves draft_k positions for the verify window: a
    budget that fits the span alone but not with them is refused."""
    st = _torch_state(SERVE_PROMPT_LOOKUP="1", SERVE_MAX_NEW="100")
    # a bucket of 64: 64 + 60 fits the 128 span, 64 + 60 + 8 does not
    with pytest.raises(ValueError, match=r"\+ draft_k \(8\) exceeds"):
        st.complete("x" * 60, max_new_tokens=60)
    assert st.complete("x" * 60, max_new_tokens=56)["tokens"] >= 1


def test_http_lookup_server_and_healthz():
    """Over HTTP: a completion and its stream equal the plain solo
    server's, and /healthz carries the speculation totals."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tjob, "init_params", _jax_weights)
        srv = tserver.make_server(dict(ENV, SERVE_DEVICE="cpu",
                                       SERVE_PROMPT_LOOKUP="1",
                                       SERVER_PORT="0"))
    plain = _torch_state()
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        host, port = srv.server_address[:2]
        req = {"prompt": "round and round and round", "max_tokens": 10}
        conn = http.client.HTTPConnection(host, port, timeout=60)
        conn.request("POST", "/v1/completions", body=json.dumps(req),
                     headers={"Content-Type": "application/json"})
        data = json.loads(conn.getresponse().read())
        want = plain.complete(req["prompt"], max_new_tokens=10)
        assert data["text"] == want["text"] and "spec" in data
        conn.request("POST", "/v1/completions",
                     body=json.dumps({**req, "stream": True}),
                     headers={"Content-Type": "application/json"})
        body = conn.getresponse().read().decode()
        text = "".join(json.loads(line[6:])["choices"][0]["text"]
                       for line in body.splitlines()
                       if line.startswith("data: {"))
        assert text == want["text"]
        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        assert health["prompt_lookup"]["draft_k"] == 8
        assert health["prompt_lookup"]["source"] == "ngram"
        assert health["prompt_lookup"]["rounds"] >= 2
        conn.close()
    finally:
        srv.shutdown()


# -- the speculating slot engine ------------------------------------------------------


def test_continuous_composes_with_prompt_lookup():
    """Lookup with the slot engine builds one engine with the n-gram
    proposer armed, and no round batcher."""
    st = tserver.ServingState(dict(ENV, SERVE_DEVICE="cpu", **SPEC_NGRAM))
    assert st._engine is not None and st._engine.spec_source == "ngram"
    assert st._batcher is None
    st._engine.close()


@pytest.fixture(scope="module")
def spec_state():
    return _torch_state(**SPEC_NGRAM)


def test_spec_ngram_identity_with_solo_greedy(jax_solo, spec_state):
    """A mixed staggered batch through the speculating engine equals the
    JAX solo server's responses; the totals prove the verify rounds served
    the rows, and the engine's stats carry them."""
    assert spec_state._engine.spec_source == "ngram"
    before = spec_state.spec_totals
    refs = [jax_solo.complete(p, max_new_tokens=b)
            for p, b in zip(PROMPTS, BUDGETS)]
    for out, ref in zip(_fan_out(spec_state, PROMPTS, BUDGETS), refs):
        _same(out, ref)
    after = spec_state.spec_totals
    assert after["rounds"] > before["rounds"]
    assert after["drafted"] > before["drafted"]
    assert after["accepted"] <= after["drafted"]
    stats = spec_state._engine.stats()["speculation"]
    assert stats["source"] == "ngram" and stats["draft_k"] == 4


def test_spec_paged_identity_with_solo_greedy(jax_solo):
    """The same through the page table: the verify scatters through it,
    each round truncates every row's table to its accepted extent, and
    every page is back on the free list once the rows drain."""
    st = _torch_state(SERVE_KV_POOL_MB="0.5", SERVE_KV_PAGE_SIZE="16",
                      **SPEC_NGRAM)
    refs = [jax_solo.complete(p, max_new_tokens=b)
            for p, b in zip(PROMPTS, BUDGETS)]
    for out, ref in zip(_fan_out(st, PROMPTS, BUDGETS), refs):
        _same(out, ref)
    _settle(lambda: st._engine.stats()["occupied"] == 0)
    s = st._engine._pages.stats()
    assert s["free"] + s["live"] + s["pinned"] == s["total"]
    assert s["free"] == s["total"] and not st._engine._table.any()
    assert st._engine.spec_totals["rounds"] > 0
    st._engine.close()


def test_spec_draft_model_identity_with_solo_greedy(jax_solo):
    """The draft model proposes (SERVE_DRAFT_MODEL wins over lookup)
    through its graphed ("spec_draft", width, k) programs; proposals never
    change tokens."""
    st = _torch_state(SERVE_CONTINUOUS_BATCHING="1", SERVER_BATCH="4",
                      SERVE_DRAFT_MODEL="llama-test", SERVE_DRAFT_K="4",
                      SERVE_PROMPT_LOOKUP="1")
    assert st._engine.spec_source == "draft"
    refs = [jax_solo.complete(p, max_new_tokens=b)
            for p, b in zip(PROMPTS, BUDGETS)]
    for out, ref in zip(_fan_out(st, PROMPTS, BUDGETS), refs):
        _same(out, ref)
    keys = {key[0] for key in st.draft.programs.captures}
    assert keys == {"spec_draft"}
    assert ("verify", 4, 4) in st.greedy.programs.replays
    st._engine.close()


def test_spec_draft_model_refusals(tmp_path):
    """A draft of another vocab, an unknown preset and a MoE draft are
    refused; a SERVE_DRAFT_HF_CHECKPOINT draft (served since the HF
    conversion) is held to the same rules once loaded, and
    SERVE_DRAFT_KV_QUANT without a draft model is refused with the
    reference's wording."""
    from dataclasses import replace

    import torch

    from tpu_kubernetes_torch.models import (
        CONFIGS,
        export_hf_llama,
        init_params,
    )

    cfg = replace(CONFIGS["llama-test"], vocab_size=320)
    export_hf_llama(init_params(cfg, torch.Generator().manual_seed(1), "cpu"),
                    cfg, tmp_path / "draft")
    base = dict(ENV, SERVE_DEVICE="cpu", SERVE_CONTINUOUS_BATCHING="1")
    for extra, match in (
            (dict(SERVE_DRAFT_MODEL="llama-1b"), "draft vocab 32000"),
            (dict(SERVE_DRAFT_MODEL="nope"), "unknown SERVE_DRAFT_MODEL"),
            (dict(SERVE_DRAFT_MODEL="moe-test"), "must be dense"),
            (dict(SERVE_DRAFT_HF_CHECKPOINT=str(tmp_path / "draft")),
             "draft vocab 320 != target vocab 256"),
            (dict(SERVE_DRAFT_KV_QUANT="1"),
             r"SERVE_DRAFT_KV_QUANT needs a draft model")):
        with pytest.raises(ValueError, match=match):
            tserver.ServingState(dict(base, **extra))


def test_spec_proposal_refill_after_partial_acceptance(spec_state):
    """The proposal buffer refills from prompt + emitted after every
    round: a period-2 prompt sustains partial acceptance (some drafts
    land, some do not), rounds emit more than one token, identity holds,
    and a released slot's buffer is cleared."""
    solo = _torch_state(SERVE_EARLY_EXIT_STEPS="0")
    text, budget = "ababababababab", 16
    before = spec_state.spec_totals
    out = spec_state.complete(text, max_new_tokens=budget)
    _same(out, solo.complete(text, max_new_tokens=budget))
    after = spec_state.spec_totals
    accepted = after["accepted"] - before["accepted"]
    drafted = after["drafted"] - before["drafted"]
    rounds = after["rounds"] - before["rounds"]
    assert 0 < accepted < drafted
    assert rounds < budget - 1
    _settle(lambda: spec_state._engine.stats()["occupied"] == 0)
    assert all(p == [] for p in spec_state._engine._proposals)


def test_spec_engine_reserves_the_window_past_the_budget(spec_state):
    """An admission whose budget fits the span but not with draft_k more
    is failed out by name (a drained row's window must stay in range)."""
    eng = spec_state._engine
    entry = eng.enqueue([1] * 100, 26)          # bucket 128 + 26 + 4 > 128
    entry["event"].wait(30)
    assert "draft_k 4" in str(entry["error"])


# -- the batch job's speculative modes ------------------------------------------------

JOB_PROMPTS = ["hello tpu", "rings of ici", "short"]


@pytest.fixture()
def prompts_file(tmp_path):
    p = tmp_path / "prompts.txt"
    p.write_text("\n".join(JOB_PROMPTS) + "\n")
    return p


def _env(prompts, out, **extra):
    env = {"SERVE_PROMPTS": str(prompts), "SERVE_OUT": str(out),
           "SERVE_MODEL": "llama-test", "SERVE_MAX_NEW": "6",
           "SERVE_BATCH": "2", "SERVE_DTYPE": "float32"}
    env.update({k: str(v) for k, v in extra.items()})
    return env


def _port_job(env):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tjob, "init_params", _jax_weights)
        return tjob.run_serving(dict(env, SERVE_DEVICE="cpu"))


def _jax_job(env):
    return jjob.run_serving(dict(env, SERVE_MESH="tensor=1"))


def test_speculative_mode_matches_plain_greedy(tmp_path, prompts_file,
                                               capsys):
    """SERVE_DRAFT_MODEL: completions equal the plain greedy job's at the
    speculative span (prompt 12 + new 6 + k 3) and the JAX job's draft
    mode; the log carries the acceptance line and one capture a key."""
    plain = _port_job(_env(prompts_file, tmp_path / "a.txt",
                           SERVE_CACHE_SPAN="21"))
    spec_env = _env(prompts_file, tmp_path / "b.txt",
                    SERVE_DRAFT_MODEL="llama-test", SERVE_DRAFT_K="3")
    capsys.readouterr()
    spec = _port_job(spec_env)
    err = capsys.readouterr().err
    assert spec == plain == _jax_job(spec_env)
    assert "speculative: k=3, accepted" in err
    assert "speculative programs: captures" in err


def test_prompt_lookup_mode_matches_plain_greedy(tmp_path, prompts_file):
    plain = _port_job(_env(prompts_file, tmp_path / "a.txt",
                           SERVE_CACHE_SPAN="22"))
    spec_env = _env(prompts_file, tmp_path / "b.txt",
                    SERVE_PROMPT_LOOKUP="1", SERVE_DRAFT_K="4")
    assert _port_job(spec_env) == plain == _jax_job(spec_env)


def test_prompt_lookup_disabled_by_falsy_values(tmp_path, prompts_file):
    """SERVE_PROMPT_LOOKUP=0 must not turn the mode on (it would refuse
    the sampling temperature)."""
    out = _port_job(_env(prompts_file, tmp_path / "o.txt",
                         SERVE_PROMPT_LOOKUP="0", SERVE_TEMPERATURE="0.7"))
    assert len(out) == len(JOB_PROMPTS)


def test_lookup_and_draft_together_draft_wins(tmp_path, prompts_file):
    draft_only = _port_job(_env(prompts_file, tmp_path / "a.txt",
                                SERVE_DRAFT_MODEL="llama-test",
                                SERVE_DRAFT_K="3"))
    both = _port_job(_env(prompts_file, tmp_path / "b.txt",
                          SERVE_PROMPT_LOOKUP="1",
                          SERVE_DRAFT_MODEL="llama-test", SERVE_DRAFT_K="3"))
    assert both == draft_only


@pytest.mark.parametrize("extra, match", [
    (dict(SERVE_DRAFT_MODEL="llama-test", SERVE_TEMPERATURE="0.7"),
     "greedy"),
    (dict(SERVE_PROMPT_LOOKUP="1", SERVE_MODEL="moe-test"), "dense TARGET"),
    (dict(SERVE_PROMPT_LOOKUP="1", SERVE_DRAFT_K="0"), "must be >= 1"),
    (dict(SERVE_PROMPT_LOOKUP="1", SERVE_DRAFT_K="16"), "draft_k <= 15"),
    (dict(SERVE_DRAFT_MODEL="llama-1b"), "draft vocab 32000"),
    (dict(SERVE_PROMPT_LOOKUP="1", SERVE_MAX_NEW="112"), "SERVE_DRAFT_K"),
])
def test_speculative_refusals(tmp_path, prompts_file, extra, match):
    """Sampling, a MoE target, draft_k out of range, a draft of another
    vocab and a span without room for the window stop the job by name."""
    with pytest.raises(SystemExit, match=match):
        _port_job(_env(prompts_file, tmp_path / "o.txt", **extra))
