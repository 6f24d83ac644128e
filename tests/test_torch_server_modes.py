"""The port server's round batcher, streaming and chat completions against
the JAX package's server on the CPU, and its refusal of the reference's
knobs it does not serve yet.

As in ``tests/test_torch_server.py``, both servers serve ``llama-test`` in
float32 from the same weights. Round batching must never change a
response; MoE with ``SERVER_BATCH`` serves solo; the UTF-8-safe deltas,
the chat transcript and its errors, and the chat response shapes equal
the reference's; the joined greedy SSE deltas equal the non-streamed
text, solo and through the slot engine."""

import http.client
import json
import re
import threading
from pathlib import Path

import jax
import numpy as np
import pytest

from tpu_kubernetes.models import llama as jllama
from tpu_kubernetes.models import moe as jmoe
from tpu_kubernetes.serve import server as jserver
from tpu_kubernetes_torch.models.from_jax import params_from_numpy
from tpu_kubernetes_torch.serve import job as tjob
from tpu_kubernetes_torch.serve import server as tserver
from tests.torch_ops_support import black_box_dirs  # noqa: F401 — autouse

ROOT = Path(__file__).resolve().parents[1]
ENV = {
    "SERVE_MODEL": "llama-test",
    "SERVE_MAX_NEW": "8",
    "SERVE_DTYPE": "float32",    # bf16 ties could break exact-id comparisons
    "SERVER_HOST": "127.0.0.1",
    "SERVER_PORT": "0",
}


def _jax_weights(cfg, generator, device):
    """Stands in for the port's init_params: the JAX server's weights."""
    if hasattr(cfg, "n_experts"):
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


@pytest.fixture(scope="module")
def jax_solo():
    st = jserver.ServingState(dict(ENV))
    st.warm()
    return st


def _concurrently(fn, args):
    outs = {}

    def run(a):
        outs[a] = fn(a)

    threads = [threading.Thread(target=run, args=(a,)) for a in args]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    return outs


# -- round batching ----------------------------------------------------------------

@pytest.fixture(scope="module")
def batch_state():
    return _torch_state(SERVER_BATCH="4", SERVER_BATCH_WINDOW_MS="30")


def test_co_riding_never_changes_a_response(jax_solo, batch_state):
    """Four different prompts at once through the round batcher: each
    response equals the JAX solo server's."""
    assert batch_state._batcher is not None and batch_state._engine is None
    prompts = ["alpha", "beta gamma", "d", "epsilon zeta eta " * 2]
    got = _concurrently(lambda p: batch_state.complete(p, 6), prompts)
    assert got == {p: jax_solo.complete(p, 6) for p in prompts}


def test_mixed_max_new_truncates_per_request(jax_solo, batch_state):
    """Co-riders run to the batch's largest budget, each response stops
    at its own."""
    got = _concurrently(lambda n: batch_state.complete("prefix", n), [3, 8])
    assert got[8] == jax_solo.complete("prefix", 8)
    assert got[3] == jax_solo.complete("prefix", 3)
    assert got[3]["tokens"] == 3


def test_batches_that_would_overflow_max_seq_split():
    """fits() keeps the widest bucket plus the largest run budget within
    max_seq (128 at llama-test): a 40-token prompt (bucket 64, 8 new) and
    a short one with 100 new tokens each fit alone but not together, so
    they ride separate rounds, and both still answer."""
    st = _torch_state(SERVER_BATCH="4", SERVER_BATCH_WINDOW_MS="30",
                      SERVE_MAX_NEW="100")
    seen = []
    inner = st._run_greedy_batch

    def recording(entries):
        seen.append(len(entries))
        inner(entries)

    st._batcher._run_batch = recording
    got = _concurrently(
        lambda a: st.complete(*a), [("y" * 40, 8), ("short", 100)])
    assert got[("y" * 40, 8)]["tokens"] == 8
    assert got[("short", 100)]["tokens"] == 100
    assert sorted(seen) == [1, 1]


def test_moe_with_server_batch_serves_solo(capfd):
    """MoE with SERVER_BATCH > 1 and no engine warns and serves solo, as
    the reference does; its responses equal the reference's."""
    env = dict(ENV, SERVE_MODEL="moe-test", SERVER_BATCH="4")
    ts = _torch_state(SERVE_MODEL="moe-test", SERVER_BATCH="4")
    assert "SERVER_BATCH ignored" in capfd.readouterr().err
    js = jserver.ServingState(env)
    js.warm()
    assert ts._batcher is None and ts._engine is None
    assert js._batcher is None and js._engine is None
    for prompt in ["", "hello"]:
        assert ts.complete(prompt) == js.complete(prompt)


# -- streaming ---------------------------------------------------------------------

class _Text:
    """The byte detokenizer, for the unbound _safe_deltas of both sides."""

    @staticmethod
    def decode_text(ids):
        return bytes(ids).decode("utf-8", errors="replace")


@pytest.mark.parametrize("batches", [
    [[104], [105], [33]],
    # é (c3 a9) and ✓ (e2 9c 93) split across batches
    [[104, 0xC3], [0xA9, 0xE2], [0x9C], [0x93, 33]],
    # a byte that never completes, held back then flushed
    [[104, 0xE2], [0x9C]],
    [[], [0xC3], [], [0xA9]],
])
def test_safe_deltas_equal_jax(batches):
    got = list(tserver.ServingState._safe_deltas(_Text, iter(batches)))
    want = list(jserver.ServingState._safe_deltas(_Text, iter(batches)))
    assert got == want
    assert "".join(got) == _Text.decode_text(sum(batches, []))


def test_stream_cancel_releases_the_lock():
    st = _torch_state()
    cancel = threading.Event()
    pieces = st.stream("hello", 8, cancel=cancel)
    assert next(pieces)
    assert st._lock.locked()
    cancel.set()
    rest = list(pieces)
    assert len(rest) <= 1                   # at most the held-back tail
    assert not st._lock.locked()


def test_streamed_sampled_equals_non_streamed_with_its_seed():
    st = _torch_state()
    kw = dict(max_new_tokens=6, temperature=0.9, top_p=0.9, seed=11)
    finish = {}
    text = "".join(st.stream("seeded", finish=finish, **kw))
    plain = st.complete("seeded", **kw)
    assert text == plain["text"]
    assert finish["reason"] == plain["finish_reason"] == "length"


@pytest.fixture(scope="module", params=["solo", "continuous"])
def live(request):
    extra = ({"SERVE_CONTINUOUS_BATCHING": "1", "SERVER_BATCH": "4"}
             if request.param == "continuous" else {})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tjob, "init_params", _jax_weights)
        srv = tserver.make_server(dict(ENV, SERVE_DEVICE="cpu", **extra))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield srv
    srv.shutdown()
    srv.server_close()
    thread.join(timeout=10)


def _post(srv, path, body, stream=False):
    host, port = srv.server_address[:2]
    conn = http.client.HTTPConnection(host, port, timeout=60)
    try:
        conn.request("POST", path, body=json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        if not stream:
            return resp.status, json.loads(resp.read())
        return resp.status, _read_sse(resp)
    finally:
        conn.close()


def _read_sse(resp):
    """→ (joined text, saw [DONE], content type, finish reason, objects)."""
    pieces, done, reason, objects = [], False, None, set()
    for line in resp.read().decode().splitlines():
        if not line.startswith("data: "):
            continue
        payload = line[len("data: "):]
        if payload == "[DONE]":
            done = True
            continue
        obj = json.loads(payload)
        objects.add(obj["object"])
        choice = obj["choices"][0]
        if choice.get("finish_reason") is not None:
            reason = choice["finish_reason"]
        pieces.append(choice.get("text")
                      or choice.get("delta", {}).get("content", ""))
    return ("".join(pieces), done, resp.getheader("Content-Type"), reason,
            objects)


def test_streamed_greedy_equals_non_streamed(live, jax_solo):
    """stream=true answers chunked SSE whose joined deltas are the
    non-streamed greedy text, on both endpoints, closed by [DONE] with the
    same finish reason."""
    req = {"prompt": "stream me", "max_new_tokens": 6}
    code, plain = _post(live, "/v1/completions", req)
    assert code == 200 and plain == jax_solo.complete("stream me", 6)
    code, (text, done, ctype, reason, objects) = _post(
        live, "/v1/completions", {**req, "stream": True}, stream=True)
    assert code == 200 and ctype.startswith("text/event-stream") and done
    assert text == plain["text"] and reason == "length"
    assert objects == {"text_completion"}
    messages = [{"role": "user", "content": "stream chat"}]
    code, chat = _post(live, "/v1/chat/completions",
                       {"messages": messages, "max_tokens": 6})
    assert code == 200
    code, (text, done, _, reason, objects) = _post(
        live, "/v1/chat/completions",
        {"messages": messages, "max_tokens": 6, "stream": True},
        stream=True)
    assert code == 200 and done and objects == {"chat.completion.chunk"}
    assert text == chat["choices"][0]["message"]["content"]
    assert reason == chat["choices"][0]["finish_reason"] == "length"
    code, err = _post(live, "/v1/completions",
                      {"prompt": "x", "stream": True, "max_new_tokens": 0})
    assert code == 400 and "error" in err


# -- chat completions -------------------------------------------------------------

CHAT_ERRORS = [
    None, [], "hi", [["user", "x"]],
    [{"role": "robot", "content": "x"}],
    [{"role": "user"}],
    [{"role": "user", "content": 3}],
]


def test_chat_prompt_equals_jax_and_its_errors_match():
    messages = [{"role": "system", "content": "be brief"},
                {"role": "user", "content": "héllo ✓"},
                {"role": "assistant", "content": ""}]
    assert (tserver._Handler._chat_prompt(messages)
            == jserver._Handler._chat_prompt(messages))
    for bad in CHAT_ERRORS:
        with pytest.raises(ValueError) as want:
            jserver._Handler._chat_prompt(bad)
        with pytest.raises(ValueError, match=re.escape(str(want.value))):
            tserver._Handler._chat_prompt(bad)


def _shape(obj):
    """The keys of a JSON object, recursively, with the types of leaves."""
    if isinstance(obj, dict):
        return {k: _shape(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_shape(v) for v in obj]
    return type(obj).__name__


@pytest.fixture(scope="module")
def jax_live():
    srv = jserver.make_server(dict(ENV))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield srv
    srv.shutdown()
    srv.server_close()
    thread.join(timeout=10)


def test_chat_response_shapes_match_jax(live, jax_live):
    """chat.completion: the same keys and leaf types as the reference's,
    the same content, finish reason and usage; its content equals
    /v1/completions on the rendered transcript; bad bodies are a 400."""
    messages = [{"role": "system", "content": "be brief"},
                {"role": "user", "content": "hello tpu"}]
    body = {"messages": messages, "max_tokens": 6}
    code, got = _post(live, "/v1/chat/completions", body)
    jcode, want = _post(jax_live, "/v1/chat/completions", body)
    assert code == jcode == 200
    assert _shape(got) == _shape(want)
    for key in ("id", "created"):
        got.pop(key), want.pop(key)
    assert got == want
    assert got["object"] == "chat.completion"
    rendered = "system: be brief\nuser: hello tpu\nassistant:"
    _, plain = _post(live, "/v1/completions",
                     {"prompt": rendered, "max_new_tokens": 6})
    assert got["choices"][0]["message"]["content"] == plain["text"]
    assert got["usage"]["completion_tokens"] == plain["tokens"]
    for bad in [{}] + [{"messages": m} for m in CHAT_ERRORS[1:]]:
        code, err = _post(live, "/v1/chat/completions", bad)
        assert code == 400 and "error" in err, bad


# -- the reference's knobs -------------------------------------------------------

def _reference_knobs() -> set:
    """Every SERVE_* / SERVER_* name the JAX server and its
    load_serving_stack read (from their source text)."""
    server = (ROOT / "tpu_kubernetes/serve/server.py").read_text()
    job = (ROOT / "tpu_kubernetes/serve/job.py").read_text()
    start = job.index("def load_serving_stack")
    stack = job[start:job.index("\ndef ", start + 1)]
    return set(re.findall(r'"(SERVER?_[A-Z_]+)"', server + stack))


def _other_value(read, default):
    if isinstance(default, bool):
        return "1"
    if isinstance(default, (int, float)):
        return str(default + 1)
    return "decode" if default == "serve" else "x"


def test_every_reference_knob_is_read_or_refused():
    """Each knob the reference reads is either read by the port's server
    or refused at start-up with a ValueError naming the ROADMAP.md item
    that brings it; set to its default, a refused knob is accepted."""
    port_text = "".join(
        (ROOT / "tpu_kubernetes_torch/serve" / f).read_text()
        for f in ("server.py", "job.py"))
    knobs = _reference_knobs()
    assert {"SERVE_KV_QUANT", "SERVE_MESH", "SERVER_BATCH",
            "SERVE_CONTINUOUS_BATCHING", "SERVE_QUANT"} <= knobs
    later = tserver.LATER_KNOBS
    assert set(later) <= knobs                 # no knob of its own
    read = {k for k in knobs - set(later) if f'"{k}"' in port_text}
    assert read | set(later) == knobs, knobs - read - set(later)
    assert {"SERVER_BATCH", "SERVER_BATCH_WINDOW_MS",
            "SERVE_CONTINUOUS_BATCHING"} <= read
    for name, (reader, default, item) in later.items():
        env = dict(ENV, SERVE_DEVICE="cpu",
                   **{name: _other_value(reader, default)})
        with pytest.raises(ValueError, match=rf"{name}=.*ROADMAP\.md "
                                             rf"{re.escape(item)}"):
            tserver.ServingState(env)
        tserver.refuse_later_knobs({name: str(default).lower()
                                    if isinstance(default, bool)
                                    else str(default)})
    with pytest.raises(ValueError, match="SERVE_MESH"):
        tserver.make_server(dict(ENV, SERVE_DEVICE="cpu",
                                 SERVE_MESH="tensor=2"))
