"""The port's HTTP completions server against the JAX package's on the CPU.

Both ``ServingState``s serve ``llama-test`` in float32 from the same
weights: the port's ``init_params`` is patched to hand back the JAX
``init_params(PRNGKey(0), cfg)`` tree through ``models.from_jax``, which
is what the JAX server draws. Greedy ``complete()`` must then give the
same token ids, text, count and finish reason for every prompt (empty,
short, ragged widths, multi-byte, with and without EOS). Sampled
requests are checked for their budget and range only: ``torch.Generator``
and ``jax.random`` draw different bits. One live HTTP round trip runs on
the port."""

import http.client
import json
import threading

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
    "SERVE_MAX_NEW": "8",
    "SERVE_DTYPE": "float32",    # bf16 ties could break exact-id comparisons
}
PROMPTS = ["", "hello", "the quick brown fox jumps over the lazy dog",
           "héllo wörld ✓", "x" * 17]


def _jax_weights(cfg, generator, device):
    """Stands in for the port's init_params: the JAX server's weights."""
    jp = jllama.init_params(jax.random.PRNGKey(0),
                            jllama.CONFIGS["llama-test"])
    return params_from_numpy(jax.tree.map(np.asarray, jp), device=device)


def _recording(state):
    """Wrap the state's detokenizer so the raw ids of each response are
    kept beside its text."""
    inner = state.decode_text
    state.last_ids = None

    def decode(ids):
        state.last_ids = list(ids)
        return inner(ids)

    state.decode_text = decode
    return state


def _torch_state(**extra):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tjob, "init_params", _jax_weights)
        st = tserver.ServingState(dict(ENV, SERVE_DEVICE="cpu", **extra))
    st.warm()
    return _recording(st)


def _jax_state(**extra):
    st = JState(dict(ENV, **extra))
    st.warm()
    return _recording(st)


@pytest.fixture(scope="module")
def states():
    return _jax_state(), _torch_state()


@pytest.mark.parametrize("max_new", [None, 1, 3, 5])
@pytest.mark.parametrize("prompt", PROMPTS)
def test_greedy_complete_identical_to_jax(states, prompt, max_new):
    js, ts = states
    ref = js.complete(prompt, max_new_tokens=max_new)
    got = ts.complete(prompt, max_new_tokens=max_new)
    assert ts.last_ids == js.last_ids
    assert got == ref
    assert got["tokens"] == (max_new or 8)


def test_greedy_complete_with_eos_identical_to_jax(states):
    """An EOS id taken from the free-running output cuts both servers'
    responses at the same place, with finish_reason "stop"."""
    _, ts = states
    ts.complete("hello")
    eos = ts.last_ids[2]
    js_eos = _jax_state(SERVE_EOS_ID=str(eos))
    ts_eos = _torch_state(SERVE_EOS_ID=str(eos))
    stopped = 0
    for prompt in PROMPTS:
        ref = js_eos.complete(prompt)
        got = ts_eos.complete(prompt)
        assert ts_eos.last_ids == js_eos.last_ids
        assert got == ref
        stopped += got["finish_reason"] == "stop"
    assert stopped >= 1
    assert ts_eos.complete("hello")["tokens"] == 2


@pytest.mark.parametrize("early_exit", ["0", "1", "3"])
def test_early_exit_interval_never_changes_tokens(states, early_exit):
    """SERVE_EARLY_EXIT_STEPS only decides when the decode loop may stop."""
    _, ts = states
    other = _torch_state(SERVE_EARLY_EXIT_STEPS=early_exit)
    for prompt in PROMPTS[:3]:
        assert other.complete(prompt, 5) == ts.complete(prompt, 5)


def test_sampled_complete_keeps_budget_and_seed(states):
    _, ts = states
    a = ts.complete("hello", max_new_tokens=6, temperature=1.0, seed=1)
    ids_a = ts.last_ids
    b = ts.complete("hello", max_new_tokens=6, temperature=1.0, seed=1)
    assert a == b and a["tokens"] == 6 and a["finish_reason"] == "length"
    assert all(0 <= t < 256 for t in ids_a)
    # top_k=1 collapses sampling onto the greedy choice
    k1 = ts.complete("hello", max_new_tokens=6, temperature=0.7, top_k=1,
                     seed=9)
    assert k1 == ts.complete("hello", max_new_tokens=6)


def test_validation_matches_jax(states):
    js, ts = states
    for st in (js, ts):
        with pytest.raises(ValueError, match=">= 1"):
            st.complete("hi", max_new_tokens=0)
        with pytest.raises(ValueError, match="exceeds max_seq"):
            st.complete("y" * 125, max_new_tokens=8)
    assert ts._validate("y" * 17, 5) == js._validate("y" * 17, 5)
    assert tserver._bucket(17) == 32 and tserver._bucket_max_new(5, 64) == 8
    assert tserver._is_greedy(0.0, 0, 0.0)
    assert not tserver._is_greedy(0.0, 0, 0.9)


@pytest.mark.parametrize("name,value,slice_word", [
    # served now (tests/test_torch_finetune.py); a missing checkpoint is
    # refused by name, and the id keeps the case it had
    pytest.param("SERVE_HF_CHECKPOINT", "/nonexistent",
                 "SERVE_HF_CHECKPOINT='/nonexistent': no checkpoint",
                 id="SERVE_HF_CHECKPOINT-/nonexistent-tooling"),
    ("SERVE_QUANT", "int4", "SERVE_QUANT must be 'int8'"),
    ("SERVE_DTYPE", "float16", "SERVE_DTYPE"),
    ("SERVE_MODEL", "llama-moe-test", "unknown SERVE_MODEL"),
])
def test_load_serving_stack_refuses_what_it_cannot_serve(name, value,
                                                         slice_word):
    env = dict(ENV, SERVE_DEVICE="cpu", **{name: value})
    with pytest.raises(SystemExit, match=slice_word):
        tjob.load_serving_stack(env)


def test_load_serving_stack_refuses_a_vocab_it_cannot_render():
    env = dict(ENV, SERVE_DEVICE="cpu", SERVE_MODEL="llama-125m")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tjob, "init_params", lambda cfg, g, device: {})
        mp.setattr(tjob, "_cast", lambda tree, dtype: tree)
        with pytest.raises(SystemExit, match="cannot render"):
            tjob.load_serving_stack(env)


def test_truthy_env_and_envparse_rules():
    from tpu_kubernetes.util import envparse as jenv
    from tpu_kubernetes_torch.util import envparse as tenv

    env = {"A": "off", "B": " Yes ", "C": "", "N": "12", "X": "eight",
           "F": "0.25"}
    for name in "ABCZ":
        assert tjob.truthy_env(env, name) == jenv.env_bool(name, env=env)
    assert tenv.env_int("N", 3, env=env) == 12
    assert tenv.env_int("X", 3, env=env) == jenv.env_int("X", 3, env=env)
    assert tenv.env_float("F", 1.0, env=env) == 0.25
    assert tenv.env_str("C", "dflt", env=env) == "dflt"


@pytest.fixture()
def live_server():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tjob, "init_params", _jax_weights)
        srv = tserver.make_server(dict(ENV, SERVE_DEVICE="cpu",
                                       SERVER_PORT="0"))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield srv
    srv.shutdown()
    srv.server_close()
    thread.join(timeout=10)


def _call(srv, method, path, body=None):
    host, port = srv.server_address[:2]
    conn = http.client.HTTPConnection(host, port, timeout=60)
    try:
        conn.request(method, path,
                     body=None if body is None else json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def test_http_round_trip(live_server, states):
    js, _ = states
    code, health = _call(live_server, "GET", "/healthz")
    assert code == 200 and health["status"] == "ok"
    assert health["device"] == "cpu"
    code, models = _call(live_server, "GET", "/v1/models")
    assert code == 200 and models["data"][0]["id"] == "llama-test"
    code, out = _call(live_server, "POST", "/v1/completions",
                      {"prompt": "hello", "max_tokens": 4})
    assert code == 200
    assert out == js.complete("hello", max_new_tokens=4)
    code, out = _call(live_server, "POST", "/v1/completions",
                      {"prompt": "hello", "max_new_tokens": 3,
                       "temperature": 0.9, "top_p": 0.9, "seed": 4})
    assert code == 200 and out["tokens"] == 3
    for bad in ({"max_tokens": 4}, {"prompt": "a", "max_tokens": 0},
                {"prompt": "a", "top_k": [1]}):
        code, err = _call(live_server, "POST", "/v1/completions", bad)
        assert code == 400 and "error" in err
    assert _call(live_server, "GET", "/nope")[0] == 404
    # streaming and chat completions are served: SSE frames ending in
    # [DONE], and a chat.completion whose body is validated (no
    # "messages" is a 400, not an unknown path)
    host, port = live_server.server_address[:2]
    conn = http.client.HTTPConnection(host, port, timeout=60)
    try:
        conn.request("POST", "/v1/completions",
                     body=json.dumps({"prompt": "hello", "max_tokens": 4,
                                      "stream": True}),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200
        assert resp.getheader("Content-Type") == "text/event-stream"
        frames = resp.read().decode()
    finally:
        conn.close()
    assert frames.rstrip().endswith("data: [DONE]")
    assert frames.count("data: {") >= 2        # a piece and the last frame
    code, chat = _call(live_server, "POST", "/v1/chat/completions",
                       {"messages": [{"role": "user", "content": "a"}],
                        "max_tokens": 3})
    assert code == 200 and chat["object"] == "chat.completion"
    assert chat["usage"]["completion_tokens"] == 3
    code, err = _call(live_server, "POST", "/v1/chat/completions",
                      {"prompt": "a"})
    assert code == 400 and "messages" in err["error"]


def test_entry_points_default_to_cuda():
    """Without SERVE_DEVICE the server asks for the card, and says so when
    there is none; the model entry points default to cuda too."""
    import inspect

    from tpu_kubernetes_torch.models import decode as tdec
    from tpu_kubernetes_torch.models import llama as tllama

    assert inspect.signature(tllama.init_params).parameters[
        "device"].default == "cuda"
    assert inspect.signature(tdec.init_cache).parameters[
        "device"].default == "cuda"
    seen = {}

    def fake_init(cfg, generator, device):
        seen["device"] = device
        raise RuntimeError("stop")

    cpu_generator = torch.Generator
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tjob.torch.cuda, "is_available", lambda: False)
        with pytest.raises(SystemExit, match="SERVE_DEVICE=cpu"):
            tjob.load_serving_stack({"SERVE_MODEL": "llama-test"})
        mp.setattr(tjob.torch.cuda, "is_available", lambda: True)
        mp.setattr(tjob, "init_params", fake_init)
        mp.setattr(tjob.torch, "Generator", lambda device: cpu_generator())
        with pytest.raises(RuntimeError, match="stop"):
            tjob.load_serving_stack({"SERVE_MODEL": "llama-test"})
    assert seen["device"] == torch.device("cuda")
