"""The reference's serve-path resilience tests (``tests/test_resilience.py``)
against the port: deadlines and cancellation (queued, mid-flight,
preflight), admission control and load shedding, the graceful drain, and
the engine watchdog (``serve/resilience.py`` and the port's
``serve/server.py``) on the CPU at ``llama-test``.

The policy layer is torch-free, so its half runs without a model; the
engine and HTTP half drives the port's continuous engine and a live server
with deterministic triggers (a deadline mutated into the past, a scheduler
thread killed by an injected escape), as the reference does."""

import http.client
import json
import threading
import time

import pytest

from tests.torch_ops_support import clean_singletons  # noqa: F401 — autouse
from tpu_kubernetes_torch.serve import resilience as rz
from tpu_kubernetes_torch.serve.resilience import (
    AdmissionController,
    Cancelled,
    DeadlineExceeded,
    DrainController,
    Draining,
    Overloaded,
    Watchdog,
    deadline_from,
    expired,
    warn_once,
)
from tpu_kubernetes_torch.serve.server import ServingState, make_server
from tests.torch_ops_support import keep_jax_ledger  # noqa: F401 — autouse
from tests.torch_ops_support import black_box_dirs  # noqa: F401 — autouse


ENV = {
    "SERVE_MODEL": "llama-test",
    "SERVE_MAX_NEW": "16",
    "SERVE_DTYPE": "float32",
}


def test_deadline_from_anchors_at_receipt():
    assert deadline_from(100.0, 250.0) == pytest.approx(100.25)
    assert deadline_from(100.0, None, default_ms=500.0) == pytest.approx(100.5)
    # 0 / negative / no default → no deadline
    assert deadline_from(100.0, None) is None
    assert deadline_from(100.0, None, default_ms=0.0) is None
    # a per-request override beats the default
    assert deadline_from(100.0, 100.0, default_ms=9000.0) == pytest.approx(100.1)


def test_expired():
    assert not expired(None)
    assert expired(10.0, now=10.0)
    assert expired(10.0, now=11.0)
    assert not expired(10.0, now=9.0)


def test_admission_queue_full_sheds_with_retry_after():
    adm = AdmissionController(max_queue=4)
    adm.admit(3)                                  # below the bound
    with pytest.raises(Overloaded) as exc:
        adm.admit(4)
    assert exc.value.retry_after_s >= 1
    # 0 disables the depth bound entirely
    AdmissionController(max_queue=0).admit(10_000)


def test_admission_doomed_deadline_requires_learning():
    adm = AdmissionController(max_queue=100)
    # nothing learned yet: never shed on a guess
    adm.admit(50, deadline=0.0, now=1000.0)
    adm.observe_service(2.0)                      # ~2 s per queued entry
    with pytest.raises(Overloaded):               # 50 * ~2 s >> 1 s left
        adm.admit(50, deadline=1001.0, now=1000.0)
    adm.admit(1, deadline=1010.0, now=1000.0)     # survivable → admitted


def test_admission_ewma_tracks_service_times():
    adm = AdmissionController()
    adm.observe_service(1.0)
    assert adm.estimated_wait(1) == pytest.approx(1.0)
    adm.observe_service(0.0)
    assert adm.estimated_wait(1) == pytest.approx(0.8)
    assert adm.estimated_wait(10) == pytest.approx(8.0)


def test_drain_controller_state_machine():
    d = DrainController()
    assert not d.is_draining and d.state == "serving"
    assert d.begin("test") is True
    assert d.begin("again") is False              # first caller wins
    assert d.is_draining and d.reason == "test"
    assert not d.wait_drained(timeout=0.01)
    d.mark_drained()
    assert d.state == "drained" and d.wait_drained(timeout=1)


def test_warn_once_counts_every_occurrence(caplog):
    rz.reset_warned()
    c0 = rz.FALLBACKS.labels("test_reason").value
    warn_once("test_reason", "something fell back")
    warn_once("test_reason", "something fell back")
    assert rz.FALLBACKS.labels("test_reason").value == c0 + 2
    rz.reset_warned()


def test_watchdog_restarts_dead_thread_then_gives_up():
    alive = {"v": False}
    calls = {"restart": 0, "give_up": 0}

    def restart():
        calls["restart"] += 1

    wd = Watchdog(lambda: alive["v"], restart, max_restarts=2,
                  interval_s=0.01,
                  on_give_up=lambda: calls.__setitem__("give_up", 1))
    wd.start()
    deadline = time.monotonic() + 5
    while calls["give_up"] == 0 and time.monotonic() < deadline:
        time.sleep(0.01)
    wd.stop()
    assert calls["restart"] == 2                  # bounded restarts
    assert calls["give_up"] == 1                  # then the hard-fail hook


def test_watchdog_never_fires_while_alive():
    calls = {"restart": 0}
    wd = Watchdog(lambda: True, lambda: calls.__setitem__("restart", 1),
                  max_restarts=3, interval_s=0.005)
    wd.start()
    time.sleep(0.05)
    wd.stop()
    assert calls["restart"] == 0


def _state(**extra) -> ServingState:
    st = ServingState(dict(ENV, SERVE_DEVICE="cpu", **extra))
    st.warm()
    return st


@pytest.fixture(scope="module")
def cont_state():
    return _state(SERVE_CONTINUOUS_BATCHING="1", SERVER_BATCH="2")


def _settle(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.005)
    assert pred()


def test_engine_fails_out_expired_queued_entry(cont_state):
    """An entry whose deadline is already past when a slot frees must
    fail out WITHOUT spending a prefill."""
    eng = cont_state._engine
    ids = cont_state.encode("pack my box")
    entry = eng.enqueue(ids, 8, deadline=time.monotonic() - 1.0)
    assert entry["event"].wait(30)
    with pytest.raises(DeadlineExceeded):
        from tpu_kubernetes_torch.serve.server import _Batcher
        _Batcher.result(entry)


def test_engine_retires_expired_resident_slot(cont_state):
    """A resident row whose deadline passes mid-decode is retired from
    its slot: the submitter gets DeadlineExceeded and the slot frees for
    the next admission (the scarce resource comes back)."""
    eng = cont_state._engine
    ids = cont_state.encode("the quick brown fox jumps over the lazy dog")
    # a deadline far enough out to survive admission, then mutated into
    # the past once resident — deterministic, no timer races
    entry = eng.enqueue(ids, 16, deadline=time.monotonic() + 3600)
    assert entry["dispatched"].wait(30)
    assert entry in eng._entries
    entry["deadline"] = time.monotonic() - 1.0
    assert entry["event"].wait(30)
    with pytest.raises(DeadlineExceeded):
        from tpu_kubernetes_torch.serve.server import _Batcher
        _Batcher.result(entry)
    _settle(lambda: entry not in eng._entries)
    # the engine still serves: the freed slot takes the next request
    out = cont_state.complete("pack my box", max_new_tokens=4)
    assert out["text"]


def test_engine_retires_cancelled_resident_slot(cont_state):
    eng = cont_state._engine
    ids = cont_state.encode("sphinx of black quartz judge my vow")
    cancel = threading.Event()
    entry = eng.enqueue(ids, 16, cancel=cancel)
    assert entry["dispatched"].wait(30)
    cancel.set()
    assert entry["event"].wait(30)
    with pytest.raises(Cancelled):
        from tpu_kubernetes_torch.serve.server import _Batcher
        _Batcher.result(entry)
    _settle(lambda: entry not in eng._entries)


def test_watchdog_recovers_killed_scheduler(cont_state):
    """Kill the scheduler thread (an exception that escapes the loop
    itself, past the per-pass try), then verify the watchdog restarts
    it cold within the bound and the engine serves again."""
    st = cont_state
    eng = st._engine

    dead = threading.Event()
    real_reap = eng._reap

    def boom():
        # one-shot: restore the real method (the restarted thread must
        # run clean), then escape the loop via BaseException — the
        # per-pass handler catches Exception, so this kills the thread
        # exactly like an uncatchable runtime escape would
        del eng.__dict__["_reap"]
        dead.set()
        raise SystemExit("injected scheduler death")

    eng.__dict__["_reap"] = boom
    victim = eng.enqueue(st.encode("pack my box"), 8)   # wakes the loop
    assert dead.wait(10)
    # default watchdog interval is 0.5 s — recovery within one restart
    _settle(lambda: eng.restarts >= 1, timeout=15)
    # the victim was failed out by the cold reset, never hung
    assert victim["event"].wait(10)
    assert isinstance(victim["error"], Exception)
    # ... and the fresh scheduler serves correctly
    out = st.complete("pack my box", max_new_tokens=4)
    assert out["text"]
    assert st._engine.stats()["restarts"] >= 1
    assert not st.failed


def test_preflight_rejects_expired_deadline(cont_state):
    with pytest.raises(DeadlineExceeded):
        cont_state.complete("hi", max_new_tokens=2,
                            deadline=time.monotonic() - 1.0)


def test_preflight_sheds_when_queue_full(cont_state):
    full = AdmissionController(max_queue=1)
    real = cont_state.admission
    cont_state.admission = full
    try:
        # depth comes from the engine queue: stuff it directly
        with cont_state._engine._cond:
            cont_state._engine._queue.extend([{}, {}])
            with pytest.raises(Overloaded):
                cont_state.complete("hi", max_new_tokens=2)
            cont_state._engine._queue.clear()
    finally:
        cont_state.admission = real


def test_preflight_refuses_while_draining(cont_state):
    st = cont_state
    real = st.drain
    st.drain = DrainController()
    st.drain.begin("test")        # no worker: flip the flag only
    try:
        with pytest.raises(Draining):
            st.complete("hi", max_new_tokens=2)
        with pytest.raises(Draining):
            list(st.stream("hi", max_new_tokens=2))
    finally:
        st.drain = real


def _request(server, method, path, body=None, timeout=60):
    host, port = server.server_address[:2]
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    conn.request(
        method, path,
        body=None if body is None else json.dumps(body),
        headers={"Content-Type": "application/json"},
    )
    resp = conn.getresponse()
    data = resp.read()
    headers = dict(resp.getheaders())
    conn.close()
    return resp.status, data, headers


def _serve(**extra):
    srv = make_server(dict(
        ENV, SERVE_DEVICE="cpu", SERVER_HOST="127.0.0.1", SERVER_PORT="0",
        SERVE_CONTINUOUS_BATCHING="1", SERVER_BATCH="2", **extra,
    ))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    return srv, thread


@pytest.fixture(scope="module")
def mapping_server():
    """Never drained — shared by every test that only reads statuses."""
    srv, thread = _serve()
    yield srv, thread
    srv.shutdown()


@pytest.fixture()
def drain_server():
    """Function-scoped: a drain is terminal for its server."""
    srv, thread = _serve()
    yield srv, thread
    if thread.is_alive():
        srv.shutdown()


def test_http_maps_resilience_errors(mapping_server):
    srv, _ = mapping_server
    st = srv.RequestHandlerClass.state

    # 504: deadline_ms so small it expires during body handling
    status, body, _ = _request(srv, "POST", "/v1/completions", {
        "prompt": "hi", "max_new_tokens": 2, "deadline_ms": 1e-6,
    })
    assert status == 504
    assert "deadline" in json.loads(body)["error"]

    # 400: non-positive deadline is a config error, not a deadline miss
    status, body, _ = _request(srv, "POST", "/v1/completions", {
        "prompt": "hi", "deadline_ms": -5,
    })
    assert status == 400

    # 429 + Retry-After: admission full
    real = st.admission
    st.admission = AdmissionController(max_queue=1)
    try:
        with st._engine._cond:
            st._engine._queue.extend([{}, {}])
        status, body, headers = _request(srv, "POST", "/v1/completions", {
            "prompt": "hi", "max_new_tokens": 2,
        })
        with st._engine._cond:
            st._engine._queue.clear()
    finally:
        st.admission = real
    assert status == 429
    assert int(headers["Retry-After"]) >= 1

    # 500 JSON (not a dropped socket) on an organic generation failure
    real_complete = st.complete
    st.complete = lambda *a, **k: (_ for _ in ()).throw(
        RuntimeError("chip fell over"))
    try:
        status, body, _ = _request(srv, "POST", "/v1/completions", {
            "prompt": "hi", "max_new_tokens": 2,
        })
    finally:
        st.complete = real_complete
    assert status == 500
    assert "chip fell over" in json.loads(body)["error"]

    # healthz still consistent after the error parade
    status, body, _ = _request(srv, "GET", "/healthz")
    assert status == 200
    payload = json.loads(body)
    assert payload["status"] == "ok"
    assert payload["resilience"]["state"] == "serving"


def test_graceful_drain_end_to_end(drain_server):
    """In-flight continuous requests complete, new requests get 503
    during the drain, /healthz flips, and serve_forever returns (the
    process-exit contract) once quiesced. Drain idempotency (second
    begin_drain → accepted False) rides the same server."""
    srv, thread = drain_server
    st = srv.RequestHandlerClass.state

    results = []

    def inflight():
        results.append(_request(srv, "POST", "/v1/completions", {
            "prompt": "the quick brown fox jumps over the lazy dog",
            "max_new_tokens": 12,
        }))

    t = threading.Thread(target=inflight)
    t.start()
    # wait until the request is resident in the engine, then drain
    deadline = time.monotonic() + 30
    while (st._engine.stats()["occupied"] == 0
           and time.monotonic() < deadline):
        time.sleep(0.002)

    status, body, _ = _request(srv, "POST", "/drain")
    assert status == 202 and json.loads(body)["accepted"] is True
    assert st.begin_drain("again") is False       # first caller wins

    # new work refused while draining (until the listener closes)
    try:
        status, body, _ = _request(srv, "POST", "/v1/completions", {
            "prompt": "hi", "max_new_tokens": 2,
        })
        assert status == 503
    except (ConnectionRefusedError, ConnectionResetError,
            http.client.HTTPException):
        pass                      # listener already closed — also valid

    t.join(60)
    assert not t.is_alive()
    status, body, _ = results[0]
    assert status == 200 and json.loads(body)["text"]   # finished cleanly

    assert st.drain.wait_drained(timeout=30)
    thread.join(30)
    assert not thread.is_alive()                  # serve_forever returned
    assert st._quiesced()

