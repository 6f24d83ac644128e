"""The reference's observability tests (``tests/test_obs.py``) against the
port's copies: the metrics registry (labels, buckets, Prometheus
exposition), the structured-event sink and its rotation, and the bounded
tracer with its span trees. The reference's run-report and ``get runs``
tests are not here: they drive the JAX package's CLI, backends and run log,
which the port has no counterpart of. The last tests hold the port
server's ``/metrics`` to the JAX server's after the same request sequence
at ``llama-test`` in f32 from the same weights: the same families, types
and label names, and equal request and token counters."""

import http.client
import io
import json
import threading

import pytest

from tests.torch_ops_support import (
    clean_singletons,  # noqa: F401 — autouse
    families,
    jax_weights,
)
# the reference registers tpu_train_checkpoint_seconds in its own
# train/checkpoint.py, as the port does in its copy: imported here, so that
# the reference's registry holds the family whenever an earlier test in the
# worker's process has imported the port's (the train job, the checkpoints)
import tpu_kubernetes.train.checkpoint  # noqa: F401
from tpu_kubernetes_torch.obs import events
from tpu_kubernetes_torch.obs.metrics import (
    CONTENT_TYPE,
    MetricError,
    Registry,
)
from tpu_kubernetes_torch.util.trace import Tracer
from tests.torch_ops_support import keep_jax_ledger  # noqa: F401 — autouse
from tests.torch_ops_support import black_box_dirs  # noqa: F401 — autouse


def test_counter_inc_and_get_or_create():
    reg = Registry()
    c = reg.counter("requests_total", "requests")
    c.inc()
    c.inc(2)
    assert c.value == 3
    # get-or-create: same family object every time
    assert reg.counter("requests_total", "requests") is c
    with pytest.raises(MetricError):
        c.inc(-1)


def test_kind_mismatch_rejected():
    reg = Registry()
    reg.counter("x_total", "x")
    with pytest.raises(MetricError):
        reg.gauge("x_total", "x")
    with pytest.raises(MetricError):
        reg.counter("x_total", "x", labelnames=("a",))


def test_gauge_set_inc_dec():
    reg = Registry()
    g = reg.gauge("temp", "t")
    g.set(5)
    g.inc()
    g.dec(2)
    assert g.value == 4


def test_labels_positional_and_by_name():
    reg = Registry()
    c = reg.counter("ops_total", "ops", labelnames=("command", "status"))
    c.labels("apply", "ok").inc()
    c.labels(command="apply", status="ok").inc()
    assert c.labels("apply", "ok").value == 2
    with pytest.raises(MetricError):
        c.labels("apply")  # wrong arity
    with pytest.raises(MetricError):
        c.labels(command="apply", nope="x")
    with pytest.raises(MetricError):
        c.inc()  # labeled family has no solo child


def test_histogram_buckets_le_semantics():
    reg = Registry()
    h = reg.histogram("lat_seconds", "l", buckets=(0.1, 1.0, 10.0))
    for v in (0.05, 0.1, 0.5, 1.0, 5.0, 100.0):
        h.observe(v)
    text = reg.render()
    # cumulative ≤: boundary values land in their own bucket
    assert 'lat_seconds_bucket{le="0.1"} 2' in text
    assert 'lat_seconds_bucket{le="1"} 4' in text
    assert 'lat_seconds_bucket{le="10"} 5' in text
    assert 'lat_seconds_bucket{le="+Inf"} 6' in text
    assert "lat_seconds_count 6" in text
    assert "lat_seconds_sum 106.65" in text


def test_exposition_golden():
    reg = Registry()
    c = reg.counter("tf_runs_total", "terraform runs", labelnames=("command",))
    c.labels("apply").inc(3)
    g = reg.gauge("workers", "worker count")
    g.set(2)
    assert reg.render() == (
        "# HELP tf_runs_total terraform runs\n"
        "# TYPE tf_runs_total counter\n"
        'tf_runs_total{command="apply"} 3\n'
        "# HELP workers worker count\n"
        "# TYPE workers gauge\n"
        "workers 2\n"
    )
    assert CONTENT_TYPE.startswith("text/plain; version=0.0.4")


def test_label_value_escaping():
    reg = Registry()
    c = reg.counter("weird_total", "w", labelnames=("path",))
    c.labels('a"b\\c\nd').inc()
    assert 'weird_total{path="a\\"b\\\\c\\nd"} 1' in reg.render()


def test_snapshot_prefix_filter():
    reg = Registry()
    reg.counter("tpu_tf_failures_total", "f").inc()
    reg.gauge("tpu_serve_workers", "w").set(1)
    snap = reg.snapshot(prefix="tpu_tf_")
    assert list(snap) == ["tpu_tf_failures_total"]
    assert snap["tpu_tf_failures_total"]["samples"][0]["value"] == 1
    h = reg.histogram("tpu_tf_command_seconds", "s", buckets=(1.0,))
    h.observe(0.5)
    sample = reg.snapshot()["tpu_tf_command_seconds"]["samples"][0]
    assert sample["count"] == 1 and sample["sum"] == 0.5


def test_registry_thread_safety():
    reg = Registry()
    c = reg.counter("n_total", "n", labelnames=("who",))

    def work(who):
        for _ in range(1000):
            c.labels(who).inc()

    threads = [threading.Thread(target=work, args=(str(i % 3),)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sum(c.labels(str(i)).value for i in range(3)) == 6000


@pytest.fixture()
def sink():
    buf = io.StringIO()
    events.configure(stream=buf)
    yield buf
    events.configure()  # remove


def read_events(buf):
    return [json.loads(line) for line in buf.getvalue().splitlines()]


def test_events_disabled_without_sink():
    events.configure()
    events.emit("noop")  # must not raise, and write nowhere


def test_run_and_span_correlation(sink):
    with events.run_context() as rid:
        with events.span("outer") as outer_id:
            with events.span("inner"):
                events.emit("progress", pct=50)
    evs = read_events(sink)
    assert [e["kind"] for e in evs] == [
        "span_start", "span_start", "progress", "span_end", "span_end",
    ]
    assert all(e["run"] == rid for e in evs)
    inner_start = evs[1]
    assert inner_start["parent"] == outer_id
    assert evs[2]["span"] == inner_start["span"]  # progress nested in inner
    assert evs[3]["status"] == "ok" and evs[3]["seconds"] >= 0


def test_span_error_status(sink):
    with pytest.raises(RuntimeError):
        with events.span("doomed"):
            raise RuntimeError("boom")
    end = read_events(sink)[-1]
    assert end["kind"] == "span_end" and end["status"] == "error"


def test_emit_never_raises():
    class Exploding(io.StringIO):
        def write(self, *_):
            raise OSError("disk gone")

    events.configure(stream=Exploding())
    try:
        events.emit("anything")  # swallowed
    finally:
        events.configure()


def test_tracer_phase_records_and_reports():
    tr = Tracer(stream=io.StringIO())
    mark = tr.mark()
    with tr.phase("render", manager="dev"):
        pass
    with tr.phase("apply"):
        pass
    report = tr.report(since=mark)
    assert [p["phase"] for p in report] == ["render", "apply"]
    assert report[0]["manager"] == "dev"
    assert all(p["seconds"] >= 0 for p in report)


def test_tracer_nesting_links_spans(tmp_path):
    tr = Tracer(stream=io.StringIO())
    with tr.phase("outer") as outer:
        with tr.phase("inner") as inner:
            pass
    assert inner.parent_id == outer.span_id


def test_tracer_ring_eviction_keeps_marks_valid():
    tr = Tracer(stream=io.StringIO(), max_spans=4)
    for _ in range(3):
        with tr.phase("early"):
            pass
    mark = tr.mark()
    for i in range(4):  # evicts all three "early" spans
        with tr.phase(f"late{i}"):
            pass
    assert [p["phase"] for p in tr.report(since=mark)] == [
        "late0", "late1", "late2", "late3",
    ]
    assert len(tr.spans) == 4


def test_tracer_reset_since():
    tr = Tracer(stream=io.StringIO())
    with tr.phase("old"):
        pass
    mark = tr.mark()
    with tr.phase("new"):
        pass
    tr.reset(since=mark)
    assert [p["phase"] for p in tr.report()] == ["new"]
    tr.reset()
    assert tr.report() == []


def test_tracer_thread_safety():
    tr = Tracer(stream=io.StringIO(), max_spans=64)

    def work():
        for _ in range(50):
            with tr.phase("p"):
                pass

    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert tr.mark() == 200
    assert len(tr.spans) == 64


def test_tracer_report_with_pre_eviction_mark():
    """A mark taken BEFORE spans that later fall out of the ring must not
    resurrect or double-count anything: report(since=old_mark) returns
    exactly what the ring still holds."""
    tr = Tracer(stream=io.StringIO(), max_spans=4)
    mark = tr.mark()                 # position 0, before any eviction
    for i in range(7):               # three spans evicted by the end
        with tr.phase(f"p{i}"):
            pass
    assert [p["phase"] for p in tr.report(since=mark)] == [
        "p3", "p4", "p5", "p6",
    ]
    # a mark inside the evicted region behaves identically
    assert [p["phase"] for p in tr.report(since=2)] == [
        "p3", "p4", "p5", "p6",
    ]


def test_span_tree_nests_by_run():
    from tpu_kubernetes_torch.util.trace import span_tree

    tr = Tracer(stream=io.StringIO())
    with events.run_context("run-a"):
        with tr.phase("request", endpoint="/x"):
            with tr.phase("queue"):
                pass
            with tr.phase("batch"):
                pass
    with events.run_context("run-b"):
        with tr.phase("other"):
            pass
    tree = span_tree(tr.spans, "run-a")
    assert len(tree) == 1 and tree[0]["name"] == "request"
    assert [c["name"] for c in tree[0]["children"]] == ["queue", "batch"]
    assert span_tree(tr.spans, "run-b")[0]["name"] == "other"
    assert span_tree(tr.spans, "run-missing") == []


def test_event_sink_rotates_by_size(tmp_path):
    path = tmp_path / "events.jsonl"
    sink = events.EventSink(path=str(path), max_bytes=200)
    for i in range(20):
        sink.write({"kind": "tick", "i": i})
    rotated = tmp_path / "events.jsonl.1"
    assert rotated.exists()
    # both generations hold whole lines — rotation lands on boundaries
    for p in (path, rotated):
        lines = p.read_text().splitlines()
        assert lines and all(json.loads(ln)["kind"] == "tick" for ln in lines)
    assert rotated.stat().st_size <= 200
    # the two generations partition the history, newest in the live file
    live = [json.loads(ln)["i"] for ln in path.read_text().splitlines()]
    assert live[-1] == 19


def test_event_sink_rotation_disabled_and_env(tmp_path, monkeypatch):
    path = tmp_path / "events.jsonl"
    sink = events.EventSink(path=str(path), max_bytes=0)   # ≤0 disables
    for i in range(50):
        sink.write({"kind": "tick", "i": i})
    assert not (tmp_path / "events.jsonl.1").exists()
    assert len(path.read_text().splitlines()) == 50

    monkeypatch.setenv("TPU_K8S_EVENTS_MAX_MB", "2")
    assert events.EventSink(path="x")._max_bytes == 2 * 1024 * 1024
    monkeypatch.setenv("TPU_K8S_EVENTS_MAX_MB", "junk")    # bad → default
    assert events.EventSink(path="x")._max_bytes == int(
        events.DEFAULT_MAX_MB * 1024 * 1024
    )
    monkeypatch.delenv("TPU_K8S_EVENTS_MAX_MB")
    assert events.EventSink(path="x")._max_bytes == int(
        events.DEFAULT_MAX_MB * 1024 * 1024
    )


def test_event_sink_keeps_n_generations(tmp_path):
    path = tmp_path / "events.jsonl"
    sink = events.EventSink(path=str(path), max_bytes=120, keep=3)
    for i in range(60):
        sink.write({"kind": "tick", "i": i})
    gens = [tmp_path / f"events.jsonl.{n}" for n in (1, 2, 3)]
    assert all(g.exists() for g in gens)
    assert not (tmp_path / "events.jsonl.4").exists()   # capped at keep
    # generations stay ordered: .1 newer than .2 newer than .3, live newest
    def first_i(p):
        return json.loads(p.read_text().splitlines()[0])["i"]
    order = [first_i(p) for p in (path, *gens)]
    assert order == sorted(order, reverse=True)
    # every surviving line is whole (cascade lands on line boundaries)
    for p in (path, *gens):
        assert all(json.loads(ln)["kind"] == "tick"
                   for ln in p.read_text().splitlines())


def test_event_sink_keep_prunes_stale_generations(tmp_path, monkeypatch):
    path = tmp_path / "events.jsonl"
    # a previous run with a larger keep left generations behind
    for n in (1, 2, 3, 4, 5):
        (tmp_path / f"events.jsonl.{n}").write_text('{"old": %d}\n' % n)
    sink = events.EventSink(path=str(path), max_bytes=60, keep=2)
    for i in range(10):
        sink.write({"kind": "tick", "i": i})
    # prune-on-write: the lowered keep retires .3/.4/.5
    assert not any(
        (tmp_path / f"events.jsonl.{n}").exists() for n in (3, 4, 5))
    assert (tmp_path / "events.jsonl.1").exists()

    # env spelling, with bad values falling back like MAX_MB does
    monkeypatch.setenv("TPU_K8S_EVENTS_KEEP", "4")
    assert events.EventSink(path="x")._keep == 4
    monkeypatch.setenv("TPU_K8S_EVENTS_KEEP", "junk")
    assert events.EventSink(path="x")._keep == events.DEFAULT_KEEP
    monkeypatch.setenv("TPU_K8S_EVENTS_KEEP", "0")     # floor of 1
    assert events.EventSink(path="x")._keep == 1
    monkeypatch.delenv("TPU_K8S_EVENTS_KEEP")
    assert events.EventSink(path="x")._keep == events.DEFAULT_KEEP


def test_event_sink_rotation_failure_swallowed(tmp_path, monkeypatch):
    path = tmp_path / "events.jsonl"
    sink = events.EventSink(path=str(path), max_bytes=50)

    def refuse(*_):
        raise OSError("rename refused")

    monkeypatch.setattr("os.replace", refuse)
    for i in range(10):
        sink.write({"kind": "tick", "i": i})    # must not raise
    assert len(path.read_text().splitlines()) == 10



# -- /metrics against the JAX server ------------------------------------------

SEQUENCE = [
    ("GET", "/healthz", None),
    ("GET", "/v1/models", None),
    ("POST", "/v1/completions", {"prompt": "pack my box", "max_tokens": 5}),
    ("POST", "/v1/completions",
     {"prompt": "the quick brown fox jumps over the lazy dog",
      "max_tokens": 9}),
    ("POST", "/v1/chat/completions",
     {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 4}),
    ("POST", "/v1/completions",
     {"prompt": "sphinx of black quartz", "max_tokens": 6, "stream": True}),
    ("POST", "/v1/completions", {"max_tokens": 3}),         # 400
    ("GET", "/nowhere", None),                               # 404
]
# the families the serving stack defines (the reference's registry also
# holds its trainer's and alert manager's, which the server never feeds)
SERVING = ("tpu_serve_", "tpu_trace_", "tpu_k8s_faults")


def _request(srv, method, path, body):
    host, port = srv.server_address[:2]
    conn = http.client.HTTPConnection(host, port, timeout=120)
    conn.request(method, path,
                 body=None if body is None else json.dumps(body),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, data


@pytest.fixture(scope="module")
def scrapes():
    """Both servers (continuous engine, paged pool, prefix cache) from the
    same weights, the same request sequence through each → for each, its
    /metrics before and after."""
    from tpu_kubernetes.serve.server import make_server as jmake
    from tpu_kubernetes_torch.serve import job as tjob
    from tpu_kubernetes_torch.serve.server import make_server as tmake

    env = {"SERVE_MODEL": "llama-test", "SERVE_MAX_NEW": "16",
           "SERVE_DTYPE": "float32", "SERVER_HOST": "127.0.0.1",
           "SERVER_PORT": "0", "SERVE_CONTINUOUS_BATCHING": "1",
           "SERVER_BATCH": "2", "SERVE_KV_POOL_MB": "0.25",
           "SERVE_PREFIX_CACHE_MB": "4"}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tjob, "init_params", jax_weights)
        port = tmake(dict(env, SERVE_DEVICE="cpu"))
    out = {}
    for name, srv in (("jax", jmake(dict(env))), ("port", port)):
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        try:
            before = families(_request(srv, "GET", "/metrics", None)[1]
                              .decode())
            codes = [_request(srv, *req)[0] for req in SEQUENCE]
            after = families(_request(srv, "GET", "/metrics", None)[1]
                             .decode())
        finally:
            srv.shutdown()
        out[name] = (before, after, codes)
    return out


def test_metrics_families_types_and_labels_equal_jax(scrapes):
    """Every family the port serves is the reference's, with its type and
    label names, and every serving family of the reference is served."""
    ref, port = scrapes["jax"][1], scrapes["port"][1]
    assert scrapes["port"][2] == scrapes["jax"][2]
    assert set(port) <= set(ref), set(port) - set(ref)
    serving = {n for n in ref if n.startswith(SERVING)}
    assert serving <= set(port), serving - set(port)
    assert {"tpu_serve_requests_total", "tpu_serve_tokens_total",
            "tpu_serve_phase_seconds", "tpu_serve_role_info",
            "tpu_serve_kv_pages"} <= serving
    from tpu_kubernetes.obs import REGISTRY as JREGISTRY
    from tpu_kubernetes_torch.obs import REGISTRY as TREGISTRY

    for name in port:
        assert port[name][0] == ref[name][0], name
        # the declared label names (a family with no sample yet shows none)
        assert (TREGISTRY._families[name].labelnames
                == JREGISTRY._families[name].labelnames), name


@pytest.mark.parametrize("family", [
    "tpu_serve_requests_total", "tpu_serve_tokens_generated_total",
    "tpu_serve_prompt_tokens_total", "tpu_serve_tokens_emitted_total",
    "tpu_serve_tokens_total",
])
def test_request_and_token_counters_equal_jax(scrapes, family):
    """The sequence moves the request counters (by endpoint and code) and
    the token counters of both servers by the same amounts."""
    def delta(name):
        before, after, _ = scrapes[name]
        old = before.get(family, (None, {}))[1]
        moved = {k: v - old.get(k, 0.0)
                 for k, v in after[family][1].items()}
        return {k: d for k, d in moved.items() if d}

    got, want = delta("port"), delta("jax")
    assert got == want
    assert any(got.values())
