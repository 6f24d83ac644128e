"""The reference's distributed-tracing tests (``tests/test_tracing.py``)
against the port's ``obs/tracing.py`` and its server: W3C ``traceparent``
propagation, deterministic head sampling and tail capture, the bounded
non-blocking span exporter, cross-instance stitching, and two live port
servers on the CPU whose one client ``traceparent`` becomes one stitched
trace, its critical-path phases accounting for the wall latency. The
reference's ``get trace`` CLI calls are replaced by the same fetch and
stitch through ``obs/tracing.py`` (the port has no CLI), and its fleet
aggregator's scrape by a request carrying ``outbound_headers()`` (the
aggregator waits for ROADMAP.md queue 1 item 3.5b)."""

import http.client
import json
import random
import threading
import time

import pytest

from tests.torch_ops_support import clean_singletons  # noqa: F401 — autouse
from tpu_kubernetes_torch.obs import tracing
from tpu_kubernetes_torch.obs.faults import injected
from tpu_kubernetes_torch.obs.tracing import (
    SPANS_DROPPED,
    SPANS_EXPORTED,
    SpanExporter,
    TraceConfig,
    TraceContext,
    TraceRuntime,
    critical_path,
    current_trace,
    head_sampled,
    new_span_id,
    new_trace_id,
    outbound_headers,
    parse_traceparent,
    render_traceparent,
    span_export_record,
    stitch_trace,
    trace_payload,
    trace_scope,
)
from tpu_kubernetes_torch.util.trace import Tracer
from tests.torch_ops_support import keep_jax_ledger  # noqa: F401 — autouse
from tests.torch_ops_support import black_box_dirs  # noqa: F401 — autouse

TID = "4bf92f3577b34da6a3ce929d0e0e4736"


SID = "00f067aa0ba902b7"


def test_traceparent_round_trip():
    ctx = TraceContext(TID, SID, sampled=True)
    assert render_traceparent(ctx) == f"00-{TID}-{SID}-01"
    assert parse_traceparent(render_traceparent(ctx)) == ctx
    unsampled = TraceContext(TID, SID, sampled=False)
    assert render_traceparent(unsampled).endswith("-00")
    assert parse_traceparent(render_traceparent(unsampled)) == unsampled


def test_traceparent_parse_tolerates_case_and_whitespace():
    ctx = parse_traceparent(f"  00-{TID.upper()}-{SID.upper()}-01  ")
    assert ctx is not None
    assert ctx.trace_id == TID and ctx.span_id == SID and ctx.sampled


@pytest.mark.parametrize("header", [
    None, "", "garbage",
    f"00-{TID}-{SID}",                      # missing flags
    f"00-{TID}-{SID}-01-extra",             # version 00: exactly 4 fields
    f"ff-{TID}-{SID}-01",                   # forbidden version
    f"0x-{TID}-{SID}-01",                   # non-hex version
    f"00-{'0' * 32}-{SID}-01",              # all-zero trace id
    f"00-{TID}-{'0' * 16}-01",              # all-zero span id
    f"00-{TID[:31]}-{SID}-01",              # short trace id
    f"00-{TID}-{SID[:15]}-01",              # short span id
    f"00-{TID}-{SID}-1",                    # short flags
    f"00-{'g' * 32}-{SID}-01",              # non-hex trace id
])
def test_traceparent_rejects_malformed(header):
    assert parse_traceparent(header) is None


def test_traceparent_accepts_future_versions_with_extra_fields():
    ctx = parse_traceparent(f"42-{TID}-{SID}-01-what-ever")
    assert ctx is not None and ctx.trace_id == TID


def test_ids_deterministic_under_injected_rng():
    assert new_trace_id(random.Random(7)) == new_trace_id(random.Random(7))
    assert new_span_id(random.Random(7)) == new_span_id(random.Random(7))
    assert new_trace_id(random.Random(7)) != new_trace_id(random.Random(8))
    assert len(new_trace_id()) == 32 and len(new_span_id()) == 16


def test_head_sampling_is_deterministic_and_calibrated():
    assert head_sampled(TID, 1.0) and not head_sampled(TID, 0.0)
    rng = random.Random(123)
    ids = [new_trace_id(rng) for _ in range(1000)]
    kept = [t for t in ids if head_sampled(t, 0.5)]
    # same id → same verdict, every time, on every "instance"
    assert all(head_sampled(t, 0.5) for t in kept)
    assert 350 < len(kept) < 650        # the rate actually means the rate
    assert head_sampled("zz", 0.5) is False  # garbage id → drop, no raise


def test_trace_scope_contextvar():
    assert current_trace() is None
    ctx = TraceContext(TID, SID)
    with trace_scope(ctx):
        assert current_trace() is ctx
        assert tracing.current_trace_id() == TID
    assert current_trace() is None and tracing.current_trace_id() == ""


def test_outbound_headers_child_of_ambient_context():
    ctx = TraceContext(TID, SID, sampled=True)
    with trace_scope(ctx):
        out = outbound_headers({"Accept": "text/plain"})
    sent = parse_traceparent(out[tracing.TRACEPARENT])
    assert out["Accept"] == "text/plain"
    assert sent.trace_id == TID and sent.span_id != SID and sent.sampled


def test_outbound_headers_fresh_root_without_context():
    out = outbound_headers(rng=random.Random(5), sample=1.0)
    sent = parse_traceparent(out[tracing.TRACEPARENT])
    assert sent is not None and sent.sampled
    again = outbound_headers(rng=random.Random(5), sample=1.0)
    assert out == again                  # injected rng → fully determined


def test_trace_config_from_env_defaults_and_clamps():
    cfg = TraceConfig.from_env({})
    assert cfg == TraceConfig()
    cfg = TraceConfig.from_env({
        "TPU_K8S_TRACE_SAMPLE": "2.5",          # clamped into [0, 1]
        "TPU_K8S_TRACE_SLOW_S": "0.25",
        "TPU_K8S_TRACE_EXPORT_PATH": "/tmp/spans.jsonl",
        "TPU_K8S_TRACE_EXPORT_QUEUE": "-3",     # floor of 1
    })
    assert cfg.sample == 1.0 and cfg.slow_s == 0.25
    assert cfg.export_path == "/tmp/spans.jsonl" and cfg.queue_max == 1


def test_extract_continues_callers_trace():
    rt = TraceRuntime(TraceConfig(sample=0.0), rng=random.Random(1))
    ctx = rt.extract(f"00-{TID}-{SID}-01")
    # the caller's trace id and SAMPLED verdict win; our span id is fresh
    assert ctx.trace_id == TID and ctx.span_id != SID and ctx.sampled
    assert not rt.extract(f"00-{TID}-{SID}-00").sampled


def test_extract_mints_deterministic_roots_under_injected_rng():
    def sequence(seed):
        rt = TraceRuntime(TraceConfig(sample=0.5), rng=random.Random(seed))
        return [(c.trace_id, c.sampled) for c in
                (rt.extract(None) for _ in range(50))]

    a, b = sequence(42), sequence(42)
    assert a == b                        # injected rng/clock → reproducible
    # and the sampled bit is the deterministic function of the trace id
    assert all(s == head_sampled(t, 0.5) for t, s in a)
    assert {s for _, s in a} == {True, False}


def test_should_export_head_and_tail():
    rt = TraceRuntime(TraceConfig(sample=0.0, slow_s=0.5))
    kept = TraceContext(TID, SID, sampled=True)
    dropped = TraceContext(TID, SID, sampled=False)
    assert rt.should_export(kept, code=200, wall_s=0.01)
    assert not rt.should_export(dropped, code=200, wall_s=0.01)
    # tail capture: errors, deadline 504s, sheds, and slow requests stay
    assert rt.should_export(dropped, code=500, wall_s=0.01)
    assert rt.should_export(dropped, code=504, wall_s=0.01)
    assert rt.should_export(dropped, code=429, wall_s=0.01)
    assert rt.should_export(dropped, code=200, wall_s=0.6)
    assert not rt.should_export(None, code=500, wall_s=9.0)


def _records(n, trace=TID):
    return [
        {"trace": trace, "span": f"{i:016x}", "parent": "", "run": "r",
         "name": "request", "start_unix_nano": i, "end_unix_nano": i + 1,
         "attrs": {}, "instance": "t"}
        for i in range(1, n + 1)
    ]


def test_exporter_disabled_without_sinks():
    ex = SpanExporter()
    assert not ex.enabled
    assert ex.submit(_records(3)) == 0   # no thread, no queue, no raise
    ex.close()


def test_exporter_writes_jsonl(tmp_path):
    path = tmp_path / "spans.jsonl"
    ex = SpanExporter(path=str(path))
    assert ex.submit(_records(3)) == 3
    assert ex.flush(5.0)
    ex.close()
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert [r["span"] for r in lines] == [r["span"] for r in _records(3)]
    assert all(r["trace"] == TID for r in lines)


def test_exporter_bounded_queue_drops_and_counts(tmp_path):
    before = SPANS_DROPPED.value
    ex = SpanExporter(path=str(tmp_path / "s.jsonl"), queue_max=4)
    # one oversized submit: room is computed under the lock in a single
    # pass, so at most queue_max records fit and the rest drop-newest
    accepted = ex.submit(_records(10))
    assert accepted <= 4
    assert SPANS_DROPPED.value >= before + 6
    assert ex.flush(5.0)
    ex.close()


def test_exporter_chaos_drops_batch_silently(tmp_path):
    path = tmp_path / "spans.jsonl"
    ex = SpanExporter(path=str(path))
    d0, e0 = SPANS_DROPPED.value, SPANS_EXPORTED.value
    with injected("obs.trace_export:1.0"):
        assert ex.submit(_records(5)) == 5
        assert ex.flush(5.0)             # attempted, failed, dropped
    assert SPANS_DROPPED.value >= d0 + 5
    assert not path.exists() or path.read_text() == ""
    # faults cleared: the same exporter delivers again
    assert ex.submit(_records(2)) == 2
    assert ex.flush(5.0)
    ex.close()
    assert SPANS_EXPORTED.value >= e0 + 2
    assert len(path.read_text().splitlines()) == 2


def test_finish_request_exports_request_and_linked_segment(tmp_path):
    tracer = Tracer()
    # one request's spans plus a scheduler segment linked to its trace
    tracer.record("request", 0.2, run_id="run-1", trace=TID)
    tracer.record("queue", 0.05, run_id="run-1")
    tracer.record("segment", 0.1, run_id="", links=[TID], device_s=0.1)
    tracer.record("request", 0.3, run_id="run-2", trace="f" * 32)

    path = tmp_path / "spans.jsonl"
    rt = TraceRuntime(
        TraceConfig(sample=1.0),
        exporter=SpanExporter(path=str(path)),
    )
    ctx = TraceContext(TID, SID, sampled=True)
    n = rt.finish_request(tracer, "run-1", ctx, code=200, wall_s=0.2,
                          instance="127.0.0.1:1")
    assert n == 3                        # run-1's two spans + the segment
    assert rt.exporter.flush(5.0)
    rt.close()
    recs = [json.loads(x) for x in path.read_text().splitlines()]
    assert {r["name"] for r in recs} == {"request", "queue", "segment"}
    assert all(r["trace"] == TID for r in recs)
    assert all(r["instance"] == "127.0.0.1:1" for r in recs)
    # span clocks were rebased to unix nanos for cross-host ordering
    assert all(r["end_unix_nano"] > 10 ** 18 for r in recs)


def test_finish_request_never_blocks_or_raises_when_disabled():
    rt = TraceRuntime(TraceConfig())     # no sinks → disabled exporter
    assert rt.finish_request(Tracer(), "r", TraceContext(TID, SID)) == 0
    assert rt.finish_request(None, "r", None) == 0   # garbage in, 0 out
    rt.close()


def test_span_export_record_shapes_otlp():
    tracer = Tracer()
    span = tracer.record("request", 0.1, run_id="r1", endpoint="/x")
    rec = span_export_record(span, TID, instance="a:1")
    payload = tracing._otlp_payload([rec])
    otlp = payload["resourceSpans"][0]["scopeSpans"][0]["spans"][0]
    assert otlp["traceId"] == TID and len(otlp["spanId"]) == 16
    assert otlp["name"] == "request"
    assert {"key": "endpoint", "value": {"stringValue": "/x"}} \
        in otlp["attributes"]


def _fake_payload(wall=1.0):
    return {
        "trace": TID,
        "runs": ["run-1"],
        "spans": [{
            "name": "request", "seconds": wall,
            "meta": {"trace": TID, "endpoint": "/v1/completions"},
            "children": [
                {"name": "queue", "seconds": 0.2, "children": []},
                {"name": "batch", "seconds": 0.7,
                 "meta": {"admission_wait_s": 0.15, "device_s": 0.5,
                          "tokens": {"useful": 8, "trimmed": 2}},
                 "children": []},
                {"name": "decode", "seconds": 0.05, "children": []},
            ],
        }],
        "segments": [
            {"name": "segment", "seconds": 0.25,
             "meta": {"links": [TID], "device_s": 0.25}},
        ],
    }


def test_trace_payload_collects_runs_and_linked_segments():
    tracer = Tracer()
    tracer.record("request", 0.2, run_id="run-1", trace=TID)
    tracer.record("segment", 0.1, run_id="", links=[TID, "e" * 32])
    tracer.record("segment", 0.1, run_id="", links=["e" * 32])
    tracer.record("request", 0.2, run_id="run-9", trace="e" * 32)
    p = trace_payload(tracer.spans, TID)
    assert p["runs"] == ["run-1"]
    assert len(p["spans"]) == 1 and p["spans"][0]["name"] == "request"
    assert len(p["segments"]) == 1
    assert TID in p["segments"][0]["meta"]["links"]


def test_stitch_and_critical_path():
    stitched = stitch_trace(TID, {
        "a:1": _fake_payload(wall=1.0),
        "b:2": {"trace": TID, "runs": [], "spans": [], "segments": []},
    })
    assert sorted(stitched["instances"]) == ["a:1", "b:2"]
    cp = stitched["critical_path"]
    assert cp["wall_s"] == pytest.approx(1.0)
    assert cp["phases"] == {"queue": 0.2, "batch": 0.7, "decode": 0.05}
    assert cp["accounted_s"] == pytest.approx(0.95)
    assert cp["admission_wait_s"] == pytest.approx(0.15)
    assert cp["device_s"] == pytest.approx(0.25)
    assert cp["segments"] == 1
    assert cp["tokens"] == {"useful": 8, "trimmed": 2}


def test_critical_path_empty_stitch():
    cp = critical_path({"instances": {}})
    assert cp["wall_s"] == 0.0 and cp["phases"] == {}


def test_render_trace_smoke():
    text = tracing.render_trace(stitch_trace(TID, {
        "a:1": _fake_payload(),
    }))
    assert TID in text
    assert "critical path:" in text
    assert "queue" in text and "batch" in text
    assert "instance a:1" in text


ENV = {
    "SERVE_MODEL": "llama-test",
    "SERVE_MAX_NEW": "16",
    "SERVE_DTYPE": "float32",
    "SERVER_HOST": "127.0.0.1",
    "SERVER_PORT": "0",
    "SERVE_CONTINUOUS_BATCHING": "1",
    "SERVER_BATCH": "2",
}


@pytest.fixture(scope="module")
def two_servers():
    from tpu_kubernetes_torch.serve.server import make_server

    servers = [make_server(dict(ENV, SERVE_DEVICE="cpu"))
               for _ in range(2)]
    threads = [
        threading.Thread(target=s.serve_forever, daemon=True)
        for s in servers
    ]
    for t in threads:
        t.start()
    yield servers
    for s in servers:
        s.shutdown()


def _post(server, path, body, headers=None):
    host, port = server.server_address[:2]
    conn = http.client.HTTPConnection(host, port, timeout=120)
    conn.request("POST", path, body=json.dumps(body),
                 headers=dict({"Content-Type": "application/json"},
                              **(headers or {})))
    resp = conn.getresponse()
    data = json.loads(resp.read() or b"{}")
    hdrs = {k.lower(): v for k, v in resp.getheaders()}
    conn.close()
    return resp.status, data, hdrs


def _target(server):
    host, port = server.server_address[:2]
    return f"{host}:{port}"


def _get_trace(tid: str, targets: list) -> tuple[int, dict | None]:
    """The reference's ``get trace`` over the port's ``obs/tracing.py``:
    each reachable instance's view, stitched → (exit code, the stitched
    trace): 1 when no instance knows the trace, 2 without an id."""
    if not tid:
        return 2, None
    payloads = {}
    for target in targets:
        try:
            payloads[target] = tracing.fetch_trace(target, tid)
        except Exception:  # noqa: BLE001 — a dead or unaware instance
            pass
    if not payloads:
        return 1, None
    return 0, tracing.stitch_trace(tid, payloads)


def test_two_server_propagation_stitches_one_trace(two_servers):
    """The tentpole acceptance path: the same client traceparent sent to
    two instances yields ONE stitched trace spanning both, with segment
    spans linked to it, and a critical path whose phase durations
    account for the wall latency."""
    a, b = two_servers
    tid = new_trace_id(random.Random(99))
    header = {"traceparent": f"00-{tid}-{SID}-01"}

    for srv in (a, b):
        status, data, hdrs = _post(
            srv, "/v1/completions",
            {"prompt": "the quick brown fox", "max_new_tokens": 4},
            headers=header,
        )
        assert status == 200 and data["text"] is not None
        echoed = parse_traceparent(hdrs.get("traceparent"))
        # the response continues OUR trace with the server's own span id
        assert echoed.trace_id == tid and echoed.span_id != SID
        assert echoed.sampled

    # each instance answers /debug/trace/<trace_id> over HTTP (both
    # in-process servers share the module-global span ring, so each
    # view covers both runs — the live HTTP + stitch path is the test)
    for srv in (a, b):
        payload = tracing.fetch_trace(_target(srv), tid)
        assert payload["trace"] == tid
        assert len(payload["runs"]) >= 1
        roots = payload["spans"]
        assert roots and all(r["name"] == "request" for r in roots)
        assert all(r["meta"]["trace"] == tid for r in roots)
        # the continuous scheduler linked its decode segments to us
        assert payload["segments"]
        assert all(tid in s["meta"]["links"] for s in payload["segments"])

    # the CLI stitches both views into one cross-instance trace
    code, stitched = _get_trace(tid, [_target(a), _target(b)])
    assert code == 0
    assert stitched["trace"] == tid
    assert len(stitched["instances"]) == 2
    assert all(len(v["spans"]) >= 1 for v in stitched["instances"].values())

    cp = stitched["critical_path"]
    assert cp["wall_s"] > 0 and cp["segments"] >= 2
    assert {"queue", "batch", "decode"} <= set(cp["phases"])
    # the phase sum accounts for the wall latency (handler overhead —
    # JSON parse, header writes — is the only slack)
    assert cp["accounted_s"] <= cp["wall_s"] + 0.01
    assert cp["accounted_s"] >= 0.5 * cp["wall_s"]
    assert cp["device_s"] > 0

    # human rendering carries the tree and the breakdown
    out = tracing.render_trace(stitched)
    assert tid in out and "critical path:" in out and "request (" in out


def test_two_server_unsampled_trace_not_exported_but_served(two_servers):
    """sampled=0 still records locally (the span ring always fills) so
    /debug/trace answers — sampling gates EXPORT, not recording."""
    a, _ = two_servers
    tid = new_trace_id(random.Random(7))
    status, _, hdrs = _post(
        a, "/v1/completions",
        {"prompt": "pack my box", "max_new_tokens": 3},
        headers={"traceparent": f"00-{tid}-{SID}-00"},
    )
    assert status == 200
    assert parse_traceparent(hdrs["traceparent"]).sampled is False
    payload = tracing.fetch_trace(_target(a), tid)
    assert payload["runs"] and payload["spans"]


def test_trace_stitch_tolerates_missing_instances(two_servers):
    """An unreachable instance drops out of the stitch instead of
    failing it; a trace unknown everywhere (404) exits 1."""
    a, _ = two_servers
    tid = new_trace_id(random.Random(13))
    status, _, _ = _post(
        a, "/v1/completions",
        {"prompt": "sphinx of black quartz", "max_new_tokens": 3},
        headers={"traceparent": f"00-{tid}-{SID}-01"},
    )
    assert status == 200
    dead = "127.0.0.1:1"                 # nothing listens on port 1
    code, stitched = _get_trace(tid, [_target(a), dead])
    assert code == 0
    # only the reachable instance contributes to the stitch
    assert list(stitched["instances"]) == [_target(a)]

    unknown = "d" * 32
    assert _get_trace(unknown, [_target(a)])[0] == 1
    assert _get_trace("", [_target(a), dead])[0] == 2  # id missing


def test_scrape_with_outbound_context_is_traced(two_servers):
    """A scrape carrying ``outbound_headers()`` (what the reference's
    fleet aggregator injects) lands in the server's span ring as a traced
    ``/metrics`` request of that trace."""
    from tpu_kubernetes_torch.serve.server import TRACER

    a, _ = two_servers
    host, port = a.server_address[:2]
    ctx = TraceContext(new_trace_id(random.Random(21)),
                       new_span_id(random.Random(22)), True)
    with trace_scope(ctx):
        headers = outbound_headers()
    conn = http.client.HTTPConnection(host, port, timeout=30)
    conn.request("GET", "/metrics", headers=headers)
    resp = conn.getresponse()
    assert resp.status == 200 and b"tpu_serve_requests_total" in resp.read()
    conn.close()
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline:
        spans = [
            s for s in TRACER.spans
            if s.name == "request" and s.meta.get("endpoint") == "/metrics"
            and s.meta.get("trace") == ctx.trace_id
        ]
        if spans:
            break
        time.sleep(0.05)
    assert spans, "no traced /metrics request span recorded"
