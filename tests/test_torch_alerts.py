"""The reference's ``tests/test_alerts.py`` against the port's copy of the
alert manager (``tpu_kubernetes_torch/obs/alerts.py``), then parity
cases that put the same inputs through both packages.

The reference's docstring:

The rule-driven alert manager (obs/alerts.py): lifecycle with
hold-downs in both directions under injectable clocks, fingerprint
dedup, grouped notifications, silences, the tripwire/anomaly rule
vocabulary, declarative rule files, and the JSONL/webhook sinks with
bounded retry behind the ``obs.alert_sink`` fault site.

Every lifecycle test drives the clock by hand — no sleeps anywhere on
the state-machine paths; only the notifier-drain calls block (bounded)
on the delivery thread.
"""

import http.server
import io
import json
import os
import socket
import threading
import time
import types

import pytest

from tpu_kubernetes_torch.obs import REGISTRY, events
from tpu_kubernetes_torch.obs.alerts import (
    AlertManager,
    CounterDeltaRule,
    CounterStallRule,
    EvalContext,
    EWMADriftRule,
    GaugeThresholdRule,
    JSONLSink,
    QueueRunawayRule,
    Reading,
    SLOBurnRule,
    WebhookSink,
    build_rule,
    default_fleet_rules,
    engine_local_context,
    engine_tripwires,
    fingerprint,
    ledger_conservation_rule,
    load_rules,
    page_partition_rule,
    render_alerts,
    sinks_from_env,
    target_down_rule,
)
from tpu_kubernetes_torch.obs.faults import injected

EXAMPLES_DIR = os.path.join(
    os.path.dirname(__file__), os.pardir, "examples", "alerts.d"
)


class _MemSink:
    """An in-memory sink capturing every delivered batch."""

    name = "mem"

    def __init__(self):
        self.batches = []
        self._lock = threading.Lock()

    def send(self, batch):
        with self._lock:
            self.batches.append(batch)

    def snapshot(self):
        with self._lock:
            return list(self.batches)


def _metric_sum(name, **labels):
    fam = REGISTRY.snapshot(prefix=name).get(name)
    if not fam:
        return 0.0
    return sum(
        s["value"] for s in fam["samples"]
        if all(s["labels"].get(k) == v for k, v in labels.items())
    )


def _gauge_rule(threshold=10.0, **kw):
    """A local-value threshold rule: the simplest lifecycle vehicle."""
    kw.setdefault("severity", "page")
    return GaugeThresholdRule("depth-high", "depth", threshold, **kw)


# ---------------------------------------------------------------------------
# lifecycle: ok → pending → firing → resolved, hold-downs both ways
# ---------------------------------------------------------------------------


def test_lifecycle_pending_firing_resolved_under_injected_clock():
    mgr = AlertManager([_gauge_rule(for_s=30.0, resolve_for_s=60.0)])
    t0 = 1_000.0

    def state_at(now, depth):
        alerts = mgr.evaluate(now=now, local={"depth": depth})
        return alerts[0]["state"] if alerts else None

    # breach → pending immediately, firing only after for_s held
    assert state_at(t0, 20.0) == "pending"
    assert state_at(t0 + 10, 20.0) == "pending"
    assert state_at(t0 + 30, 20.0) == "firing"
    # clean → the resolve hold-down keeps it firing resolve_for_s
    assert state_at(t0 + 40, 0.0) == "firing"
    assert state_at(t0 + 99, 0.0) == "firing"
    assert state_at(t0 + 101, 0.0) == "resolved"
    # resolved alerts stay listed until retention, then vanish
    a = mgr.active(now=t0 + 102)[0]
    assert a["state"] == "resolved" and a["resolved_at"] == t0 + 101
    assert mgr.evaluate(now=t0 + 101 + 601, local={"depth": 0.0}) == []


def test_pending_blip_never_fires():
    mgr = AlertManager([_gauge_rule(for_s=30.0)])
    alerts = mgr.evaluate(now=0.0, local={"depth": 20.0})
    assert alerts[0]["state"] == "pending"
    # clean before for_s elapsed: straight back to ok, nothing tracked
    assert mgr.evaluate(now=10.0, local={"depth": 0.0}) == []


def test_for_s_zero_fires_in_one_step():
    mgr = AlertManager([_gauge_rule(for_s=0.0)])
    alerts = mgr.evaluate(now=5.0, local={"depth": 99.0})
    assert alerts[0]["state"] == "firing"
    assert alerts[0]["severity"] == "page"


def test_rebreach_during_resolve_hold_does_not_strobe():
    """A signal hovering at its threshold: the re-breach cancels the
    clear anchor, the alert stays firing the whole time, and the only
    transitions ever seen are one fire and one final resolve."""
    sink = _MemSink()
    mgr = AlertManager([_gauge_rule(for_s=0.0, resolve_for_s=60.0)],
                       sinks=[sink], group_interval_s=0.0)
    t0 = 0.0
    mgr.evaluate(now=t0, local={"depth": 20.0})          # firing
    for i, depth in enumerate([0.0, 20.0, 0.0, 20.0, 0.0]):
        alerts = mgr.evaluate(now=t0 + 10 * (i + 1), local={"depth": depth})
        assert alerts[0]["state"] == "firing"            # never resolves
    alerts = mgr.evaluate(now=t0 + 50 + 61, local={"depth": 0.0})
    assert alerts[0]["state"] == "resolved"
    assert mgr.drain_notifications(5.0)
    states = [a["state"] for b in sink.snapshot() for a in b["alerts"]]
    assert states == ["firing", "resolved"]              # exactly two


def test_fingerprint_dedup_one_notification_while_firing():
    sink = _MemSink()
    mgr = AlertManager([_gauge_rule(for_s=0.0)], sinks=[sink],
                       group_interval_s=0.0)
    for i in range(10):                                  # ten breached evals
        mgr.evaluate(now=float(i), local={"depth": 50.0})
    assert mgr.drain_notifications(5.0)
    batches = sink.snapshot()
    firing = [a for b in batches for a in b["alerts"]
              if a["state"] == "firing"]
    assert len(firing) == 1                              # one fp, one notify
    assert firing[0]["fingerprint"] == fingerprint("depth-high")


def test_fingerprints_are_stable_and_label_scoped():
    assert fingerprint("r", {"a": "1"}) == fingerprint("r", {"a": "1"})
    assert fingerprint("r", {"a": "1"}) != fingerprint("r", {"a": "2"})
    assert fingerprint("r") != fingerprint("q")


def test_group_interval_paces_notifications():
    """First flush for a group is immediate; later transitions buffer
    until the interval elapses — one POST per group per interval."""
    sink = _MemSink()
    a = GaugeThresholdRule("a-high", "a", 1.0, group="g", severity="page")
    b = GaugeThresholdRule("b-high", "b", 1.0, group="g", severity="page")
    mgr = AlertManager([a, b], sinks=[sink], group_interval_s=60.0)

    mgr.evaluate(now=0.0, local={"a": 5.0, "b": 0.0})    # a fires → flush
    mgr.evaluate(now=10.0, local={"a": 5.0, "b": 5.0})   # b fires → buffered
    mgr.evaluate(now=30.0, local={"a": 5.0, "b": 5.0})   # still inside
    assert mgr.drain_notifications(5.0)
    assert len(sink.snapshot()) == 1
    mgr.evaluate(now=61.0, local={"a": 5.0, "b": 5.0})   # interval over
    assert mgr.drain_notifications(5.0)
    batches = sink.snapshot()
    assert len(batches) == 2
    assert [a["rule"] for a in batches[0]["alerts"]] == ["a-high"]
    assert [a["rule"] for a in batches[1]["alerts"]] == ["b-high"]
    # the second batch's "firing" list shows the whole group's state
    assert {a["rule"] for a in batches[1]["firing"]} == {"a-high", "b-high"}


def test_silence_suppresses_notifications_not_tracking():
    sink = _MemSink()
    mgr = AlertManager([_gauge_rule(for_s=0.0)], sinks=[sink],
                       group_interval_s=0.0)
    mgr.silence({"rule": "depth-high"}, until=100.0, comment="maint")
    alerts = mgr.evaluate(now=0.0, local={"depth": 50.0})
    assert alerts[0]["state"] == "firing"                # still tracked
    assert alerts[0]["silenced"] is True
    assert mgr.drain_notifications(5.0)
    assert sink.snapshot() == []                         # but never notified
    # expired silence: the next transition (resolve) notifies again
    alerts = mgr.evaluate(now=200.0, local={"depth": 0.0})
    assert alerts[0]["state"] == "resolved"
    assert alerts[0]["silenced"] is False
    assert mgr.drain_notifications(5.0)
    assert [a["state"] for b in sink.snapshot()
            for a in b["alerts"]] == ["resolved"]


def test_silence_label_matchers_scope_to_one_instance():
    mgr = AlertManager([target_down_rule()])
    mgr.silence({"rule": "scrape-target-down", "instance": "w1:1"})
    snap = types.SimpleNamespace(health={
        "w1:1": types.SimpleNamespace(up=0, consecutive_failures=3,
                                      last_error="refused"),
        "w2:1": types.SimpleNamespace(up=0, consecutive_failures=1,
                                      last_error="refused"),
    })
    alerts = mgr.evaluate(now=0.0, snapshot=snap)
    by_instance = {a["labels"]["instance"]: a for a in alerts}
    assert by_instance["w1:1"]["silenced"] is True
    assert by_instance["w2:1"]["silenced"] is False


def test_alert_transition_events_carry_fingerprint():
    stream = io.StringIO()
    events.configure(stream=stream)
    try:
        mgr = AlertManager([_gauge_rule(for_s=10.0, resolve_for_s=0.0)])
        mgr.evaluate(now=0.0, local={"depth": 50.0})     # → pending
        mgr.evaluate(now=10.0, local={"depth": 50.0})    # → firing
        mgr.evaluate(now=20.0, local={"depth": 0.0})     # → resolved
    finally:
        events.configure()
    lines = [json.loads(line) for line in
             stream.getvalue().strip().splitlines()]
    trans = [e for e in lines if e["kind"] == "alert_transition"]
    assert [(e["from_state"], e["to_state"]) for e in trans] == [
        ("ok", "pending"), ("pending", "firing"), ("firing", "resolved"),
    ]
    fp = fingerprint("depth-high")
    assert all(e["fingerprint"] == fp for e in trans)
    assert all(e["rule"] == "depth-high" for e in trans)


def test_firing_gauge_tracks_by_severity():
    mgr = AlertManager([
        _gauge_rule(for_s=0.0),                          # page
        GaugeThresholdRule("q2", "q2", 1.0, severity="ticket"),
    ])
    mgr.evaluate(now=0.0, local={"depth": 50.0, "q2": 0.0})
    assert _metric_sum("tpu_alerts_firing", severity="page") == 1.0
    assert _metric_sum("tpu_alerts_firing", severity="ticket") == 0.0
    mgr.evaluate(now=1.0, local={"depth": 50.0, "q2": 5.0})
    assert _metric_sum("tpu_alerts_firing", severity="ticket") == 1.0
    mgr.evaluate(now=2.0, local={"depth": 0.0, "q2": 0.0})
    assert _metric_sum("tpu_alerts_firing", severity="page") == 0.0


def test_broken_rule_is_skipped_not_fatal():
    class Broken(GaugeThresholdRule):
        def evaluate(self, ctx):
            raise RuntimeError("boom")

    mgr = AlertManager([Broken("b", "x", 1.0), _gauge_rule(for_s=0.0)])
    alerts = mgr.evaluate(now=0.0, local={"depth": 50.0})
    assert [a["rule"] for a in alerts] == ["depth-high"]


def test_summary_and_snapshot_shapes():
    mgr = AlertManager([_gauge_rule(for_s=0.0)])
    mgr.evaluate(now=0.0, local={"depth": 50.0})
    assert mgr.summary(now=1.0) == {
        "firing": 1, "pending": 0, "by_severity": {"page": 1},
    }
    snap = mgr.snapshot(now=1.0)
    assert snap["schema"] == "tpu-k8s-alerts/1"
    assert snap["alerts"][0]["rule"] == "depth-high"
    assert snap["rules"][0]["name"] == "depth-high"
    json.dumps(snap)                                     # serializable whole
    text = render_alerts(snap)
    assert "FIRING" in text and "depth-high" in text
    assert "1 firing" in text


# ---------------------------------------------------------------------------
# the rule vocabulary: tripwires and anomaly detectors
# ---------------------------------------------------------------------------


def test_page_partition_tripwire():
    rule = page_partition_rule()
    ok = {"free": 3, "live": 2, "pinned": 1, "total": 6}
    leak = {"free": 3, "live": 2, "pinned": 1, "total": 7}
    assert not rule.evaluate(EvalContext(0.0, local={"pages": ok}))[0].breached
    r = rule.evaluate(EvalContext(0.0, local={"pages": leak}))[0]
    assert r.breached and "total=7" in r.summary
    # fleet-side (no local pages): reports nothing, never false-positives
    assert rule.evaluate(EvalContext(0.0)) == []


def test_ledger_conservation_tripwire():
    rule = ledger_conservation_rule(for_s=0.0)
    balanced = {"emitted": 10, "classes": {"useful": 8, "cancelled": 2}}
    hole = {"emitted": 10, "classes": {"useful": 7}}
    assert not rule.evaluate(
        EvalContext(0.0, local={"ledger": balanced}))[0].breached
    r = rule.evaluate(EvalContext(0.0, local={"ledger": hole}))[0]
    assert r.breached and r.value == 3.0
    assert rule.evaluate(EvalContext(0.0)) == []


def test_target_down_per_instance_readings():
    rule = target_down_rule()
    snap = types.SimpleNamespace(health={
        "a:1": types.SimpleNamespace(up=1, consecutive_failures=0,
                                     last_error=""),
        "b:2": types.SimpleNamespace(up=0, consecutive_failures=4,
                                     last_error="connection refused"),
    })
    readings = rule.evaluate(EvalContext(0.0, snapshot=snap))
    by = {r.labels["instance"]: r for r in readings}
    assert not by["a:1"].breached
    assert by["b:2"].breached and "refused" in by["b:2"].summary


def test_counter_delta_baselines_then_fires_then_rides_resets():
    values = {"v": 5.0}
    rule = CounterDeltaRule("bump", lambda ctx: values["v"],
                            threshold=0.0, for_s=0.0)
    ctx = EvalContext(0.0)
    assert rule.evaluate(ctx) == []                      # first sight
    assert not rule.evaluate(ctx)[0].breached            # flat
    values["v"] = 8.0
    r = rule.evaluate(ctx)[0]
    assert r.breached and r.value == 3.0
    values["v"] = 2.0                                    # counter reset
    assert not rule.evaluate(ctx)[0].breached            # re-baselined
    values["v"] = 3.0
    assert rule.evaluate(ctx)[0].breached                # counting again


def test_counter_stall_detector():
    rule = CounterStallRule(for_s=0.0)
    state = {"emitted": 100.0, "inflight": 2.0}
    ctx = lambda: EvalContext(0.0, local=dict(state))  # noqa: E731
    assert rule.evaluate(ctx()) == []                    # baseline
    state["emitted"] = 110.0
    assert not rule.evaluate(ctx())[0].breached          # progress
    r = rule.evaluate(ctx())[0]                          # flat + inflight
    assert r.breached and r.value == 2.0
    state["inflight"] = 0.0
    assert not rule.evaluate(ctx())[0].breached          # idle is fine


def test_queue_runaway_detector():
    rule = QueueRunawayRule(max_depth=8.0, for_s=0.0)
    assert not rule.evaluate(
        EvalContext(0.0, local={"queued": 7.0}))[0].breached
    assert rule.evaluate(
        EvalContext(0.0, local={"queued": 8.0}))[0].breached


def test_ewma_drift_learns_baseline_then_flags_outlier():
    rule = EWMADriftRule(min_samples=8, z=4.0, for_s=0.0)
    for _ in range(10):                                  # learn p99 ≈ 0.1s
        r = rule.evaluate(EvalContext(0.0, local={"latency_q": 0.1}))[0]
        assert not r.breached                            # warm-up can't page
    r = rule.evaluate(EvalContext(0.0, local={"latency_q": 5.0}))[0]
    assert r.breached and r.value > 4.0
    # the outage did NOT teach the baseline that slow is normal
    r = rule.evaluate(EvalContext(0.0, local={"latency_q": 0.1}))[0]
    assert not r.breached
    r = rule.evaluate(EvalContext(0.0, local={"latency_q": 5.0}))[0]
    assert r.breached


def test_slo_burn_rule_mirrors_tracker_lifecycle():
    from tpu_kubernetes_torch.obs.slo import GOOD_SERIES, TOTAL_SERIES, SLOTracker

    tracker = SLOTracker("availability", 0.999, lambda s: (0, 0),
                         for_s=60.0)
    labels = (("slo", "availability"),)
    t0 = 1_000_000.0
    tracker.store.append(TOTAL_SERIES, 1000.0, labels, ts=t0,
                         kind="counter")
    tracker.store.append(GOOD_SERIES, 1000.0, labels, ts=t0,
                         kind="counter")
    mgr = AlertManager([SLOBurnRule(tracker)])
    assert mgr.evaluate(now=t0) == []                    # healthy

    tracker.store.append(TOTAL_SERIES, 1100.0, labels, ts=t0 + 60,
                         kind="counter")
    tracker.store.append(GOOD_SERIES, 1000.0, labels, ts=t0 + 60,
                         kind="counter")                 # 100 bad events
    a = mgr.evaluate(now=t0 + 60)[0]
    assert a["state"] == "pending" and a["severity"] == "page"
    assert a["rule"] == "slo-availability" and a["kind"] == "slo_burn"
    a = mgr.evaluate(now=t0 + 120)[0]
    assert a["state"] == "firing"                        # held past for_s
    # hours later the windows are clean: the manager shows the close
    a = mgr.evaluate(now=t0 + 30_000)[0]
    assert a["state"] == "resolved"


def test_default_fleet_rules_cover_the_vocabulary():
    from tpu_kubernetes_torch.obs.slo import default_slos

    rules = default_fleet_rules(default_slos())
    names = {r.name for r in rules}
    assert {"slo-availability", "slo-latency", "slo-ttft",
            "scrape-target-down", "engine-restarts", "latency-drift",
            "token-counter-stall", "queue-runaway"} <= names


def test_engine_tripwires_read_local_stats():
    stats = {"queued": 0, "occupied": 0, "restarts": 0,
             "pages": {"free": 4, "live": 0, "pinned": 0, "total": 4}}
    ledger = {"emitted": 0, "classes": {}}
    rules = engine_tripwires(stats_fn=lambda: dict(stats),
                             ledger=types.SimpleNamespace(
                                 snapshot=lambda **kw: dict(ledger)),
                             for_s=0.0, resolve_for_s=0.0,
                             queue_max_depth=4.0)
    mgr = AlertManager(rules)
    ctx = lambda now: engine_local_context(rules, now)  # noqa: E731
    assert mgr.evaluate(ctx(0.0)) == []                  # healthy engine
    stats["pages"]["total"] = 5                          # page leak
    stats["queued"] = 4                                  # queue at cap
    alerts = {a["rule"]: a for a in mgr.evaluate(ctx(1.0))}
    assert alerts["page-partition-leak"]["state"] == "firing"
    assert alerts["queue-runaway"]["state"] == "firing"
    stats["pages"]["total"] = 4
    stats["queued"] = 0
    assert all(a["state"] == "resolved"
               for a in mgr.evaluate(ctx(2.0)))


# ---------------------------------------------------------------------------
# declarative rule files
# ---------------------------------------------------------------------------


def test_load_rules_from_committed_example_dir():
    rules = load_rules(EXAMPLES_DIR)
    names = {r.name for r in rules}
    assert {"scrape-target-down", "inflight-saturation",
            "p99-latency-breach", "engine-restart-burst", "latency-drift",
            "token-counter-stall", "queue-runaway"} == names
    # the loaded registry evaluates cleanly against an empty context
    assert AlertManager(rules).evaluate(now=0.0) == []


def test_unknown_rule_kind_is_a_loud_error(tmp_path):
    with pytest.raises(ValueError, match="not registered"):
        build_rule({"kind": "nope", "name": "x"})
    p = tmp_path / "bad.json"
    p.write_text(json.dumps({"rules": [{"kind": "bogus"}]}))
    with pytest.raises(ValueError):
        load_rules(str(p))
    with pytest.raises(FileNotFoundError):
        load_rules(str(tmp_path / "missing"))


def test_load_rules_single_file_and_bare_list(tmp_path):
    p = tmp_path / "one.json"
    p.write_text(json.dumps([{"kind": "queue_runaway", "name": "q",
                              "max_depth": 4}]))
    rules = load_rules(str(p))
    assert len(rules) == 1 and rules[0].kind == "queue_runaway"


# ---------------------------------------------------------------------------
# sinks: JSONL file, webhook against a live endpoint, bounded failure
# ---------------------------------------------------------------------------


class _WebhookReceiver:
    """A live HTTP endpoint capturing every alert POST."""

    def __init__(self, status=200):
        self.posts = []
        self._lock = threading.Lock()
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *args):  # noqa: ARG002 — quiet tests
                pass

            def do_POST(self):  # noqa: N802
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length)
                with outer._lock:
                    outer.posts.append(json.loads(body))
                self.send_response(status)
                self.send_header("Content-Length", "0")
                self.end_headers()

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                      Handler)
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()

    @property
    def url(self):
        host, port = self.server.server_address[:2]
        return f"http://{host}:{port}/alerts"

    def snapshot(self):
        with self._lock:
            return list(self.posts)

    def stop(self):
        self.server.shutdown()
        self.server.server_close()


def test_jsonl_sink_appends_parseable_batches(tmp_path):
    path = str(tmp_path / "alerts" / "stream.jsonl")
    mgr = AlertManager([_gauge_rule(for_s=0.0)], sinks=[JSONLSink(path)],
                       group_interval_s=0.0)
    mgr.evaluate(now=0.0, local={"depth": 50.0})
    mgr.evaluate(now=10.0, local={"depth": 0.0})
    assert mgr.drain_notifications(5.0)
    lines = [json.loads(line) for line in
             open(path, encoding="utf-8").read().strip().splitlines()]
    assert len(lines) == 2
    assert lines[0]["schema"] == "tpu-k8s-alerts/1"
    assert lines[0]["alerts"][0]["state"] == "firing"
    assert lines[1]["alerts"][0]["state"] == "resolved"


def test_webhook_delivers_to_live_endpoint():
    ok_before = _metric_sum("tpu_alert_notifications_total",
                            sink="webhook", status="ok")
    recv = _WebhookReceiver()
    try:
        mgr = AlertManager([_gauge_rule(for_s=0.0)],
                           sinks=[WebhookSink(recv.url)],
                           group_interval_s=0.0)
        mgr.evaluate(now=0.0, local={"depth": 50.0})
        assert mgr.drain_notifications(5.0)
        posts = recv.snapshot()
        assert len(posts) == 1
        assert posts[0]["alerts"][0]["rule"] == "depth-high"
        assert posts[0]["alerts"][0]["state"] == "firing"
    finally:
        recv.stop()
    assert _metric_sum("tpu_alert_notifications_total",
                       sink="webhook", status="ok") == ok_before + 1


def test_webhook_dead_endpoint_bounded_and_counted():
    """A dead endpoint: evaluate() returns without blocking, the sink
    exhausts its bounded retries on the notifier thread, and the
    failure lands in tpu_alert_notifications_total{status="error"}."""
    err_before = _metric_sum("tpu_alert_notifications_total",
                             sink="webhook", status="error")
    # a port that is certainly closed: bind, read the number, release
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    sink = WebhookSink(f"http://127.0.0.1:{port}/alerts",
                       timeout_s=0.5, retries=2, backoff_s=0.01)
    mgr = AlertManager([_gauge_rule(for_s=0.0)], sinks=[sink],
                       group_interval_s=0.0)
    t0 = time.monotonic()
    mgr.evaluate(now=0.0, local={"depth": 50.0})
    assert time.monotonic() - t0 < 0.4                   # never blocked
    assert mgr.drain_notifications(10.0)                 # attempts bounded
    assert _metric_sum("tpu_alert_notifications_total",
                       sink="webhook", status="error") == err_before + 1


def test_alert_sink_fault_site_counts_as_error():
    """obs.alert_sink armed at prob 1.0: every delivery attempt faults
    before reaching the sink and is counted status="error" — chaos for
    the notification path itself."""
    err_before = _metric_sum("tpu_alert_notifications_total",
                             sink="mem", status="error")
    sink = _MemSink()
    mgr = AlertManager([_gauge_rule(for_s=0.0)], sinks=[sink],
                       group_interval_s=0.0)
    with injected("obs.alert_sink:1.0"):
        mgr.evaluate(now=0.0, local={"depth": 50.0})
        assert mgr.drain_notifications(5.0)
    assert sink.snapshot() == []                         # never delivered
    assert _metric_sum("tpu_alert_notifications_total",
                       sink="mem", status="error") == err_before + 1
    # faults cleared: the next transition delivers normally
    mgr.evaluate(now=10.0, local={"depth": 0.0})
    assert mgr.drain_notifications(5.0)
    assert len(sink.snapshot()) == 1


def test_one_dead_sink_does_not_starve_the_other():
    mem = _MemSink()

    class Dead:
        name = "dead"

        def send(self, batch):
            raise OSError("gone")

    mgr = AlertManager([_gauge_rule(for_s=0.0)], sinks=[Dead(), mem],
                       group_interval_s=0.0)
    mgr.evaluate(now=0.0, local={"depth": 50.0})
    assert mgr.drain_notifications(5.0)
    assert len(mem.snapshot()) == 1


def test_sinks_from_env(tmp_path):
    assert sinks_from_env({}) == []
    sinks = sinks_from_env({
        "TPU_K8S_ALERTS_FILE": str(tmp_path / "a.jsonl"),
        "TPU_K8S_ALERT_WEBHOOK": "http://127.0.0.1:1/x",
        "TPU_K8S_ALERT_WEBHOOK_TIMEOUT_S": "0.5",
        "TPU_K8S_ALERT_WEBHOOK_RETRIES": "1",
    })
    assert [s.name for s in sinks] == ["jsonl", "webhook"]
    assert sinks[1].timeout_s == 0.5 and sinks[1].retries == 1


def test_render_alerts_empty_payload():
    text = render_alerts({"alerts": [], "summary": {}, "rules": []})
    assert "none active" in text


# ---------------------------------------------------------------------------
# parity with the reference's module: one rule set, one clock, both packages
# ---------------------------------------------------------------------------


def _engine_trace():
    """A scripted engine: healthy, a page leak, a queue at its cap, a
    restart, an unsettled ledger held past for_s, a fault, then clean."""
    base = {"queued": 0, "occupied": 1, "restarts": 0,
            "pages": {"free": 4, "live": 0, "pinned": 0, "total": 4}}
    steps = []
    for t in range(16):
        s = json.loads(json.dumps(base))
        ledger = {"emitted": 10 * t, "classes": {"useful": 10 * t}}
        if 2 <= t <= 4:
            s["pages"]["total"] = 5
        if 3 <= t <= 6:
            s["queued"] = 4
        if t >= 5:
            s["restarts"] = 1
        if 7 <= t <= 10:
            ledger["classes"]["useful"] -= 3
        steps.append((1_000.0 + 2.0 * t, s, ledger, t == 8))
    return steps


def _run_tripwires(pkg):
    import importlib

    alerts = importlib.import_module(f"{pkg}.obs.alerts")
    metrics = importlib.import_module(f"{pkg}.obs.metrics")
    registry = metrics.Registry()
    faults = registry.counter("tpu_k8s_faults_injected_total", "faults",
                              labelnames=("site",))
    state = {}
    rules = alerts.engine_tripwires(
        stats_fn=lambda: state["stats"],
        ledger=types.SimpleNamespace(
            snapshot=lambda **kw: dict(state["ledger"])),
        registry=registry, for_s=3.0, resolve_for_s=4.0,
        queue_max_depth=4.0)
    sink = _MemSink()
    mgr = alerts.AlertManager(rules, sinks=[sink], group_interval_s=0.0)
    seen = []
    try:
        for now, stats, ledger, fault in _engine_trace():
            state["stats"], state["ledger"] = stats, ledger
            if fault:
                faults.labels("serve.segment").inc()
            seen.append(mgr.evaluate(alerts.engine_local_context(rules,
                                                                 now)))
        assert mgr.drain_notifications()
        snap = mgr.snapshot(now=now)
    finally:
        mgr.close()
    return seen, sink.snapshot(), snap


def test_engine_tripwires_follow_the_reference():
    """The engine tripwires of both packages over one scripted engine
    under one injected clock: the same alert lists (rules, fingerprints,
    states, values, times) at every evaluation, the same notification
    batches, and the same final snapshot."""
    port, port_batches, port_snap = _run_tripwires("tpu_kubernetes_torch")
    ref, ref_batches, ref_snap = _run_tripwires("tpu_kubernetes")
    assert port == ref
    assert port_batches == ref_batches
    assert port_snap == ref_snap
    fired = {a["rule"] for step in ref for a in step
             if a["state"] == "firing"}
    assert {"page-partition-leak", "queue-runaway", "engine-restarts",
            "ledger-conservation", "fault-injected"} <= fired
    assert all(a["fingerprint"] == fingerprint(a["rule"], a["labels"])
               for step in port for a in step)


def test_load_rules_from_committed_example_dir_in_both():
    """``examples/alerts.d`` loads into the same rules in both packages,
    and each manager reports them alike."""
    from tpu_kubernetes.obs.alerts import AlertManager as JAlertManager
    from tpu_kubernetes.obs.alerts import load_rules as jload_rules

    def shape(rules):
        return [(r.name, r.kind, r.severity, r.for_s, r.resolve_for_s,
                 r.group, r.description, r.series) for r in rules]

    port, ref = load_rules(EXAMPLES_DIR), jload_rules(EXAMPLES_DIR)
    assert shape(port) == shape(ref)
    assert AlertManager(port).snapshot(now=0.0) == \
        JAlertManager(ref).snapshot(now=0.0)
