"""The reference's ``tests/test_incidents.py`` against the port's copy of the
incident correlator (``tpu_kubernetes_torch/obs/incidents.py``), then parity
cases that put the same inputs through both packages.

The reference's docstring:

The incident correlator (obs/incidents.py): temporally overlapping
firing alerts become one incident, persisted as an atomic, redacted,
retention-pruned JSON bundle cross-referencing the flight recorder,
the fault counters, the goodput ledger, and the implicated TSDB series.

Every lifecycle test drives the clock by hand (``now=``) — no sleeps.
"""

import io
import json
import os
import types

from tpu_kubernetes_torch.obs import events
from tpu_kubernetes_torch.obs.alerts import AlertManager, GaugeThresholdRule, fingerprint
from tpu_kubernetes_torch.obs.flightrec import FlightRecorder
from tpu_kubernetes_torch.obs.incidents import (
    IncidentCorrelator,
    list_incidents,
    render_incidents,
)
from tpu_kubernetes_torch.obs.metrics import Registry
from tpu_kubernetes_torch.obs.tsdb import TSDB


def _alert(rule="page-partition-leak", state="firing", labels=None,
           **overrides):
    labels = labels or {}
    d = {
        "fingerprint": fingerprint(rule, labels),
        "rule": rule,
        "kind": "invariant",
        "labels": labels,
        "severity": "page",
        "state": state,
        "summary": f"{rule} breached",
        "value": 1.0,
        "series": ["tpu_serve_kv_pages"],
        "firing_since": None,
    }
    d.update(overrides)
    return d


def _correlator(tmp_path, **kw):
    kw.setdefault("registry", Registry())
    kw.setdefault("ledger", types.SimpleNamespace(
        snapshot=lambda **k: {"classes": {}, "emitted": 0, "unsettled": 0}
    ))
    return IncidentCorrelator(directory=str(tmp_path / "incidents"), **kw)


def _bundles(corr):
    return list_incidents(corr.directory)


# ---------------------------------------------------------------------------
# lifecycle: open on first firing, merge overlap, close after quiet hold
# ---------------------------------------------------------------------------


def test_open_merge_close_lifecycle(tmp_path):
    corr = _correlator(tmp_path, close_after_s=30.0)
    t0 = 1_000.0
    corr.observe([_alert("rule-a")], now=t0)             # opens
    assert corr.current_incident_id() is not None
    assert corr.counts()["opened"] == 1

    # a second alert firing while open joins the SAME incident
    corr.observe([_alert("rule-a"), _alert("rule-b")], now=t0 + 5)
    assert corr.counts()["opened"] == 1
    (b,) = _bundles(corr)
    assert b["status"] == "open"
    assert set(b["rules"]) == {"rule-a", "rule-b"}
    assert len(b["alerts"]) == 2

    # quiet, but inside the close hold: still open
    corr.observe([], now=t0 + 20)
    assert corr.current_incident_id() is not None
    # a re-fire during the hold cancels it
    corr.observe([_alert("rule-a")], now=t0 + 25)
    corr.observe([], now=t0 + 40)
    assert corr.current_incident_id() is not None        # hold restarted
    corr.observe([], now=t0 + 71)                        # 31s quiet → close
    assert corr.current_incident_id() is None
    assert corr.counts()["closed"] == 1
    (b,) = _bundles(corr)
    assert b["status"] == "closed"
    assert b["opened_at"] == t0 and b["closed_at"] == t0 + 71
    # a later flare-up is a NEW incident, a second bundle
    corr.observe([_alert("rule-c")], now=t0 + 200)
    assert corr.counts()["opened"] == 2
    assert len(_bundles(corr)) == 2


def test_pending_alerts_do_not_open_incidents(tmp_path):
    corr = _correlator(tmp_path)
    corr.observe([_alert(state="pending")], now=0.0)
    corr.observe([_alert(state="resolved")], now=1.0)
    assert corr.current_incident_id() is None
    assert _bundles(corr) == []


def test_member_keeps_first_seen_across_updates(tmp_path):
    corr = _correlator(tmp_path, close_after_s=0.0)
    corr.observe([_alert("rule-a")], now=10.0)
    corr.observe([_alert("rule-a", value=7.0)], now=20.0)
    corr.observe([], now=30.0)                           # close
    (b,) = _bundles(corr)
    m = list(b["alerts"].values())[0]
    assert m["first_seen"] == 10.0 and m["last_seen"] == 20.0
    assert m["value"] == 7.0                             # latest reading


# ---------------------------------------------------------------------------
# the bundle: atomic, parseable, redacted, pruned, conservation-checkable
# ---------------------------------------------------------------------------


def test_bundle_is_atomic_and_parseable(tmp_path):
    corr = _correlator(tmp_path, close_after_s=0.0)
    corr.observe([_alert()], now=100.0)
    corr.observe([], now=200.0)
    names = os.listdir(corr.directory)
    assert not [n for n in names if n.endswith(".tmp")]  # no torn writes
    (b,) = _bundles(corr)
    assert b["schema"] == "tpu-k8s-incident/1"
    assert b["incident_id"] and b["_path"].endswith(".json")
    json.dumps({k: v for k, v in b.items() if k != "_path"})


def test_bundle_redacts_user_content(tmp_path):
    """Prompt-bearing fields riding alert labels/summaries never reach
    disk — the flightrec redaction applies to the whole bundle."""
    secret = "the user's secret prompt text"
    corr = _correlator(tmp_path, close_after_s=0.0)
    corr.observe([_alert(labels={"prompt": secret})], now=0.0)
    corr.observe([], now=1.0)
    (b,) = _bundles(corr)
    raw = open(b["_path"], encoding="utf-8").read()
    assert secret not in raw
    m = list(b["alerts"].values())[0]
    assert m["labels"]["prompt"].startswith("<redacted:")


def test_retention_prunes_oldest_bundles(tmp_path):
    corr = _correlator(tmp_path, keep=2, close_after_s=0.0)
    for i in range(4):
        t = 1_000.0 * (i + 1)
        corr.observe([_alert(f"rule-{i}")], now=t)
        corr.observe([], now=t + 1)
    names = sorted(os.listdir(corr.directory))
    assert len(names) == 2
    bundles = _bundles(corr)
    assert {b["rules"][0] for b in bundles} == {"rule-2", "rule-3"}


def test_bundle_embeds_faults_ledger_and_history(tmp_path):
    registry = Registry()
    registry.counter("tpu_k8s_faults_injected_total", "faults",
                     labelnames=("site",)).labels("serve.prefill").inc(3)
    ledger = types.SimpleNamespace(snapshot=lambda **k: {
        "classes": {"useful": 80, "cancelled": 15, "shed-spent": 5},
        "emitted": 100, "unsettled": 0, "goodput": 0.8,
    })
    store = TSDB()
    for i in range(40):
        store.append("tpu_serve_kv_pages", float(i), {"state": "free"},
                     ts=float(i))
    corr = _correlator(tmp_path, registry=registry, ledger=ledger,
                       store=store, close_after_s=0.0, tail_n=8)
    corr.observe([_alert()], now=50.0)
    corr.observe([], now=60.0)
    (b,) = _bundles(corr)

    assert b["faults_injected"] == {"serve.prefill": 3.0}
    # the goodput-loss breakdown: conservation-checkable offline
    ledger_block = b["ledger"]
    assert (sum(ledger_block["classes"].values())
            + ledger_block["unsettled"] == ledger_block["emitted"])
    loss = ledger_block["loss_breakdown"]
    assert loss["lost_tokens"] == 20
    assert loss["lost_fraction"] == 0.2
    assert loss["by_class"] == {"cancelled": 15, "shed-spent": 5}
    # last-N samples for the series the member rules implicate
    (series,) = b["history"]["tpu_serve_kv_pages"]
    assert len(series["samples"]) == 8
    assert series["samples"][-1][1] == 39.0              # [ts, value] pairs


def test_write_failures_counted_not_raised(tmp_path):
    corr = _correlator(tmp_path)
    # a directory path that is actually a file: every write must fail
    blocker = tmp_path / "blocked"
    blocker.write_text("x")
    corr.directory = str(blocker)
    corr.observe([_alert()], now=0.0)                    # never raises
    assert corr.counts()["write_failures"] >= 1
    assert corr.current_incident_id() is not None        # tracking intact


# ---------------------------------------------------------------------------
# flight-recorder cross-refs, both directions
# ---------------------------------------------------------------------------


def test_incident_open_triggers_dump_and_cross_refs_both_ways(tmp_path):
    rec = FlightRecorder(directory=str(tmp_path / "flightrec"), keep=8,
                         registry=Registry())
    corr = _correlator(tmp_path, close_after_s=0.0, flightrec=rec)
    rec.incidents = corr

    corr.observe([_alert()], now=100.0)
    incident_id = corr.current_incident_id()
    (b,) = _bundles(corr)
    # bundle → dump: opening the incident wrote a postmortem and listed it
    assert len(b["flightrec_dumps"]) == 1
    dump_path = b["flightrec_dumps"][0]
    assert os.path.isfile(dump_path)
    payload = json.load(open(dump_path, encoding="utf-8"))
    # dump → bundle: the postmortem carries the incident id back
    assert payload["incident_id"] == incident_id
    assert payload["reason"] == f"incident-{incident_id}"

    # dumps taken WHILE the incident is open also attach
    mid = rec.dump("mid-incident")
    corr.observe([_alert()], now=101.0)
    corr.observe([], now=102.0)                          # close
    (b,) = _bundles(corr)
    assert b["status"] == "closed"
    assert mid in b["flightrec_dumps"]


def test_dump_before_incident_is_adopted(tmp_path):
    """The postmortem usually lands a tick before the page: a dump taken
    just before the incident opens joins its bundle."""
    rec = FlightRecorder(directory=str(tmp_path / "flightrec"), keep=8,
                         registry=Registry())
    corr = _correlator(tmp_path, close_after_s=0.0, flightrec=rec)
    rec.incidents = corr

    early = rec.dump("engine-reset")                     # no incident yet
    payload = json.load(open(early, encoding="utf-8"))
    assert payload["incident_id"] is None                # nothing open
    corr.observe([_alert()], now=None)                   # wall clock: within
    (b,) = _bundles(corr)                                # the adopt window
    assert early in b["flightrec_dumps"]


def test_incident_events_carry_correlation_ids(tmp_path):
    stream = io.StringIO()
    events.configure(stream=stream)
    try:
        corr = _correlator(tmp_path, close_after_s=0.0)
        corr.observe([_alert("rule-a"), _alert("rule-b")], now=10.0)
        corr.observe([], now=50.0)
    finally:
        events.configure()
    lines = [json.loads(line) for line in
             stream.getvalue().strip().splitlines()]
    opened = [e for e in lines if e["kind"] == "incident_open"]
    closed = [e for e in lines if e["kind"] == "incident_close"]
    assert len(opened) == 1 and len(closed) == 1
    assert opened[0]["incident_id"] == closed[0]["incident_id"]
    assert sorted(opened[0]["rules"]) == ["rule-a", "rule-b"]
    assert set(closed[0]["fingerprints"]) == {
        fingerprint("rule-a"), fingerprint("rule-b"),
    }
    assert closed[0]["duration_s"] == 40.0


# ---------------------------------------------------------------------------
# wired behind an AlertManager: evaluation feeds correlation
# ---------------------------------------------------------------------------


def test_alert_manager_feeds_correlator_end_to_end(tmp_path):
    corr = _correlator(tmp_path, close_after_s=0.0)
    rule = GaugeThresholdRule("depth-high", "depth", 10.0,
                              severity="page", resolve_for_s=0.0)
    mgr = AlertManager([rule], incidents=corr)
    mgr.evaluate(now=0.0, local={"depth": 50.0})         # firing → open
    assert corr.current_incident_id() is not None
    mgr.evaluate(now=10.0, local={"depth": 0.0})         # resolved → close
    assert corr.current_incident_id() is None
    (b,) = _bundles(corr)
    assert b["status"] == "closed"
    assert b["rules"] == ["depth-high"]


# ---------------------------------------------------------------------------
# the `get incidents` CLI face
# ---------------------------------------------------------------------------


def test_list_and_render_incidents(tmp_path):
    corr = _correlator(tmp_path, close_after_s=0.0, ledger=types.SimpleNamespace(
        snapshot=lambda **k: {"classes": {"useful": 5, "expired": 5},
                              "emitted": 10, "unsettled": 0},
    ))
    corr.observe([_alert("rule-a")], now=1_000.0)
    corr.observe([], now=1_100.0)
    corr.observe([_alert("rule-b")], now=2_000.0)

    payloads = list_incidents(corr.directory)
    assert len(payloads) == 2
    assert payloads[0]["rules"] == ["rule-b"]            # newest first
    text = render_incidents(payloads)
    assert "OPEN" in text and "CLOSED" in text
    assert "rule-a" in text and "rule-b" in text
    assert "goodput loss: 5 tokens" in text
    # unparseable bundles are skipped, not fatal
    bad = os.path.join(corr.directory, "incident-999-zz.json")
    open(bad, "w").write("{not json")
    assert len(list_incidents(corr.directory)) == 2

    assert render_incidents([]) == "no incident bundles found\n"
    assert list_incidents(str(tmp_path / "nowhere")) == []


# ---------------------------------------------------------------------------
# parity with the reference's module
# ---------------------------------------------------------------------------


def _run_correlator(pkg, tmp_path):
    """A manager and its correlator, in one package, over a scripted
    local value under one clock: two overlapping alerts, a quiet hold,
    then a second incident → the bundles, newest first."""
    import importlib

    alerts = importlib.import_module(f"{pkg}.obs.alerts")
    incidents = importlib.import_module(f"{pkg}.obs.incidents")
    metrics = importlib.import_module(f"{pkg}.obs.metrics")
    corr = incidents.IncidentCorrelator(
        directory=str(tmp_path / pkg), close_after_s=30.0,
        registry=metrics.Registry(),
        ledger=types.SimpleNamespace(snapshot=lambda **k: {
            "classes": {"useful": 7, "shed-spent": 3}, "emitted": 10,
            "unsettled": 0}))
    rules = [alerts.GaugeThresholdRule("depth-high", "depth", 10.0,
                                       severity="page", resolve_for_s=5.0),
             alerts.GaugeThresholdRule("stall", "stall", 0.5,
                                       severity="ticket")]
    mgr = alerts.AlertManager(rules, incidents=corr)
    script = [(0.0, 50.0, 0.0), (5.0, 50.0, 1.0), (10.0, 0.0, 1.0),
              (20.0, 0.0, 0.0), (60.0, 0.0, 0.0), (100.0, 0.0, 0.0),
              (200.0, 0.0, 1.0), (300.0, 0.0, 0.0), (400.0, 0.0, 0.0)]
    ids = []
    for t, depth, stall in script:
        mgr.evaluate(now=1_000.0 + t, local={"depth": depth, "stall": stall})
        ids.append(corr.current_incident_id())
    return ids, incidents.list_incidents(corr.directory), corr.counts()


def test_correlator_follows_the_reference(tmp_path):
    """Both packages open, merge and close the same incidents under one
    clock and write the same bundles (ids, members, rules, ledger)."""
    from tpu_kubernetes.obs.incidents import render_incidents as jrender

    port_ids, port, port_counts = _run_correlator("tpu_kubernetes_torch",
                                                  tmp_path)
    ref_ids, ref, ref_counts = _run_correlator("tpu_kubernetes", tmp_path)
    assert port_ids == ref_ids
    assert len([i for i in set(port_ids) if i]) == 2
    assert port_counts == ref_counts
    assert [{k: v for k, v in b.items() if k != "_path"} for b in port] == \
        [{k: v for k, v in b.items() if k != "_path"} for b in ref]
    assert render_incidents(port) == jrender(port)
