"""The aggregator, SLO and history-store part of the reference's
``tests/test_fleet_obs.py`` against the port's copies
(``tpu_kubernetes_torch/obs/aggregate.py``, ``slo.py``, ``tsdb.py``),
then parity cases that put the same inputs through both packages. The
reference's ``monitor`` and ``get history`` tests stay with the reference:
``obs/monitor.py`` is not ported, being an HTTP client that scrapes the
port's server as it scrapes the reference's.

The reference's docstring:

Fleet observability: scraping live workers into one merged snapshot
(obs/aggregate.py), SLO burn-rate alerting over it (obs/slo.py), and the
``tpu-kubernetes monitor`` CLI (obs/monitor.py).

The "workers" here are real HTTP servers (stdlib ThreadingHTTPServer)
exposing a per-test Registry at /metrics — live sockets and real scrape
failures, without paying a model bring-up per test."""

import http.server
import json
import threading

import pytest

from tpu_kubernetes_torch.obs import expfmt
from tpu_kubernetes_torch.obs.aggregate import (
    FleetAggregator,
    _normalize_target,
    rate,
)
from tpu_kubernetes_torch.obs.metrics import Registry
from tpu_kubernetes_torch.obs.tsdb import TSDB
from tpu_kubernetes_torch.obs.slo import (
    Alert,
    SLOTracker,
    availability_source,
    default_slos,
    threshold_source,
)


class _Exporter:
    """A live /metrics endpoint over one Registry."""

    def __init__(self, registry: Registry):
        self.registry = registry
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *args):  # noqa: ARG002 — quiet tests
                pass

            def do_GET(self):  # noqa: N802
                if self.path != "/metrics":
                    self.send_response(404)
                    self.end_headers()
                    return
                body = outer.registry.render().encode("utf-8")
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.server = http.server.ThreadingHTTPServer(
            ("127.0.0.1", 0), Handler
        )
        self.thread = threading.Thread(
            target=self.server.serve_forever, daemon=True
        )
        self.thread.start()

    @property
    def target(self) -> str:
        host, port = self.server.server_address[:2]
        return f"{host}:{port}"

    def stop(self) -> None:
        self.server.shutdown()
        self.server.server_close()


def _serving_registry(ok=10, errors_5xx=0, tokens=100,
                      latencies=(0.05,), inflight=0) -> Registry:
    """A registry shaped like one serve worker's."""
    reg = Registry()
    req = reg.counter("tpu_serve_requests_total", "requests",
                      labelnames=("endpoint", "code"))
    if ok:
        req.labels("/v1/completions", "200").inc(ok)
    if errors_5xx:
        req.labels("/v1/completions", "500").inc(errors_5xx)
    lat = reg.histogram("tpu_serve_request_seconds", "latency",
                        labelnames=("endpoint",),
                        buckets=(0.1, 0.5, 1.0))
    for v in latencies:
        lat.labels("/v1/completions").observe(v)
    reg.counter("tpu_serve_tokens_generated_total", "tokens").inc(tokens)
    reg.gauge("tpu_serve_inflight_requests", "inflight").set(inflight)
    return reg


@pytest.fixture()
def two_workers():
    a = _Exporter(_serving_registry(ok=10, tokens=100, inflight=2))
    b = _Exporter(_serving_registry(ok=30, tokens=900, inflight=0))
    yield a, b
    a.stop()
    b.stop()


# -- target normalization ----------------------------------------------------


def test_normalize_target_forms():
    assert _normalize_target("127.0.0.1:9100") == (
        "127.0.0.1:9100", "http://127.0.0.1:9100/metrics"
    )
    assert _normalize_target("http://h:1/metrics") == (
        "h:1", "http://h:1/metrics"
    )
    assert _normalize_target("http://h:1") == ("h:1", "http://h:1/metrics")


def test_rate_handles_resets_and_degenerate_windows():
    assert rate(110.0, 100.0, 5.0) == pytest.approx(2.0)
    # counter reset (worker restarted): `then` is treated as 0, so the
    # rate is the new value over the window — never negative, never None
    assert rate(5.0, 100.0, 5.0) == pytest.approx(1.0)
    assert rate(1.0, 0.0, 0.0) is None


# -- the aggregator against live workers -------------------------------------


def test_aggregator_merges_instances(two_workers):
    a, b = two_workers
    agg = FleetAggregator([a.target, b.target])
    snap = agg.scrape_once()

    assert snap.instances() == sorted([a.target, b.target])
    assert all(h.up == 1 for h in snap.health.values())
    assert all(h.consecutive_failures == 0 for h in snap.health.values())

    # every merged sample carries its worker's instance label
    tokens = snap.families["tpu_serve_tokens_generated_total"]
    assert {s.labels_dict()["instance"] for s in tokens.samples} == {
        a.target, b.target
    }
    assert snap.value_sum("tpu_serve_tokens_generated_total") == 1000
    mine = lambda inst: lambda labels: labels.get("instance") == inst
    assert snap.value_sum(
        "tpu_serve_tokens_generated_total", mine(a.target)
    ) == 100

    # the synthetic health families use the Prometheus convention
    up = {s.labels_dict()["instance"]: s.value
          for s in snap.families["up"].samples}
    assert up == {a.target: 1.0, b.target: 1.0}

    # the merged view re-exposes losslessly (scrape-able aggregator)
    reparsed = {f.name for f in expfmt.parse(snap.render())}
    assert "up" in reparsed and "tpu_serve_requests_total" in reparsed


def test_dead_target_degrades_not_fails(two_workers):
    a, b = two_workers
    dead_port_target = b.target
    b.stop()                       # the port is now closed
    agg = FleetAggregator([a.target, dead_port_target], timeout_s=1.0)

    snap = agg.scrape_once()
    assert snap.health[a.target].up == 1
    dead = snap.health[dead_port_target]
    assert dead.up == 0
    assert dead.consecutive_failures == 1
    assert dead.last_error

    snap = agg.scrape_once()       # failures accumulate across cycles
    assert snap.health[dead_port_target].consecutive_failures == 2
    # the live worker's samples still merged both times
    assert snap.value_sum("tpu_serve_tokens_generated_total") == 100


def test_histogram_queries_across_fleet(two_workers):
    a, b = two_workers
    # a: one fast request; b: one fast + two slow
    b.registry.histogram(
        "tpu_serve_request_seconds", "latency", labelnames=("endpoint",),
        buckets=(0.1, 0.5, 1.0),
    ).labels("/v1/completions").observe(0.4)
    snap = FleetAggregator([a.target, b.target]).scrape_once()
    assert snap.histogram_count("tpu_serve_request_seconds") == 3
    buckets = dict(snap.histogram_buckets("tpu_serve_request_seconds"))
    assert buckets[0.1] == 2 and buckets[0.5] == 3
    assert snap.quantile("tpu_serve_request_seconds", 0.5) is not None


# -- SLO burn-rate alerting --------------------------------------------------


def test_availability_burn_alert_lifecycle(two_workers):
    """Synthetic 5xx injection drives the availability SLO through the
    full multi-window life: ok → pending (fast burn) → firing (held past
    for_s) → fast windows clear while slow still remembers → resolved."""
    a, b = two_workers
    req = a.registry.counter(
        "tpu_serve_requests_total", "requests",
        labelnames=("endpoint", "code"),
    )
    agg = FleetAggregator([a.target, b.target])
    slo = SLOTracker("availability", 0.999, availability_source,
                     for_s=60.0)
    t0 = 1_000_000.0

    def cycle(now):
        snap = agg.scrape_once(now=now)
        slo.observe(snap, now=now)
        return slo.evaluate(now=now)

    req.labels("/v1/completions", "200").inc(1000)
    alert = cycle(t0)
    assert alert.state == "ok" and alert.severity == ""

    req.labels("/v1/completions", "500").inc(100)   # inject 5xx burst
    alert = cycle(t0 + 60)
    assert alert.state == "pending"
    assert alert.severity == "page" and alert.since == t0 + 60
    assert alert.burn_fast >= 14.4

    req.labels("/v1/completions", "200").inc(100)   # bleeding stopped
    alert = cycle(t0 + 120)
    assert alert.state == "firing"                  # breach held for_s

    req.labels("/v1/completions", "200").inc(100)
    alert = cycle(t0 + 420)
    # the 5m window is past the burst so the fast pair cleared, but the
    # slow pair still remembers — this is the ticket, not the page
    assert alert.burn_fast < 14.4
    assert alert.state == "firing" and alert.severity == "ticket"

    req.labels("/v1/completions", "200").inc(100)
    alert = cycle(t0 + 2220)
    assert alert.state == "ok" and alert.since is None  # fully resolved


def test_slo_resolve_hold_down_prevents_flapping():
    """Regression: a firing SLO must stay clean ``resolve_for_s`` before
    it resolves, so burn hovering at the threshold cannot strobe
    firing/resolved at the pager — and a re-breach during the hold keeps
    the ORIGINAL firing alert (no ok→pending round trip). The default
    ``resolve_for_s=0`` preserves the historical instant resolve (the
    lifecycle test above exercises that path)."""
    reading = {"good": 100.0, "total": 100.0}
    slo = SLOTracker(
        "availability", 0.99,
        lambda _snap: (reading["good"], reading["total"]),
        for_s=60.0, resolve_for_s=600.0,
    )
    assert SLOTracker("availability", 0.99,
                      availability_source).resolve_for_s == 0.0

    def cycle(now, good=0.0, bad=0.0):
        reading["good"] += good
        reading["total"] += good + bad
        slo.observe(None, now=now)
        return slo.evaluate(now=now)

    t0 = 1_000_000.0
    assert cycle(t0).state == "ok"
    assert cycle(t0 + 60, bad=100).state == "pending"
    alert = cycle(t0 + 120, bad=10)
    assert alert.state == "firing" and alert.since == t0 + 60

    # burn goes fully clean — before the fix this resolved instantly;
    # now the hold keeps it firing (and still paging) for resolve_for_s
    alert = cycle(t0 + 30_000, good=100_000)
    assert alert.state == "firing" and alert.severity == "page"
    alert = cycle(t0 + 30_300, good=100)         # clean 300s < 600s hold
    assert alert.state == "firing"

    # re-breach DURING the hold: the same alert keeps firing with its
    # original since — no resolve/refire strobe ever reached the pager
    alert = cycle(t0 + 30_360, bad=200_000)
    assert alert.state == "firing" and alert.severity == "page"
    assert alert.since == t0 + 60

    # clean again, and STAY clean through the full hold → resolved
    alert = cycle(t0 + 60_360, good=10_000_000)
    assert alert.state == "firing"               # hold restarts
    alert = cycle(t0 + 60_960, good=100)         # clean ≥ resolve_for_s
    assert alert.state == "ok" and alert.since is None


def test_threshold_source_reads_cumulative_buckets(two_workers):
    a, b = two_workers
    # a has one 0.05s request; b one 0.05s; add two slow ones to b
    h = b.registry.histogram(
        "tpu_serve_request_seconds", "latency", labelnames=("endpoint",),
        buckets=(0.1, 0.5, 1.0),
    )
    h.labels("/v1/completions").observe(0.9)
    h.labels("/v1/completions").observe(5.0)
    snap = FleetAggregator([a.target, b.target]).scrape_once()
    good, total = threshold_source("tpu_serve_request_seconds", 0.5)(snap)
    assert total == 4 and good == 2           # the two 0.05s requests


def test_default_slos_cover_the_serving_objectives():
    names = {t.name for t in default_slos()}
    assert names == {"availability", "latency", "ttft"}
    with pytest.raises(ValueError):
        SLOTracker("bad", 1.5, availability_source)


# -- dead-target backoff (jittered exponential, reset on success) ------------


def test_dead_target_backs_off_with_jitter(two_workers):
    a, b = two_workers
    dead = b.target
    b.stop()
    agg = FleetAggregator([a.target, dead], timeout_s=1.0, retries=0,
                          backoff_base_s=10.0)

    snap = agg.scrape_once(now=1000.0)
    h = snap.health[dead]
    assert h.up == 0 and h.consecutive_failures == 1
    assert 8.0 <= h.backoff_s <= 12.0          # base ± 20% jitter
    assert h.next_scrape_ts == pytest.approx(1000.0 + h.backoff_s)

    # inside the window the dead target is skipped entirely — no timeout
    # burned, failure count frozen — while the live sibling still scrapes
    snap = agg.scrape_once(now=1001.0)
    assert snap.health[dead].consecutive_failures == 1
    assert snap.value_sum("tpu_serve_tokens_generated_total") == 100

    # past the window it is re-polled and the penalty roughly doubles
    snap = agg.scrape_once(now=1000.0 + h.backoff_s + 0.01)
    h2 = snap.health[dead]
    assert h2.consecutive_failures == 2
    assert 16.0 <= h2.backoff_s <= 24.0

    # the penalty is a first-class gauge in the merged snapshot
    backoffs = {s.labels_dict()["instance"]: s.value
                for s in snap.families["fleet_scrape_backoff_seconds"].samples}
    assert backoffs[dead] == h2.backoff_s
    assert backoffs[a.target] == 0.0


def test_backoff_caps_then_resets_on_success(two_workers):
    """Drive a LIVE target dead via the fault harness: the penalty grows
    to the 8x cap and no further; the first clean scrape zeroes it."""
    from tpu_kubernetes_torch.obs.faults import injected

    a, _b = two_workers
    agg = FleetAggregator([a.target], timeout_s=1.0, retries=0,
                          backoff_base_s=1.0)
    now = 1000.0
    with injected("fleet.scrape:1.0"):
        for _ in range(6):
            h = agg.scrape_once(now=now).health[a.target]
            assert h.up == 0
            assert "injected fault" in h.last_error
            now = h.next_scrape_ts + 0.01      # jump past each window
    assert h.consecutive_failures == 6
    assert h.backoff_s <= 8.0 * 1.2            # capped at 8x base (+jitter)
    assert h.backoff_s >= 8.0 * 0.8

    # faults cleared → next due scrape succeeds and resets everything
    h = agg.scrape_once(now=now).health[a.target]
    assert h.up == 1
    assert h.consecutive_failures == 0
    assert h.backoff_s == 0.0 and h.next_scrape_ts == 0.0


def test_backoff_disabled_by_default(two_workers):
    """backoff_base_s=0 (the default, and every one-shot caller) keeps
    every target in every cycle — no skip window ever opens."""
    a, b = two_workers
    dead = b.target
    b.stop()
    agg = FleetAggregator([a.target, dead], timeout_s=1.0)
    agg.scrape_once(now=1000.0)
    h = agg.scrape_once(now=1000.1).health[dead]
    assert h.consecutive_failures == 2         # scraped both cycles
    assert h.backoff_s == 0.0 and h.next_scrape_ts == 0.0


# -- SLO alert payloads -------------------------------------------------------


def test_alert_json_carries_since_age_and_burn_thresholds(two_workers):
    """Satellite: `monitor --json` alert objects say how long the alert
    has been active and what burn multiple the thresholds demand."""
    from tpu_kubernetes_torch.obs.slo import FAST_BURN, SLOW_BURN

    a, b = two_workers
    req = a.registry.counter(
        "tpu_serve_requests_total", "requests",
        labelnames=("endpoint", "code"),
    )
    agg = FleetAggregator([a.target, b.target])
    slo = SLOTracker("availability", 0.999, availability_source, for_s=60.0)
    t0 = 1_000_000.0

    def cycle(now):
        snap = agg.scrape_once(now=now)
        slo.observe(snap, now=now)
        return slo.evaluate(now=now)

    req.labels("/v1/completions", "200").inc(1000)
    d = cycle(t0).to_dict()
    assert d["since"] is None and d["age_s"] is None

    req.labels("/v1/completions", "500").inc(100)
    d = cycle(t0 + 60).to_dict()
    assert d["state"] == "pending"
    assert d["since"] == t0 + 60 and d["age_s"] == 0.0
    assert d["burn_fast"] >= d["burn_fast_threshold"] == FAST_BURN
    assert d["burn_slow_threshold"] == SLOW_BURN

    d = cycle(t0 + 120).to_dict()
    assert d["state"] == "firing"
    assert d["age_s"] == pytest.approx(60.0)


# ---------------------------------------------------------------------------
# per-role saturation + exemplars through the fleet pipeline
# ---------------------------------------------------------------------------


def _saturating_registry(role="prefill", occupancy=3.0, inflight=6,
                         waits=(0.5, 0.5, 0.5, 0.5), pages=None) -> Registry:
    """One worker under load: admission-wait observations, live slot
    rows, queue depth, a SERVE_ROLE info gauge, optionally a paged-KV
    page partition."""
    reg = _serving_registry(ok=5, inflight=inflight)
    reg.gauge("tpu_serve_role_info", "worker role (SERVE_ROLE)",
              labelnames=("role",)).labels(role).set(1)
    reg.gauge("tpu_serve_slot_occupancy", "live slot rows").set(occupancy)
    aw = reg.histogram("tpu_serve_admission_wait_seconds", "admission wait",
                       buckets=(0.01, 0.1, 1.0))
    for v in waits:
        aw.observe(v)
    if pages:
        pg = reg.gauge("tpu_serve_kv_pages", "page partition",
                       labelnames=("state",))
        for state, n in pages.items():
            pg.labels(state).set(n)
    return reg


def test_saturation_gauge_carries_role_label():
    w = _Exporter(_saturating_registry(role="prefill"))
    try:
        agg = FleetAggregator([w.target])
        snap = agg.scrape_once(now=1000.0)
        (sample,) = snap.families["tpu_serve_saturation"].samples
        d = sample.labels_dict()
        assert d["instance"] == w.target and d["role"] == "prefill"
        # first cycle: the EWMA seeds from the full absolutes (0.5s mean
        # wait -> ewma 0.15 -> 0.375); occupancy 3/(3+2)=0.6 dominates
        # inflight 6/(6+8); the score is the max component
        assert sample.value == pytest.approx(0.6, abs=1e-6)
        # a second cycle with no new observations keeps the EWMA steady
        (again,) = agg.scrape_once(now=1010.0) \
            .families["tpu_serve_saturation"].samples
        assert again.value == pytest.approx(0.6, abs=1e-6)
    finally:
        w.stop()


def test_saturation_page_pressure_component():
    w = _Exporter(_saturating_registry(
        role="decode", occupancy=0.0, inflight=0, waits=(),
        pages={"free": 2, "used": 18},
    ))
    try:
        snap = FleetAggregator([w.target]).scrape_once(now=1.0)
        (sample,) = snap.families["tpu_serve_saturation"].samples
        assert sample.labels_dict()["role"] == "decode"
        assert sample.value == pytest.approx(0.9, abs=1e-6)  # 1 - 2/20
    finally:
        w.stop()


def test_exemplars_survive_scrape_merge_reexpose():
    tid = "4bf92f3577b34da6a3ce929d0e0e4736"
    reg = _serving_registry(latencies=(0.05,))
    lat = reg.histogram("tpu_serve_request_seconds", "latency",
                        labelnames=("endpoint",),
                        buckets=(0.1, 0.5, 1.0))  # get-or-create: same family
    lat.labels("/v1/completions").observe(0.3, exemplar=tid)
    w = _Exporter(reg)
    try:
        snap = FleetAggregator([w.target]).scrape_once(now=1.0)
        text = snap.render()
        # the aggregator re-exposes the worker's exemplar verbatim...
        assert f'# {{trace_id="{tid}"}} 0.3' in text
        # ...still attached to the instance-tagged bucket sample, and the
        # re-exposed text parses back with the exemplar intact
        sample = next(
            s for f in expfmt.parse(text)
            if f.name == "tpu_serve_request_seconds"
            for s in f.samples if s.exemplar is not None
        )
        assert sample.labels_dict()["instance"] == w.target
        assert sample.exemplar.labels == (("trace_id", tid),)
        assert sample.exemplar.value == pytest.approx(0.3)
    finally:
        w.stop()


# ---------------------------------------------------------------------------
# parity with the reference's modules: the same expositions through both
# packages' snapshots, objectives and history stores
# ---------------------------------------------------------------------------


def _cycles():
    """Ten cycles of one worker's exposition: clean traffic, a 5xx burst
    and slow requests, then clean traffic again."""
    reg = _serving_registry(ok=1000, latencies=(0.05,) * 50)
    req = reg.counter("tpu_serve_requests_total", "requests",
                      labelnames=("endpoint", "code"))
    lat = reg.histogram("tpu_serve_request_seconds", "latency",
                        labelnames=("endpoint",), buckets=(0.1, 0.5, 1.0))
    for i in range(10):
        req.labels("/v1/completions", "200").inc(100)
        if 2 <= i <= 4:
            req.labels("/v1/completions", "500").inc(40)
            for _ in range(20):
                lat.labels("/v1/completions").observe(3.0)
        yield 1_000_000.0 + 60.0 * i, reg.render()


def _snapshot(pkg, ts, text):
    import importlib

    expfmt_mod = importlib.import_module(f"{pkg}.obs.expfmt")
    aggregate = importlib.import_module(f"{pkg}.obs.aggregate")
    families = {f.name: f for f in expfmt_mod.parse(text)}
    return aggregate.FleetSnapshot(ts=ts, health={}, families=families)


def test_objectives_and_store_follow_the_reference():
    """The default objectives over one series of snapshots give the same
    alerts (state, severity, burns, since) at every cycle in both
    packages, and the stores they share answer alike."""
    from tpu_kubernetes.obs.slo import default_slos as jdefault_slos
    from tpu_kubernetes.obs.tsdb import TSDB as JTSDB

    stores = {"tpu_kubernetes_torch": TSDB(), "tpu_kubernetes": JTSDB()}
    slos = {"tpu_kubernetes_torch": default_slos(
                store=stores["tpu_kubernetes_torch"], for_s=60.0),
            "tpu_kubernetes": jdefault_slos(
                store=stores["tpu_kubernetes"], for_s=60.0)}
    states = set()
    for ts, text in _cycles():
        alerts = {}
        for pkg in stores:
            snap = _snapshot(pkg, ts, text)
            stores[pkg].ingest(snap)
            for t in slos[pkg]:
                t.observe(snap, now=ts)
            alerts[pkg] = [t.evaluate(now=ts).to_dict() for t in slos[pkg]]
        assert alerts["tpu_kubernetes_torch"] == alerts["tpu_kubernetes"]
        states.update(a["state"] for a in alerts["tpu_kubernetes"])
        port_snap = _snapshot("tpu_kubernetes_torch", ts, text)
        ref_snap = _snapshot("tpu_kubernetes", ts, text)
        assert port_snap.render() == ref_snap.render()
        for q in (0.5, 0.99):
            assert port_snap.quantile("tpu_serve_request_seconds", q) == \
                ref_snap.quantile("tpu_serve_request_seconds", q)
    assert {"ok", "pending", "firing"} <= states
    port, ref = stores["tpu_kubernetes_torch"], stores["tpu_kubernetes"]
    assert port.names() == ref.names()
    for name in ("tpu_serve_requests_total",
                 "tpu_serve_tokens_generated_total"):
        assert port.rate_over_time(name, 300.0, ts) == \
            ref.rate_over_time(name, 300.0, ts)
