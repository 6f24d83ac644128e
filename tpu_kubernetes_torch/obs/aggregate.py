"""Fleet-scope metrics aggregation: scrape N workers, merge one view.

The port's copy of ``tpu_kubernetes/obs/aggregate.py`` (the port imports nothing of
the JAX package): the same names, families and behaviour.

Every process has its own registry and ``GET /metrics``; this is
the layer that can see the fleet (ROADMAP north star: many serve/train
workers behind one operator). A :class:`FleetAggregator` polls each
target's ``/metrics`` concurrently (bounded by per-request timeouts and
a retry), parses the exposition (obs/expfmt.py), tags every sample with
an ``instance`` label, and merges the lot into one
:class:`FleetSnapshot` — which renders back out as exposition (the
aggregator is itself scrape-able) and answers the queries the SLO
evaluator (obs/slo.py) and the ``monitor`` CLI ask.

Per-target scrape health is first-class: ``up`` (the Prometheus
convention — 1 scraped, 0 failed), scrape latency, and consecutive
failure counts survive across cycles, so one dead worker reads as
``up=0`` without failing the cycle for its siblings.
"""

from __future__ import annotations

import json
import math
import random
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field, replace
from typing import Callable

from tpu_kubernetes_torch.obs import expfmt, tracing
from tpu_kubernetes_torch.obs.faults import FAULTS

# synthetic per-target families the aggregator itself contributes
UP = "up"
SCRAPE_SECONDS = "fleet_scrape_duration_seconds"
SCRAPE_FAILURES = "fleet_scrape_consecutive_failures"
SCRAPE_BACKOFF = "fleet_scrape_backoff_seconds"

# exponential backoff cap, as a multiple of the base interval: a target
# that stays dead is re-polled at ~8x the normal period, not never
BACKOFF_CAP_MULT = 8.0

# per-instance saturation score: each component maps to [0, 1) via
# x / (x + half), where ``half`` is the reading at which the component
# scores 0.5 — the score is the MAX component (the binding constraint),
# which is what a placement decision actually routes away from
SAT_WAIT_HALF_S = 0.25   # admission-wait EWMA seconds scoring 0.5
SAT_QUEUE_HALF = 8.0     # inflight requests scoring 0.5
SAT_SLOTS_HALF = 2.0     # mean live slot rows scoring 0.5
SAT_EWMA_ALPHA = 0.3     # per-cycle smoothing of the admission wait


@dataclass
class TargetHealth:
    instance: str
    up: int = 0
    consecutive_failures: int = 0
    last_scrape_seconds: float = 0.0
    last_error: str = ""
    last_success_ts: float = 0.0
    backoff_s: float = 0.0       # current penalty (0 = none / disabled)
    next_scrape_ts: float = 0.0  # skip scrapes until this timestamp
    # instance lifecycle from GET /healthz ("serving"/"warming"/
    # "draining"/"failed"; "" = unknown or probing disabled) — what
    # distinguishes a draining instance from a merely saturated one
    lifecycle: str = ""


@dataclass
class FleetSnapshot:
    """One merged scrape cycle: every worker's families with ``instance``
    labels, plus the synthetic health families."""

    ts: float
    health: dict[str, TargetHealth]
    families: dict[str, expfmt.Family]

    def instances(self) -> list[str]:
        return sorted(self.health)

    def render(self) -> str:
        """The merged view as text exposition (name-ordered, like the
        per-process registry) — the aggregator re-exposes losslessly."""
        return expfmt.render(
            [self.families[n] for n in sorted(self.families)]
        )

    # -- queries (what obs/slo.py and the monitor table read) --------------

    def _samples(self, sample_name: str, family: str,
                 where: Callable[[dict[str, str]], bool] | None):
        fam = self.families.get(family)
        if fam is None:
            return
        for s in fam.samples:
            if s.name != sample_name:
                continue
            if where is None or where(s.labels_dict()):
                yield s

    def value_sum(self, name: str,
                  where: Callable[[dict[str, str]], bool] | None = None,
                  ) -> float:
        """Sum a counter/gauge family's samples across the fleet
        (optionally filtered by a labels predicate, e.g. one instance)."""
        return sum(s.value for s in self._samples(name, name, where))

    def histogram_buckets(self, name: str,
                          where: Callable[[dict[str, str]], bool] | None = None,
                          ) -> list[tuple[float, float]]:
        """Cumulative ``(le, count)`` pairs for a histogram family,
        bucket-wise summed across matching series (le grids are shared —
        every worker runs the same instrumentation)."""
        acc: dict[float, float] = {}
        for s in self._samples(f"{name}_bucket", name, where):
            le = expfmt.parse_value(s.labels_dict().get("le", "+Inf"))
            acc[le] = acc.get(le, 0.0) + s.value
        return sorted(acc.items())

    def histogram_count(self, name: str,
                        where: Callable[[dict[str, str]], bool] | None = None,
                        ) -> float:
        return sum(s.value for s in self._samples(f"{name}_count", name, where))

    def histogram_sum(self, name: str,
                      where: Callable[[dict[str, str]], bool] | None = None,
                      ) -> float:
        return sum(s.value for s in self._samples(f"{name}_sum", name, where))

    def quantile(self, name: str, q: float,
                 where: Callable[[dict[str, str]], bool] | None = None,
                 ) -> float | None:
        return expfmt.bucket_quantile(self.histogram_buckets(name, where), q)

    def label_value(self, family: str, label: str,
                    where: Callable[[dict[str, str]], bool] | None = None,
                    ) -> str | None:
        """First matching sample's value for one LABEL — how ``*_info``
        idiom families are read (e.g. the ``version`` a worker's
        ``tpu_k8s_build_info`` carries), where the sample value is a
        constant 1 and the payload rides the labels."""
        fam = self.families.get(family)
        if fam is None:
            return None
        for s in fam.samples:
            d = s.labels_dict()
            if where is not None and not where(d):
                continue
            if label in d:
                return d[label]
        return None


@dataclass
class ScrapeResult:
    instance: str
    ok: bool
    seconds: float
    families: list[expfmt.Family] = field(default_factory=list)
    error: str = ""
    lifecycle: str = ""


def _normalize_target(target: str) -> tuple[str, str]:
    """``host:port`` (or a full URL) → (instance label, scrape URL)."""
    target = target.strip()
    if "://" not in target:
        return target, f"http://{target}/metrics"
    rest = target.split("://", 1)[1]
    instance = rest.split("/", 1)[0]
    if rest == instance:  # bare scheme://host:port — default the path
        return instance, f"{target.rstrip('/')}/metrics"
    return instance, target


class FleetAggregator:
    """Thread-safe multi-target scraper. ``scrape_once`` may be called
    from any thread (the monitor loop, a test, a future autoscaler);
    health state is cumulative across cycles under one lock."""

    def __init__(self, targets: list[str], timeout_s: float = 2.0,
                 retries: int = 1, max_workers: int = 16,
                 backoff_base_s: float = 0.0, tsdb=None, alerts=None,
                 probe_health: bool = False):
        self._targets = [_normalize_target(t) for t in targets]
        if not self._targets:
            raise ValueError("FleetAggregator needs at least one target")
        self.timeout_s = timeout_s
        self.retries = max(0, int(retries))
        # probe_health=True adds one GET /healthz per target per cycle,
        # recording the instance lifecycle (serving/warming/draining/
        # failed) alongside the scrape — bare exporters without a
        # healthz endpoint simply read as "" (unknown)
        self.probe_health = bool(probe_health)
        # backoff_base_s > 0 (callers pass their poll interval) arms
        # jittered exponential backoff for dead targets: consecutive
        # failures double the re-poll delay up to BACKOFF_CAP_MULT x the
        # base, reset on success. 0 keeps every cycle scraping every
        # target (one-shot callers want the immediate answer).
        self.backoff_base_s = max(0.0, float(backoff_base_s))
        # a history store (obs/tsdb.py, duck-typed: .ingest(snapshot))
        # receives every merged cycle — the one source of truth the SLO
        # burn windows, monitor trends, and `get history` all read
        self._tsdb = tsdb
        # an alert manager (obs/alerts.py, duck-typed:
        # .evaluate(snapshot=, store=, now=)) evaluated against every
        # merged cycle — headless callers (a future autoscaler) get
        # rule evaluation without running the monitor loop
        self._alerts = alerts
        self._max_workers = max(1, min(max_workers, len(self._targets)))
        self._lock = threading.Lock()
        self._health: dict[str, TargetHealth] = {
            instance: TargetHealth(instance=instance)
            for instance, _ in self._targets
        }
        # admission-wait EWMA state per instance (scrape_once only —
        # single-writer, so it lives outside the health lock)
        self._sat_state: dict[str, dict] = {}

    def _fetch(self, url: str) -> str:
        # every outbound scrape carries W3C trace context — the scrape
        # itself becomes a span in the worker's ring, so a slow /metrics
        # endpoint is attributable like any other request
        req = urllib.request.Request(
            url, headers=tracing.outbound_headers({
                "Accept": "text/plain", "User-Agent": "tpu-k8s-monitor",
            }),
        )
        with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
            return resp.read().decode("utf-8", "replace")

    def _probe_lifecycle(self, instance: str, url: str) -> str:
        """GET the target's ``/healthz`` and map its ``status`` to the
        lifecycle label the monitor shows: ``ok`` → ``serving``; the
        503 states (``warming``/``draining``/``failed``) carry their
        status in the error body. Anything unparsable — a bare metrics
        exporter with no healthz — reads as ``""`` (unknown)."""
        probe = f"{url.split('://', 1)[0]}://{instance}/healthz"
        req = urllib.request.Request(probe, headers=tracing.outbound_headers({
            "Accept": "application/json", "User-Agent": "tpu-k8s-monitor",
        }))
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
                body = resp.read()
        except urllib.error.HTTPError as e:
            try:
                body = e.read()
            except Exception:  # noqa: BLE001 — probe is best-effort
                return ""
        except Exception:  # noqa: BLE001 — probe is best-effort
            return ""
        try:
            status = json.loads(body.decode("utf-8", "replace")).get("status")
        except Exception:  # noqa: BLE001 — non-JSON healthz
            return ""
        if not isinstance(status, str):
            return ""
        return "serving" if status == "ok" else status

    def _scrape_target(self, instance: str, url: str) -> ScrapeResult:
        last_error = ""
        lifecycle = (
            self._probe_lifecycle(instance, url) if self.probe_health else ""
        )
        t0 = time.monotonic()
        for _ in range(self.retries + 1):
            try:
                FAULTS.fire("fleet.scrape")
                families = expfmt.parse(self._fetch(url))
            except Exception as e:  # noqa: BLE001 — per-target isolation
                last_error = f"{type(e).__name__}: {e}"[:200]
                continue
            return ScrapeResult(
                instance=instance, ok=True,
                seconds=time.monotonic() - t0, families=families,
                lifecycle=lifecycle,
            )
        return ScrapeResult(
            instance=instance, ok=False,
            seconds=time.monotonic() - t0, error=last_error,
            lifecycle=lifecycle,
        )

    def health(self) -> dict[str, TargetHealth]:
        with self._lock:
            return {i: replace(h) for i, h in self._health.items()}

    def _saturation_family(self, merged: dict, health: dict, *,
                           metric: str) -> expfmt.Family:
        """Per-instance saturation in [0, 1): the MAX of four component
        pressures — admission-wait EWMA (delta mean per cycle, smoothed
        by SAT_EWMA_ALPHA), mean live slot rows, free-page fraction
        (paged engines), and inflight queue depth — each squashed via
        ``x / (x + half)``. The ``role`` label joins the worker's
        ``tpu_serve_role_info`` gauge (SERVE_ROLE), so disaggregated
        prefill/decode tiers balance independently."""

        def val(family: str, sample_name: str, instance: str,
                extra: dict | None = None) -> float:
            fam = merged.get(family)
            if fam is None:
                return 0.0
            out = 0.0
            for s in fam.samples:
                if s.name != sample_name:
                    continue
                d = s.labels_dict()
                if d.get("instance") != instance:
                    continue
                if extra and any(d.get(k) != v for k, v in extra.items()):
                    continue
                out += s.value
            return out

        def role_of(instance: str) -> str:
            fam = merged.get("tpu_serve_role_info")
            if fam is not None:
                for s in fam.samples:
                    d = s.labels_dict()
                    if d.get("instance") == instance and "role" in d:
                        return d["role"]
            return ""

        aw = "tpu_serve_admission_wait_seconds"
        samples = []
        for i in sorted(health):
            wsum = val(aw, aw + "_sum", i)
            wcount = val(aw, aw + "_count", i)
            st = self._sat_state.get(i) or \
                {"sum": 0.0, "count": 0.0, "ewma": 0.0}
            dsum, dcount = wsum - st["sum"], wcount - st["count"]
            if dsum < 0 or dcount < 0:   # counter reset (worker restart)
                dsum, dcount = wsum, wcount
            if dcount > 0:
                st["ewma"] = (SAT_EWMA_ALPHA * (dsum / dcount)
                              + (1.0 - SAT_EWMA_ALPHA) * st["ewma"])
            st["sum"], st["count"] = wsum, wcount
            self._sat_state[i] = st
            wait_p = st["ewma"] / (st["ewma"] + SAT_WAIT_HALF_S)
            occ = val("tpu_serve_slot_occupancy",
                      "tpu_serve_slot_occupancy", i)
            occ_p = occ / (occ + SAT_SLOTS_HALF) if occ > 0 else 0.0
            q = val("tpu_serve_inflight_requests",
                    "tpu_serve_inflight_requests", i)
            q_p = q / (q + SAT_QUEUE_HALF) if q > 0 else 0.0
            pages = val("tpu_serve_kv_pages", "tpu_serve_kv_pages", i)
            free = val("tpu_serve_kv_pages", "tpu_serve_kv_pages", i,
                       {"state": "free"})
            page_p = (1.0 - free / pages) if pages > 0 else 0.0
            samples.append(expfmt.Sample(
                name=metric,
                labels=(("instance", i), ("role", role_of(i))),
                value=round(max(wait_p, occ_p, q_p, page_p), 6),
            ))
        return expfmt.Family(
            name=metric, kind="gauge",
            help="per-instance saturation score in [0,1): max of "
                 "admission-wait EWMA, slot occupancy, page pressure, "
                 "and queue-depth components (role joins SERVE_ROLE)",
            samples=samples,
        )

    def scrape_once(self, now: float | None = None) -> FleetSnapshot:
        """One fleet cycle: scrape every target concurrently, update
        health, and return the merged snapshot. A failing target never
        fails the cycle — it contributes ``up=0`` and keeps its last
        error on record."""
        now = time.time() if now is None else now
        # dead targets still inside their backoff window are skipped this
        # cycle (they keep their up=0 / failure-count reading); everyone
        # else scrapes concurrently
        with self._lock:
            due = [
                (instance, url) for instance, url in self._targets
                if not (self.backoff_base_s > 0
                        and self._health[instance].next_scrape_ts > now)
            ]
        results: list[ScrapeResult] = []
        if due:
            with ThreadPoolExecutor(
                max_workers=min(self._max_workers, len(due))
            ) as pool:
                results = list(pool.map(
                    lambda t: self._scrape_target(*t), due
                ))

        with self._lock:
            for r in results:
                h = self._health[r.instance]
                h.up = 1 if r.ok else 0
                h.lifecycle = r.lifecycle
                h.last_scrape_seconds = round(r.seconds, 6)
                if r.ok:
                    h.consecutive_failures = 0
                    h.last_error = ""
                    h.last_success_ts = now
                    h.backoff_s = 0.0
                    h.next_scrape_ts = 0.0
                else:
                    h.consecutive_failures += 1
                    h.last_error = r.error
                    if self.backoff_base_s > 0:
                        raw = min(
                            self.backoff_base_s
                            * 2.0 ** (h.consecutive_failures - 1),
                            BACKOFF_CAP_MULT * self.backoff_base_s,
                        )
                        # ±20% jitter so a fleet of aggregators doesn't
                        # re-poll a recovering target in lockstep
                        h.backoff_s = round(
                            raw * random.uniform(0.8, 1.2), 6
                        )
                        h.next_scrape_ts = now + h.backoff_s
            health = {i: replace(h) for i, h in self._health.items()}

        merged: dict[str, expfmt.Family] = {}
        for r in results:
            for fam in r.families:
                dst = merged.get(fam.name)
                if dst is None:
                    dst = merged[fam.name] = expfmt.Family(
                        name=fam.name, help=fam.help, kind=fam.kind
                    )
                dst.samples.extend(
                    s.with_label("instance", r.instance) for s in fam.samples
                )

        for name, help_, kind, value_of in (
            (UP, "1 if the target's last scrape succeeded", "gauge",
             lambda h: float(h.up)),
            (SCRAPE_SECONDS, "wall time of the target's last scrape",
             "gauge", lambda h: h.last_scrape_seconds),
            (SCRAPE_FAILURES, "scrape failures since the last success",
             "gauge", lambda h: float(h.consecutive_failures)),
            (SCRAPE_BACKOFF, "current re-poll backoff for the target "
             "(0 = healthy or backoff disabled)",
             "gauge", lambda h: h.backoff_s),
        ):
            merged[name] = expfmt.Family(
                name=name, help=help_, kind=kind,
                samples=[
                    expfmt.Sample(
                        name=name, labels=(("instance", i),),
                        value=value_of(health[i]),
                    )
                    for i in sorted(health)
                ],
            )
        sat = self._saturation_family(
            merged, health, metric="tpu_serve_saturation",
        )
        merged[sat.name] = sat
        snapshot = FleetSnapshot(ts=now, health=health, families=merged)
        if self._tsdb is not None:
            try:
                self._tsdb.ingest(snapshot)
            except Exception:  # noqa: BLE001 — history must not fail a scrape
                pass
        if self._alerts is not None:
            try:
                self._alerts.evaluate(snapshot=snapshot, store=self._tsdb,
                                      now=now)
            except Exception:  # noqa: BLE001 — alerting must not fail a scrape
                pass
        return snapshot


def rate(now_value: float, then_value: float, seconds: float) -> float | None:
    """Per-second rate between two cumulative readings; None when the
    elapsed window is degenerate. A negative delta means the counter
    reset (worker restarted between cycles) — Prometheus semantics treat
    ``then`` as 0, so the rate is the new value over the window rather
    than a negative or a blank."""
    if seconds <= 0 or not math.isfinite(seconds):
        return None
    delta = now_value - then_value
    if delta < 0:  # counter reset: everything since restart is increase
        delta = now_value
    return delta / seconds
