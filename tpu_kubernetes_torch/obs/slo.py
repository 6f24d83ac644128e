"""Sliding-window SLOs with multi-window burn-rate alerting.

The port's copy of ``tpu_kubernetes/obs/slo.py`` (the port imports nothing of
the JAX package): the same names, families and behaviour.

The fleet aggregator (obs/aggregate.py) answers "what are the numbers";
this module answers "is the fleet keeping its promises". Each
:class:`SLOTracker` reduces a :class:`~tpu_kubernetes_torch.obs.aggregate.
FleetSnapshot` to a good/total event pair (availability from status
codes, latency and TTFT from histogram buckets vs a threshold), records
the pair as counter series in a history store (obs/tsdb.py — the same
store the monitor trends and ``get history`` read, one source of
truth), and evaluates the multi-window burn-rate rule from the SRE
workbook:

* **fast** — burn ≥ 14.4× over BOTH the 5m and 1h windows (budget gone
  in hours → page);
* **slow** — burn ≥ 6× over BOTH the 30m and 6h windows (budget gone in
  days → ticket).

Burn rate = (bad events / total events over the window) / (1 − target).
Requiring both windows makes alerts resolve quickly once the bleeding
stops (the short window goes clean first) without flapping on blips.

Alerts move ``ok → pending → firing``: a breach must hold for ``for_s``
seconds before it pages, and — symmetrically — a firing alert must stay
clean for ``resolve_for_s`` seconds before it resolves, so burn
hovering at the threshold cannot strobe firing/resolved at the pager
(``resolve_for_s=0``, the default, keeps the historical
instant-resolve). Clocks are injectable (``now=``) so tests can drive
hours of window arithmetic in milliseconds; production callers just
omit it.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable

from tpu_kubernetes_torch.obs.aggregate import FleetSnapshot
from tpu_kubernetes_torch.obs.tsdb import TSDB

# (windows that must BOTH breach, burn multiple, severity)
FAST_WINDOWS = (300.0, 3600.0)
FAST_BURN = 14.4
SLOW_WINDOWS = (1800.0, 21600.0)
SLOW_BURN = 6.0

# the series an objective writes into its history store — one pair per
# tracker, distinguished by the ``slo`` label, so many objectives can
# share one store with the fleet scrape series
GOOD_SERIES = "slo_good_total"
TOTAL_SERIES = "slo_events_total"

OK = "ok"
PENDING = "pending"
FIRING = "firing"


@dataclass
class Alert:
    """One SLO's evaluated state at a point in time."""

    slo: str
    state: str
    target: float
    severity: str = ""            # "page" (fast) / "ticket" (slow) when breaching
    since: float | None = None    # when the current pending/firing began
    age_s: float | None = None    # seconds in the current pending/firing state
    burn_fast: float = 0.0        # min burn over the fast window pair
    burn_slow: float = 0.0        # min burn over the slow window pair
    description: str = ""

    def to_dict(self) -> dict:
        """The pager-facing shape: ``since``/``age_s`` let receivers
        dedupe re-notifications of one incident and age it; the burn
        multiples (with their firing thresholds) say how fast the error
        budget is going."""
        return {
            "slo": self.slo,
            "state": self.state,
            "target": self.target,
            "severity": self.severity,
            "since": self.since,
            "age_s": None if self.age_s is None else round(self.age_s, 3),
            "burn_fast": round(self.burn_fast, 3),
            "burn_slow": round(self.burn_slow, 3),
            "burn_fast_threshold": FAST_BURN,
            "burn_slow_threshold": SLOW_BURN,
            "description": self.description,
        }


class SLOTracker:
    """One objective: a good/total reduction over snapshots plus the
    burn-rate state machine. Thread-safe (the monitor loop observes
    while a CLI/status thread may evaluate). Readings live in a
    :class:`~tpu_kubernetes_torch.obs.tsdb.TSDB` — pass ``store=`` to share
    the monitor's fleet store (the burn windows then read from the same
    retained history as every trend column), or omit it for a private
    one."""

    def __init__(self, name: str, target: float,
                 source: Callable[[FleetSnapshot], tuple[float, float]],
                 for_s: float = 60.0, description: str = "",
                 store: TSDB | None = None, resolve_for_s: float = 0.0):
        if not 0.0 < target < 1.0:
            raise ValueError(f"SLO target must be in (0, 1), got {target}")
        self.name = name
        self.target = target
        self.for_s = for_s
        self.resolve_for_s = max(0.0, float(resolve_for_s))
        self.description = description
        self._source = source
        self.store = store if store is not None else TSDB(max_bytes=1 << 20)
        self._labels = (("slo", name),)
        self._state = OK
        self._since: float | None = None
        self._clear_since: float | None = None  # resolve hold-down anchor
        self._last_severity = ""                # shown while holding clean
        self._lock = threading.Lock()

    def observe(self, snapshot: FleetSnapshot,
                now: float | None = None) -> None:
        """Record one aggregated cycle's good/total reading."""
        now = time.time() if now is None else now
        good, total = self._source(snapshot)
        with self._lock:
            self.store.append(GOOD_SERIES, float(good), self._labels,
                              ts=now, kind="counter")
            self.store.append(TOTAL_SERIES, float(total), self._labels,
                              ts=now, kind="counter")

    def _reading(self, ts: float) -> tuple[float, float] | None:
        """The (good, total) pair at the newest sample with timestamp
        ≤ ts, falling back to the oldest retained reading — with history
        shorter than the window the oldest reading is the baseline (rate
        over the data we have; cold starts must not divide by fiction)."""
        total = (self.store.sample_at_or_before(TOTAL_SERIES, self._labels, ts)
                 or self.store.first_sample(TOTAL_SERIES, self._labels))
        if total is None:
            return None
        good = (self.store.sample_at_or_before(GOOD_SERIES, self._labels, ts)
                or self.store.first_sample(GOOD_SERIES, self._labels))
        return (good[1] if good is not None else 0.0, total[1])

    def _burn(self, window: float, now: float) -> float:
        """Burn multiple over [now - window, now], read from the store."""
        latest = self._reading(float("inf"))
        if latest is None:
            return 0.0
        baseline = self._reading(now - window)
        if baseline is None:
            return 0.0
        delta_total = latest[1] - baseline[1]
        if delta_total <= 0:
            return 0.0
        delta_bad = delta_total - (latest[0] - baseline[0])
        ratio = min(1.0, max(0.0, delta_bad) / delta_total)
        return ratio / (1.0 - self.target)

    def evaluate(self, now: float | None = None) -> Alert:
        """Advance the state machine against the current history and
        return this objective's alert state."""
        now = time.time() if now is None else now
        with self._lock:
            burn_fast = min(self._burn(w, now) for w in FAST_WINDOWS)
            burn_slow = min(self._burn(w, now) for w in SLOW_WINDOWS)
            if burn_fast >= FAST_BURN:
                severity = "page"
            elif burn_slow >= SLOW_BURN:
                severity = "ticket"
            else:
                severity = ""
            if severity:
                self._clear_since = None
                self._last_severity = severity
                if self._state == OK:
                    self._state, self._since = PENDING, now
                elif (self._state == PENDING and self._since is not None
                        and now - self._since >= self.for_s):
                    self._state = FIRING
            elif self._state == FIRING and self.resolve_for_s > 0:
                # symmetric hold-down: a firing alert must stay clean
                # resolve_for_s before resolving, so burn hovering at
                # the threshold doesn't strobe firing/resolved
                if self._clear_since is None:
                    self._clear_since = now
                if now - self._clear_since >= self.resolve_for_s:
                    self._state, self._since = OK, None
                    self._clear_since = None
                    self._last_severity = ""
            else:
                self._state, self._since = OK, None
                self._clear_since = None
                self._last_severity = ""
            shown = severity or (
                self._last_severity if self._state == FIRING else ""
            )
            return Alert(
                slo=self.name, state=self._state, target=self.target,
                severity=shown if self._state != OK else "",
                since=self._since,
                age_s=None if self._since is None else max(0.0, now - self._since),
                burn_fast=burn_fast,
                burn_slow=burn_slow, description=self.description,
            )


# -- the serving fleet's standard objectives --------------------------------


def availability_source(snapshot: FleetSnapshot) -> tuple[float, float]:
    """good = responses that were not 5xx (client errors are the
    client's problem, not an availability burn)."""
    total = snapshot.value_sum("tpu_serve_requests_total")
    bad = snapshot.value_sum(
        "tpu_serve_requests_total",
        where=lambda labels: labels.get("code", "").startswith("5"),
    )
    return total - bad, total


def threshold_source(histogram: str, threshold_s: float,
                     ) -> Callable[[FleetSnapshot], tuple[float, float]]:
    """good = observations at or under ``threshold_s``, read from the
    cumulative bucket whose bound is the smallest ``le ≥ threshold``
    (the p99-style latency SLO: X% of requests under Y seconds)."""

    def source(snapshot: FleetSnapshot) -> tuple[float, float]:
        buckets = snapshot.histogram_buckets(histogram)
        total = snapshot.histogram_count(histogram)
        good = total
        for le, count in buckets:  # sorted ascending
            if le >= threshold_s:
                good = count
                break
        return good, total

    return source


def default_slos(availability_target: float = 0.999,
                 latency_threshold_s: float = 1.0,
                 latency_target: float = 0.99,
                 ttft_threshold_s: float = 2.5,
                 ttft_target: float = 0.95,
                 for_s: float = 60.0,
                 store: TSDB | None = None,
                 resolve_for_s: float = 60.0) -> list[SLOTracker]:
    """The serving fleet's standard objectives — what the ``monitor``
    CLI evaluates unless handed something else. ``store`` shares one
    history store across the objectives (and with the fleet scrape
    series when the monitor passes its own)."""
    return [
        SLOTracker(
            "availability", availability_target, availability_source,
            for_s=for_s, store=store, resolve_for_s=resolve_for_s,
            description="non-5xx responses / all responses",
        ),
        SLOTracker(
            "latency", latency_target,
            threshold_source("tpu_serve_request_seconds",
                             latency_threshold_s),
            for_s=for_s, store=store, resolve_for_s=resolve_for_s,
            description=(
                f"requests served within {latency_threshold_s:g}s"
            ),
        ),
        SLOTracker(
            "ttft", ttft_target,
            threshold_source("tpu_serve_time_to_first_token_seconds",
                             ttft_threshold_s),
            for_s=for_s, store=store, resolve_for_s=resolve_for_s,
            description=(
                f"streams first token within {ttft_threshold_s:g}s"
            ),
        ),
    ]
