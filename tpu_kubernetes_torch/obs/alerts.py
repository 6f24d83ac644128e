"""Rule-driven alerting: the layer that *acts on* what the obs stack sees.

The port's copy of ``tpu_kubernetes/obs/alerts.py`` (the port imports nothing of
the JAX package): the same names, families and behaviour.

The metrics registry, fleet aggregator, TSDB, and SLO burn windows can
observe everything; this module turns those observations into a
deduplicated, machine-consumable stream of firing signals — the input
the ROADMAP's fleet controller will eventually scale on, and the input
the incident correlator (obs/incidents.py) groups into postmortem
bundles today.

An :class:`AlertManager` evaluates a declarative registry of
:class:`Rule` objects against an :class:`EvalContext` (a fleet
snapshot, a history store, and/or engine-local callables) and runs each
breach through one state machine::

    ok ──breach──▶ pending ──held for_s──▶ firing
                      │                       │
                   clean                 clean held
                   (drop)                resolve_for_s
                      ▼                       ▼
                     ok ◀────retention──── resolved

Hold-downs apply in BOTH directions: a breach must persist ``for_s``
seconds before it fires (no paging on a blip) and a firing alert must
stay clean ``resolve_for_s`` seconds before it resolves (no strobing
when a signal hovers at its threshold). Alerts are deduplicated by
**fingerprint** (a stable hash of rule name + labels), grouped for
notification (one webhook POST per fingerprint per group interval, not
one per evaluation), silenceable by label matchers, and every state
transition emits a structured event (obs/events.py) carrying the
fingerprint as the correlation id. Clocks are injectable (``now=``)
throughout — the whole lifecycle is testable without a single sleep.

The rule vocabulary covers three families:

* **SLO burn** — :class:`SLOBurnRule` wraps an existing
  :class:`~tpu_kubernetes_torch.obs.slo.SLOTracker`; the tracker keeps owning
  the burn-window state machine and the manager adds fingerprints,
  dedup, notifications, and incident correlation on top.
* **Invariant tripwires** — conditions that must NEVER be true: the
  page-pool partition drifting from ``free+live+pinned == total``, the
  token ledger failing ``sum(classes) == emitted``, a scrape target
  down, the engine-restart counter increasing, any fault injected.
* **Anomaly detectors** — EWMA/z-score latency drift, counter-stall
  (tokens-emitted flat while work is in flight), queue-depth runaway.

Notification sinks (JSONL file, webhook HTTP with bounded
retry/backoff) deliver from a dedicated daemon thread with a bounded
queue, so a dead webhook endpoint can NEVER block the scrape or
scheduler loop that evaluated the alert. Every delivery attempt runs
behind the ``obs.alert_sink`` fault site and lands in
``tpu_alert_notifications_total{sink,status}``; the current firing
count rides ``tpu_alerts_firing{severity}``.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import threading
import time
import urllib.request
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable

from tpu_kubernetes_torch.obs import REGISTRY
from tpu_kubernetes_torch.obs.faults import FAULTS

SCHEMA = "tpu-k8s-alerts/1"

OK = "ok"
PENDING = "pending"
FIRING = "firing"
RESOLVED = "resolved"

# how long a resolved alert stays listed (snapshot/`get alerts`) before
# the manager forgets its fingerprint
RESOLVED_RETENTION_S = 600.0

# -- self-metrics ------------------------------------------------------------

ALERTS_FIRING = REGISTRY.gauge(
    "tpu_alerts_firing",
    "alerts currently firing, by severity",
    labelnames=("severity",),
)
NOTIFICATIONS_TOTAL = REGISTRY.counter(
    "tpu_alert_notifications_total",
    "alert notification deliveries by sink and outcome "
    '(status="error" means the sink exhausted its bounded retries)',
    labelnames=("sink", "status"),
)


def fingerprint(rule: str, labels: dict[str, str] | None = None) -> str:
    """The stable dedup key of one (rule, labels) alert identity."""
    blob = rule + "|" + ",".join(
        f"{k}={v}" for k, v in sorted((labels or {}).items())
    )
    return hashlib.sha1(blob.encode("utf-8")).hexdigest()[:12]


@dataclass
class EvalContext:
    """What rules evaluate against. Fleet-side evaluation carries a
    :class:`~tpu_kubernetes_torch.obs.aggregate.FleetSnapshot` and the shared
    history store; engine-local tripwires carry callables in ``local``
    (engine stats, the ledger, registry counter readers). Rules that
    need a part the context lacks report nothing — one rule file can
    serve both sides."""

    now: float
    snapshot: Any = None          # FleetSnapshot | None
    store: Any = None             # TSDB | None
    local: dict[str, Any] = field(default_factory=dict)

    def local_value(self, key: str) -> Any:
        v = self.local.get(key)
        return v() if callable(v) else v


@dataclass
class Reading:
    """One rule's verdict for one labeled identity this evaluation."""

    breached: bool
    value: float = 0.0
    labels: dict[str, str] = field(default_factory=dict)
    summary: str = ""
    severity: str = ""            # overrides the rule's severity when set
    state: str | None = None      # externally-owned lifecycle (SLO rules)
    since: float | None = None


class Rule:
    """One named alerting rule. Subclasses implement :meth:`evaluate`
    returning zero or more :class:`Reading` s (one per labeled identity,
    e.g. per instance). ``series`` names the TSDB series this rule
    reads — the incident correlator embeds their recent samples in the
    bundle so the postmortem shows the data the alert fired on."""

    kind = "rule"

    def __init__(self, name: str, severity: str = "ticket",
                 for_s: float = 0.0, resolve_for_s: float = 0.0,
                 group: str | None = None, description: str = "",
                 series: tuple[str, ...] | list[str] = ()):
        self.name = name
        self.severity = severity
        self.for_s = max(0.0, float(for_s))
        self.resolve_for_s = max(0.0, float(resolve_for_s))
        self.group = group or name
        self.description = description
        self.series = tuple(series)

    def evaluate(self, ctx: EvalContext) -> list[Reading]:
        raise NotImplementedError


# -- the declarative rule registry -------------------------------------------

RULE_KINDS: dict[str, Callable[..., Rule]] = {}


def rule_kind(name: str):
    """Register a rule constructor under a spec-file ``kind`` name."""

    def deco(fn):
        RULE_KINDS[name] = fn
        fn.kind = name
        return fn

    return deco


def build_rule(spec: dict) -> Rule:
    """One ``{"kind": ..., ...params}`` spec → a Rule. Unknown kinds and
    bad params are loud errors — a rule file that silently arms nothing
    is worse than no rule file (the obs/faults.py stance)."""
    spec = dict(spec)
    kind = spec.pop("kind", None)
    if not kind or kind not in RULE_KINDS:
        raise ValueError(
            f"alert rule kind {kind!r} is not registered "
            f"(known: {sorted(RULE_KINDS)})"
        )
    rule = RULE_KINDS[kind](**spec)
    rule.kind = kind
    return rule


def load_rules(path: str) -> list[Rule]:
    """Load rules from one JSON file or an ``alerts.d`` directory of
    ``*.json`` files. Each file is ``{"rules": [spec, ...]}`` (or a bare
    list). Missing path is a loud error; an empty directory is fine."""
    paths: list[str]
    if os.path.isdir(path):
        paths = sorted(
            os.path.join(path, n) for n in os.listdir(path)
            if n.endswith(".json")
        )
    elif os.path.isfile(path):
        paths = [path]
    else:
        raise FileNotFoundError(f"alert rule path {path!r} does not exist")
    rules: list[Rule] = []
    for p in paths:
        with open(p, encoding="utf-8") as f:
            doc = json.load(f)
        specs = doc.get("rules", []) if isinstance(doc, dict) else doc
        for spec in specs:
            rules.append(build_rule(spec))
    return rules


# -- SLO burn (the migrated obs/slo.py alerts) --------------------------------


@rule_kind("slo_burn")
class SLOBurnRule(Rule):
    """Wraps one :class:`~tpu_kubernetes_torch.obs.slo.SLOTracker`: the
    tracker keeps owning the burn-window state machine (including its
    own pending/resolve hold-downs), and this rule surfaces its state
    into the manager — fingerprints, dedup, silences, notifications,
    events, and incident correlation come for free."""

    def __init__(self, tracker, **kw):
        from tpu_kubernetes_torch.obs.slo import GOOD_SERIES, TOTAL_SERIES

        kw.setdefault("series", (GOOD_SERIES, TOTAL_SERIES))
        kw.setdefault("group", "slo")
        kw.setdefault("description", tracker.description)
        super().__init__(name=f"slo-{tracker.name}", **kw)
        self.tracker = tracker

    def evaluate(self, ctx: EvalContext) -> list[Reading]:
        alert = self.tracker.evaluate(now=ctx.now)
        return [Reading(
            breached=alert.state != OK,
            value=max(alert.burn_fast, alert.burn_slow),
            summary=(
                f"burn fast={alert.burn_fast:.1f}x slow="
                f"{alert.burn_slow:.1f}x (target {self.tracker.target:g})"
            ),
            severity=alert.severity or self.severity,
            state=alert.state,
            since=alert.since,
        )]


# -- invariant tripwires ------------------------------------------------------


class InvariantRule(Rule):
    """A condition that must never be true, checked by a callable
    ``check(ctx) -> Reading | list[Reading] | None``."""

    kind = "invariant"

    def __init__(self, name: str, check: Callable[[EvalContext], Any],
                 **kw):
        kw.setdefault("severity", "page")
        super().__init__(name=name, **kw)
        self._check = check

    def evaluate(self, ctx: EvalContext) -> list[Reading]:
        out = self._check(ctx)
        if out is None:
            return []
        return out if isinstance(out, list) else [out]


@rule_kind("page_partition")
def page_partition_rule(name: str = "page-partition-leak", **kw) -> Rule:
    """``free + live + pinned == total`` must hold for the KV page pool
    — a drift IS a page leak (serve/pages.py recomputes the partition
    from ground truth exactly so this check is meaningful). Engine-local
    evaluation reads ``local["pages"]``; fleet-side evaluation is a
    no-op (the gauge's free/live/pinned samples are scraped at different
    instants, so a cross-scrape sum would false-positive)."""
    kw.setdefault("series", ("tpu_serve_kv_pages",))
    kw.setdefault("description",
                  "KV page-pool partition free+live+pinned == total")

    def check(ctx: EvalContext):
        pages = ctx.local_value("pages")
        if not pages:
            return None
        parts = sum(
            pages.get(k, 0) for k in ("free", "live", "pinned")
        )
        total = pages.get("total", 0)
        return Reading(
            breached=parts != total,
            value=float(parts - total),
            summary=(
                f"free={pages.get('free')}+live={pages.get('live')}"
                f"+pinned={pages.get('pinned')} != total={total}"
            ),
        )

    return InvariantRule(name, check, **kw)


@rule_kind("ledger_conservation")
def ledger_conservation_rule(name: str = "ledger-conservation",
                             **kw) -> Rule:
    """The token ledger must settle: ``sum(classes) == emitted`` at
    quiescence. Tokens are legitimately unsettled while requests are in
    flight, which is exactly what the ``for_s`` pending hold absorbs —
    only a SUSTAINED imbalance fires. Reads ``local["ledger"]`` (the
    LEDGER singleton or anything with ``snapshot()``)."""
    kw.setdefault("for_s", 30.0)
    kw.setdefault("series", ("tpu_serve_tokens_emitted_total",
                             "tpu_serve_tokens_total"))
    kw.setdefault("description",
                  "token-ledger conservation sum(classes) == emitted")

    def check(ctx: EvalContext):
        ledger = ctx.local_value("ledger")
        if ledger is None:
            return None
        snap = ledger.snapshot() if hasattr(ledger, "snapshot") else ledger
        emitted = snap.get("emitted", 0)
        settled = sum(snap.get("classes", {}).values())
        unsettled = emitted - settled
        return Reading(
            breached=unsettled != 0,
            value=float(unsettled),
            summary=(
                f"emitted={emitted} settled={settled} "
                f"unsettled={unsettled}"
            ),
        )

    return InvariantRule(name, check, **kw)


@rule_kind("target_down")
def target_down_rule(name: str = "scrape-target-down", **kw) -> Rule:
    """A fleet scrape target with ``up == 0`` — one reading per dead
    instance, so two dead workers are two fingerprints (and one
    recovering doesn't resolve the other)."""
    kw.setdefault("severity", "page")
    kw.setdefault("series", ("up",))
    kw.setdefault("description", "scrape target down (up == 0)")

    def check(ctx: EvalContext):
        if ctx.snapshot is None:
            return None
        out = []
        for instance, h in sorted(ctx.snapshot.health.items()):
            out.append(Reading(
                breached=h.up == 0,
                value=float(h.consecutive_failures),
                labels={"instance": instance},
                summary=(
                    f"{h.consecutive_failures} consecutive scrape "
                    f"failures: {h.last_error}" if h.up == 0 else "up"
                ),
            ))
        return out

    return InvariantRule(name, check, **kw)


class CounterDeltaRule(Rule):
    """Fires when a cumulative counter increases by more than
    ``threshold`` between evaluations — the tripwire shape for "this
    number must never move" counters (engine restarts, injected
    faults, 5xx responses). ``value_fn(ctx)`` returns the current
    cumulative reading (float, or ``{label_key: float}`` for per-label
    identities, or None to skip). Reset-aware: a shrinking counter
    (process restart) re-baselines instead of alerting on the wrap."""

    kind = "counter_delta"

    def __init__(self, name: str,
                 value_fn: Callable[[EvalContext], Any],
                 threshold: float = 0.0, label: str = "", **kw):
        super().__init__(name=name, **kw)
        self._value_fn = value_fn
        self.threshold = float(threshold)
        self._label = label
        self._prev: dict[str, float] = {}

    def evaluate(self, ctx: EvalContext) -> list[Reading]:
        current = self._value_fn(ctx)
        if current is None:
            return []
        if not isinstance(current, dict):
            current = {"": float(current)}
        out = []
        for key, value in sorted(current.items()):
            prev = self._prev.get(key)
            self._prev[key] = value
            if prev is None:         # first sight: baseline, never alert
                continue
            delta = value - prev
            if delta < 0:            # counter reset — re-baseline
                delta = 0.0
            labels = {self._label: key} if self._label and key else {}
            out.append(Reading(
                breached=delta > self.threshold,
                value=delta,
                labels=labels,
                summary=f"+{delta:g} since last evaluation "
                        f"(cumulative {value:g})",
            ))
        return out


def _snapshot_sum(series: str, pred=None):
    """A per-instance counter reader over the fleet snapshot."""

    def value_fn(ctx: EvalContext):
        if ctx.snapshot is None:
            return None
        out = {}
        for instance in ctx.snapshot.instances():
            out[instance] = ctx.snapshot.value_sum(
                series,
                lambda labels, i=instance: (
                    labels.get("instance") == i
                    and (pred is None or pred(labels))
                ),
            )
        return out

    return value_fn


@rule_kind("counter_delta")
def counter_delta_rule(name: str, series: str, threshold: float = 0.0,
                       **kw) -> Rule:
    """Spec-file face of :class:`CounterDeltaRule`: per-instance deltas
    of one fleet-scraped counter family."""
    kw.setdefault("series", (series,))
    kw.setdefault("description", f"increase of {series}")
    return CounterDeltaRule(
        name, _snapshot_sum(series), threshold=threshold,
        label="instance", **kw,
    )


@rule_kind("engine_restart")
def engine_restart_rule(name: str = "engine-restarts", **kw) -> Rule:
    """The engine-restart counter moved — locally from
    ``local["restarts"]`` when present, else the scraped family."""
    kw.setdefault("severity", "page")
    kw.setdefault("series", ("tpu_serve_engine_restarts_total",))
    kw.setdefault("description", "slot-engine watchdog restart")
    fleet = _snapshot_sum("tpu_serve_engine_restarts_total")

    def value_fn(ctx: EvalContext):
        local = ctx.local_value("restarts")
        if local is not None:
            return float(local)
        return fleet(ctx)

    return CounterDeltaRule(name, value_fn, label="instance", **kw)


@rule_kind("fault_injection")
def fault_injection_rule(name: str = "fault-injected", **kw) -> Rule:
    """Any injected-fault counter increase: nonzero outside a chaos run
    means ``TPU_K8S_FAULTS`` leaked into prod (the obs/faults.py
    warning, promoted to a tripwire). In a chaos run this is the
    universal canary — every armed site that fires trips it."""
    kw.setdefault("severity", "warn")
    kw.setdefault("series", ("tpu_k8s_faults_injected_total",))
    kw.setdefault("description", "faults injected (TPU_K8S_FAULTS armed)")
    fleet = _snapshot_sum("tpu_k8s_faults_injected_total")

    def value_fn(ctx: EvalContext):
        local = ctx.local_value("faults_total")
        if local is not None:
            return float(local)
        return fleet(ctx)

    return CounterDeltaRule(name, value_fn, label="instance", **kw)


# -- anomaly detectors --------------------------------------------------------


@rule_kind("counter_stall")
class CounterStallRule(Rule):
    """Tokens-emitted flat while work is in flight: the engine is wedged
    (a hung device call, a dead scheduler) even though every gauge looks
    "busy". Breached when the emitted counter's delta is 0 while the
    inflight reading is > 0 — sustained for ``for_s`` before firing, so
    a long prefill between segments doesn't page."""

    def __init__(self, name: str = "token-counter-stall",
                 counter: str = "tpu_serve_tokens_emitted_total",
                 inflight: str = "tpu_serve_inflight_requests", **kw):
        kw.setdefault("for_s", 30.0)
        kw.setdefault("severity", "page")
        kw.setdefault("series", (counter, inflight))
        kw.setdefault("description",
                      f"{counter} flat while {inflight} > 0")
        super().__init__(name=name, **kw)
        self.counter = counter
        self.inflight = inflight
        self._prev: dict[str, float] = {}

    def _pairs(self, ctx: EvalContext):
        emitted = ctx.local_value("emitted")
        inflight = ctx.local_value("inflight")
        if emitted is not None and inflight is not None:
            yield "", float(emitted), float(inflight)
            return
        if ctx.snapshot is None:
            return
        for instance in ctx.snapshot.instances():
            mine = (lambda i: lambda labels:
                    labels.get("instance") == i)(instance)
            yield (instance,
                   ctx.snapshot.value_sum(self.counter, mine),
                   ctx.snapshot.value_sum(self.inflight, mine))

    def evaluate(self, ctx: EvalContext) -> list[Reading]:
        out = []
        for key, emitted, inflight in self._pairs(ctx):
            prev = self._prev.get(key)
            self._prev[key] = emitted
            if prev is None:
                continue
            delta = emitted - prev
            out.append(Reading(
                breached=delta <= 0 and inflight > 0,
                value=inflight,
                labels={"instance": key} if key else {},
                summary=(
                    f"emitted +{max(0.0, delta):g} with "
                    f"{inflight:g} in flight"
                ),
            ))
        return out


@rule_kind("queue_runaway")
class QueueRunawayRule(Rule):
    """Queue depth at or beyond ``max_depth`` — sustained (``for_s``)
    so an admission burst that drains doesn't page. Engine-local
    evaluation reads ``local["queued"]``; fleet-side the inflight
    gauge per instance."""

    def __init__(self, name: str = "queue-runaway",
                 series: str = "tpu_serve_inflight_requests",
                 max_depth: float = 64.0, **kw):
        kw.setdefault("for_s", 30.0)
        kw.setdefault("series", (series,))
        kw.setdefault("description",
                      f"{series} >= {max_depth:g} sustained")
        super().__init__(name=name, **kw)
        self.gauge = series
        self.max_depth = float(max_depth)

    def evaluate(self, ctx: EvalContext) -> list[Reading]:
        local = ctx.local_value("queued")
        if local is not None:
            depth = float(local)
            return [Reading(
                breached=depth >= self.max_depth, value=depth,
                summary=f"queue depth {depth:g} >= {self.max_depth:g}",
            )]
        if ctx.snapshot is None:
            return []
        out = []
        for instance in ctx.snapshot.instances():
            mine = (lambda i: lambda labels:
                    labels.get("instance") == i)(instance)
            depth = ctx.snapshot.value_sum(self.gauge, mine)
            out.append(Reading(
                breached=depth >= self.max_depth, value=depth,
                labels={"instance": instance},
                summary=f"queue depth {depth:g} >= {self.max_depth:g}",
            ))
        return out


@rule_kind("latency_drift")
class EWMADriftRule(Rule):
    """EWMA/z-score drift detection on a latency quantile: keeps an
    exponentially-weighted mean and variance per instance and fires
    when the current reading sits more than ``z`` standard deviations
    above the learned mean (one-sided — getting faster is not an
    incident). Needs ``min_samples`` readings before it can alert, so a
    cold start never pages on its own warm-up."""

    def __init__(self, name: str = "latency-drift",
                 histogram: str = "tpu_serve_request_seconds",
                 q: float = 0.99, alpha: float = 0.3, z: float = 4.0,
                 min_samples: int = 8, min_sigma_s: float = 1e-3, **kw):
        kw.setdefault("series", (histogram,))
        kw.setdefault("description",
                      f"p{int(q * 100)} {histogram} z-score > {z:g}")
        super().__init__(name=name, **kw)
        self.histogram = histogram
        self.q = q
        self.alpha = float(alpha)
        self.z = float(z)
        self.min_samples = int(min_samples)
        self.min_sigma_s = float(min_sigma_s)
        # per-key (mean, variance, count)
        self._ewma: dict[str, tuple[float, float, int]] = {}

    def _readings(self, ctx: EvalContext):
        local = ctx.local_value("latency_q")
        if local is not None:
            yield "", float(local)
            return
        if ctx.snapshot is None:
            return
        for instance in ctx.snapshot.instances():
            mine = (lambda i: lambda labels:
                    labels.get("instance") == i)(instance)
            v = ctx.snapshot.quantile(self.histogram, self.q, mine)
            if v is not None:
                yield instance, float(v)

    def evaluate(self, ctx: EvalContext) -> list[Reading]:
        out = []
        for key, v in self._readings(ctx):
            mean, var, n = self._ewma.get(key, (v, 0.0, 0))
            sigma = max(math.sqrt(max(0.0, var)), self.min_sigma_s)
            score = (v - mean) / sigma
            breached = n >= self.min_samples and score > self.z
            if not breached:
                # the baseline only learns non-anomalous readings — an
                # outage must not teach the detector that slow is normal
                d = v - mean
                mean += self.alpha * d
                var = (1 - self.alpha) * (var + self.alpha * d * d)
                n += 1
            self._ewma[key] = (mean, var, n)
            out.append(Reading(
                breached=breached, value=round(score, 3),
                labels={"instance": key} if key else {},
                summary=(
                    f"p{int(self.q * 100)}={v:.3f}s z={score:.1f} "
                    f"(mean {mean:.3f}s ± {sigma:.3f}s over {n})"
                ),
            ))
        return out


@rule_kind("gauge_threshold")
class GaugeThresholdRule(Rule):
    """A plain threshold on one gauge/counter family: breached when the
    per-instance sum compares true against ``threshold`` under ``op``
    (``>=``, ``>``, ``<=``, ``<``)."""

    _OPS = {">=": lambda a, b: a >= b, ">": lambda a, b: a > b,
            "<=": lambda a, b: a <= b, "<": lambda a, b: a < b}

    def __init__(self, name: str, series: str, threshold: float,
                 op: str = ">=", **kw):
        if op not in self._OPS:
            raise ValueError(f"gauge_threshold op {op!r} not in "
                             f"{sorted(self._OPS)}")
        kw.setdefault("series", (series,))
        kw.setdefault("description", f"{series} {op} {threshold:g}")
        super().__init__(name=name, **kw)
        self.series_name = series
        self.threshold = float(threshold)
        self.op = op

    def evaluate(self, ctx: EvalContext) -> list[Reading]:
        cmp = self._OPS[self.op]
        local = ctx.local_value(self.series_name)
        if local is not None:
            v = float(local)
            return [Reading(
                breached=cmp(v, self.threshold), value=v,
                summary=f"{self.series_name}={v:g} {self.op} "
                        f"{self.threshold:g}",
            )]
        if ctx.snapshot is None:
            return []
        out = []
        for instance in ctx.snapshot.instances():
            mine = (lambda i: lambda labels:
                    labels.get("instance") == i)(instance)
            v = ctx.snapshot.value_sum(self.series_name, mine)
            out.append(Reading(
                breached=cmp(v, self.threshold), value=v,
                labels={"instance": instance},
                summary=f"{self.series_name}={v:g} {self.op} "
                        f"{self.threshold:g}",
            ))
        return out


@rule_kind("quantile_threshold")
class QuantileThresholdRule(Rule):
    """Breached when a histogram quantile exceeds ``threshold_s`` —
    the fixed-bar sibling of the adaptive :class:`EWMADriftRule`."""

    def __init__(self, name: str, histogram: str, threshold_s: float,
                 q: float = 0.99, **kw):
        kw.setdefault("series", (histogram,))
        kw.setdefault("description",
                      f"p{int(q * 100)} {histogram} > {threshold_s:g}s")
        super().__init__(name=name, **kw)
        self.histogram = histogram
        self.q = q
        self.threshold_s = float(threshold_s)

    def evaluate(self, ctx: EvalContext) -> list[Reading]:
        if ctx.snapshot is None:
            return []
        out = []
        for instance in ctx.snapshot.instances():
            mine = (lambda i: lambda labels:
                    labels.get("instance") == i)(instance)
            v = ctx.snapshot.quantile(self.histogram, self.q, mine)
            if v is None:
                continue
            out.append(Reading(
                breached=v > self.threshold_s, value=round(v, 6),
                labels={"instance": instance},
                summary=f"p{int(self.q * 100)}={v:.3f}s > "
                        f"{self.threshold_s:g}s",
            ))
        return out


# -- notification sinks -------------------------------------------------------


class JSONLSink:
    """Append one JSON line per notification batch — the machine-
    consumable alert log (``TPU_K8S_ALERTS_FILE``)."""

    name = "jsonl"

    def __init__(self, path: str):
        self.path = path

    def send(self, batch: dict) -> None:
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(self.path, "a", encoding="utf-8") as f:
            f.write(json.dumps(batch, sort_keys=True, default=str) + "\n")


class WebhookSink:
    """POST each batch as JSON to one URL (``TPU_K8S_ALERT_WEBHOOK``)
    with bounded retry/backoff: at most ``retries + 1`` attempts,
    sleeping ``backoff_s * 2^i`` between them, then the error
    propagates to the notifier (which counts it and moves on). The
    worst case is strictly bounded — a dead endpoint costs
    ``(retries+1) * timeout_s + sum(backoffs)`` on the NOTIFIER thread,
    never on the loop that evaluated the alert."""

    name = "webhook"

    def __init__(self, url: str, timeout_s: float = 2.0,
                 retries: int = 2, backoff_s: float = 0.1):
        self.url = url
        self.timeout_s = float(timeout_s)
        self.retries = max(0, int(retries))
        self.backoff_s = max(0.0, float(backoff_s))

    def send(self, batch: dict) -> None:
        body = json.dumps(batch, sort_keys=True, default=str).encode()
        last: Exception | None = None
        for attempt in range(self.retries + 1):
            if attempt and self.backoff_s:
                time.sleep(self.backoff_s * 2.0 ** (attempt - 1))
            try:
                req = urllib.request.Request(
                    self.url, data=body,
                    headers={"Content-Type": "application/json",
                             "User-Agent": "tpu-k8s-alerts"},
                    method="POST",
                )
                with urllib.request.urlopen(
                    req, timeout=self.timeout_s
                ) as resp:
                    resp.read()
                return
            except Exception as e:  # noqa: BLE001 — bounded retry
                last = e
        raise last if last is not None else RuntimeError("unreachable")


def sinks_from_env(env: dict | None = None) -> list:
    """The sinks one process's env asks for: ``TPU_K8S_ALERTS_FILE``
    (JSONL) and/or ``TPU_K8S_ALERT_WEBHOOK`` (HTTP POST)."""
    env = os.environ if env is None else env
    sinks: list = []
    path = env.get("TPU_K8S_ALERTS_FILE", "")
    if path:
        sinks.append(JSONLSink(path))
    url = env.get("TPU_K8S_ALERT_WEBHOOK", "")
    if url:
        from tpu_kubernetes_torch.util.envparse import env_float, env_int

        sinks.append(WebhookSink(
            url,
            timeout_s=env_float("TPU_K8S_ALERT_WEBHOOK_TIMEOUT_S", 2.0,
                                env=env),
            retries=env_int("TPU_K8S_ALERT_WEBHOOK_RETRIES", 2,
                            env=env),
        ))
    return sinks


class _Notifier:
    """The delivery thread: a bounded queue the manager pushes batches
    into and a daemon that drains it through every sink. Evaluation
    loops (fleet scrape cycle, engine scheduler) only ever pay one
    deque append — a dead webhook endpoint backs up THIS thread, and
    when the queue overflows the oldest batches drop (counted as
    ``status="dropped"``) rather than blocking anyone."""

    MAX_QUEUE = 256

    def __init__(self, sinks: list):
        self.sinks = list(sinks)
        self._queue: deque[dict] = deque()
        self._cond = threading.Condition()
        self._inflight = 0
        self._closed = False
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="alert-notifier"
        )
        self._thread.start()

    def submit(self, batch: dict) -> None:
        with self._cond:
            if self._closed:
                return
            if len(self._queue) >= self.MAX_QUEUE:
                self._queue.popleft()
                for sink in self.sinks:
                    NOTIFICATIONS_TOTAL.labels(sink.name, "dropped").inc()
            self._queue.append(batch)
            self._cond.notify()

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._closed:
                    self._cond.wait()
                if self._closed and not self._queue:
                    return
                batch = self._queue.popleft()
                self._inflight += 1
            try:
                self._deliver(batch)
            finally:
                with self._cond:
                    self._inflight -= 1
                    self._cond.notify_all()

    def _deliver(self, batch: dict) -> None:
        for sink in self.sinks:
            try:
                FAULTS.fire("obs.alert_sink")
                sink.send(batch)
            except Exception:  # noqa: BLE001 — a sink must not kill others
                NOTIFICATIONS_TOTAL.labels(sink.name, "error").inc()
            else:
                NOTIFICATIONS_TOTAL.labels(sink.name, "ok").inc()

    def drain(self, timeout_s: float = 5.0) -> bool:
        """Block until every submitted batch has been attempted (tests;
        nothing on the serving path calls this)."""
        deadline = time.monotonic() + timeout_s
        with self._cond:
            while self._queue or self._inflight:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cond.wait(timeout=left)
        return True

    def close(self, timeout_s: float = 2.0) -> None:
        self.drain(timeout_s)
        with self._cond:
            self._closed = True
            self._cond.notify_all()


# -- silences ----------------------------------------------------------------


@dataclass
class Silence:
    """Suppress notifications for alerts matching every matcher
    (``rule`` matches the rule name; anything else matches a label).
    The alert still tracks state — a silenced page is a known problem,
    not an invisible one."""

    matchers: dict[str, str]
    until: float | None = None
    comment: str = ""

    def active(self, now: float) -> bool:
        return self.until is None or now < self.until

    def matches(self, rule: str, labels: dict[str, str]) -> bool:
        for k, v in self.matchers.items():
            have = rule if k == "rule" else labels.get(k)
            if have != v:
                return False
        return True

    def to_dict(self) -> dict:
        return {"matchers": dict(self.matchers), "until": self.until,
                "comment": self.comment}


@dataclass
class _Tracked:
    """The manager's per-fingerprint lifecycle record."""

    rule: Rule
    labels: dict[str, str]
    state: str = OK
    severity: str = ""
    since: float | None = None          # current pending/firing began
    firing_since: float | None = None
    clear_since: float | None = None    # resolve hold-down anchor
    resolved_at: float | None = None
    value: float = 0.0
    summary: str = ""
    silenced: bool = False
    seen: bool = False                  # reported by its rule this cycle


class AlertManager:
    """The rule registry + lifecycle + dedup + notification fan-out.

    Thread-safe: one evaluation runs at a time under the manager lock
    (the engine scheduler ticks while an HTTP handler snapshots).
    ``evaluate`` never raises and never blocks on sink I/O — a broken
    rule is skipped, deliveries happen on the notifier thread."""

    def __init__(self, rules: list[Rule], sinks: list | None = None,
                 group_interval_s: float = 60.0,
                 resolved_retention_s: float = RESOLVED_RETENTION_S,
                 incidents=None):
        self.rules = list(rules)
        self.group_interval_s = max(0.0, float(group_interval_s))
        self.resolved_retention_s = float(resolved_retention_s)
        # the incident correlator (obs/incidents.py) observes every
        # evaluation's alert list — temporally overlapping firing
        # alerts become one incident bundle
        self.incidents = incidents
        # subscribers beyond the correlator: anything with an
        # ``observe(alerts, now=, snapshot=)`` method (duck-typed — the
        # FleetController in obs/controller.py registers here) sees the
        # same alert list the correlator does, after it, so an acting
        # listener reads the incident the correlator just opened
        self.listeners: list = []
        self._silences: list[Silence] = []
        self._tracked: dict[str, _Tracked] = {}
        self._lock = threading.Lock()
        self._notifier = _Notifier(sinks) if sinks else None
        # per-group notification pacing: pending transition queue + the
        # last flush time (one POST per fingerprint per group interval)
        self._pending_notify: dict[str, dict[str, dict]] = {}
        self._last_flush: dict[str, float] = {}

    # -- silences ----------------------------------------------------------

    def silence(self, matchers: dict[str, str], until: float | None = None,
                comment: str = "") -> Silence:
        s = Silence(dict(matchers), until, comment)
        with self._lock:
            self._silences.append(s)
        return s

    def _silenced(self, rule: str, labels: dict[str, str],
                  now: float) -> bool:
        return any(
            s.active(now) and s.matches(rule, labels)
            for s in self._silences
        )

    # -- evaluation --------------------------------------------------------

    def evaluate(self, ctx: EvalContext | None = None, *,
                 now: float | None = None, snapshot=None, store=None,
                 local: dict | None = None) -> list[dict]:
        """One evaluation cycle: run every rule, advance every
        fingerprint's state machine, emit transition events, update the
        firing gauge, queue grouped notifications, and feed the
        incident correlator. Returns the current alert list (active +
        recently resolved)."""
        if ctx is None:
            ctx = EvalContext(
                now=time.time() if now is None else now,
                snapshot=snapshot, store=store, local=local or {},
            )
        with self._lock:
            transitions = self._advance(ctx)
            alerts = [self._to_dict(t, ctx.now)
                      for t in self._tracked.values()]
            self._set_gauge()
            self._queue_notifications(transitions, ctx.now)
            self._flush_groups(ctx.now)
        for fp, old, new, alert in transitions:
            from tpu_kubernetes_torch.obs import events

            events.emit("alert_transition", fingerprint=fp,
                        rule=alert["rule"], labels=alert["labels"],
                        severity=alert["severity"], from_state=old,
                        to_state=new, value=alert["value"],
                        summary=alert["summary"])
        if self.incidents is not None:
            try:
                self.incidents.observe(alerts, now=ctx.now)
            except Exception:  # noqa: BLE001 — correlation must not
                pass           # fail the evaluation loop
        for listener in list(self.listeners):
            try:
                listener.observe(alerts, now=ctx.now,
                                 snapshot=ctx.snapshot)
            except Exception:  # noqa: BLE001 — a listener must not
                pass           # fail the evaluation loop
        return alerts

    def _advance(self, ctx: EvalContext):
        """Run the rules and move every fingerprint one step; returns
        ``(fingerprint, old_state, new_state, alert_dict)`` for each
        transition. Lock held by the caller."""
        now = ctx.now
        reported: set[str] = set()
        transitions = []
        for rule in self.rules:
            try:
                readings = rule.evaluate(ctx)
            except Exception:  # noqa: BLE001 — one broken rule must not
                continue       # take down the evaluation cycle
            for r in readings:
                fp = fingerprint(rule.name, r.labels)
                reported.add(fp)
                t = self._tracked.get(fp)
                if t is None:
                    if not r.breached:
                        continue
                    t = self._tracked[fp] = _Tracked(
                        rule=rule, labels=dict(r.labels)
                    )
                t.value = r.value
                if r.summary:
                    t.summary = r.summary
                t.severity = r.severity or rule.severity
                t.silenced = self._silenced(rule.name, t.labels, now)
                old = t.state
                if r.state is not None:
                    self._step_external(t, r, now)
                else:
                    self._step(t, r.breached, now)
                if t.state != old:
                    transitions.append(
                        (fp, old, t.state, self._to_dict(t, now))
                    )
                if t.state == OK:   # a pending blip that cleared: forget
                    self._tracked.pop(fp, None)
        # a tracked fingerprint its rule stopped reporting is clean
        # (e.g. a per-instance reading whose instance left the fleet)
        for fp, t in list(self._tracked.items()):
            if fp in reported:
                continue
            old = t.state
            self._step(t, False, now)
            if t.state != old:
                transitions.append((fp, old, t.state, self._to_dict(t, now)))
            if t.state == OK:
                del self._tracked[fp]
        # retention: resolved alerts age out of the listing
        for fp, t in list(self._tracked.items()):
            if (t.state == RESOLVED and t.resolved_at is not None
                    and now - t.resolved_at >= self.resolved_retention_s):
                del self._tracked[fp]
        return transitions

    def _step(self, t: _Tracked, breached: bool, now: float) -> None:
        """The manager-owned state machine, hold-downs both ways."""
        if breached:
            t.clear_since = None
            if t.state in (OK, RESOLVED):
                t.since = now
                t.state = PENDING
                t.resolved_at = None
            since = now if t.since is None else t.since
            if t.state == PENDING and now - since >= t.rule.for_s:
                t.state = FIRING
                t.firing_since = t.firing_since or now
        else:
            if t.state == PENDING:
                t.state = OK
                t.since = None
            elif t.state == FIRING:
                if t.rule.resolve_for_s > 0:
                    if t.clear_since is None:
                        t.clear_since = now
                    if now - t.clear_since < t.rule.resolve_for_s:
                        return
                t.state = RESOLVED
                t.resolved_at = now
                t.clear_since = None

    def _step_external(self, t: _Tracked, r: Reading, now: float) -> None:
        """Mirror an externally-owned lifecycle (the SLO tracker's) —
        the manager only translates its terminal clean state into
        ``resolved`` so receivers see the close."""
        if r.state in (PENDING, FIRING):
            t.state = r.state
            if r.since is not None:
                t.since = r.since
            elif t.since is None:
                t.since = now
            if r.state == FIRING:
                t.firing_since = t.firing_since or now
            t.resolved_at = None
        else:  # ok
            if t.state == FIRING:
                t.state = RESOLVED
                t.resolved_at = now
            elif t.state in (PENDING, OK):
                t.state = OK
                t.since = None

    # -- notifications -----------------------------------------------------

    def _queue_notifications(self, transitions, now: float) -> None:
        for fp, _old, new, alert in transitions:
            if new not in (FIRING, RESOLVED):
                continue
            if alert["silenced"]:
                continue
            group = alert["group"]
            self._pending_notify.setdefault(group, {})[fp] = alert

    def _flush_groups(self, now: float) -> None:
        if self._notifier is None:
            self._pending_notify.clear()
            return
        for group, pending in list(self._pending_notify.items()):
            if not pending:
                continue
            last = self._last_flush.get(group)
            if last is not None and now - last < self.group_interval_s:
                continue
            firing = [
                self._to_dict(t, now) for t in self._tracked.values()
                if t.state == FIRING and t.rule.group == group
                and not t.silenced
            ]
            batch = {
                "schema": SCHEMA,
                "ts": round(now, 3),
                "group": group,
                "alerts": list(pending.values()),
                "firing": firing,
            }
            self._last_flush[group] = now
            self._pending_notify[group] = {}
            self._notifier.submit(batch)

    def _set_gauge(self) -> None:
        counts: dict[str, int] = {}
        for t in self._tracked.values():
            if t.state == FIRING:
                sev = t.severity or "none"
                counts[sev] = counts.get(sev, 0) + 1
        for sev in ("page", "ticket", "warn"):
            counts.setdefault(sev, 0)
        for sev, n in counts.items():
            ALERTS_FIRING.labels(sev).set(float(n))

    # -- read faces --------------------------------------------------------

    def _to_dict(self, t: _Tracked, now: float) -> dict:
        return {
            "fingerprint": fingerprint(t.rule.name, t.labels),
            "rule": t.rule.name,
            "kind": t.rule.kind,
            "group": t.rule.group,
            "labels": dict(t.labels),
            "severity": t.severity,
            "state": t.state,
            "since": t.since,
            "age_s": (None if t.since is None
                      else round(max(0.0, now - t.since), 3)),
            "firing_since": t.firing_since,
            "resolved_at": t.resolved_at,
            "value": t.value,
            "summary": t.summary,
            "description": t.rule.description,
            "series": list(t.rule.series),
            "silenced": t.silenced,
        }

    def active(self, now: float | None = None) -> list[dict]:
        """Current tracked alerts (pending/firing + recently resolved),
        most severe states first."""
        now = time.time() if now is None else now
        order = {FIRING: 0, PENDING: 1, RESOLVED: 2}
        with self._lock:
            alerts = [self._to_dict(t, now) for t in self._tracked.values()]
        return sorted(alerts, key=lambda a: (order.get(a["state"], 3),
                                             a["rule"]))

    def summary(self, now: float | None = None) -> dict:
        """The one-glance healthz mirror: counts by state/severity."""
        alerts = self.active(now)
        by_sev: dict[str, int] = {}
        for a in alerts:
            if a["state"] == FIRING:
                by_sev[a["severity"] or "none"] = (
                    by_sev.get(a["severity"] or "none", 0) + 1
                )
        return {
            "firing": sum(a["state"] == FIRING for a in alerts),
            "pending": sum(a["state"] == PENDING for a in alerts),
            "by_severity": by_sev,
        }

    def snapshot(self, now: float | None = None) -> dict:
        """The full ``GET /debug/alerts`` payload."""
        now = time.time() if now is None else now
        with self._lock:
            silences = [s.to_dict() for s in self._silences
                        if s.active(now)]
            rules = [
                {"name": r.name, "kind": r.kind, "severity": r.severity,
                 "for_s": r.for_s, "resolve_for_s": r.resolve_for_s,
                 "group": r.group, "description": r.description}
                for r in self.rules
            ]
        return {
            "schema": SCHEMA,
            "ts": round(now, 3),
            "alerts": self.active(now),
            "summary": self.summary(now),
            "silences": silences,
            "rules": rules,
        }

    def close(self) -> None:
        if self._notifier is not None:
            self._notifier.close()

    # test/ops hook: block until queued notifications were attempted
    def drain_notifications(self, timeout_s: float = 5.0) -> bool:
        if self._notifier is None:
            return True
        return self._notifier.drain(timeout_s)


# -- standard rule sets -------------------------------------------------------


def _registry_counter_sum(registry, name: str, pred=None) -> float:
    """Sum one counter family's samples straight from a process-local
    registry snapshot (no exposition round-trip)."""
    fam = registry.snapshot(prefix=name).get(name)
    if not fam:
        return 0.0
    return sum(
        s["value"] for s in fam["samples"]
        if pred is None or pred(s["labels"])
    )


def engine_tripwires(*, stats_fn: Callable[[], dict | None],
                     ledger=None, registry=None,
                     for_s: float = 5.0, resolve_for_s: float = 10.0,
                     queue_max_depth: float = 64.0) -> list[Rule]:
    """The engine-local tripwire set the serve scheduler evaluates
    between segments: page-partition, ledger conservation, restart and
    5xx counter deltas, fault injection, counter-stall, and queue
    runaway — all reading THIS process (``stats_fn`` is the engine's
    ``stats()``), no scrape hop involved."""
    registry = REGISTRY if registry is None else registry

    def stat(key):
        def get():
            s = stats_fn()
            return None if s is None else s.get(key)
        return get

    def pages():
        s = stats_fn()
        return None if s is None else s.get("pages")

    def emitted():
        if ledger is None:
            return None
        return ledger.snapshot().get("emitted", 0)

    def inflight():
        s = stats_fn()
        if s is None:
            return None
        return (s.get("occupied") or 0) + (s.get("queued") or 0)

    def errors_5xx():
        return _registry_counter_sum(
            registry, "tpu_serve_requests_total",
            lambda labels: labels.get("code", "").startswith("5"),
        )

    def faults_total():
        return _registry_counter_sum(
            registry, "tpu_k8s_faults_injected_total"
        )

    hold = {"for_s": for_s, "resolve_for_s": resolve_for_s}
    rules = [
        page_partition_rule(resolve_for_s=resolve_for_s),
        ledger_conservation_rule(**hold),
        engine_restart_rule(resolve_for_s=resolve_for_s),
        CounterDeltaRule(
            "error-burst", lambda ctx: errors_5xx(),
            severity="ticket", resolve_for_s=resolve_for_s,
            series=("tpu_serve_requests_total",),
            description="5xx responses served",
        ),
        fault_injection_rule(resolve_for_s=resolve_for_s),
        CounterStallRule(**hold),
        QueueRunawayRule(max_depth=queue_max_depth, **hold),
    ]
    local = {
        "pages": pages, "ledger": ledger, "restarts": stat("restarts"),
        "faults_total": faults_total, "emitted": emitted,
        "inflight": inflight, "queued": stat("queued"),
    }
    # the rules close over nothing process-global; the caller passes
    # this dict as EvalContext.local on every tick
    for r in rules:
        r.local_defaults = local  # type: ignore[attr-defined]
    return rules


def engine_local_context(rules: list[Rule], now: float,
                         store=None) -> EvalContext:
    """Build the engine-local EvalContext from the ``local_defaults``
    the :func:`engine_tripwires` factory attached to its rules."""
    local: dict[str, Any] = {}
    for r in rules:
        local.update(getattr(r, "local_defaults", {}))
    return EvalContext(now=now, store=store, local=local)


def default_fleet_rules(trackers=None, *, queue_max_depth: float = 64.0,
                        ) -> list[Rule]:
    """The fleet-side default registry the monitor evaluates each
    scrape cycle: the SLO burn trackers migrated in as rules, plus
    target-down, restart-delta, latency drift, counter-stall, and
    queue-runaway over the scraped families."""
    rules: list[Rule] = [
        SLOBurnRule(t) for t in (trackers or [])
    ]
    rules += [
        target_down_rule(for_s=0.0, resolve_for_s=60.0),
        engine_restart_rule(resolve_for_s=60.0),
        EWMADriftRule(for_s=0.0, resolve_for_s=60.0, severity="ticket"),
        CounterStallRule(for_s=30.0, resolve_for_s=60.0),
        QueueRunawayRule(max_depth=queue_max_depth, for_s=30.0,
                         resolve_for_s=60.0, severity="ticket"),
    ]
    return rules


# -- the `get alerts` CLI face ------------------------------------------------


def fetch_alerts(target: str, timeout: float = 5.0) -> dict:
    """GET ``/debug/alerts`` from ``host:port`` (scheme/path optional,
    the fetch_flightrec normalization)."""
    t = target.strip()
    if "//" not in t:
        t = "http://" + t
    if not t.rstrip("/").endswith("/debug/alerts"):
        t = t.rstrip("/") + "/debug/alerts"
    with urllib.request.urlopen(t, timeout=timeout) as resp:
        return json.loads(resp.read().decode("utf-8", "replace"))


def render_alerts(payload: dict) -> str:
    """The operator summary of one ``/debug/alerts`` payload."""
    alerts = payload.get("alerts", [])
    summary = payload.get("summary", {})
    lines = [
        f"alerts — {summary.get('firing', 0)} firing, "
        f"{summary.get('pending', 0)} pending "
        f"({len(payload.get('rules', []))} rules registered)"
    ]
    for a in alerts:
        labels = ",".join(f"{k}={v}" for k, v in
                          sorted(a.get("labels", {}).items()))
        age = a.get("age_s")
        lines.append(
            f"  [{a.get('state', '?').upper():>8}]"
            f" {a.get('rule')}{'{' + labels + '}' if labels else ''}"
            f" severity={a.get('severity') or '-'}"
            f" value={a.get('value')}"
            + (f" for {age:.0f}s" if age is not None else "")
            + (" (silenced)" if a.get("silenced") else "")
            + (f" — {a['summary']}" if a.get("summary") else "")
        )
    if not alerts:
        lines.append("  (none active)")
    for s in payload.get("silences", []):
        matchers = ",".join(f"{k}={v}" for k, v in
                            sorted(s.get("matchers", {}).items()))
        lines.append(f"  silence {{{matchers}}} until={s.get('until')}"
                     + (f" — {s['comment']}" if s.get("comment") else ""))
    return "\n".join(lines) + "\n"
