"""The serve-engine flight recorder: a black box for the slot engine.

The port's copy of ``tpu_kubernetes/obs/flightrec.py`` (the port imports nothing of
the JAX package): the same names, families and behaviour.

Watchdog cold-restarts, drains, and chaos faults used to
leave only log lines behind — no capture of what the continuous-
batching engine was actually doing when it died. This module is the
black box: the engine feeds it one bounded snapshot per decode segment
(slot occupancy, live rows, page-pool partition, ledger deltas,
admission/reap/preemption counts, faults injected so far, recent span
ids), and on every way a serving process can end work — watchdog
restart, hard-fail, drain, SIGTERM — it atomically dumps a redacted
JSON postmortem under ``runs/``-style retention. One file tells the
whole story: the segment ring, the token-ledger snapshot (whose
conservation invariant a postmortem can check offline), the SLO alerts
that were pending or firing, the recent history-store samples for the
serve series, and the fault counters.

Operational stance (the obs/events.py contract): the recorder NEVER
raises — a broken disk must not take down serving, and a postmortem
writer that crashes the patient is worse than no postmortem. Dumps are
atomic (tmp + rename) and pruned newest-kept like runs/ reports
(``TPU_K8S_FLIGHTREC_KEEP``), so a crash-looping engine cannot fill a
disk with its own obituaries.

On-demand access: ``GET /debug/flightrec`` on the serve port and
``tpu-kubernetes get flightrec`` return the same payload live, without
writing a file — the pre-incident view of the same black box.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
import urllib.request
from collections import deque
from typing import Any

from tpu_kubernetes_torch.obs import REGISTRY, expfmt
from tpu_kubernetes_torch.obs.ledger import LEDGER
from tpu_kubernetes_torch.obs.tsdb import TSDB
from tpu_kubernetes_torch.util.trace import TRACER

SCHEMA = "tpu-k8s-flightrec/1"

DEFAULT_DIR = os.path.join("runs", "flightrec")
DEFAULT_KEEP = 8
DEFAULT_SEGMENTS = 256

# how often (seconds) a segment feed also refreshes the local SLO /
# history view from the registry — parsing the exposition every segment
# would tax the decode loop for telemetry nobody reads that fast
OBSERVE_EVERY_S = 2.0

# last-N raw samples per serve series embedded in a dump
TAIL_SAMPLES = 32
TAIL_SERIES = (
    "tpu_serve_requests_total",
    "tpu_serve_tokens_emitted_total",
    "tpu_serve_inflight_requests",
    "tpu_serve_kv_pages",
    "tpu_serve_slot_occupancy",
)

# payload keys whose values never belong in a postmortem — prompts and
# generations are user data; a flight recorder records the airplane,
# not the passengers' conversations
REDACT_KEYS = frozenset({
    "prompt", "prompts", "text", "completion", "messages", "tokens",
    "token_ids", "ids", "content",
})
MAX_STR = 512


def redact(obj: Any) -> Any:
    """Recursively strip user-content keys (replaced by a length
    marker) and truncate oversized strings — applied to every payload
    before it leaves the process."""
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            if isinstance(k, str) and k.lower() in REDACT_KEYS:
                n = len(v) if isinstance(v, (str, list, tuple, dict)) else 1
                out[k] = f"<redacted:{n}>"
            else:
                out[k] = redact(v)
        return out
    if isinstance(obj, (list, tuple)):
        return [redact(v) for v in obj]
    if isinstance(obj, str) and len(obj) > MAX_STR:
        return obj[:MAX_STR] + f"…<truncated {len(obj) - MAX_STR}>"
    return obj


def _int_env(env: dict, key: str, default: int) -> int:
    from tpu_kubernetes_torch.util.envparse import env_int

    return env_int(key, default, env=env)


class FlightRecorder:
    """The bounded black box one serving process feeds.

    Thread-safe: the engine scheduler records segments while HTTP
    handler threads snapshot and failure paths dump.
    """

    def __init__(self, directory: str = DEFAULT_DIR, keep: int = DEFAULT_KEEP,
                 capacity: int = DEFAULT_SEGMENTS, registry=None,
                 ledger=None, tracer=None, slos=None, incidents=None):
        self.directory = directory
        self.keep = max(1, int(keep))
        # the incident correlator (obs/incidents.py), when one is wired:
        # dumps taken during an open incident carry its id, and every
        # dump path is reported back for the bundle's cross-ref list
        self.incidents = incidents
        self._registry = REGISTRY if registry is None else registry
        self._ledger = LEDGER if ledger is None else ledger
        self._tracer = TRACER if tracer is None else tracer
        self._segments: deque[dict] = deque(maxlen=max(1, int(capacity)))
        self._lock = threading.Lock()
        self._counts = {"segments": 0, "dumps": 0, "dump_failures": 0}
        self._last_observe = 0.0
        # the recorder's own retained history + objectives, observed
        # from THIS process's registry (no HTTP hop: render → parse →
        # the same FleetSnapshot queries the fleet monitor runs)
        self.store = TSDB(max_bytes=2 << 20)
        if slos is None:
            from tpu_kubernetes_torch.obs.slo import default_slos
            slos = default_slos(store=self.store)
        self._slos = slos

    @classmethod
    def from_env(cls, env: dict) -> "FlightRecorder":
        return cls(
            directory=env.get("TPU_K8S_FLIGHTREC_DIR", "") or DEFAULT_DIR,
            keep=_int_env(env, "TPU_K8S_FLIGHTREC_KEEP", DEFAULT_KEEP),
            capacity=_int_env(env, "TPU_K8S_FLIGHTREC_SEGMENTS",
                              DEFAULT_SEGMENTS),
        )

    # -- the local registry view -------------------------------------------

    def _local_snapshot(self, now: float):
        """This process's registry as a single-instance FleetSnapshot —
        what the SLO trackers and the history store ingest."""
        from tpu_kubernetes_torch.obs.aggregate import FleetSnapshot

        families = {f.name: f for f in expfmt.parse(self._registry.render())}
        return FleetSnapshot(ts=now, health={}, families=families)

    def _observe(self, now: float, force: bool = False) -> None:
        """Refresh the local history/SLO view, throttled unless forced
        (dump time always refreshes: the postmortem must carry the final
        instant, not one from two seconds ago)."""
        with self._lock:
            if not force and now - self._last_observe < OBSERVE_EVERY_S:
                return
            self._last_observe = now
        try:
            snapshot = self._local_snapshot(now)
            self.store.ingest(snapshot)
            for tracker in self._slos:
                tracker.observe(snapshot, now=now)
        except Exception:  # noqa: BLE001 — telemetry must not hurt serving
            pass

    # -- feeds --------------------------------------------------------------

    def record_segment(self, **fields: Any) -> None:
        """One decode segment's snapshot, straight from the engine
        scheduler (before its per-segment counters reset). Never
        raises."""
        try:
            now = time.time()
            seg = {"ts": round(now, 3)}
            seg.update(fields)
            with self._lock:
                self._segments.append(seg)
                self._counts["segments"] += 1
            self._observe(now)
        except Exception:  # noqa: BLE001 — the decode loop is the patient
            pass

    # -- payload ------------------------------------------------------------

    def _fault_totals(self) -> dict[str, float]:
        fam = self._registry.snapshot(
            prefix="tpu_k8s_faults_injected_total"
        ).get("tpu_k8s_faults_injected_total")
        if not fam:
            return {}
        return {
            s["labels"].get("site", ""): s["value"]
            for s in fam["samples"]
        }

    def _recent_spans(self, n: int = 20) -> list[dict]:
        spans = self._tracer.spans[-n:]
        return [
            {
                "span_id": s.span_id,
                "name": s.name,
                "seconds": round(s.seconds, 6),
                "run_id": s.run_id,
            }
            for s in spans
        ]

    def snapshot(self, reason: str = "on-demand",
                 extra: dict | None = None) -> dict:
        """The full, redacted payload — what a dump writes and what
        ``GET /debug/flightrec`` returns live."""
        now = time.time()
        self._observe(now, force=True)
        with self._lock:
            segments = list(self._segments)
            counts = dict(self._counts)
        try:
            alerts = [t.evaluate(now=now).to_dict() for t in self._slos]
        except Exception:  # noqa: BLE001
            alerts = []
        try:
            ledger = self._ledger.snapshot(timeline=16)
        except Exception:  # noqa: BLE001
            ledger = {}
        payload = {
            "schema": SCHEMA,
            "reason": reason,
            "ts": round(now, 3),
            "pid": os.getpid(),
            "recorder": counts,
            "segments": segments,
            "ledger": ledger,
            "alerts": alerts,
            "faults_injected": self._fault_totals(),
            "spans": self._recent_spans(),
            "history": {
                name: self.store.tail(name, TAIL_SAMPLES)
                for name in TAIL_SERIES
                if self.store.has_samples(name)
            },
        }
        if extra:
            payload["extra"] = extra
        if self.incidents is not None:
            try:
                payload["incident_id"] = self.incidents.current_incident_id()
            except Exception:  # noqa: BLE001
                payload["incident_id"] = None
        return redact(payload)

    # -- persistence --------------------------------------------------------

    def _prune(self) -> None:
        names = sorted(
            n for n in os.listdir(self.directory)
            if n.startswith("flightrec-") and n.endswith(".json")
        )
        for stale in names[:-self.keep]:
            try:
                os.remove(os.path.join(self.directory, stale))
            except OSError:
                pass

    def dump(self, reason: str, extra: dict | None = None) -> str | None:
        """Write one postmortem atomically; prune to ``keep`` newest;
        return the path (None on any failure — never raises)."""
        try:
            payload = self.snapshot(reason=reason, extra=extra)
            os.makedirs(self.directory, exist_ok=True)
            safe = "".join(
                c if c.isalnum() or c in "-_" else "-" for c in reason
            ) or "dump"
            name = f"flightrec-{int(time.time() * 1e3)}-{safe}.json"
            path = os.path.join(self.directory, name)
            fd, tmp = tempfile.mkstemp(
                prefix=".flightrec-", suffix=".tmp", dir=self.directory
            )
            try:
                with os.fdopen(fd, "w", encoding="utf-8") as f:
                    json.dump(payload, f, sort_keys=True, default=str)
                os.replace(tmp, path)
            except BaseException:
                try:
                    os.remove(tmp)
                except OSError:
                    pass
                raise
            self._prune()
            with self._lock:
                self._counts["dumps"] += 1
            from tpu_kubernetes_torch.obs import events

            events.emit("flightrec_dump", reason=reason, path=path,
                        segments=len(payload.get("segments", [])),
                        incident_id=payload.get("incident_id"))
            if self.incidents is not None:
                try:
                    self.incidents.note_flightrec_dump(path)
                except Exception:  # noqa: BLE001
                    pass
            return path
        except Exception:  # noqa: BLE001 — the postmortem writer must not
            with self._lock:  # crash the patient
                self._counts["dump_failures"] += 1
            return None


# -- the `get flightrec` CLI face -------------------------------------------


def fetch_flightrec(target: str, timeout: float = 5.0) -> dict:
    """GET ``/debug/flightrec`` from ``host:port`` (scheme/path
    optional, mirroring fetch_profile's target normalization)."""
    t = target.strip()
    if "//" not in t:
        t = "http://" + t
    if not t.rstrip("/").endswith("/debug/flightrec"):
        t = t.rstrip("/") + "/debug/flightrec"
    with urllib.request.urlopen(t, timeout=timeout) as resp:
        return json.loads(resp.read().decode("utf-8", "replace"))


def render_flightrec(payload: dict) -> str:
    """The operator summary of one recorder payload: how much the ring
    holds, what the engine was doing last, whether the ledger balances,
    and what was alerting."""
    lines = []
    counts = payload.get("recorder", {})
    lines.append(
        f"flight recorder ({payload.get('reason', '?')}) — "
        f"{len(payload.get('segments', []))} segments in ring, "
        f"{counts.get('segments', 0)} recorded, "
        f"{counts.get('dumps', 0)} dumps"
    )
    segments = payload.get("segments", [])
    if segments:
        seg = segments[-1]
        lines.append(
            f"  last segment: occupied {seg.get('occupied')}/"
            f"{seg.get('slots')} slots, live_steps={seg.get('live_steps')}"
            f", admitted={seg.get('admitted')}, reaped={seg.get('reaped')}"
            f", queued={seg.get('queued')}"
        )
        traces = seg.get("trace_ids")
        if traces:
            shown = ", ".join(traces[:4])
            more = len(traces) - 4
            lines.append(
                "  traces resident: " + shown
                + (f" (+{more} more)" if more > 0 else "")
            )
        pages = seg.get("pages")
        if pages:
            lines.append(
                f"  pages: free={pages.get('free')} live={pages.get('live')}"
                f" pinned={pages.get('pinned')} / total={pages.get('total')}"
                f" (stalls={pages.get('stalls')})"
            )
    ledger = payload.get("ledger", {})
    classes = ledger.get("classes")
    if classes is not None:
        settled = sum(classes.values())
        lines.append(
            f"  ledger: emitted={ledger.get('emitted')} settled={settled}"
            f" unsettled={ledger.get('unsettled')}"
        )
    active = [a for a in payload.get("alerts", [])
              if a.get("state") != "ok"]
    for a in active:
        lines.append(
            f"  alert [{a.get('state', '?').upper()}] {a.get('slo')}"
            f" burn fast={a.get('burn_fast')}x slow={a.get('burn_slow')}x"
        )
    faults = {k: v for k, v in payload.get("faults_injected", {}).items() if v}
    if faults:
        lines.append("  faults injected: " + ", ".join(
            f"{site}={int(n)}" for site, n in sorted(faults.items())
        ))
    return "\n".join(lines) + "\n"
