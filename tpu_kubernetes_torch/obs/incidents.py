"""Incident correlation: temporally overlapping alerts → one bundle.

The port's copy of ``tpu_kubernetes/obs/incidents.py`` (the port imports nothing of
the JAX package): the same names, families and behaviour.

An alert stream answers "what is wrong right now"; a postmortem needs
"what was wrong TOGETHER, and what did the system look like while it
was". The :class:`IncidentCorrelator` watches every
:class:`~tpu_kubernetes_torch.obs.alerts.AlertManager` evaluation: when any
alert fires while no incident is open, it opens one; every alert that
fires before the incident closes joins it (temporal overlap IS the
correlation — a page-alloc fault storm, the restart tripwire it trips,
and the latency drift it causes land in one bundle, not three); when
nothing has been firing for ``close_after_s``, the incident closes.

Each incident is one JSON bundle on disk — atomic (tmp + rename),
redacted (obs/flightrec.py's ``redact``, prompts never persist),
retention-pruned (keep-newest, a crash-looping fleet cannot fill a
disk), and rewritten in place as the incident evolves so the file is
always the current truth. A bundle carries everything a postmortem
opens four terminals for today:

* the member alerts (fingerprint, rule, lifecycle timestamps, last
  value/summary);
* cross-refs to every flight-recorder dump written during (or just
  before) the incident — opening an incident also TRIGGERS a dump, so
  the cross-ref always exists, and dumps taken while the incident is
  open carry the ``incident_id`` back (tested in both directions);
* the per-site injected-fault counters at close;
* the token ledger snapshot with a goodput-loss breakdown (which
  settlement classes ate the tokens), conservation-checkable offline;
* the last-N history-store samples for every series the member rules
  implicate — the data the alerts fired on.

Structured events (obs/events.py) mark ``incident_open`` /
``incident_close`` with the member fingerprints as correlation ids.
Everything is clock-injectable (``now=``) and the correlator never
raises into its caller — it rides the same evaluation loops that serve
traffic.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from collections import deque

from tpu_kubernetes_torch.obs import REGISTRY
from tpu_kubernetes_torch.obs.flightrec import redact
from tpu_kubernetes_torch.obs.ledger import LEDGER, USEFUL

SCHEMA = "tpu-k8s-incident/1"

DEFAULT_DIR = os.path.join("runs", "incidents")
DEFAULT_KEEP = 32
DEFAULT_CLOSE_AFTER_S = 60.0

# flightrec dumps written this long before an incident opens are
# adopted into it — the dump that DOCUMENTS a failure usually lands a
# tick before the tripwire that announces it
ADOPT_WINDOW_S = 60.0

# last-N history samples per implicated series in a bundle
TAIL_SAMPLES = 32


def _int_env(env: dict, key: str, default: int) -> int:
    from tpu_kubernetes_torch.util.envparse import env_int

    return env_int(key, default, env=env)


def _float_env(env: dict, key: str, default: float) -> float:
    from tpu_kubernetes_torch.util.envparse import env_float

    return env_float(key, default, env=env)


class IncidentCorrelator:
    """Groups firing alerts into incidents and persists the bundles.

    Thread-safe via an RLock — opening an incident triggers a
    flight-recorder dump, and that dump re-enters the correlator on the
    same thread (``current_incident_id`` for the payload,
    ``note_flightrec_dump`` for the cross-ref)."""

    def __init__(self, directory: str = DEFAULT_DIR,
                 keep: int = DEFAULT_KEEP,
                 close_after_s: float = DEFAULT_CLOSE_AFTER_S,
                 registry=None, ledger=None, store=None, flightrec=None,
                 tail_n: int = TAIL_SAMPLES):
        self.directory = directory
        self.keep = max(1, int(keep))
        self.close_after_s = max(0.0, float(close_after_s))
        self._registry = REGISTRY if registry is None else registry
        self._ledger = LEDGER if ledger is None else ledger
        self._store = store
        self._flightrec = flightrec
        self._tail_n = max(1, int(tail_n))
        self._lock = threading.RLock()
        self._open: dict | None = None      # the live incident record
        self._clear_since: float | None = None
        self._counts = {"opened": 0, "closed": 0, "write_failures": 0}
        # (ts, path) of recent dumps with no incident to attach to yet
        self._recent_dumps: deque[tuple[float, str]] = deque(maxlen=16)

    @classmethod
    def from_env(cls, env: dict, **kw) -> "IncidentCorrelator":
        return cls(
            directory=env.get("TPU_K8S_INCIDENTS_DIR", "") or DEFAULT_DIR,
            keep=_int_env(env, "TPU_K8S_INCIDENTS_KEEP", DEFAULT_KEEP),
            close_after_s=_float_env(env, "TPU_K8S_INCIDENTS_CLOSE_S",
                                     DEFAULT_CLOSE_AFTER_S),
            **kw,
        )

    # -- the alert-manager feed --------------------------------------------

    def observe(self, alerts: list[dict], now: float | None = None) -> None:
        """One evaluation cycle's alert list. Never raises."""
        try:
            self._observe(alerts, time.time() if now is None else now)
        except Exception:  # noqa: BLE001 — correlation must not take
            pass           # down the loop that evaluated the alerts

    def _observe(self, alerts: list[dict], now: float) -> None:
        firing = [a for a in alerts if a.get("state") == "firing"]
        with self._lock:
            if self._open is None:
                if not firing:
                    return
                self._open_incident(firing, now)
                return
            inc = self._open
            if firing:
                self._clear_since = None
                changed = False
                for a in firing:
                    fp = a.get("fingerprint", "")
                    prev = inc["alerts"].get(fp)
                    inc["alerts"][fp] = self._member(a, prev, now)
                    if prev is None:
                        changed = True
                if changed:
                    inc["updated_at"] = now
                    self._write(inc, now)
                return
            # nothing firing: hold, then close
            if self._clear_since is None:
                self._clear_since = now
            if now - self._clear_since >= self.close_after_s:
                self._close_incident(now)

    def _member(self, alert: dict, prev: dict | None, now: float) -> dict:
        m = {
            "fingerprint": alert.get("fingerprint"),
            "rule": alert.get("rule"),
            "kind": alert.get("kind"),
            "labels": alert.get("labels", {}),
            "severity": alert.get("severity"),
            "summary": alert.get("summary"),
            "value": alert.get("value"),
            "series": alert.get("series", []),
            "first_seen": prev.get("first_seen") if prev else now,
            "last_seen": now,
            "firing_since": alert.get("firing_since"),
        }
        return m

    def _open_incident(self, firing: list[dict], now: float) -> None:
        fps = sorted(a.get("fingerprint", "") for a in firing)
        incident_id = f"{int(now * 1e3):x}-{fps[0][:6]}"
        inc = {
            "incident_id": incident_id,
            "status": "open",
            "opened_at": now,
            "updated_at": now,
            "closed_at": None,
            "alerts": {},
            "flightrec_dumps": [],
            # the controller's audit trail: every action record emitted
            # while this incident is open (obs/controller.py) — the
            # bundle reads detect → decide → actuate → resolve
            "actions": [],
        }
        for a in firing:
            inc["alerts"][a.get("fingerprint", "")] = self._member(
                a, None, now
            )
        # adopt the dumps that immediately preceded the tripwire — the
        # postmortem usually lands before the page does
        for ts, path in self._recent_dumps:
            if now - ts <= ADOPT_WINDOW_S:
                inc["flightrec_dumps"].append(path)
        self._recent_dumps.clear()
        self._open = inc
        self._clear_since = None
        self._counts["opened"] += 1
        from tpu_kubernetes_torch.obs import events

        events.emit("incident_open", incident_id=incident_id,
                    fingerprints=fps,
                    rules=sorted({a.get("rule") for a in firing}))
        # every incident gets at least one flight-recorder cross-ref:
        # the dump re-enters note_flightrec_dump under our RLock
        if self._flightrec is not None:
            try:
                self._flightrec.dump(f"incident-{incident_id}")
            except Exception:  # noqa: BLE001 — recorder is best-effort
                pass
        self._write(inc, now)

    def _close_incident(self, now: float) -> None:
        inc = self._open
        inc["status"] = "closed"
        inc["closed_at"] = now
        inc["updated_at"] = now
        self._open = None
        self._clear_since = None
        self._counts["closed"] += 1
        self._write(inc, now)
        from tpu_kubernetes_torch.obs import events

        events.emit("incident_close", incident_id=inc["incident_id"],
                    fingerprints=sorted(inc["alerts"]),
                    duration_s=round(now - inc["opened_at"], 3),
                    dumps=len(inc["flightrec_dumps"]),
                    actions=len(inc.get("actions", [])))

    # -- the flight-recorder cross-ref -------------------------------------

    def current_incident_id(self) -> str | None:
        """The open incident's id, if any — stamped into flight-recorder
        dumps taken while an incident is open."""
        with self._lock:
            return self._open["incident_id"] if self._open else None

    def note_flightrec_dump(self, path: str,
                            now: float | None = None) -> None:
        """A dump landed: attach it to the open incident, or remember it
        briefly so an incident opening moments later adopts it."""
        now = time.time() if now is None else now
        with self._lock:
            if self._open is not None:
                if path not in self._open["flightrec_dumps"]:
                    self._open["flightrec_dumps"].append(path)
            else:
                self._recent_dumps.append((now, path))

    # -- the fleet-controller cross-ref -------------------------------------

    def note_action(self, action: dict, now: float | None = None) -> None:
        """A controller action record (obs/controller.py) landed while
        this incident is open: append it to the bundle's audit trail
        and rewrite. Actions with no open incident only live in the
        action ledger — the standalone audit trail."""
        now = time.time() if now is None else now
        with self._lock:
            if self._open is None:
                return
            inc = self._open
            inc.setdefault("actions", []).append(dict(action))
            inc["updated_at"] = now
            self._write(inc, now)

    # -- the bundle ---------------------------------------------------------

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

    def _ledger_block(self) -> dict:
        try:
            snap = self._ledger.snapshot(timeline=16)
        except Exception:  # noqa: BLE001
            return {}
        classes = snap.get("classes", {})
        emitted = snap.get("emitted", 0)
        # the goodput-loss breakdown: which settlement classes ate the
        # non-useful tokens (what the incident COST, in tokens)
        loss = {
            cls: n for cls, n in classes.items()
            if cls != USEFUL and n
        }
        snap["loss_breakdown"] = {
            "lost_tokens": sum(loss.values()),
            "lost_fraction": (round(sum(loss.values()) / emitted, 6)
                              if emitted else None),
            "by_class": loss,
        }
        return snap

    def _history_block(self, inc: dict) -> dict:
        if self._store is None:
            return {}
        series: set[str] = set()
        for m in inc["alerts"].values():
            series.update(m.get("series") or [])
        out = {}
        for name in sorted(series):
            try:
                if self._store.has_samples(name):
                    out[name] = self._store.tail(name, self._tail_n)
            except Exception:  # noqa: BLE001
                continue
        return out

    def _payload(self, inc: dict) -> dict:
        payload = {
            "schema": SCHEMA,
            "incident_id": inc["incident_id"],
            "status": inc["status"],
            "opened_at": inc["opened_at"],
            "updated_at": inc["updated_at"],
            "closed_at": inc["closed_at"],
            "alerts": inc["alerts"],
            "rules": sorted({m.get("rule") for m in
                             inc["alerts"].values()}),
            "flightrec_dumps": list(inc["flightrec_dumps"]),
            "actions": list(inc.get("actions", [])),
            "faults_injected": self._fault_totals(),
            "ledger": self._ledger_block(),
            "history": self._history_block(inc),
        }
        return redact(payload)

    def _write(self, inc: dict, now: float) -> None:
        """Rewrite the incident's bundle atomically; prune; count
        failures instead of raising."""
        try:
            payload = self._payload(inc)
            os.makedirs(self.directory, exist_ok=True)
            name = (f"incident-{int(inc['opened_at'] * 1e3)}-"
                    f"{inc['incident_id']}.json")
            path = os.path.join(self.directory, name)
            fd, tmp = tempfile.mkstemp(
                prefix=".incident-", suffix=".tmp", dir=self.directory
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
        except Exception:  # noqa: BLE001 — the bundle writer must not
            self._counts["write_failures"] += 1  # crash the patient

    def _prune(self) -> None:
        names = sorted(
            n for n in os.listdir(self.directory)
            if n.startswith("incident-") and n.endswith(".json")
        )
        for stale in names[:-self.keep]:
            try:
                os.remove(os.path.join(self.directory, stale))
            except OSError:
                pass

    def counts(self) -> dict:
        with self._lock:
            return dict(self._counts)


# -- the `get incidents` CLI face --------------------------------------------


def list_incidents(directory: str = DEFAULT_DIR) -> list[dict]:
    """Parse every incident bundle in ``directory``, newest first.
    Unparseable files are skipped (a half-written tmp never matches the
    glob; a corrupt bundle should not hide its siblings)."""
    if not os.path.isdir(directory):
        return []
    out = []
    for name in sorted(os.listdir(directory), reverse=True):
        if not (name.startswith("incident-") and name.endswith(".json")):
            continue
        path = os.path.join(directory, name)
        try:
            with open(path, encoding="utf-8") as f:
                payload = json.load(f)
        except (OSError, ValueError):
            continue
        payload["_path"] = path
        out.append(payload)
    return out


def render_incidents(payloads: list[dict]) -> str:
    """The operator summary of a directory of incident bundles."""
    if not payloads:
        return "no incident bundles found\n"
    lines = []
    for p in payloads:
        alerts = p.get("alerts", {})
        opened = p.get("opened_at")
        closed = p.get("closed_at")
        dur = (f"{closed - opened:.0f}s" if opened and closed
               else "open")
        lines.append(
            f"incident {p.get('incident_id')} "
            f"[{p.get('status', '?').upper()}] — "
            f"{len(alerts)} alerts, duration {dur}, "
            f"{len(p.get('flightrec_dumps', []))} flightrec dumps"
        )
        for fp, m in sorted(alerts.items()):
            labels = ",".join(f"{k}={v}" for k, v in
                              sorted((m.get("labels") or {}).items()))
            lines.append(
                f"    {fp} {m.get('rule')}"
                f"{'{' + labels + '}' if labels else ''}"
                f" severity={m.get('severity') or '-'}"
                + (f" — {m['summary']}" if m.get("summary") else "")
            )
        for a in p.get("actions", []):
            lines.append(
                f"    action {a.get('id') or '-'}: {a.get('kind')}"
                f" -> {a.get('outcome')}"
                + (f" target={a['target']}" if a.get("target") else "")
                + (f" — {a['reason']}" if a.get("reason") else "")
                + (f" [{a['error']}]" if a.get("error") else "")
            )
        ledger = p.get("ledger", {})
        loss = ledger.get("loss_breakdown", {})
        if loss.get("lost_tokens"):
            by = ", ".join(f"{c}={n}" for c, n in
                           sorted(loss.get("by_class", {}).items()))
            frac = loss.get("lost_fraction")
            lines.append(
                f"    goodput loss: {loss['lost_tokens']} tokens"
                + (f" ({frac:.1%})" if isinstance(frac, float) else "")
                + (f" — {by}" if by else "")
            )
    return "\n".join(lines) + "\n"
