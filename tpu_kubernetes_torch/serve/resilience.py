"""Serve-path resilience primitives: deadlines, load shedding, drain,
and the self-healing watchdog.

The port's copy of ``tpu_kubernetes/serve/resilience.py`` (the port imports nothing of
the JAX package): the same names, families and behaviour.

The server (serve/server.py) had exactly one bounded failure mode —
"the request errors" — and three unbounded ones: a slow client could
hold an engine slot forever, a traffic spike could queue unboundedly
behind the generation lock, and a dead scheduler thread hung every
future submitter. This module is the policy layer that bounds them:

* **Deadlines** (:class:`DeadlineExceeded`): every request may carry a
  monotonic deadline (``SERVE_DEADLINE_MS`` default, ``deadline_ms``
  per-request override). Expired entries are failed out of queues and
  retired mid-flight from engine slots — the slot is the scarce
  resource, and a request nobody is waiting for must not spend it.
* **Admission control** (:class:`AdmissionController`,
  :class:`Overloaded`): a bounded queue (``SERVE_MAX_QUEUE``) plus
  estimated-wait gating — a request whose deadline cannot survive the
  current queue is shed NOW with 429 + ``Retry-After`` instead of
  queueing doomed work that will 504 after consuming a slot.
* **Graceful drain** (:class:`DrainController`, :class:`Draining`):
  SIGTERM / ``POST /drain`` stops admission (new work gets 503),
  finishes resident slots, flushes metrics/events, flips ``/healthz``
  to ``draining`` — the contract a Kubernetes preStop hook needs.
* **Self-healing** (:class:`Watchdog`): a dead engine scheduler thread
  is restarted with a cold engine reset, bounded times
  (``SERVE_MAX_ENGINE_RESTARTS``); past the bound the process hard-fails
  ``/healthz`` so the fleet replaces it (the Podracer stance: cheap
  restart IS the recovery primitive).

Everything here is dependency-free and jax-free so the policy is unit-
testable without a model; serve/server.py wires it to the engine.
"""

from __future__ import annotations

import threading
import time

from tpu_kubernetes_torch.obs import REGISTRY
from tpu_kubernetes_torch.util import log

SHED_TOTAL = REGISTRY.counter(
    "tpu_serve_shed_total",
    "requests rejected by admission control with 429 (queue_full = the "
    "bounded queue was at SERVE_MAX_QUEUE; doomed_deadline = the "
    "estimated queue wait already exceeded the request's deadline)",
    labelnames=("reason",),
)
DEADLINE_TOTAL = REGISTRY.counter(
    "tpu_serve_deadline_exceeded_total",
    "requests failed for missing their deadline, by where it expired "
    "(preflight = before generation, queued = waiting for dispatch or "
    "a slot, resident = retired mid-flight from an engine slot)",
    labelnames=("stage",),
)
CANCELLED_TOTAL = REGISTRY.counter(
    "tpu_serve_cancelled_total",
    "requests cancelled before finishing, by cause (disconnect = the "
    "SSE client went away and generation was stopped early)",
    labelnames=("reason",),
)
ENGINE_RESTARTS = REGISTRY.counter(
    "tpu_serve_engine_restarts_total",
    "continuous-engine scheduler threads restarted cold by the "
    "watchdog (bounded by SERVE_MAX_ENGINE_RESTARTS, then /healthz "
    "hard-fails)",
)
FALLBACKS = REGISTRY.counter(
    "tpu_serve_fallback_total",
    "serving-lever fallbacks taken, by reason (each occurrence counts; "
    "the warning logs once per process per reason)",
    labelnames=("reason",),
)

_WARNED: set[str] = set()
_WARNED_LOCK = threading.Lock()


def warn_once(reason: str, message: str) -> None:
    """Count every occurrence in ``tpu_serve_fallback_total{reason}``
    but log the warning once per process per reason — fallbacks taken
    per request must not turn the log into spam when the metric already
    carries the rate."""
    FALLBACKS.labels(reason).inc()
    with _WARNED_LOCK:
        if reason in _WARNED:
            return
        _WARNED.add(reason)
    log.warn(message)


def reset_warned() -> None:
    """Test isolation: forget which reasons already logged."""
    with _WARNED_LOCK:
        _WARNED.clear()


class DeadlineExceeded(RuntimeError):
    """The request's deadline passed before (or while) serving it —
    surfaced to HTTP clients as 504."""


class Cancelled(RuntimeError):
    """The client stopped caring (disconnect) — the work was retired."""


class Overloaded(RuntimeError):
    """Admission control shed this request — surfaced as 429 with a
    ``Retry-After`` of :attr:`retry_after_s` seconds."""

    def __init__(self, message: str, retry_after_s: int = 1):
        super().__init__(message)
        self.retry_after_s = max(1, int(retry_after_s))


class Draining(RuntimeError):
    """The server is draining — new work gets 503 and should go to a
    sibling instance."""


def deadline_from(t0: float, deadline_ms: float | None,
                  default_ms: float = 0.0) -> float | None:
    """Request deadline as a monotonic timestamp anchored at ``t0`` (the
    moment the request was received — queue time before parsing counts).
    ``None`` when neither a per-request override nor a positive
    ``SERVE_DEADLINE_MS`` default applies."""
    ms = default_ms if deadline_ms is None else float(deadline_ms)
    if ms is None or ms <= 0:
        return None
    return t0 + ms / 1e3


def expired(deadline: float | None, now: float | None = None) -> bool:
    if deadline is None:
        return False
    return (time.monotonic() if now is None else now) >= deadline


class AdmissionController:
    """Bounded-queue + estimated-wait gating for one serving process.

    ``admit(depth, deadline)`` raises :class:`Overloaded` when the queue
    is at ``max_queue`` (429 beats an unbounded queue: the client's
    retry policy — not this process's memory — absorbs the spike), or
    when the EWMA-estimated wait at this depth already exceeds the
    request's remaining deadline (queueing doomed work costs a slot and
    still 504s). The wait estimate learns from ``observe_service`` —
    the enqueue→dispatch waits the engine/batcher actually measured."""

    def __init__(self, max_queue: int = 0):
        self.max_queue = max(0, int(max_queue))
        self._ewma: float | None = None
        self._lock = threading.Lock()

    def observe_service(self, seconds: float) -> None:
        with self._lock:
            self._ewma = (
                seconds if self._ewma is None
                else 0.8 * self._ewma + 0.2 * seconds
            )

    def estimated_wait(self, depth: int) -> float:
        """Expected queue wait with ``depth`` entries ahead — depth
        times the learned per-entry wait (conservative floor of one
        entry when the queue is empty but admission still costs)."""
        with self._lock:
            per = self._ewma
        return max(1, depth) * (0.05 if per is None else per)

    def admit(self, depth: int, deadline: float | None = None,
              now: float | None = None) -> None:
        if self.max_queue and depth >= self.max_queue:
            wait = self.estimated_wait(depth)
            SHED_TOTAL.labels("queue_full").inc()
            raise Overloaded(
                f"queue full ({depth} >= SERVE_MAX_QUEUE={self.max_queue})"
                " — retry against a less-loaded instance",
                retry_after_s=int(wait) + 1,
            )
        if deadline is not None:
            with self._lock:
                learned = self._ewma is not None
            if not learned:
                return          # never shed on a guess
            now = time.monotonic() if now is None else now
            wait = self.estimated_wait(depth)
            if now + wait >= deadline:
                SHED_TOTAL.labels("doomed_deadline").inc()
                raise Overloaded(
                    f"estimated queue wait {wait:.3f}s exceeds the "
                    "request deadline — shedding instead of queueing "
                    "doomed work",
                    retry_after_s=int(wait) + 1,
                )


class DrainController:
    """The drain state machine: ``serving`` → ``draining`` →
    ``drained``. ``begin`` is idempotent-ish (first caller wins and gets
    True); ``wait_drained`` is what a shutdown hook blocks on."""

    def __init__(self):
        self._lock = threading.Lock()
        self.state = "serving"
        self.reason = ""
        self._drained = threading.Event()

    @property
    def is_draining(self) -> bool:
        return self.state != "serving"

    def begin(self, reason: str = "") -> bool:
        with self._lock:
            if self.state != "serving":
                return False
            self.state = "draining"
            self.reason = reason
        log.info(f"serve: draining ({reason or 'requested'}) — "
                 "admission stopped, finishing resident work")
        return True

    def mark_drained(self) -> None:
        with self._lock:
            self.state = "drained"
        self._drained.set()

    def wait_drained(self, timeout: float | None = None) -> bool:
        return self._drained.wait(timeout)


class Watchdog:
    """Self-healing monitor for one thread-shaped resource: polls
    ``is_alive`` every ``interval_s``; on death calls ``restart`` up to
    ``max_restarts`` times, then ``on_give_up`` (the hard-fail path —
    /healthz flips so the fleet replaces this instance). The restart
    callback owns the actual recovery (the engine fails resident work
    out and starts a fresh scheduler on a cold cache)."""

    def __init__(self, is_alive, restart, max_restarts: int = 3,
                 interval_s: float = 0.5, on_give_up=None,
                 name: str = "engine"):
        self.is_alive = is_alive
        self.restart = restart
        self.max_restarts = max(0, int(max_restarts))
        self.interval_s = interval_s
        self.on_give_up = on_give_up
        self.name = name
        self.restarts = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name=f"watchdog-{name}"
        )

    def start(self) -> "Watchdog":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()

    def _give_up(self, why: str) -> None:
        log.warn(f"watchdog[{self.name}]: giving up — {why}")
        if self.on_give_up is not None:
            try:
                self.on_give_up()
            except Exception as e:  # noqa: BLE001 — last resort already
                log.warn(f"watchdog[{self.name}]: give-up hook failed: {e}")

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                alive = bool(self.is_alive())
            except Exception:  # noqa: BLE001 — a broken probe reads as dead
                alive = False
            if alive:
                continue
            if self.restarts >= self.max_restarts:
                self._give_up(
                    f"{self.restarts} restarts exhausted "
                    f"(SERVE_MAX_ENGINE_RESTARTS={self.max_restarts})"
                )
                return
            self.restarts += 1
            log.warn(
                f"watchdog[{self.name}]: thread dead — cold restart "
                f"{self.restarts}/{self.max_restarts}"
            )
            try:
                self.restart()
            except Exception as e:  # noqa: BLE001 — restart itself broke
                self._give_up(f"restart failed: {type(e).__name__}: {e}")
                return
