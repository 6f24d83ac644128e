"""Structured run events: a JSONL sink with correlation IDs and nesting.

The port's copy of ``tpu_kubernetes/obs/events.py`` (the port imports nothing of
the JAX package): the same names, families and behaviour.

The human-facing channel is util/log (leveled stderr); the machine-facing
channel is this one — append-only JSON lines, one event per line, each
carrying:

  ``run``    the run/correlation id (one workflow invocation, one HTTP
             request, one training job) — set with :func:`run_context`
  ``span``   this event's span id (span_start/span_end pairs share one)
  ``parent`` the enclosing span's id, so nested phases reconstruct as a
             tree (terraform init inside apply manager inside the run)

The sink is disabled unless configured (``TPU_K8S_EVENTS=<path>`` or
:func:`configure`), and it NEVER raises: observability must not fail a
workflow (the util/runlog.py stance). Context flows through contextvars,
so concurrent server threads and nested workflow phases each see their
own run/parent without any plumbing through call signatures.
"""

from __future__ import annotations

import contextlib
import contextvars
import io
import json
import os
import threading
import time
import uuid

_run_id: contextvars.ContextVar[str | None] = contextvars.ContextVar(
    "tpu_k8s_run_id", default=None
)
_parent_span: contextvars.ContextVar[str | None] = contextvars.ContextVar(
    "tpu_k8s_parent_span", default=None
)


def new_id() -> str:
    """A short correlation id (12 hex chars — log-line friendly, and far
    beyond collision range for per-process event streams)."""
    return uuid.uuid4().hex[:12]


def current_run_id() -> str | None:
    return _run_id.get()


def current_span_id() -> str | None:
    return _parent_span.get()


DEFAULT_MAX_MB = 64.0
DEFAULT_KEEP = 1


def _max_bytes_from_env() -> int:
    from tpu_kubernetes_torch.util.envparse import env_float

    mb = env_float("TPU_K8S_EVENTS_MAX_MB", DEFAULT_MAX_MB)
    return int(mb * 1024 * 1024)


def _keep_from_env() -> int:
    from tpu_kubernetes_torch.util.envparse import env_int

    return max(1, env_int("TPU_K8S_EVENTS_KEEP", DEFAULT_KEEP))


class EventSink:
    """Thread-safe JSONL writer over a path or an open stream.

    Path sinks rotate by size so a long-lived server cannot fill a disk:
    when the file would exceed ``max_bytes`` (``TPU_K8S_EVENTS_MAX_MB``,
    default 64; ≤0 disables) generations cascade ``<path>.N-1 →
    <path>.N`` up to ``keep`` rotations (``TPU_K8S_EVENTS_KEEP``,
    default 1) — always at a line boundary — and the stream starts
    fresh; stale generations beyond ``keep`` are pruned on write, the
    same retention discipline as runs/ (util/runlog.py). Rotation
    failures are swallowed like every other sink failure: observability
    must not fail the workflow."""

    def __init__(self, path: str | None = None, stream: io.IOBase | None = None,
                 max_bytes: int | None = None, keep: int | None = None):
        self._path = path
        self._stream = stream
        self._max_bytes = (
            _max_bytes_from_env() if max_bytes is None else int(max_bytes)
        )
        self._keep = max(1, _keep_from_env() if keep is None else int(keep))
        self._lock = threading.Lock()

    def _maybe_rotate(self, incoming: int) -> None:
        if self._max_bytes <= 0 or self._path is None:
            return
        try:
            if os.path.getsize(self._path) + incoming > self._max_bytes:
                # prune-on-write: a keep lowered between runs retires
                # generations the old setting left behind
                i = self._keep + 1
                while os.path.exists(f"{self._path}.{i}"):
                    os.remove(f"{self._path}.{i}")
                    i += 1
                # cascade oldest-first so every survivor shifts one slot
                for i in range(self._keep, 1, -1):
                    older = f"{self._path}.{i - 1}"
                    if os.path.exists(older):
                        os.replace(older, f"{self._path}.{i}")
                os.replace(self._path, f"{self._path}.1")
        except OSError:
            pass  # no file yet, or rename refused — keep appending

    def write(self, event: dict) -> None:
        line = json.dumps(event, sort_keys=True, default=str)
        with self._lock:
            if self._stream is not None:
                self._stream.write(line + "\n")
                self._stream.flush()
            elif self._path is not None:
                self._maybe_rotate(len(line) + 1)
                with open(self._path, "a", encoding="utf-8") as f:
                    f.write(line + "\n")


_sink: EventSink | None = None
_sink_lock = threading.Lock()
_env_checked = False


def configure(path: str | None = None, stream=None) -> None:
    """Install (or with no arguments, remove) the process event sink."""
    global _sink, _env_checked
    with _sink_lock:
        _env_checked = True  # explicit configure overrides the env default
        _sink = (
            EventSink(path=path, stream=stream)
            if path or stream is not None else None
        )


def _active_sink() -> EventSink | None:
    global _sink, _env_checked
    if not _env_checked:
        with _sink_lock:
            if not _env_checked:
                path = os.environ.get("TPU_K8S_EVENTS")
                if path:
                    _sink = EventSink(path=path)
                _env_checked = True
    return _sink


def emit(kind: str, **fields) -> None:
    """Write one event; a no-op without a sink, and never raises."""
    sink = _active_sink()
    if sink is None:
        return
    event = {"ts": round(time.time(), 6), "kind": kind}
    run = _run_id.get()
    if run:
        event["run"] = run
    parent = _parent_span.get()
    if parent:
        event.setdefault("span", parent)
    event.update(fields)
    try:
        sink.write(event)
    except Exception:  # noqa: BLE001 — observability must not fail the caller
        pass


@contextlib.contextmanager
def run_context(run_id: str | None = None):
    """Scope a run/correlation id (new one when not given) over a block;
    every event and span inside carries it. Yields the id."""
    rid = run_id or new_id()
    token = _run_id.set(rid)
    try:
        yield rid
    finally:
        _run_id.reset(token)


@contextlib.contextmanager
def parent_scope(span_id: str):
    """Make ``span_id`` the parent for spans/events opened inside the
    block — for callers (util/trace.py) that manage their own span
    records but want their nesting visible here."""
    token = _parent_span.set(span_id)
    try:
        yield
    finally:
        _parent_span.reset(token)


@contextlib.contextmanager
def span(name: str, **meta):
    """A nested span: emits span_start/span_end events sharing one span
    id, with the enclosing span as ``parent``. Yields the span id (which
    becomes the parent for anything opened inside the block)."""
    sid = new_id()
    parent = _parent_span.get()
    start = time.monotonic()
    emit("span_start", span=sid, parent=parent, name=name, **meta)
    token = _parent_span.set(sid)
    try:
        yield sid
    except BaseException:
        _parent_span.reset(token)
        emit(
            "span_end", span=sid, parent=parent, name=name,
            seconds=round(time.monotonic() - start, 6), status="error", **meta,
        )
        raise
    else:
        _parent_span.reset(token)
        emit(
            "span_end", span=sid, parent=parent, name=name,
            seconds=round(time.monotonic() - start, 6), status="ok", **meta,
        )
