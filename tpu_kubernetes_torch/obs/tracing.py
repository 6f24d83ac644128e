"""End-to-end distributed tracing for the serve fleet.

The port's copy of ``tpu_kubernetes/obs/tracing.py`` (the port imports nothing of
the JAX package): the same names, families and behaviour.

The tracer (util/trace.py) follows a request *inside* one process
— ``GET /debug/trace/<run_id>`` renders the phase tree — but dies at
the process boundary: a fleet-routed request, or a future prefill/
decode KV handoff between tiers, cannot be followed across instances.
This module is the cross-process substrate:

* **W3C ``traceparent`` propagation** — :func:`parse_traceparent` /
  :func:`render_traceparent` speak the standard header
  (``00-<32hex trace>-<16hex span>-<2hex flags>``); the HTTP server
  extracts inbound context and echoes its own, the fleet aggregator
  injects outbound context on every scrape, and the contextvar scope
  (:func:`trace_scope` / :func:`current_trace`) carries the context
  across the handler → engine → SSE-producer thread hops.
* **Head + tail sampling** — the head decision is *deterministic in
  the trace id* (:func:`head_sampled`), so every instance touched by
  one trace agrees without coordination; tail capture
  (:meth:`TraceRuntime.should_export`) additionally keeps error,
  deadline-exceeded, and slow traces that head sampling missed.
* **Bounded background export** — :class:`SpanExporter` buffers span
  records in a bounded queue and delivers them from a daemon thread
  (JSONL file and/or OTLP-HTTP-JSON endpoint), so the scheduler and
  handler threads never block on sink I/O. Delivery runs behind the
  ``obs.trace_export`` fault site; failures drop the batch silently
  and count ``tpu_trace_spans_dropped_total``.
* **Stitching** — :func:`fetch_trace` / :func:`stitch_trace` pull
  ``/debug/trace/<trace_id>`` from every instance and merge the span
  trees plus the scheduler's segment spans (which carry *links* to
  every resident request's trace) into one cross-instance view with a
  :func:`critical_path` breakdown: queue vs admission-wait vs prefill
  vs decode-segments vs SSE stream, annotated with device-seconds and
  ledger token classes.

Everything here is stdlib-only and never raises into the caller's
request path — observability must not take the service down.

Env knobs (all read through util/envparse, bad values degrade):
``TPU_K8S_TRACE_SAMPLE``, ``TPU_K8S_TRACE_SLOW_S``,
``TPU_K8S_TRACE_EXPORT_PATH``, ``TPU_K8S_TRACE_EXPORT_URL``,
``TPU_K8S_TRACE_EXPORT_QUEUE``.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import random
import threading
import time
import urllib.request
from collections import deque
from dataclasses import dataclass
from typing import Callable, Mapping

from tpu_kubernetes_torch.obs.faults import FAULTS
from tpu_kubernetes_torch.obs.metrics import REGISTRY
from tpu_kubernetes_torch.util.envparse import env_float, env_int, env_str

TRACEPARENT = "traceparent"
_VERSION = "00"
FLAG_SAMPLED = 0x01

SPANS_EXPORTED = REGISTRY.counter(
    "tpu_trace_spans_exported_total",
    "span records delivered to an export sink (JSONL or OTLP)",
)
SPANS_DROPPED = REGISTRY.counter(
    "tpu_trace_spans_dropped_total",
    "span records dropped: queue overflow or export-sink failure",
)


# ---------------------------------------------------------------------------
# W3C trace context


@dataclass(frozen=True)
class TraceContext:
    """One hop of a W3C trace: the fleet-wide trace id, this process's
    span id (what downstream calls see as their parent), and the
    sampled flag carried in ``traceparent`` flags."""

    trace_id: str
    span_id: str
    sampled: bool = True

    def child(self, rng: random.Random | None = None) -> "TraceContext":
        """Same trace, fresh span id — what an outbound call sends."""
        return TraceContext(self.trace_id, new_span_id(rng), self.sampled)


def _rand_hex(nchars: int, rng: random.Random | None = None) -> str:
    r = rng if rng is not None else random
    value = r.getrandbits(nchars * 4)
    out = format(value, "0" + str(nchars) + "x")
    # the spec forbids the all-zero id; one nudge keeps it valid
    return out if any(c != "0" for c in out) else "1" + out[1:]


def new_trace_id(rng: random.Random | None = None) -> str:
    return _rand_hex(32, rng)


def new_span_id(rng: random.Random | None = None) -> str:
    return _rand_hex(16, rng)


def _is_hex(s: str) -> bool:
    return bool(s) and all(c in "0123456789abcdef" for c in s)


def parse_traceparent(header: str | None) -> TraceContext | None:
    """``TraceContext`` from a ``traceparent`` header, or ``None`` for
    anything malformed (bad field count/length, non-hex, all-zero ids,
    unknown future version with a short header). Unknown versions with
    a well-formed prefix are accepted per spec."""
    if not header:
        return None
    parts = header.strip().lower().split("-")
    if len(parts) < 4:
        return None
    version, trace_id, span_id, flags = parts[0], parts[1], parts[2], parts[3]
    if len(version) != 2 or not _is_hex(version) or version == "ff":
        return None
    if version == _VERSION and len(parts) != 4:
        return None
    if len(trace_id) != 32 or not _is_hex(trace_id):
        return None
    if len(span_id) != 16 or not _is_hex(span_id):
        return None
    if len(flags) != 2 or not _is_hex(flags):
        return None
    if set(trace_id) == {"0"} or set(span_id) == {"0"}:
        return None
    return TraceContext(
        trace_id=trace_id, span_id=span_id,
        sampled=bool(int(flags, 16) & FLAG_SAMPLED),
    )


def render_traceparent(ctx: TraceContext) -> str:
    flags = format(FLAG_SAMPLED if ctx.sampled else 0, "02x")
    return f"{_VERSION}-{ctx.trace_id}-{ctx.span_id}-{flags}"


def head_sampled(trace_id: str, rate: float) -> bool:
    """Deterministic head-sampling decision: the trace id's low 8 bytes
    as a uniform draw against ``rate``. Every instance that sees the
    same trace id reaches the same verdict with zero coordination."""
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    try:
        draw = int(trace_id[-16:], 16) / float(1 << 64)
    except (ValueError, TypeError):
        return False
    return draw < rate


# ---------------------------------------------------------------------------
# ambient context (contextvars ride the handler → producer-thread hop)

_CURRENT: contextvars.ContextVar[TraceContext | None] = contextvars.ContextVar(
    "tpu_k8s_trace_ctx", default=None,
)


@contextlib.contextmanager
def trace_scope(ctx: TraceContext | None):
    token = _CURRENT.set(ctx)
    try:
        yield ctx
    finally:
        _CURRENT.reset(token)


def current_trace() -> TraceContext | None:
    return _CURRENT.get()


def current_trace_id() -> str:
    ctx = _CURRENT.get()
    return ctx.trace_id if ctx is not None else ""


def outbound_headers(headers: dict | None = None, *,
                     rng: random.Random | None = None,
                     sample: float = 1.0) -> dict:
    """Headers for an outbound HTTP call: the ambient trace context's
    child hop if one is active, else a fresh root (head-sampled at
    ``sample``) — so aggregator scrapes are traceable end to end."""
    out = dict(headers or {})
    ctx = current_trace()
    if ctx is None:
        trace_id = new_trace_id(rng)
        ctx = TraceContext(trace_id, new_span_id(rng),
                           head_sampled(trace_id, sample))
    else:
        ctx = ctx.child(rng)
    out[TRACEPARENT] = render_traceparent(ctx)
    return out


# ---------------------------------------------------------------------------
# configuration


@dataclass(frozen=True)
class TraceConfig:
    sample: float = 1.0        # head-sampling rate in [0, 1]
    slow_s: float = 1.0        # tail capture: wall latency threshold
    export_path: str = ""      # JSONL sink ("" = off)
    export_url: str = ""       # OTLP-HTTP-JSON sink ("" = off)
    queue_max: int = 2048      # exporter buffer bound (records)

    @classmethod
    def from_env(cls, env: Mapping[str, str] | None = None) -> "TraceConfig":
        sample = env_float("TPU_K8S_TRACE_SAMPLE", 1.0, env=env)
        return cls(
            sample=min(1.0, max(0.0, sample)),
            slow_s=env_float("TPU_K8S_TRACE_SLOW_S", 1.0, env=env),
            export_path=env_str("TPU_K8S_TRACE_EXPORT_PATH", env=env),
            export_url=env_str("TPU_K8S_TRACE_EXPORT_URL", env=env),
            queue_max=max(1, env_int("TPU_K8S_TRACE_EXPORT_QUEUE", 2048,
                                     env=env)),
        )


# ---------------------------------------------------------------------------
# export


def span_export_record(span, trace_id: str, *, instance: str = "",
                       epoch_offset: float | None = None) -> dict:
    """One util/trace.py Span as a flat export record. Span clocks are
    monotonic; ``epoch_offset`` (default: computed now) rebases them to
    unix time so downstream tooling can order records across hosts."""
    off = (time.time() - time.monotonic()) if epoch_offset is None \
        else epoch_offset
    end = span.end if span.end is not None else time.monotonic()
    return {
        "trace": trace_id,
        "span": span.span_id or "",
        "parent": span.parent_id or "",
        "run": span.run_id or "",
        "name": span.name,
        "start_unix_nano": int((span.start + off) * 1e9),
        "end_unix_nano": int((end + off) * 1e9),
        "attrs": dict(span.meta),
        "instance": instance,
    }


def _otlp_payload(records: list[dict]) -> dict:
    spans = []
    for r in records:
        attrs = [
            {"key": k, "value": {"stringValue": str(v)}}
            for k, v in sorted(r.get("attrs", {}).items())
        ]
        spans.append({
            "traceId": r.get("trace", ""),
            "spanId": (r.get("span", "") or "0").ljust(16, "0")[:16],
            "parentSpanId": (r.get("parent", "") or "").ljust(16, "0")[:16]
            if r.get("parent") else "",
            "name": r.get("name", ""),
            "startTimeUnixNano": str(r.get("start_unix_nano", 0)),
            "endTimeUnixNano": str(r.get("end_unix_nano", 0)),
            "attributes": attrs,
        })
    return {"resourceSpans": [{"scopeSpans": [{"spans": spans}]}]}


class SpanExporter:
    """Bounded, non-blocking span delivery. ``submit`` appends to an
    in-memory buffer under the lock and returns immediately — overflow
    drops the *newest* records (and counts them) rather than blocking a
    request or scheduler thread. A daemon worker drains batches and
    delivers them OUTSIDE the lock; each delivery attempt runs behind
    the ``obs.trace_export`` fault site and any failure (injected or
    real) drops the batch silently."""

    def __init__(self, path: str = "", url: str = "",
                 queue_max: int = 2048, *, timeout_s: float = 2.0):
        self.path = path
        self.url = url
        self.timeout_s = timeout_s
        self._buf: deque[dict] = deque()
        self._max = max(1, int(queue_max))
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._closed = False
        self._accepted = 0
        self._done = 0
        self._thread: threading.Thread | None = None
        if self.enabled:
            self._thread = threading.Thread(
                target=self._worker, name="trace-export", daemon=True,
            )
            self._thread.start()

    @property
    def enabled(self) -> bool:
        return bool(self.path or self.url)

    def submit(self, records: list[dict]) -> int:
        """Queue records for delivery; returns how many were accepted.
        Never blocks, never raises."""
        if not records or not self.enabled:
            return 0
        with self._cv:
            if self._closed:
                return 0
            room = self._max - len(self._buf)
            accepted = records[:max(0, room)]
            overflow = len(records) - len(accepted)
            self._buf.extend(accepted)
            self._accepted += len(accepted)
            self._cv.notify_all()
        if overflow:
            SPANS_DROPPED.inc(overflow)
        return len(accepted)

    def flush(self, timeout_s: float = 5.0) -> bool:
        """Wait until every accepted record has been attempted (test
        hook — production callers never wait on the exporter)."""
        with self._cv:
            return self._cv.wait_for(
                lambda: self._done >= self._accepted, timeout=timeout_s,
            )

    def close(self, timeout_s: float = 2.0) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=timeout_s)

    # -- worker side ----------------------------------------------------

    def _worker(self) -> None:
        while True:
            with self._cv:
                while not self._buf and not self._closed:
                    self._cv.wait(timeout=0.5)
                batch = list(self._buf)
                self._buf.clear()
                closed = self._closed
            if batch:
                ok = self._deliver(batch)
                # count BEFORE marking done: a flush() observer must see
                # the batch's counters the moment the wait returns
                (SPANS_EXPORTED if ok else SPANS_DROPPED).inc(len(batch))
                with self._cv:
                    self._done += len(batch)
                    self._cv.notify_all()
            if closed and not batch:
                return

    def _deliver(self, batch: list[dict]) -> bool:
        """One delivery attempt for a batch — sink I/O happens here, on
        the worker thread, outside the lock. Returns False (drop) on
        any failure; export must never take the service down."""
        try:
            FAULTS.fire("obs.trace_export")
            if self.path:
                lines = "".join(
                    json.dumps(r, sort_keys=True) + "\n" for r in batch
                )
                with open(self.path, "a", encoding="utf-8") as fh:
                    fh.write(lines)
            if self.url:
                body = json.dumps(_otlp_payload(batch)).encode("utf-8")
                req = urllib.request.Request(
                    self.url, data=body,
                    headers={"Content-Type": "application/json"},
                    method="POST",
                )
                with urllib.request.urlopen(req, timeout=self.timeout_s):
                    pass
            return True
        except Exception:
            return False


# ---------------------------------------------------------------------------
# per-process runtime policy (the serve server owns one)


class TraceRuntime:
    """The server-side policy bundle: extract/mint context on inbound
    requests, decide head+tail export, and hand finished requests'
    spans to the bounded exporter. RNG and clock are injectable so
    sampling decisions are deterministic under test."""

    def __init__(self, config: TraceConfig | None = None, *,
                 rng: random.Random | None = None,
                 clock: Callable[[], float] = time.monotonic,
                 exporter: SpanExporter | None = None):
        self.config = config if config is not None else TraceConfig()
        self.rng = rng if rng is not None else random.Random()
        self.clock = clock
        self.exporter = exporter if exporter is not None else SpanExporter(
            path=self.config.export_path, url=self.config.export_url,
            queue_max=self.config.queue_max,
        )

    def extract(self, header: str | None) -> TraceContext:
        """Inbound context: continue the caller's trace (their sampled
        flag wins — the fleet honors one coordinated head decision) or
        mint a fresh root, head-sampled deterministically by rate."""
        parsed = parse_traceparent(header)
        if parsed is not None:
            return TraceContext(
                parsed.trace_id, new_span_id(self.rng), parsed.sampled,
            )
        trace_id = new_trace_id(self.rng)
        return TraceContext(
            trace_id, new_span_id(self.rng),
            head_sampled(trace_id, self.config.sample),
        )

    def should_export(self, ctx: TraceContext | None, *, code: int = 0,
                      wall_s: float = 0.0) -> bool:
        """Head decision, plus tail capture: server errors (5xx —
        includes 504 deadline-exceeded), overload rejections (429), and
        slow requests are kept even when head sampling said no."""
        if ctx is None:
            return False
        if ctx.sampled:
            return True
        return code >= 500 or code == 429 or wall_s >= self.config.slow_s

    def finish_request(self, tracer, run_id: str,
                       ctx: TraceContext | None, *, code: int = 0,
                       wall_s: float = 0.0, instance: str = "") -> int:
        """Export one finished request's spans (plus the scheduler
        segment spans linked to its trace) if sampling keeps it.
        Returns records submitted; never raises."""
        try:
            if not self.exporter.enabled:
                return 0
            if not self.should_export(ctx, code=code, wall_s=wall_s):
                return 0
            off = time.time() - time.monotonic()
            records = []
            for s in tracer.spans:
                mine = s.run_id == run_id
                linked = (not mine and s.meta.get("links")
                          and ctx.trace_id in s.meta["links"])
                if mine or linked:
                    records.append(span_export_record(
                        s, ctx.trace_id, instance=instance,
                        epoch_offset=off,
                    ))
            return self.exporter.submit(records)
        except Exception:
            return 0

    def close(self) -> None:
        self.exporter.close()


# ---------------------------------------------------------------------------
# cross-instance fetch + stitch (the `get trace` surface)


def trace_payload(spans, trace_id: str) -> dict:
    """Everything one process knows about a trace id: the span trees of
    every run whose root carried ``meta.trace == trace_id``, plus the
    scheduler segment spans whose ``meta.links`` include it. This is
    what ``GET /debug/trace/<trace_id>`` serves when the id is not a
    local run id."""
    from tpu_kubernetes_torch.util.trace import span_tree

    run_ids = sorted({
        s.run_id for s in spans
        if s.run_id and s.meta.get("trace") == trace_id
    })
    trees: list[dict] = []
    for rid in run_ids:
        trees.extend(span_tree(spans, rid))
    segments = [
        {
            "name": s.name,
            "seconds": round(s.seconds, 6),
            "meta": dict(s.meta),
        }
        for s in spans
        if s.name == "segment"
        and trace_id in (s.meta.get("links") or ())
    ]
    return {
        "trace": trace_id, "runs": run_ids,
        "spans": trees, "segments": segments,
    }


def fetch_trace(target: str, trace_id: str, timeout: float = 5.0) -> dict:
    """GET one instance's view of a trace. ``target`` is a host:port or
    URL, normalized the same way fetch_flightrec normalizes."""
    t = target.strip()
    if "//" not in t:
        t = "http://" + t
    t = t.rstrip("/")
    if not t.endswith("/debug/trace/" + trace_id):
        t = t + "/debug/trace/" + trace_id
    with urllib.request.urlopen(t, timeout=timeout) as resp:
        return json.loads(resp.read().decode("utf-8"))


def stitch_trace(trace_id: str, payloads: Mapping[str, dict]) -> dict:
    """Merge per-instance ``/debug/trace`` payloads into one
    cross-instance view keyed by instance, with the critical-path
    breakdown computed over all of it."""
    instances: dict[str, dict] = {}
    for instance in sorted(payloads):
        p = payloads[instance] or {}
        instances[instance] = {
            "spans": list(p.get("spans") or []),
            "segments": list(p.get("segments") or []),
            "runs": list(p.get("runs") or []),
        }
    stitched = {"trace": trace_id, "instances": instances}
    stitched["critical_path"] = critical_path(stitched)
    return stitched


def _walk(nodes, fn, depth=0):
    for n in nodes:
        fn(n, depth)
        _walk(n.get("children") or [], fn, depth + 1)


def critical_path(stitched: dict) -> dict:
    """Phase breakdown of a stitched trace. ``wall_s`` is the longest
    ``request`` root (the client-facing instance); ``phases`` sums that
    request's direct children by span name — queue, prefill, batch
    (the continuous decode segments), decode / stream — so the phase
    durations account for the wall latency within scheduling noise.
    Admission wait, device-seconds, and ledger token classes ride the
    span meta and are surfaced alongside."""
    best: dict | None = None
    device_s = 0.0
    segments = 0
    for inst in (stitched.get("instances") or {}).values():
        for seg in inst.get("segments") or []:
            segments += 1
            try:
                device_s += float((seg.get("meta") or {}).get("device_s", 0))
            except (TypeError, ValueError):
                pass
        for root in inst.get("spans") or []:
            if root.get("name") != "request":
                continue
            if best is None or root.get("seconds", 0) > best.get("seconds", 0):
                best = root
    out: dict = {
        "wall_s": 0.0, "phases": {}, "accounted_s": 0.0,
        "admission_wait_s": 0.0, "device_s": round(device_s, 6),
        "segments": segments, "tokens": {},
    }
    if best is None:
        return out
    out["wall_s"] = round(float(best.get("seconds", 0.0)), 6)
    phases: dict[str, float] = {}
    for child in best.get("children") or []:
        name = child.get("name", "?")
        phases[name] = phases.get(name, 0.0) + float(child.get("seconds", 0))
        meta = child.get("meta") or {}
        try:
            out["admission_wait_s"] += float(meta.get("admission_wait_s", 0))
        except (TypeError, ValueError):
            pass
        if isinstance(meta.get("tokens"), dict):
            for k, v in meta["tokens"].items():
                try:
                    out["tokens"][k] = out["tokens"].get(k, 0) + int(v)
                except (TypeError, ValueError):
                    pass
    out["phases"] = {k: round(v, 6) for k, v in sorted(phases.items())}
    out["accounted_s"] = round(sum(phases.values()), 6)
    out["admission_wait_s"] = round(out["admission_wait_s"], 6)
    return out


def render_trace(stitched: dict) -> str:
    """Human-readable stitched trace for ``get trace`` (non-JSON)."""
    lines: list[str] = []
    cp = stitched.get("critical_path") or {}
    instances = stitched.get("instances") or {}
    lines.append(
        f"trace {stitched.get('trace', '?')}  "
        f"({len(instances)} instance(s), wall {cp.get('wall_s', 0):.3f}s)"
    )
    for instance in sorted(instances):
        inst = instances[instance]
        spans = inst.get("spans") or []
        segs = inst.get("segments") or []
        lines.append(f"  instance {instance}  "
                     f"({len(spans)} root span(s), {len(segs)} segment(s))")

        def emit(node, depth):
            meta = node.get("meta") or {}
            keys = ("endpoint", "trace", "admission_wait_s", "device_s")
            extra = " ".join(
                f"{k}={meta[k]}" for k in keys if k in meta
            )
            lines.append(
                "    " + "  " * depth
                + f"{node.get('name', '?')} ({node.get('seconds', 0):.3f}s)"
                + (f"  {extra}" if extra else "")
            )

        _walk(spans, emit)
    if cp.get("phases"):
        parts = " · ".join(
            f"{name} {secs:.3f}s" for name, secs in cp["phases"].items()
        )
        lines.append(
            f"  critical path: {parts}  "
            f"(accounted {cp.get('accounted_s', 0):.3f}s "
            f"of {cp.get('wall_s', 0):.3f}s wall; "
            f"admission wait {cp.get('admission_wait_s', 0):.3f}s, "
            f"device {cp.get('device_s', 0):.3f}s, "
            f"{cp.get('segments', 0)} segment(s))"
        )
    return "\n".join(lines) + "\n"
