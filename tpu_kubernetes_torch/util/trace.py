"""Structured step timing.

The port's copy of ``tpu_kubernetes/util/trace.py`` (the port imports nothing of
the JAX package): the same names, families and behaviour.

The reference has no tracing at all — only fmt.Println progress lines
(SURVEY §5.1; reference: cmd/create.go:46,53,60). Since the north-star metric
is create→first-train-step latency, every workflow phase here runs under a
:func:`phase` timer and the spans are retrievable/dumpable as JSON.

Spans also feed the structured-event channel (obs/events.py): each phase
carries a span id, its parent span's id (phases nest — terraform init
inside apply manager), and the ambient run/correlation id, and emits
span_start/span_end JSONL events when a sink is configured.

The tracer is thread-safe and BOUNDED: a long-lived server process runs
phases forever, so the span store is a ring (``max_spans``) — `mark()`
hands out monotonic positions that stay valid across evictions, and
:meth:`reset` drops history explicitly.
"""

from __future__ import annotations

import contextlib
import json
import sys
import threading
import time
from collections import deque
from dataclasses import dataclass, field

from tpu_kubernetes_torch.obs import events
from tpu_kubernetes_torch.util import log


@dataclass
class Span:
    name: str
    start: float
    end: float | None = None
    meta: dict = field(default_factory=dict)
    span_id: str = ""
    parent_id: str | None = None
    run_id: str | None = None

    @property
    def seconds(self) -> float:
        return (self.end if self.end is not None else time.monotonic()) - self.start


class Tracer:
    # enough for hundreds of workflow runs in one process; a serve/train
    # process that phases forever stays O(max_spans) memory
    DEFAULT_MAX_SPANS = 4096

    def __init__(self, stream=None, enabled: bool = True,
                 max_spans: int = DEFAULT_MAX_SPANS):
        self._spans: deque[Span] = deque(maxlen=max_spans)
        self._total = 0          # spans ever recorded (marks stay valid
        self._lock = threading.Lock()  # across ring evictions)
        self.stream = stream if stream is not None else sys.stderr
        self.enabled = enabled

    @property
    def spans(self) -> list[Span]:
        with self._lock:
            return list(self._spans)

    @contextlib.contextmanager
    def phase(self, name: str, quiet: bool = False, **meta):
        """Record a span over the block. ``quiet`` suppresses the
        progress lines only (per-request server spans must not spam
        stderr) — recording and event emission are unaffected."""
        span = Span(
            name=name, start=time.monotonic(), meta=dict(meta),
            span_id=events.new_id(),
            parent_id=events.current_span_id(),
            run_id=events.current_run_id(),
        )
        with self._lock:
            self._spans.append(span)
            self._total += 1
        events.emit(
            "span_start", span=span.span_id, parent=span.parent_id,
            name=name, **meta,
        )
        show = self.enabled and not quiet and log.level() >= log.NORMAL
        if show:
            print(f"[tpu-k8s] ▶ {name}", file=self.stream)
        try:
            with events.parent_scope(span.span_id):
                yield span
        finally:
            span.end = time.monotonic()
            events.emit(
                "span_end", span=span.span_id, parent=span.parent_id,
                name=name, seconds=round(span.seconds, 6), **meta,
            )
            if show:
                print(f"[tpu-k8s] ✓ {name} ({span.seconds:.1f}s)", file=self.stream)

    def record(self, name: str, seconds: float, *, run_id: str = "",
               parent_id: str | None = None, end: float | None = None,
               **meta) -> Span:
        """Append an already-finished span of known duration — for work
        measured outside a ``with phase(...)`` block (the continuous
        scheduler times its segment on the device clock and records the
        span after the fact, carrying links to the resident requests'
        traces in ``meta``)."""
        t_end = time.monotonic() if end is None else end
        span = Span(
            name=name, start=t_end - max(0.0, float(seconds)), end=t_end,
            meta=dict(meta), span_id=events.new_id(),
            parent_id=parent_id, run_id=run_id,
        )
        with self._lock:
            self._spans.append(span)
            self._total += 1
        events.emit(
            "span_end", span=span.span_id, parent=span.parent_id,
            name=name, seconds=round(span.seconds, 6), **meta,
        )
        return span

    def mark(self) -> int:
        """Current span count — pass to :meth:`report` to scope one run's
        spans when several workflows share a process (tests, silent-install
        fan-out). Marks are positions in the FULL history, so they remain
        meaningful after ring eviction."""
        with self._lock:
            return self._total

    def report(self, since: int = 0) -> list[dict]:
        with self._lock:
            dropped = self._total - len(self._spans)
            spans = list(self._spans)[max(0, since - dropped):]
        return [
            {"phase": s.name, "seconds": round(s.seconds, 3), **s.meta}
            for s in spans
        ]

    def reset(self, since: int | None = None) -> None:
        """Drop recorded spans: everything, or (with ``since`` = an earlier
        :meth:`mark`) only spans recorded before that mark — how a
        long-lived process trims history it has already reported."""
        with self._lock:
            if since is None:
                self._spans.clear()
                return
            dropped = self._total - len(self._spans)
            for _ in range(min(max(0, since - dropped), len(self._spans))):
                self._spans.popleft()

    def dump_json(self) -> str:
        return json.dumps(self.report())


def span_tree(spans: list[Span], run_id: str) -> list[dict]:
    """The spans of one run as a nested tree (parent links resolved) —
    what ``GET /debug/trace/<run_id>`` serves. Spans whose parent was
    evicted from the ring (or lives in another process) become roots, so
    a partial history still renders."""
    mine = [s for s in spans if s.run_id == run_id]
    nodes = {
        s.span_id: {
            "name": s.name,
            "seconds": round(s.seconds, 6),
            **({"meta": s.meta} if s.meta else {}),
            "children": [],
        }
        for s in mine
    }
    roots: list[dict] = []
    for s in mine:
        parent = nodes.get(s.parent_id) if s.parent_id else None
        if parent is not None and parent is not nodes[s.span_id]:
            parent["children"].append(nodes[s.span_id])
        else:
            roots.append(nodes[s.span_id])
    return roots


# module-level default tracer; workflows use this unless handed another
TRACER = Tracer()
