"""A bounded in-memory time-series store — the fleet's retained history.

The port's copy of ``tpu_kubernetes/obs/tsdb.py`` (the port imports nothing of
the JAX package): the same names, families and behaviour.

Everything upstream of this module answers "what is the number NOW":
the registry (obs/metrics.py) holds cumulative counters, the aggregator
(obs/aggregate.py) merges one instant across workers, and ``monitor``
derived rates from exactly two consecutive scrapes. The ROADMAP's next
consumers — the autoscaling fleet controller and disaggregated
prefill/decode routing — need *trends*: goodput over the last minute,
page-pressure slope, SLO burn windows. This is that layer, kept
dependency-free and strictly bounded so it can live inside the monitor
process, the serve process (the flight recorder, obs/flightrec.py), and
tests alike.

Design:

* One :class:`TSDB` holds many series keyed by ``(name, labels)``. Each
  series is an append-only **raw ring** (newest ``raw_max`` samples)
  plus **downsample tiers** (10s and 1m buckets by default) that retain
  coarse history long after the raw ring wrapped — a bucket keeps
  first/last/min/max/sum/count so rates, averages, and extremes survive
  downsampling.
* A **hard memory cap** (``max_bytes``, estimated accounting): when the
  store would exceed it, the *coldest* series — the one appended to
  least recently — are evicted whole. Hot serve series survive; a
  one-off label explosion cannot OOM the monitor.
* Query helpers mirror the PromQL verbs the SLO evaluator and monitor
  need: :meth:`rate_over_time` / :meth:`increase` with counter-reset
  detection (a delta < 0 means the worker restarted; the increase since
  the reset is the new value itself), :meth:`avg_over_time`,
  :meth:`max_over_time`, and :meth:`quantile_over_time` which re-uses
  expfmt's bucket interpolation over per-window bucket increases.

Timestamps are caller-supplied (``ts=``) so injectable clocks flow all
the way down — the SLO lifecycle tests drive hours of window arithmetic
in milliseconds through this store exactly as they did through the old
private deques.
"""

from __future__ import annotations

import math
import threading
from collections import deque
from typing import Any, Callable, Iterable

from tpu_kubernetes_torch.obs import expfmt

# (bucket width seconds, max buckets) per downsample tier, finest first.
# 10s x 1080 = 3h of mid-resolution history; 60s x 370 ≈ 6h10m — enough
# to answer the slowest SLO burn window (21600s) plus the same 600s of
# slack the old in-tracker deque kept.
DEFAULT_TIERS: tuple[tuple[float, int], ...] = ((10.0, 1080), (60.0, 370))
DEFAULT_RAW_MAX = 240
DEFAULT_MAX_BYTES = 8 << 20

# estimated bytes per stored object — accounting, not accounting-grade;
# the cap is a guard rail against unbounded growth, not a malloc audit
_SERIES_BYTES = 512
_SAMPLE_BYTES = 64
_BUCKET_BYTES = 120

Labels = tuple[tuple[str, str], ...]


class _Bucket:
    """One downsample bucket: the fold of every raw sample whose ts
    landed in [start, start + width)."""

    __slots__ = ("start", "first_ts", "first", "last_ts", "last",
                 "vmin", "vmax", "vsum", "count")

    def __init__(self, start: float, ts: float, value: float):
        self.start = start
        self.first_ts = ts
        self.first = value
        self.last_ts = ts
        self.last = value
        self.vmin = value
        self.vmax = value
        self.vsum = value
        self.count = 1

    def fold(self, ts: float, value: float) -> None:
        self.last_ts = ts
        self.last = value
        if value < self.vmin:
            self.vmin = value
        if value > self.vmax:
            self.vmax = value
        self.vsum += value
        self.count += 1


class _Series:
    __slots__ = ("name", "labels", "kind", "raw", "tiers", "last_append")

    def __init__(self, name: str, labels: Labels, kind: str,
                 raw_max: int, tiers: tuple[tuple[float, int], ...]):
        self.name = name
        self.labels = labels
        self.kind = kind
        self.raw: deque[tuple[float, float]] = deque(maxlen=raw_max)
        self.tiers: list[tuple[float, int, deque[_Bucket]]] = [
            (width, cap, deque()) for width, cap in tiers
        ]
        self.last_append = 0.0


def _labels_key(labels: Any) -> Labels:
    if isinstance(labels, dict):
        return tuple(sorted(labels.items()))
    return tuple(sorted(tuple(pair) for pair in labels))


def _reset_aware_increase(samples: list[tuple[float, float]]) -> float:
    """Counter increase over consecutive samples with Prometheus-style
    reset detection: a negative delta means the counter restarted near
    zero, so the whole new value counts as increase."""
    inc = 0.0
    prev = samples[0][1]
    for _, v in samples[1:]:
        d = v - prev
        inc += v if d < 0 else d
        prev = v
    return inc


class TSDB:
    """The bounded, thread-safe store. All public methods may be called
    concurrently (scraper thread appends while the monitor renderer and
    SLO evaluator query)."""

    def __init__(self, max_bytes: int = DEFAULT_MAX_BYTES,
                 raw_max: int = DEFAULT_RAW_MAX,
                 tiers: tuple[tuple[float, int], ...] = DEFAULT_TIERS):
        self.max_bytes = max(_SERIES_BYTES, int(max_bytes))
        self.raw_max = max(2, int(raw_max))
        self.tiers = tuple((float(w), max(1, int(c))) for w, c in tiers)
        self._series: dict[tuple[str, Labels], _Series] = {}
        self._bytes = 0
        self._evicted = 0
        self._lock = threading.RLock()

    # -- writes -------------------------------------------------------------

    def append(self, name: str, value: float, labels: Any = (),
               ts: float | None = None, kind: str = "gauge") -> None:
        """Record one sample. ``labels`` may be a dict or pairs; ``ts``
        defaults to the wall clock. Out-of-order timestamps land in the
        raw ring but do not rewrite already-closed downsample buckets."""
        if ts is None:
            import time
            ts = time.time()
        value = float(value)
        key = (name, _labels_key(labels))
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = self._series[key] = _Series(
                    name, key[1], kind, self.raw_max, self.tiers
                )
                self._bytes += _SERIES_BYTES
            if len(s.raw) < self.raw_max:
                self._bytes += _SAMPLE_BYTES
            s.raw.append((ts, value))
            for width, cap, ring in s.tiers:
                start = ts - (ts % width)
                if ring and ring[-1].start == start:
                    ring[-1].fold(ts, value)
                elif not ring or ring[-1].start < start:
                    ring.append(_Bucket(start, ts, value))
                    self._bytes += _BUCKET_BYTES
                    while len(ring) > cap:
                        ring.popleft()
                        self._bytes -= _BUCKET_BYTES
                # ring[-1].start > start: stale timestamp — raw keeps it,
                # the closed bucket stays immutable
            s.last_append = ts
            self._evict_cold(keep=key)

    def ingest(self, snapshot: Any) -> None:
        """Feed one fleet scrape cycle (a FleetSnapshot, duck-typed:
        ``.ts`` + ``.families`` of expfmt Families) — every sample of
        every family becomes a point in its series."""
        ts = snapshot.ts
        for fam in snapshot.families.values():
            kind = fam.kind
            for sample in fam.samples:
                k = kind
                if kind == "histogram":
                    # bucket/count/sum components are all cumulative
                    k = "counter"
                self.append(sample.name, sample.value, sample.labels,
                            ts=ts, kind=k)

    def _evict_cold(self, keep: tuple[str, Labels]) -> None:
        while self._bytes > self.max_bytes and len(self._series) > 1:
            coldest = min(
                (k for k in self._series if k != keep),
                key=lambda k: self._series[k].last_append,
                default=None,
            )
            if coldest is None:
                return
            s = self._series.pop(coldest)
            self._bytes -= (
                _SERIES_BYTES + _SAMPLE_BYTES * len(s.raw)
                + _BUCKET_BYTES * sum(len(r) for _, _, r in s.tiers)
            )
            self._evicted += 1

    # -- series access ------------------------------------------------------

    def _match(self, name: str,
               where: Callable[[dict[str, str]], bool] | None) -> list[_Series]:
        out = []
        for (n, _), s in self._series.items():
            if n != name:
                continue
            if where is None or where(dict(s.labels)):
                out.append(s)
        return out

    def names(self) -> list[str]:
        with self._lock:
            return sorted({n for n, _ in self._series})

    def series_labels(self, name: str) -> list[dict[str, str]]:
        with self._lock:
            return [dict(s.labels) for s in self._match(name, None)]

    def has_samples(self, name: str,
                    where: Callable[[dict[str, str]], bool] | None = None,
                    ) -> bool:
        with self._lock:
            return any(s.raw for s in self._match(name, where))

    def stats(self) -> dict[str, int]:
        with self._lock:
            return {
                "series": len(self._series),
                "bytes_estimated": self._bytes,
                "max_bytes": self.max_bytes,
                "evicted_series": self._evicted,
            }

    # -- per-series sample reconstruction ----------------------------------

    @staticmethod
    def _merged(s: _Series, start: float, end: float
                ) -> list[tuple[float, float]]:
        """Samples in [start, end] merged across resolutions: raw wins
        where it still covers; tier buckets (their last reading) fill in
        the older history the ring already dropped — coarse first so
        finer data overwrites it."""
        points: dict[float, float] = {}
        for _, _, ring in reversed(s.tiers):  # coarsest → finest
            for b in ring:
                if start <= b.last_ts <= end:
                    points[b.last_ts] = b.last
                if start <= b.first_ts <= end:
                    points.setdefault(b.first_ts, b.first)
        for ts, v in s.raw:
            if start <= ts <= end:
                points[ts] = v
        return sorted(points.items())

    def _at_or_before(self, s: _Series, ts: float
                      ) -> tuple[float, float] | None:
        """Newest sample with timestamp ≤ ts, searching raw first and
        then each downsample tier (bucket last-readings)."""
        best: tuple[float, float] | None = None
        for t, v in reversed(s.raw):
            if t <= ts:
                best = (t, v)
                break
        if best is not None:
            return best
        for _, _, ring in s.tiers:  # finest first
            for b in reversed(ring):
                if b.last_ts <= ts:
                    return (b.last_ts, b.last)
                if b.first_ts <= ts:
                    return (b.first_ts, b.first)
        return None

    @staticmethod
    def _first(s: _Series) -> tuple[float, float] | None:
        """The oldest retained reading — coarsest tier first (it reaches
        furthest back), then the raw ring."""
        for _, _, ring in reversed(s.tiers):
            if ring:
                b = ring[0]
                return (b.first_ts, b.first)
        if s.raw:
            return tuple(s.raw[0])
        return None

    def sample_at_or_before(self, name: str, labels: Any, ts: float
                            ) -> tuple[float, float] | None:
        key = (name, _labels_key(labels))
        with self._lock:
            s = self._series.get(key)
            return None if s is None else self._at_or_before(s, ts)

    def first_sample(self, name: str, labels: Any
                     ) -> tuple[float, float] | None:
        key = (name, _labels_key(labels))
        with self._lock:
            s = self._series.get(key)
            return None if s is None else self._first(s)

    def latest(self, name: str,
               where: Callable[[dict[str, str]], bool] | None = None,
               ) -> float | None:
        """Sum of each matching series' newest value (the fleet-wide
        instant, like FleetSnapshot.value_sum but from history)."""
        with self._lock:
            vals = [s.raw[-1][1] for s in self._match(name, where) if s.raw]
        return sum(vals) if vals else None

    def window(self, name: str, start: float, end: float,
               where: Callable[[dict[str, str]], bool] | None = None,
               ) -> list[tuple[dict[str, str], list[tuple[float, float]]]]:
        """Per-series samples over [start, end] — what ``get history``
        renders."""
        with self._lock:
            return [
                (dict(s.labels), self._merged(s, start, end))
                for s in self._match(name, where)
            ]

    # -- PromQL-style verbs -------------------------------------------------

    def _series_span(self, s: _Series, window: float, now: float
                     ) -> list[tuple[float, float]]:
        """The window's samples plus the baseline reading just before it
        (so an increase over the window has its left edge)."""
        start = now - window
        samples = self._merged(s, start, now)
        baseline = self._at_or_before(s, start)
        if baseline is not None and (not samples or baseline[0] < samples[0][0]):
            samples.insert(0, baseline)
        return samples

    def increase(self, name: str, window: float, now: float,
                 where: Callable[[dict[str, str]], bool] | None = None,
                 ) -> float | None:
        """Counter increase over [now - window, now] summed across
        matching series, reset-aware. None when no series has two
        readings to difference."""
        total, found = 0.0, False
        with self._lock:
            for s in self._match(name, where):
                span = self._series_span(s, window, now)
                if len(span) < 2:
                    continue
                total += _reset_aware_increase(span)
                found = True
        return total if found else None

    def rate_over_time(self, name: str, window: float, now: float,
                       where: Callable[[dict[str, str]], bool] | None = None,
                       ) -> float | None:
        """Per-second rate over the window: each series' increase over
        the span its data actually covers (cold starts and ``--once``
        seeds must not be diluted by an empty window), summed."""
        total, found = 0.0, False
        with self._lock:
            for s in self._match(name, where):
                span = self._series_span(s, window, now)
                if len(span) < 2:
                    continue
                elapsed = span[-1][0] - span[0][0]
                if elapsed <= 0 or not math.isfinite(elapsed):
                    continue
                total += _reset_aware_increase(span) / elapsed
                found = True
        return total if found else None

    def avg_over_time(self, name: str, window: float, now: float,
                      where: Callable[[dict[str, str]], bool] | None = None,
                      ) -> float | None:
        """Mean of every matching sample in the window (gauges)."""
        vals: list[float] = []
        with self._lock:
            for s in self._match(name, where):
                vals.extend(v for _, v in self._merged(s, now - window, now))
        return sum(vals) / len(vals) if vals else None

    def max_over_time(self, name: str, window: float, now: float,
                      where: Callable[[dict[str, str]], bool] | None = None,
                      ) -> float | None:
        """Max over the window — consults downsample buckets' vmax so a
        spike that fell off the raw ring still answers."""
        best: float | None = None
        start = now - window
        with self._lock:
            for s in self._match(name, where):
                for _, v in self._merged(s, start, now):
                    if best is None or v > best:
                        best = v
                for _, _, ring in s.tiers:
                    for b in ring:
                        if b.last_ts >= start and b.first_ts <= now:
                            if best is None or b.vmax > best:
                                best = b.vmax
        return best

    def quantile_over_time(self, name: str, q: float, window: float,
                           now: float,
                           where: Callable[[dict[str, str]], bool] | None = None,
                           ) -> float | None:
        """Histogram quantile from per-``le`` bucket increases over the
        window (the family's ``<name>_bucket`` series), interpolated by
        expfmt — the windowed sibling of FleetSnapshot.quantile."""
        acc: dict[float, float] = {}
        with self._lock:
            for s in self._match(f"{name}_bucket", where):
                le = expfmt.parse_value(dict(s.labels).get("le", "+Inf"))
                span = self._series_span(s, window, now)
                if len(span) < 2:
                    continue
                acc[le] = acc.get(le, 0.0) + _reset_aware_increase(span)
        if not acc:
            return None
        return expfmt.bucket_quantile(sorted(acc.items()), q)

    def binned(self, name: str, window: float, now: float, bins: int = 8,
               mode: str = "value",
               where: Callable[[dict[str, str]], bool] | None = None,
               ) -> list[float | None]:
        """The window cut into ``bins`` equal slots, oldest first — the
        sparkline feed. ``mode="value"``: per-bin mean of gauge samples.
        ``mode="rate"``: per-bin per-second counter increase (reset-
        aware), each inter-sample delta attributed to the bin holding
        the later sample. Bins with no data are None."""
        bins = max(1, int(bins))
        width = window / bins
        start = now - window
        sums = [0.0] * bins
        counts = [0] * bins
        with self._lock:
            for s in self._match(name, where):
                span = self._series_span(s, window, now)
                if mode == "rate":
                    if len(span) < 2:
                        continue
                    prev_ts, prev_v = span[0]
                    for ts, v in span[1:]:
                        d = v - prev_v
                        inc = v if d < 0 else d
                        i = min(bins - 1, max(0, int((ts - start) / width)))
                        sums[i] += inc
                        counts[i] += 1
                        prev_ts, prev_v = ts, v
                else:
                    for ts, v in span:
                        if ts < start:
                            continue
                        i = min(bins - 1, max(0, int((ts - start) / width)))
                        sums[i] += v
                        counts[i] += 1
        if mode == "rate":
            return [
                (sums[i] / width) if counts[i] else None for i in range(bins)
            ]
        return [
            (sums[i] / counts[i]) if counts[i] else None for i in range(bins)
        ]

    def tail(self, name: str, n: int = 32,
             where: Callable[[dict[str, str]], bool] | None = None,
             ) -> list[dict[str, Any]]:
        """The last ``n`` raw samples of every matching series — what a
        flight-recorder dump embeds so a postmortem carries the recent
        timeline, not just the final instant."""
        out = []
        with self._lock:
            for s in self._match(name, where):
                recent = list(s.raw)[-max(0, int(n)):]
                out.append({
                    "name": s.name,
                    "labels": dict(s.labels),
                    "kind": s.kind,
                    "samples": [[round(t, 3), v] for t, v in recent],
                })
        return out


# -- presentation helpers (shared by monitor and `get history`) -------------

SPARK_BARS = "▁▂▃▄▅▆▇█"


def sparkline(values: Iterable[float | None]) -> str:
    """Unicode sparkline, scaled to the series' own max; None (no data
    in that slot) renders as '·' so gaps — a dead target's cycles — stay
    visible instead of reading as zero."""
    vals = list(values)
    finite = [v for v in vals if v is not None and math.isfinite(v)]
    top = max(finite) if finite else 0.0
    chars = []
    for v in vals:
        if v is None or not math.isfinite(v):
            chars.append("·")
        elif top <= 0:
            chars.append(SPARK_BARS[0])
        else:
            idx = int(v / top * (len(SPARK_BARS) - 1) + 0.5)
            chars.append(SPARK_BARS[max(0, min(len(SPARK_BARS) - 1, idx))])
    return "".join(chars)
