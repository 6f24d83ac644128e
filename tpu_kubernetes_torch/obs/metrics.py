"""Dependency-free Prometheus-style metrics registry.

The port's copy of ``tpu_kubernetes/obs/metrics.py`` (the port imports nothing of
the JAX package): the same names, families and behaviour.

The reference provisioner has no observability beyond bare fmt.Println
progress lines (SURVEY §5.1/§5.5); the serving/training stack here needs
request-level metrics to be operable at all (ROADMAP north star). This is
the one process-wide place those numbers live:

* :class:`Counter`, :class:`Gauge`, :class:`Histogram` — with labels,
  thread-safe, zero dependencies (stdlib only — the serve path must stay
  air-gap friendly, same stance as serve/server.py).
* Text exposition in the Prometheus format, so ``GET /metrics`` on the
  inference server (serve/server.py) and ``tpu-k8s get metrics`` are
  scrape-ready without a client library.
* :meth:`Registry.snapshot` — the same numbers as plain JSON, which is
  what run reports persist (util/runlog.py).

Metric families are get-or-create: instrumentation sites call
``REGISTRY.counter(...)`` every time and always receive the same family,
so import order never matters and tests can reset the registry wholesale.
"""

from __future__ import annotations

import math
import threading
from bisect import bisect_left
from typing import Any, Iterable

# Prometheus' default latency buckets, extended upward: terraform applies
# and TPU compiles legitimately take minutes, and a histogram whose last
# finite bucket is 10s would flatten exactly the tail being tuned.
DEFAULT_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
    30.0, 60.0, 120.0, 300.0, 600.0,
)


def _escape_label(value: str) -> str:
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace("\"", "\\\"")
        .replace("\n", "\\n")
    )


def _format_value(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


def _label_str(names: tuple[str, ...], values: tuple[str, ...],
               extra: str = "") -> str:
    pairs = [
        f'{n}="{_escape_label(v)}"' for n, v in zip(names, values)
    ]
    if extra:
        pairs.append(extra)
    return "{" + ",".join(pairs) + "}" if pairs else ""


class MetricError(ValueError):
    pass


class _Child:
    """One labeled time series. Updates lock on the parent family's mutex
    (updates are a few arithmetic ops; one lock per family keeps the
    memory overhead O(families), not O(series))."""

    __slots__ = ("_family",)

    def __init__(self, family: _Family):
        self._family = family


class _CounterChild(_Child):
    __slots__ = ("value",)

    def __init__(self, family: _Family):
        super().__init__(family)
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise MetricError("counters only go up — use a Gauge")
        with self._family._lock:
            self.value += amount


class _GaugeChild(_Child):
    __slots__ = ("value",)

    def __init__(self, family: _Family):
        super().__init__(family)
        self.value = 0.0

    def set(self, value: float) -> None:
        with self._family._lock:
            self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._family._lock:
            self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)


class _HistogramChild(_Child):
    __slots__ = ("counts", "sum", "count", "exemplars")

    def __init__(self, family: _Family):
        super().__init__(family)
        self.counts = [0] * (len(family.buckets) + 1)  # +1: the +Inf bucket
        self.sum = 0.0
        self.count = 0
        # bucket index -> (trace_id, observed value): the latest exemplar
        # per bucket, so a p99 bucket links to a real slow trace
        self.exemplars: dict[int, tuple[str, float]] = {}

    def observe(self, value: float, exemplar: str | None = None) -> None:
        v = float(value)
        i = bisect_left(self._family.buckets, v)
        with self._family._lock:
            self.counts[i] += 1
            self.sum += v
            self.count += 1
            if exemplar:
                self.exemplars[i] = (str(exemplar), v)


_CHILD_TYPES = {
    "counter": _CounterChild,
    "gauge": _GaugeChild,
    "histogram": _HistogramChild,
}


class _Family:
    """One named metric family: its children keyed by label values."""

    def __init__(self, name: str, help: str, kind: str,
                 labelnames: tuple[str, ...],
                 buckets: tuple[float, ...] = ()):
        self.name = name
        self.help = help
        self.kind = kind
        self.labelnames = labelnames
        self.buckets = tuple(sorted(buckets)) if kind == "histogram" else ()
        self._lock = threading.Lock()
        self._children: dict[tuple[str, ...], _Child] = {}
        if not labelnames:
            # unlabeled families still have exactly one series — exposed
            # directly so call sites write ``family.inc()`` not
            # ``family.labels().inc()``
            self._children[()] = _CHILD_TYPES[kind](self)

    def labels(self, *values: Any, **kwargs: Any) -> Any:
        if kwargs:
            if values:
                raise MetricError("pass labels positionally or by name, not both")
            try:
                values = tuple(kwargs[n] for n in self.labelnames)
            except KeyError as e:
                raise MetricError(
                    f"{self.name}: missing label {e.args[0]!r} "
                    f"(wants {list(self.labelnames)})"
                ) from None
            if len(kwargs) != len(self.labelnames):
                extra = set(kwargs) - set(self.labelnames)
                raise MetricError(f"{self.name}: unknown labels {sorted(extra)}")
        if len(values) != len(self.labelnames):
            raise MetricError(
                f"{self.name} wants labels {list(self.labelnames)}, "
                f"got {len(values)} values"
            )
        key = tuple(str(v) for v in values)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = _CHILD_TYPES[self.kind](self)
        return child

    # unlabeled convenience: family IS the single child
    def _solo(self) -> Any:
        if self.labelnames:
            raise MetricError(
                f"{self.name} has labels {list(self.labelnames)} — "
                "call .labels(...) first"
            )
        return self._children[()]

    def inc(self, amount: float = 1.0) -> None:
        self._solo().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._solo().dec(amount)

    def set(self, value: float) -> None:
        self._solo().set(value)

    def observe(self, value: float, exemplar: str | None = None) -> None:
        self._solo().observe(value, exemplar)

    @property
    def value(self) -> float:
        return self._solo().value

    # -- exposition --------------------------------------------------------

    def render(self) -> str:
        lines = [
            f"# HELP {self.name} {self.help}",
            f"# TYPE {self.name} {self.kind}",
        ]
        with self._lock:
            items = sorted(self._children.items())
            for key, child in items:
                if self.kind == "histogram":
                    acc = 0
                    for i, (bound, n) in enumerate(zip(
                        (*self.buckets, math.inf), child.counts
                    )):
                        acc += n
                        le = _format_value(bound)
                        labels = _label_str(
                            self.labelnames, key, extra=f'le="{le}"'
                        )
                        line = f"{self.name}_bucket{labels} {acc}"
                        ex = child.exemplars.get(i)
                        if ex is not None:
                            # OpenMetrics exemplar: trace id riding the
                            # bucket the observation landed in
                            line += (
                                f' # {{trace_id="{ex[0]}"}} '
                                f"{_format_value(ex[1])}"
                            )
                        lines.append(line)
                    labels = _label_str(self.labelnames, key)
                    lines.append(
                        f"{self.name}_sum{labels} {_format_value(child.sum)}"
                    )
                    lines.append(f"{self.name}_count{labels} {child.count}")
                else:
                    labels = _label_str(self.labelnames, key)
                    lines.append(
                        f"{self.name}{labels} {_format_value(child.value)}"
                    )
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict[str, Any]:
        with self._lock:
            samples = []
            for key, child in sorted(self._children.items()):
                labels = dict(zip(self.labelnames, key))
                if self.kind == "histogram":
                    samples.append({
                        "labels": labels,
                        "count": child.count,
                        "sum": round(child.sum, 6),
                    })
                else:
                    samples.append({"labels": labels, "value": child.value})
        return {"type": self.kind, "samples": samples}


# public aliases — what instrumentation sites name in annotations
Counter = _Family
Gauge = _Family
Histogram = _Family


class Registry:
    """Process-wide family store; families are created once and shared."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: dict[str, _Family] = {}

    def _get_or_create(self, name: str, help: str, kind: str,
                       labelnames: Iterable[str],
                       buckets: tuple[float, ...] = ()) -> _Family:
        labelnames = tuple(labelnames)
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind or fam.labelnames != labelnames:
                    raise MetricError(
                        f"metric {name!r} re-registered as {kind} with labels "
                        f"{list(labelnames)} (was {fam.kind} "
                        f"{list(fam.labelnames)})"
                    )
                return fam
            fam = _Family(name, help, kind, labelnames, buckets)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "",
                labelnames: Iterable[str] = ()) -> Counter:
        return self._get_or_create(name, help, "counter", labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Iterable[str] = ()) -> Gauge:
        return self._get_or_create(name, help, "gauge", labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Iterable[str] = (),
                  buckets: tuple[float, ...] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(
            name, help, "histogram", labelnames, buckets=buckets
        )

    def families(self) -> list[str]:
        with self._lock:
            return sorted(self._families)

    def render(self) -> str:
        """Prometheus text exposition (format version 0.0.4) of every
        family, name-ordered so output is diffable/golden-testable."""
        with self._lock:
            fams = [self._families[n] for n in sorted(self._families)]
        return "".join(f.render() for f in fams)

    def snapshot(self, prefix: str = "") -> dict[str, Any]:
        """The registry as plain JSON-ready data; ``prefix`` filters to
        one subsystem (run reports persist only the terraform families)."""
        with self._lock:
            fams = {
                n: f for n, f in self._families.items()
                if n.startswith(prefix)
            }
        return {n: fams[n].snapshot() for n in sorted(fams)}

    def reset(self) -> None:
        """Drop every family — test isolation only."""
        with self._lock:
            self._families.clear()


# the process-wide default registry: the serve server exposes it at
# GET /metrics, the CLI dumps it via `get metrics`, run reports snapshot it
REGISTRY = Registry()

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def register_build_info(registry: Registry | None = None) -> Gauge:
    """The Prometheus ``*_info`` idiom: a constant-1 gauge whose labels
    carry the facts — here the package version, so a fleet scrape
    (obs/aggregate.py keeps all families, instance-tagged) can answer
    "which workers run which build" during a rollout."""
    import tpu_kubernetes_torch

    fam = (registry if registry is not None else REGISTRY).gauge(
        "tpu_k8s_build_info",
        "build/version info; constant 1 — the version rides the label",
        labelnames=("version",),
    )
    fam.labels(tpu_kubernetes_torch.__version__).set(1.0)
    return fam


BUILD_INFO = register_build_info()
