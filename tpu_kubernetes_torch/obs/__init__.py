"""The port's serving observability (copies of the reference's JAX-free
``tpu_kubernetes/obs/`` modules, and a profiler rewritten for CUDA):

* :mod:`~tpu_kubernetes_torch.obs.metrics`: Prometheus-style counters,
  gauges and histograms in the process-wide :data:`REGISTRY`, served at
  ``GET /metrics``.
* :mod:`~tpu_kubernetes_torch.obs.events`: JSONL structured events with
  run and span correlation (``TPU_K8S_EVENTS=<path>``).
* :mod:`~tpu_kubernetes_torch.obs.faults`: the seeded fault injector
  (``TPU_K8S_FAULTS``).
* :mod:`~tpu_kubernetes_torch.obs.tracing`: W3C ``traceparent``, head and
  tail sampling, the bounded span exporter (``TPU_K8S_TRACE_*``).
* :mod:`~tpu_kubernetes_torch.obs.ledger`: the goodput ledger (token
  classes, bubble, the engine's segment timeline).
* :mod:`~tpu_kubernetes_torch.obs.profile`: the phase profiler (compile =
  a program's first call, execute = a replay), timed by CUDA events on
  the card, with an analytic roofline.

The engine's black box and the fleet-scope layers under it (imported
lazily, copies of the reference's modules):

* :mod:`~tpu_kubernetes_torch.obs.expfmt`: the parser and renderer of the
  text exposition, round-trip safe.
* :mod:`~tpu_kubernetes_torch.obs.tsdb`: the byte-capped history store
  with its downsample tiers, queries over time and sparklines.
* :mod:`~tpu_kubernetes_torch.obs.aggregate`: :class:`FleetSnapshot` and
  its queries, and the concurrent ``/metrics`` scraper.
* :mod:`~tpu_kubernetes_torch.obs.slo`: sliding-window SLOs with
  multi-window burn-rate alerting over the history store.
* :mod:`~tpu_kubernetes_torch.obs.flightrec`: the engine's flight
  recorder: a record a segment, redacted postmortems dumped atomically on
  a reset, a hard-fail and a drain (``GET /debug/flightrec``).
* :mod:`~tpu_kubernetes_torch.obs.alerts`: the rule-driven alert manager,
  the engine-local tripwires (``GET /debug/alerts``) and the sinks.
* :mod:`~tpu_kubernetes_torch.obs.incidents`: the incident correlator
  grouping alerts and dumps into bundles.

The fleet monitor and controller (``obs/monitor.py``,
``obs/controller.py``) stay the reference's: HTTP clients that scrape
the port's server as they scrape the reference's.
"""

from tpu_kubernetes_torch.obs.metrics import (  # noqa: F401
    CONTENT_TYPE,
    DEFAULT_BUCKETS,
    REGISTRY,
    Counter,
    Gauge,
    Histogram,
    MetricError,
    Registry,
)
from tpu_kubernetes_torch.obs import events  # noqa: F401
