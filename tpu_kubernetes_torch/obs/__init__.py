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

The flight recorder, alerts, incidents, SLOs and the fleet aggregator
are not ported yet (ROADMAP.md queue 1 item 3.5b).
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
