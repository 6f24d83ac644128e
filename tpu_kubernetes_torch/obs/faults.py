"""Deterministic fault-injection harness for the failure paths.

The port's copy of ``tpu_kubernetes/obs/faults.py`` (the port imports nothing of
the JAX package): the same names, families and behaviour.

The resilience layer (serve/resilience.py, the engine watchdog, the
terraform retry loop, the fleet-scrape backoff) exists to bound what
happens when something breaks — but failure paths that only fire in
production are failure paths that have never run. This module makes
every interesting failure *injectable, deterministic, and cheap*:

* **Named sites.** Code that can fail threads one call through
  ``FAULTS.fire("<site>")`` at the spot where the real failure would
  surface (a prefill OOM, a dead scrape target, a terraform network
  blip). The site vocabulary is closed (:data:`SITES`), so chaos tests
  can enumerate every registered site and a typo'd spec fails loudly
  instead of silently arming nothing.
* **Seeded probability.** ``TPU_K8S_FAULTS="site:prob:seed,…"`` arms a
  site with its own ``random.Random(seed)`` stream — the i-th call to a
  site faults or not as a pure function of (seed, i), so a chaos run is
  exactly reproducible and "prob=0.5" tests assert real interleavings,
  not flakes.
* **Zero cost when off.** ``fire`` is a dict miss when nothing is armed
  — the hot serving path pays one attribute load and one ``if``.

Injected faults raise :class:`FaultError` (a ``RuntimeError``), which
deliberately rides the same handling as a real failure at that site:
nothing anywhere catches FaultError specially, so what the chaos suite
proves about injected faults holds for organic ones.
"""

from __future__ import annotations

import contextlib
import os
import random
import threading

from tpu_kubernetes_torch.obs import REGISTRY

ENV_VAR = "TPU_K8S_FAULTS"

# the closed site vocabulary — one name per instrumented failure point.
# Adding a site = add it here AND thread fire() through the code path;
# chaos tests iterate this set, and the static contracts pass
# (`tpu-kubernetes analyze`, docs/guide/static-analysis.md) fails CI on
# a site that exists only here (fault-site-unfired) or only in code
# (fault-site-unknown) — no run required to catch the drift.
SITES = frozenset({
    "serve.prefill",        # prefill/prefill_resume (solo + slot admission)
    "serve.slot_insert",    # _ContinuousEngine._insert (cache graft)
    "serve.segment",        # _ContinuousEngine._run_segment (decode step)
    "serve.spec_verify",    # _ContinuousEngine speculative verify round
    "serve.shard_segment",  # _run_segment under SERVE_MESH (sharded program)
    "serve.prefix_insert",  # prefix KV-cache store insert (best-effort)
    "serve.page_alloc",     # PagePool.allocate (paged admission/top-up)
    "fleet.scrape",         # FleetAggregator per-target fetch
    "fleet.remediate",      # FleetController actuation (obs/controller.py)
    "shell.terraform",      # TerraformExecutor subprocess run
    "obs.alert_sink",       # alert notification delivery (obs/alerts.py)
    "obs.trace_export",     # span exporter delivery (obs/tracing.py)
})

FAULTS_INJECTED = REGISTRY.counter(
    "tpu_k8s_faults_injected_total",
    "faults injected by the TPU_K8S_FAULTS harness, by site "
    "(nonzero outside a chaos run means the env leaked into prod)",
    labelnames=("site",),
)


class FaultError(RuntimeError):
    """An injected fault — handled exactly like the organic failure at
    the same site (nothing catches this class specially by design)."""


class _Arm:
    __slots__ = ("prob", "rng")

    def __init__(self, prob: float, seed: int):
        self.prob = prob
        self.rng = random.Random(seed)


class FaultInjector:
    """Process-wide injector; armed from ``TPU_K8S_FAULTS`` at import
    and re-armable from tests (:meth:`configure` / :func:`injected`)."""

    def __init__(self, spec: str | None = None):
        self._lock = threading.Lock()
        self._arms: dict[str, _Arm] = {}
        if spec:
            self.configure(spec)

    def configure(self, spec: str | None) -> None:
        """Arm sites from a ``site:prob[:seed],…`` spec (seed defaults
        to 0). Replaces the whole previous arming; unknown sites and
        out-of-range probabilities are loud errors — a chaos run that
        silently tests nothing is worse than no run."""
        arms: dict[str, _Arm] = {}
        for part in (spec or "").split(","):
            part = part.strip()
            if not part:
                continue
            fields = part.split(":")
            if len(fields) not in (2, 3):
                raise ValueError(
                    f"{ENV_VAR}: {part!r} is not site:prob[:seed]"
                )
            site = fields[0].strip()
            if site not in SITES:
                raise ValueError(
                    f"{ENV_VAR}: unknown fault site {site!r} "
                    f"(registered: {sorted(SITES)})"
                )
            prob = float(fields[1])
            if not 0.0 <= prob <= 1.0:
                raise ValueError(
                    f"{ENV_VAR}: {site} probability {prob} not in [0, 1]"
                )
            seed = int(fields[2]) if len(fields) == 3 else 0
            arms[site] = _Arm(prob, seed)
        with self._lock:
            self._arms = arms

    def clear(self) -> None:
        with self._lock:
            self._arms = {}

    def armed(self, site: str | None = None) -> bool:
        with self._lock:
            return bool(self._arms) if site is None else site in self._arms

    def fire(self, site: str) -> None:
        """Raise :class:`FaultError` if ``site`` is armed and its seeded
        stream says this call faults. No-op (one dict check) otherwise."""
        if not self._arms:       # fast path: nothing armed anywhere
            return
        with self._lock:
            arm = self._arms.get(site)
            if arm is None:
                return
            hit = arm.prob > 0.0 and arm.rng.random() < arm.prob
        if hit:
            FAULTS_INJECTED.labels(site).inc()
            raise FaultError(f"injected fault at {site}")


# the process-wide injector: serve/fleet/shell code fires through this
FAULTS = FaultInjector(os.environ.get(ENV_VAR))


@contextlib.contextmanager
def injected(spec: str):
    """Test helper: arm ``spec`` for the block, always disarm after."""
    FAULTS.configure(spec)
    try:
        yield FAULTS
    finally:
        FAULTS.clear()
