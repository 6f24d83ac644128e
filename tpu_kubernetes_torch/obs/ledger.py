"""Goodput accounting: every decoded token classified exactly once.

The port's copy of ``tpu_kubernetes/obs/ledger.py`` (the port imports nothing of
the JAX package): the same names, families and behaviour.

The serving stack deliberately throws work away — shed requests,
deadline-expired slots, mid-decode cancellations, slot-engine rows
decoding past their done mask — but until now nothing said how much of
the device's output was *useful*. This module is the ledger the serve
path feeds (PAPERS.md: the Gemma-on-Cloud-TPU comparison is framed
around MFU and tokens-per-dollar; Podracer makes utilization accounting
the organizing principle): a conservation law over decoded tokens,

    ``tpu_serve_tokens_emitted_total == sum(tpu_serve_tokens_total{class=*})``

held at quiescence for every serve path. Production is counted at the
production sites (a prefill's sampled token, a decode segment's
``steps x rows`` grid) and settlement at the terminal sites (delivery,
cancellation, expiry, fail-out), so a dropped settlement *breaks the
invariant* instead of silently flattering goodput — the chaos test in
tests/test_faults.py exists to catch exactly that.

Classes:

* ``useful``     — delivered to a client.
* ``cancelled``  — client disconnected / request cancelled mid-decode.
* ``expired``    — request deadline fired after tokens were decoded.
* ``shed-spent`` — prefill (or more) was spent, then the entry was
  failed out (engine reset, insert failure).
* ``bubble``     — decoded but never deliverable: slot-engine rows past
  their done mask, empty slots inside a segment, pad rows in a static
  batch, tokens beyond the requested budget, trailing EOS.
* ``speculative-waste`` — verify-window cells whose draft the target
  rejected: the slot engine decodes ``draft_k+1`` candidates per live
  row per verify round and keeps only the accepted prefix (+1
  correction); the rejected remainder is the price of speculation,
  kept distinct from ``bubble`` so acceptance-rate regressions show up
  in the ledger, not just the spec counters.

Device seconds ride the same classes (``tpu_serve_device_seconds_total``)
as best-effort attribution — tokens are the *tested* invariant.

The slot-engine timeline (:meth:`TokenLedger.segment`) additionally
records per-segment (live rows, occupied slots, admitted/drained/reaped)
so ``GET /debug/ledger`` can show intra-segment utilization, and keeps
the running ``tpu_serve_slot_bubble_fraction`` gauge — the fraction of
slot-engine row-steps that decoded nothing a client will see.

No jax import: the CLI renders remote ledgers without an accelerator
stack, and the serve server imports this before jax is up.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request
from collections import deque

from tpu_kubernetes_torch.obs.metrics import REGISTRY, Registry

USEFUL = "useful"
CANCELLED = "cancelled"
EXPIRED = "expired"
SHED_SPENT = "shed-spent"
BUBBLE = "bubble"
SPECULATIVE_WASTE = "speculative-waste"
CLASSES = (USEFUL, CANCELLED, EXPIRED, SHED_SPENT, BUBBLE,
           SPECULATIVE_WASTE)

TIMELINE_MAX = 512


class TokenLedger:
    """Thread-safe token/device-second ledger + slot-engine timeline.

    All mutators clamp to non-negative and never raise on bad input —
    accounting must not take the serving path down. ``reset()`` zeroes
    the internal view and re-binds the metric families (so tests that
    ``REGISTRY.reset()`` get fresh counters; without a registry reset
    the exposition counters stay monotone, as Prometheus requires).
    """

    def __init__(self, registry: Registry | None = None, *,
                 timeline_max: int = TIMELINE_MAX):
        self._registry = registry if registry is not None else REGISTRY
        self._lock = threading.Lock()
        self._timeline_max = timeline_max
        self._zero()
        self._bind()

    def _zero(self) -> None:
        self._emitted = 0
        self._tokens = {c: 0 for c in CLASSES}
        self._seconds = {c: 0.0 for c in CLASSES}
        self._row_steps = 0
        self._live_steps = 0
        self._segments = 0
        self._timeline: deque[dict] = deque(maxlen=self._timeline_max)

    def _bind(self) -> None:
        r = self._registry
        self._tok_fam = r.counter(
            "tpu_serve_tokens_total",
            "decoded tokens by settlement class (useful / cancelled / "
            "expired / shed-spent / bubble); classes sum to "
            "tpu_serve_tokens_emitted_total at quiescence",
            labelnames=("class",),
        )
        self._emit_fam = r.counter(
            "tpu_serve_tokens_emitted_total",
            "decoded tokens produced by the device (the production side "
            "of the goodput conservation law; warm-up excluded)",
        )
        self._sec_fam = r.counter(
            "tpu_serve_device_seconds_total",
            "device seconds attributed by settlement class (best-effort "
            "apportioning; tokens are the conserved quantity)",
            labelnames=("class",),
        )
        self._bubble_gauge = r.gauge(
            "tpu_serve_slot_bubble_fraction",
            "continuous batching: fraction of slot-engine row-steps that "
            "decoded nothing deliverable (empty slots and done rows "
            "inside segments) — cumulative over all segments",
        )
        # pre-create every class child so the full family renders from
        # the first scrape, samples or not (the registry-wide idiom)
        for c in CLASSES:
            self._tok_fam.labels(c)
            self._sec_fam.labels(c)

    # -- production --------------------------------------------------------

    def emitted(self, n: int) -> None:
        """Count ``n`` tokens the device just produced. Called at the
        production sites (prefill sample, decode segment grids) —
        BEFORE anyone decides what the tokens were for."""
        n = int(n)
        if n <= 0:
            return
        with self._lock:
            self._emitted += n
        self._emit_fam.inc(n)

    # -- settlement --------------------------------------------------------

    def settle(self, cls: str, tokens: int = 0,
               device_s: float = 0.0) -> None:
        """Classify ``tokens`` produced earlier (and optionally device
        seconds) under ``cls``. Zero amounts are no-ops."""
        if cls not in self._tokens:
            raise ValueError(f"unknown ledger class {cls!r} "
                             f"(one of {list(CLASSES)})")
        tokens = max(0, int(tokens))
        device_s = max(0.0, float(device_s))
        if tokens:
            with self._lock:
                self._tokens[cls] += tokens
            self._tok_fam.labels(cls).inc(tokens)
        if device_s:
            with self._lock:
                self._seconds[cls] += device_s
            self._sec_fam.labels(cls).inc(device_s)

    def settle_request(self, cls: str, *, delivered: int, decoded: int,
                       device_s: float = 0.0) -> None:
        """One finished request: ``delivered`` tokens under ``cls``, the
        rest of its ``decoded`` raw tokens (budget trim, trailing EOS)
        as bubble."""
        delivered = max(0, int(delivered))
        decoded = max(delivered, int(decoded))
        self.settle(cls, delivered, device_s)
        self.settle(BUBBLE, decoded - delivered)

    def bubble(self, tokens: int, device_s: float = 0.0) -> None:
        self.settle(BUBBLE, tokens, device_s)

    # -- slot-engine timeline ----------------------------------------------

    def segment(self, *, steps: int, slots: int, occupied: int,
                live_steps: int, admitted: int = 0, drained: int = 0,
                reaped: int = 0, seconds: float = 0.0) -> None:
        """Record one slot-engine segment: the device ran
        ``steps x slots`` row-steps, of which ``live_steps`` advanced a
        resident request. Feeds the timeline and the cumulative
        ``tpu_serve_slot_bubble_fraction`` gauge."""
        row_steps = max(0, int(steps)) * max(0, int(slots))
        live_steps = min(max(0, int(live_steps)), row_steps)
        with self._lock:
            self._row_steps += row_steps
            self._live_steps += live_steps
            self._segments += 1
            frac = (1.0 - self._live_steps / self._row_steps
                    if self._row_steps else 0.0)
            self._timeline.append({
                "ts": round(time.time(), 3),
                "steps": int(steps), "slots": int(slots),
                "occupied": int(occupied), "live_steps": live_steps,
                "admitted": int(admitted), "drained": int(drained),
                "reaped": int(reaped),
                "seconds": round(float(seconds), 6),
            })
        self._bubble_gauge.set(round(frac, 6))

    # -- queries -----------------------------------------------------------

    def goodput(self) -> float | None:
        """useful / emitted over the ledger's lifetime, ``None`` before
        any production."""
        with self._lock:
            if not self._emitted:
                return None
            return self._tokens[USEFUL] / self._emitted

    def bubble_fraction(self) -> float | None:
        """Slot-engine row-step bubble fraction, ``None`` before any
        segment ran."""
        with self._lock:
            if not self._row_steps:
                return None
            return 1.0 - self._live_steps / self._row_steps

    def unsettled(self) -> int:
        """Produced-but-unclassified tokens: nonzero only while requests
        are in flight (or when a settlement site has a bug)."""
        with self._lock:
            return self._emitted - sum(self._tokens.values())

    def snapshot(self, timeline: int = 32) -> dict:
        """The ``GET /debug/ledger`` payload (roofline is merged in by
        the server from the profiler)."""
        with self._lock:
            classes = dict(self._tokens)
            seconds = {c: round(v, 6) for c, v in self._seconds.items()}
            emitted = self._emitted
            row_steps, live_steps = self._row_steps, self._live_steps
            segments = self._segments
            tail = list(self._timeline)[-max(0, timeline):]
        gp = classes[USEFUL] / emitted if emitted else None
        bf = 1.0 - live_steps / row_steps if row_steps else None
        return {
            "classes": classes,
            "emitted": emitted,
            "unsettled": emitted - sum(classes.values()),
            "goodput": round(gp, 6) if gp is not None else None,
            "device_seconds": seconds,
            "slot_engine": {
                "segments": segments,
                "row_steps": row_steps,
                "live_steps": live_steps,
                "bubble_fraction": (round(bf, 6)
                                    if bf is not None else None),
            },
            "timeline": tail,
        }

    def reset(self) -> None:
        """Zero the internal view and re-bind families (tests)."""
        with self._lock:
            self._zero()
        self._bind()


# the process-wide ledger the serve server feeds; `get goodput` and the
# chaos conservation test both read it through /debug/ledger
LEDGER = TokenLedger()


def render_ledger(payload: dict) -> str:
    """The ``tpu-kubernetes get goodput`` table for a /debug/ledger
    payload."""
    classes = payload.get("classes") or {}
    seconds = payload.get("device_seconds") or {}
    emitted = payload.get("emitted") or 0
    lines = [f"{'CLASS':<12} {'TOKENS':>10} {'SHARE':>8} {'DEVICE_S':>10}"]
    for cls in CLASSES:
        if cls not in classes:
            continue
        n = classes[cls]
        share = f"{n / emitted:7.1%}" if emitted else "      —"
        lines.append(
            f"{cls:<12} {n:>10} {share:>8} "
            f"{seconds.get(cls, 0.0):>10.4f}")
    gp = payload.get("goodput")
    lines.append(
        f"emitted={emitted} unsettled={payload.get('unsettled', 0)} "
        f"goodput={'—' if gp is None else format(gp, '.1%')}")
    eng = payload.get("slot_engine") or {}
    if eng.get("segments"):
        bf = eng.get("bubble_fraction")
        lines.append(
            f"slot engine: segments={eng['segments']} "
            f"row_steps={eng['row_steps']} live_steps={eng['live_steps']} "
            f"bubble_fraction="
            f"{'—' if bf is None else format(bf, '.3f')}")
    roof = payload.get("roofline") or {}
    progs = roof.get("programs") or {}
    if progs:
        peak = roof.get("peak_flops")
        kind = roof.get("device_kind") or "unknown"
        peak_s = f"{peak:.3g}" if peak else "none"
        lines.append(f"roofline (device={kind} peak_flops={peak_s}):")
        lines.append(
            f"{'PROGRAM':<12} {'FLOPS/TOK':>12} {'BYTES/TOK':>12} "
            f"{'INTENSITY':>10} {'MFU':>8}")
        for name in sorted(progs):
            d = progs[name]
            def _n(v, fmt=".3g"):
                return "—" if v is None else format(v, fmt)
            util = d.get("utilization")
            lines.append(
                f"{name:<12} {_n(d.get('flops_per_token')):>12} "
                f"{_n(d.get('bytes_per_token')):>12} "
                f"{_n(d.get('arithmetic_intensity')):>10} "
                f"{'null' if util is None else format(util, '.2%'):>8}")
    return "\n".join(lines) + "\n"


def fetch_ledger(target: str, timeout: float = 5.0) -> dict:
    """GET ``/debug/ledger`` from ``host:port`` (scheme/path optional,
    mirroring fetch_profile's target normalization)."""
    t = target.strip()
    if "//" not in t:
        t = "http://" + t
    if not t.rstrip("/").endswith("/debug/ledger"):
        t = t.rstrip("/") + "/debug/ledger"
    with urllib.request.urlopen(t, timeout=timeout) as resp:
        return json.loads(resp.read().decode("utf-8", "replace"))
