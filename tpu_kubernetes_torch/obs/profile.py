"""Phase profiling: compile-vs-execute attribution, device memory and an
analytic roofline (the port of ``tpu_kubernetes/obs/profile.py``, rewritten
for PyTorch and CUDA).

The metrics layer (obs/metrics.py) answers *what* is slow; this module
answers *why*. A program's first call pays for what a replay does not
(the eager warm-up that builds the kernel libraries, and the CUDA-graph
capture: ``util/graphs.py``'s :class:`Program`), so :class:`PhaseProfiler`
keeps the two apart:

* ``phase(name, key=...)`` times a block and classifies it as
  ``mode="compile"`` (the first time this ``key`` runs, or ``first=True``
  from the program itself) or ``mode="execute"`` (a replay). With a CUDA
  ``device`` (the current CUDA device: a server's) the block is timed by
  two CUDA events on its current stream (the second recorded at
  :meth:`PhaseHandle.sync`, after the block's work is enqueued) and read
  back once the end event has completed, at a later profiler call: the
  profiler adds no host–device synchronisation to the timed path. Elsewhere the block is timed on the host clock, after
  :func:`_block_until_ready` on the synced value.
* Records carry :func:`device_memory_stats` (the allocator's bytes in use
  and peak, and the card's memory; ``None`` on the CPU), sampled at most
  once every :data:`HBM_SAMPLE_S` (a sample reads the allocator's whole
  statistics, a cost a decode segment would feel; the reference samples
  at every record).
* Pre-measured durations (the engine's segment, timed by events that the
  segment's own readback completes) go in via :meth:`~PhaseProfiler.observe`.
* Stats land in three sinks at once: a per-(phase, mode) histogram in the
  process REGISTRY, an exact running aggregate for
  :meth:`~PhaseProfiler.summary` (the ``GET /debug/profile`` payload) and,
  when a ``tracer`` is passed, a child span whose ``meta`` carries the mode
  and device seconds.

The roofline is analytic (:func:`program_cost`): FLOPs and bytes of one
call counted from the model's config and the program's shapes and
admitted positions, the same work whatever implements it (kernel or plain
version). The reference reads XLA's cost model instead, so the two
``flops_per_token`` differ by design.
"""

from __future__ import annotations

import contextlib
import functools
import json
import threading
import time
import urllib.request
from collections import deque
from dataclasses import dataclass, field

import torch

from tpu_kubernetes_torch.obs.metrics import DEFAULT_BUCKETS, REGISTRY, Registry

COMPILE = "compile"
EXECUTE = "execute"
# seconds between two samples of the allocator's statistics
HBM_SAMPLE_S = 1.0


def _tensors(value):
    """The tensors of ``value`` (a tensor, or nested tuples, lists and dicts
    of them)."""
    if isinstance(value, torch.Tensor):
        yield value
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _tensors(v)
    elif isinstance(value, dict):
        for v in value.values():
            yield from _tensors(v)


def _block_until_ready(value) -> None:
    """Wait for the device work behind ``value``: for each CUDA device it
    lives on, an event recorded on that device's current stream and
    synchronised on, so other streams are not drained. A no-op for host
    values and CPU tensors; never raises."""
    try:
        devices = {t.device for t in _tensors(value) if t.is_cuda}
        for device in devices:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(device))
            ev.synchronize()
    except Exception:
        # a timing probe must not become a crash
        pass


def _is_cuda(device) -> bool:
    if isinstance(device, torch.device):
        return device.type == "cuda"
    return device is not None and torch.device(device).type == "cuda"


_TOTAL_MEMORY: dict = {}


def device_memory_stats(device=None):
    """The caching allocator's ``{"bytes_in_use", "peak_bytes_in_use",
    "bytes_limit"}`` on a CUDA ``device`` (``torch.cuda.memory_stats``; the
    limit is the card's memory from ``torch.cuda.mem_get_info``, read
    once), or ``None`` on the CPU or on any error: profiling never takes
    the profiled process down."""
    if not _is_cuda(device):
        return None
    try:
        device = torch.device(device)
        stats = torch.cuda.memory_stats(device)
        if device not in _TOTAL_MEMORY:
            _TOTAL_MEMORY[device] = int(torch.cuda.mem_get_info(device)[1])
        return {
            "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak",
                                               0)),
            "bytes_limit": _TOTAL_MEMORY[device],
        }
    except Exception:
        return None


# analytical roofline: dense bf16 peak FLOP/s per accelerator, matched by
# substring against the device kind (the reference's table; "h100"
# matches torch.cuda.get_device_name's "NVIDIA H100 80GB HBM3"). CPU and
# unknown devices get None: utilization degrades to null while FLOPs per
# token (an analytic count) stays exact everywhere.
PEAK_FLOPS = (
    ("v6e", 918e12),
    ("v5p", 459e12),
    ("v5 lite", 197e12),
    ("v5litepod", 197e12),
    ("v5e", 197e12),
    ("v4", 275e12),
    ("v3", 123e12),
    ("h100", 989e12),
    ("a100", 312e12),
)


def device_kind(device=None) -> str | None:
    """The device's kind string: ``torch.cuda.get_device_name`` on a CUDA
    device, ``"cpu"`` on the CPU (``None``: the current CUDA device where
    there is one, else the CPU)."""
    try:
        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        if not _is_cuda(device):
            return "cpu"
        return str(torch.cuda.get_device_name(torch.device(device)))
    except Exception:
        return None


def backend_peak_flops(kind: str | None = None) -> float | None:
    """Dense bf16 peak FLOP/s for ``kind``, or ``None`` on the CPU or
    unknown hardware."""
    kind = kind if kind is not None else device_kind()
    if not kind:
        return None
    k = kind.lower()
    if "cpu" in k:
        return None
    for sub, peak in PEAK_FLOPS:
        if sub in k:
            return peak
    return None


@functools.lru_cache(maxsize=64)
def matmul_params(cfg) -> int:
    """Parameters one token multiplies through: the attention projections,
    the MLP (for an MoE config, ``experts_per_token`` experts and the
    router) and the LM head. The embedding is a gather, not a matmul."""
    d, L = cfg.d_model, cfg.n_layers
    h, kv, hd, ff = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
    attn = d * h * hd + 2 * d * kv * hd + h * hd * d
    n_experts = getattr(cfg, "n_experts", None)
    if n_experts is None:
        mlp = 3 * d * ff
    else:
        mlp = cfg.experts_per_token * 3 * d * ff + d * n_experts
    return L * (attn + mlp) + d * cfg.vocab_size


@functools.lru_cache(maxsize=64)
def weight_bytes(cfg) -> int:
    """Bytes of every matmul weight (all experts of an MoE config) in the
    config's dtype: what one call reads at least once."""
    d, L = cfg.d_model, cfg.n_layers
    h, kv, hd, ff = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
    attn = d * h * hd + 2 * d * kv * hd + h * hd * d
    mlp = 3 * d * ff * getattr(cfg, "n_experts", 1)
    return (L * (attn + mlp) + d * cfg.vocab_size) * cfg.dtype.itemsize


def program_cost(cfg, *, tokens: int, attended: int,
                 kv_positions: int, weight_nbytes: int | None = None,
                 kv_quant: bool = False) -> dict:
    """The analytic cost of one program call over the model ``cfg``:

    * ``flops`` = 2 · :func:`matmul_params` · ``tokens`` (the parameter
      matmuls of every token the call runs, pad rows included) + 4 ·
      n_layers · n_heads · head_dim · ``attended`` (QKᵀ and PV, where
      ``attended`` sums, over the call's query tokens, the cache positions
      each one attends);
    * ``bytes`` = the weights' bytes (:func:`weight_bytes`, or
      ``weight_nbytes`` where the weights are int8: their int8 values and
      f32 scales, ``models/quant.py`` ``matmul_weight_bytes``) +
      ``kv_positions`` cached positions of K and V over every layer, each
      read once (an int8 cache, ``kv_quant``: a byte a value plus an f32
      scale a position and KV head).

    Counted from the config and the program's shapes and admitted
    positions, so a kernel and its plain version do the same work; the
    FLOPs do not depend on how the weights or the cache are stored."""
    L, h, hd = cfg.n_layers, cfg.n_heads, cfg.head_dim
    per_head = hd + 4 if kv_quant else hd * cfg.dtype.itemsize
    kv_bytes = 2 * L * cfg.n_kv_heads * per_head
    weights = weight_bytes(cfg) if weight_nbytes is None else weight_nbytes
    return {
        "flops": float(2 * matmul_params(cfg) * tokens
                       + 4 * L * h * hd * attended),
        "bytes": float(weights + kv_bytes * kv_positions),
    }


@dataclass
class PhaseHandle:
    """Yielded by :meth:`PhaseProfiler.phase`; call :meth:`sync` on the
    block's device outputs once their work is enqueued."""

    name: str
    mode: str
    _pending: object = None
    # on an event-timed phase: [the CUDA end event, recorded yet]
    _end: object = None

    def sync(self, value):
        """Mark the end of the block's device work: on an event-timed phase
        the end event is recorded now (no wait), elsewhere ``value`` is
        waited for before the clock stops. Returns ``value``."""
        self._pending = value
        if self._end is not None and not self._end[1]:
            self._end[0].record()
            self._end[1] = True
        return value


@dataclass
class _Stat:
    count: int = 0
    total: float = 0.0
    min: float = float("inf")
    max: float = 0.0
    last: float = 0.0

    def add(self, seconds: float, calls: int = 1) -> None:
        self.count += calls
        self.total += seconds
        per = seconds / max(1, calls)
        self.min = min(self.min, per)
        self.max = max(self.max, per)
        self.last = per

    def as_dict(self) -> dict:
        return {
            "count": self.count,
            "total_seconds": round(self.total, 6),
            "mean_seconds": round(self.total / max(1, self.count), 6),
            "min_seconds": round(self.min, 6),
            "max_seconds": round(self.max, 6),
            "last_seconds": round(self.last, 6),
        }


@dataclass
class PhaseRecord:
    name: str
    mode: str
    seconds: float
    ts: float
    meta: dict = field(default_factory=dict)
    hbm: dict | None = None


class PhaseProfiler:
    """Thread-safe phase timer with first-call (compile) detection.

    ``key`` identifies *a program*: the first ``phase()`` entry for a given
    ``(name, key)`` is recorded as ``mode="compile"``, every later one as
    ``mode="execute"``; a caller that knows better (a :class:`Program`'s
    ``captures``) passes ``first``. A block that raises does not consume
    first-call status. ``device`` (or the profiler's own, which the server
    binds) says how blocks are timed: by CUDA events on a CUDA device, by
    the host clock elsewhere."""

    def __init__(self, registry: Registry | None = None, *,
                 metric: str = "tpu_profile_phase_seconds",
                 help: str = "device-synced phase seconds by compile/execute mode",
                 max_records: int = 2048,
                 sample_hbm: bool = True,
                 buckets=DEFAULT_BUCKETS,
                 device=None):
        self._registry = registry if registry is not None else REGISTRY
        self.metric = metric
        self._hist = self._registry.histogram(
            metric, help, labelnames=("phase", "mode"), buckets=buckets)
        self._lock = threading.Lock()
        self._seen: set = set()
        self._stats: dict[tuple[str, str], _Stat] = {}
        self._records: deque[PhaseRecord] = deque(maxlen=max_records)
        self._last_hbm: dict | None = None
        self.sample_hbm = sample_hbm
        self._hbm_at = (float("-inf"), None)    # (monotonic, sample)
        self.device = device
        # event-timed phases whose end event had not completed yet:
        # (name, mode, start, end, meta, span), in order
        self._pending: deque = deque()
        # analytical roofline: per phase name, the summed cost of the calls
        # recorded (record_cost), so utilization divides the mean cost of a
        # call by the mean execute seconds of that phase
        self._costs: dict[str, dict] = {}

    def mark_first(self, name: str, key=None) -> bool:
        """Check-and-mark first-call status for ``(name, key)`` without
        opening a phase."""
        k = (name, key)
        with self._lock:
            first = k not in self._seen
            self._seen.add(k)
        return first

    @contextlib.contextmanager
    def phase(self, name: str, key=None, tracer=None, *, first=None,
              device=None, **meta):
        """Time a block as phase ``name``. See the class docstring.

        ``tracer`` (a :class:`tpu_kubernetes_torch.util.trace.Tracer`)
        opens a nested quiet span and stamps mode, device seconds and
        memory into its ``meta`` (on an event-timed phase, once the end
        event has completed)."""
        k = (name, key)
        with self._lock:
            seen = k in self._seen
            self._seen.add(k)
        first = (not seen) if first is None else bool(first)
        mode = COMPILE if first else EXECUTE
        device = self.device if device is None else device
        handle = PhaseHandle(name=name, mode=mode)
        timed = _is_cuda(device)
        ctx = (tracer.phase(name, quiet=True, **meta)
               if tracer is not None else contextlib.nullcontext())
        with ctx as span:
            start = None
            if timed:
                start = torch.cuda.Event(enable_timing=True)
                start.record()
                handle._end = [torch.cuda.Event(enable_timing=True), False]
            t0 = time.perf_counter()
            try:
                yield handle
            except BaseException:
                with self._lock:
                    if not seen:
                        self._seen.discard(k)
                raise
            if timed:
                if not handle._end[1]:
                    handle._end[0].record()
                with self._lock:
                    self._pending.append((name, mode, start, handle._end[0],
                                          dict(meta), span, device))
                self._resolve()
                return
            _block_until_ready(handle._pending)
            seconds = time.perf_counter() - t0
            hbm = self._hbm(device)
            self._record(name, mode, seconds, meta=meta, hbm=hbm)
            if span is not None:
                self._stamp(span, mode, seconds, hbm)

    @staticmethod
    def _stamp(span, mode: str, seconds: float, hbm) -> None:
        span.meta["mode"] = mode
        span.meta["device_seconds"] = round(seconds, 6)
        if hbm and "peak_bytes_in_use" in hbm:
            span.meta["hbm_peak_mb"] = round(
                hbm["peak_bytes_in_use"] / 2**20, 1)

    def _hbm(self, device=None):
        """The latest memory sample: a new one once :data:`HBM_SAMPLE_S`
        has passed since the last (``None`` on the CPU or when off)."""
        if not self.sample_hbm:
            return None
        device = self.device if device is None else device
        if not _is_cuda(device):
            return None
        now = time.monotonic()
        at, sample = self._hbm_at
        if now - at >= HBM_SAMPLE_S:
            sample = device_memory_stats(device)
            self._hbm_at = (now, sample)
        return sample

    def _resolve(self, block: bool = False) -> None:
        """Record the event-timed phases whose end event has completed, in
        order (``block``: wait for them all; only the summaries do)."""
        while True:
            with self._lock:
                if not self._pending:
                    return
                name, mode, start, end, meta, span, device = self._pending[0]
                try:
                    done = block or end.query()
                except Exception:
                    done = True
                if not done:
                    return
                self._pending.popleft()
            try:
                end.synchronize()
                seconds = start.elapsed_time(end) / 1e3
            except Exception:
                continue
            hbm = self._hbm(device)
            self._record(name, mode, seconds, meta=meta, hbm=hbm)
            if span is not None:
                self._stamp(span, mode, seconds, hbm)

    def wrap(self, name: str, key=None):
        """Decorator form: times each call, syncing the return value."""
        def deco(fn):
            @functools.wraps(fn)
            def inner(*args, **kwargs):
                with self.phase(name, key=key) as p:
                    return p.sync(fn(*args, **kwargs))
            return inner
        return deco

    def observe(self, name: str, seconds: float, *, mode: str = EXECUTE,
                calls: int = 1, **meta) -> None:
        """Record an externally measured duration. ``calls`` spreads the
        duration over that many invocations in the aggregate (one
        histogram observation either way: it is one measured region)."""
        self._resolve()
        self._record(name, mode, seconds, calls=calls, meta=meta,
                     hbm=self._hbm())

    def _record(self, name: str, mode: str, seconds: float, *,
                calls: int = 1, meta: dict | None = None,
                hbm: dict | None = None) -> None:
        self._hist.labels(name, mode).observe(seconds)
        with self._lock:
            self._stats.setdefault((name, mode), _Stat()).add(seconds, calls)
            self._records.append(PhaseRecord(
                name=name, mode=mode, seconds=seconds, ts=time.time(),
                meta=dict(meta or {}), hbm=hbm))
            if hbm:
                self._last_hbm = hbm

    def record_cost(self, name: str, cost, *, tokens: int | None = None,
                    key=None) -> None:
        """Add one call's analytic cost (``{"flops", "bytes"}``, e.g. from
        :func:`program_cost`, or a zero-argument callable returning it) to
        phase ``name``'s roofline; ``tokens`` is how many tokens the call
        runs. Unlike the reference, which captures XLA's cost of a
        program once, every call is counted: the admitted positions, and
        so the attention's work, change from call to call. ``key`` is
        accepted for the reference's signature."""
        if callable(cost):
            cost = cost()
        if not cost:
            return
        with self._lock:
            agg = self._costs.setdefault(
                name, {"calls": 0, "flops": 0.0, "bytes": 0.0, "tokens": 0})
            agg["calls"] += 1
            agg["flops"] += float(cost.get("flops") or 0.0)
            agg["bytes"] += float(cost.get("bytes") or 0.0)
            agg["tokens"] += int(tokens or 0)

    def roofline(self) -> dict:
        """Analytical MFU/roofline attribution: per phase, the mean FLOPs
        and bytes of a call, per token and their ratio (exact everywhere,
        the CPU included), and utilization = achieved FLOP/s over the
        device's dense peak: ``None`` whenever the peak (CPU) or a
        steady-state execute mean is unknown."""
        self._resolve()
        kind = device_kind(self.device)
        peak = backend_peak_flops(kind)
        with self._lock:
            costs = {n: dict(d) for n, d in self._costs.items()}
            exec_means = {
                name: s.total / s.count
                for (name, mode), s in self._stats.items()
                if mode == EXECUTE and s.count
            }
        programs: dict[str, dict] = {}
        for name in sorted(costs):
            d = costs[name]
            n = max(1, d["calls"])
            flops = d["flops"] / n or None
            nbytes = d["bytes"] / n or None
            toks = d["tokens"] / n or None
            prog = {
                "flops": flops,
                "bytes": nbytes,
                "tokens_per_call": toks,
                "flops_per_token": (round(flops / toks, 3)
                                    if flops and toks else None),
                "bytes_per_token": (round(nbytes / toks, 3)
                                    if nbytes and toks else None),
                "arithmetic_intensity": (round(flops / nbytes, 3)
                                         if flops and nbytes else None),
                "utilization": None,
            }
            mean = exec_means.get(name)
            if peak and flops and mean and mean > 0:
                prog["utilization"] = round(flops / (mean * peak), 6)
            programs[name] = prog
        return {"device_kind": kind, "peak_flops": peak,
                "programs": programs}

    def stat(self, name: str, mode: str) -> dict | None:
        self._resolve()
        with self._lock:
            s = self._stats.get((name, mode))
            return s.as_dict() if s else None

    def records(self, n: int = 50) -> list[dict]:
        self._resolve()
        with self._lock:
            recent = list(self._records)[-n:]
        return [
            {
                "phase": r.name, "mode": r.mode,
                "seconds": round(r.seconds, 6), "ts": r.ts,
                **({"meta": r.meta} if r.meta else {}),
                **({"hbm": r.hbm} if r.hbm else {}),
            }
            for r in recent
        ]

    def summary(self) -> dict:
        """Per-phase compile/execute aggregates + the latest memory sample
        (the ``GET /debug/profile`` payload); waits for the event-timed
        phases still open."""
        self._resolve(block=True)
        with self._lock:
            stats = {k: s.as_dict() for k, s in self._stats.items()}
            hbm = dict(self._last_hbm) if self._last_hbm else None
        phases: dict[str, dict] = {}
        for (name, mode), d in sorted(stats.items()):
            phases.setdefault(name, {})[mode] = d
        for name, modes in phases.items():
            comp = modes.get(COMPILE)
            execu = modes.get(EXECUTE)
            if comp and execu:
                # what the first call paid beyond a steady-state run: the
                # warm-up and capture this profiler exists to expose
                modes["compile_overhead_seconds"] = round(
                    max(0.0, comp["last_seconds"] - execu["mean_seconds"]), 6)
        return {"metric": self.metric, "phases": phases, "hbm": hbm,
                "roofline": self.roofline()}

    def reset(self) -> None:
        """Drop first-call marks, aggregates, records and costs (tests)."""
        with self._lock:
            self._seen.clear()
            self._stats.clear()
            self._records.clear()
            self._pending.clear()
            self._last_hbm = None
            self._hbm_at = (float("-inf"), None)
            self._costs.clear()


def render_profile(summary: dict) -> str:
    """The ``get profile`` table for a summary dict."""
    phases = summary.get("phases") or {}
    lines = [
        f"{'PHASE':<12} {'MODE':<8} {'CALLS':>6} {'TOTAL_S':>9} "
        f"{'MEAN_S':>9} {'LAST_S':>9}"
    ]
    if not phases:
        lines.append("(no phases recorded yet)")
    for name in sorted(phases):
        modes = phases[name]
        for mode in (COMPILE, EXECUTE):
            d = modes.get(mode)
            if not d:
                continue
            lines.append(
                f"{name:<12} {mode:<8} {d['count']:>6} "
                f"{d['total_seconds']:>9.4f} {d['mean_seconds']:>9.4f} "
                f"{d['last_seconds']:>9.4f}")
        overhead = modes.get("compile_overhead_seconds")
        if overhead is not None:
            lines.append(
                f"{name:<12} {'— compile overhead:':<25}"
                f"{overhead:>10.4f}s")
    hbm = summary.get("hbm")
    if hbm:
        parts = [f"{k}={v / 2**20:.1f}MiB" for k, v in sorted(hbm.items())]
        lines.append("hbm: " + " ".join(parts))
    roof = summary.get("roofline") or {}
    progs = roof.get("programs") or {}
    if progs:
        peak = roof.get("peak_flops")
        lines.append(
            f"roofline (device={roof.get('device_kind') or 'unknown'} "
            f"peak_flops={f'{peak:.3g}' if peak else 'none'}):")
        lines.append(
            f"{'PROGRAM':<12} {'FLOPS/TOK':>12} {'BYTES/TOK':>12} "
            f"{'INTENSITY':>10} {'MFU':>8}")
        for name in sorted(progs):
            d = progs[name]
            fmt = lambda v: "—" if v is None else format(v, ".3g")  # noqa: E731
            util = d.get("utilization")
            lines.append(
                f"{name:<12} {fmt(d.get('flops_per_token')):>12} "
                f"{fmt(d.get('bytes_per_token')):>12} "
                f"{fmt(d.get('arithmetic_intensity')):>10} "
                f"{'null' if util is None else format(util, '.2%'):>8}")
    return "\n".join(lines) + "\n"


def fetch_profile(target: str, timeout: float = 5.0) -> dict:
    """GET ``/debug/profile`` from ``host:port`` (scheme/path optional)."""
    t = target.strip()
    if "//" not in t:
        t = "http://" + t
    if not t.rstrip("/").endswith("/debug/profile"):
        t = t.rstrip("/") + "/debug/profile"
    with urllib.request.urlopen(t, timeout=timeout) as resp:
        return json.loads(resp.read().decode("utf-8", "replace"))
