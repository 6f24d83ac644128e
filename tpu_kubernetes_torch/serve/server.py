"""HTTP completions server (port of ``tpu_kubernetes/serve/server.py``).

A stdlib server exposing:

  GET  /healthz         → {"status": "ok", "model": ..., "metrics",
                          "goodput", "resilience", ...}; 503 with
                          "warming" until the default programs have run
                          once, "draining"/"drained" during a drain and
                          "failed" once the engine watchdog gave up; with
                          the slot engine on, ``"continuous_batching"``:
                          its stats, and ``"alerts"``: the firing and
                          pending counts
  GET  /metrics         → Prometheus text exposition of the registry
  GET  /debug/profile   → the phase profiler's compile/execute summary
  GET  /debug/ledger    → the goodput ledger, the analytic roofline and,
                          paged, the page partition
  GET  /debug/flightrec → the engine's flight recorder, live (segment
                          ring, ledger, SLO alerts, history samples)
  GET  /debug/alerts    → the engine-local tripwires' alerts, silences
                          and rules
  GET  /debug/trace/<id> → the span tree of a request id or trace id
  GET  /v1/models       → the one resident model, OpenAI-list shaped
  POST /drain           → 202: stop admission, finish resident work, close
  POST /v1/completions  → {"prompt": str, "max_new_tokens"?: int,
                           "temperature"?: float, "top_k"?: int,
                           "top_p"?: float, "seed"?: int,
                           "stream"?: bool}
                          ("max_tokens" aliases max_new_tokens)
                          ⇒ {"text": str, "tokens": int,
                           "prompt_tokens": int, "finish_reason":
                           "stop"|"length", "model": str}
                          — or, with "stream": true, Server-Sent Events
                          (``data: {json}`` frames of OpenAI-shaped
                          chunks, then ``data: [DONE]``) whose pieces
                          arrive as tokens decode; each piece is the
                          delta of the decoded prefix, so a multi-byte
                          character never splits across frames
  POST /v1/chat/completions → {"messages": [{"role", "content"}...],
                          "max_tokens"?, ..., "stream"?} ⇒ a
                          ``chat.completion`` (or SSE
                          ``chat.completion.chunk`` deltas); the messages
                          render as a plain role-prefixed transcript

Model bring-up is ``serve/job.py``'s ``load_serving_stack`` (SERVE_MODEL
or SERVE_HF_CHECKPOINT, SERVE_TOKENIZER, SERVE_DTYPE, SERVE_DEVICE
(``cuda`` unless set) and SERVE_QUANT=int8 for int8 weights), plus
SERVE_KV_QUANT (the int8 KV
cache of every lane, the engine's cache and pool included) and
SERVE_DRAFT_KV_QUANT (the draft model's cache alone), plus
SERVER_HOST/SERVER_PORT, SERVE_MAX_NEW (the per-request max_new_tokens
cap, default 64), SERVE_EOS_ID (tokens from it on are cut from
responses), SERVE_EARLY_EXIT_STEPS (the greedy decode loop checks
between segments of this many steps whether any row is still live,
default 8; <= 0 runs one segment; it doubles as the slot engine's
segment length), SERVER_BATCH / SERVER_BATCH_WINDOW_MS (round batching),
SERVE_CONTINUOUS_BATCHING (the slot engine), SERVE_KV_POOL_MB /
SERVE_KV_PAGE_SIZE (the engine's paged KV pool), SERVE_PREFIX_CACHE_MB
(the prefix cache) and the speculation knobs SERVE_PROMPT_LOOKUP,
SERVE_DRAFT_K (default 8), SERVE_NGRAM (default 2), SERVE_DRAFT_MODEL and
SERVE_DRAFT_HF_CHECKPOINT. Every other knob the reference reads is
refused at start-up with the ``ROADMAP.md`` item that brings it
(:data:`LATER_KNOBS`).

Request handling follows the reference, so a greedy response is
token-identical to it: the prompt is byte-encoded (empty → ``[0]``),
right-padded to a power-of-two width, prefilled raggedly into a cache
spanning ``width + run_max_new`` (``run_max_new`` is the requested
budget rounded up to a power of two, capped), decoded greedily in
segments until the budget or EOS, then cut to the requested budget and
at EOS. The greedy lane (:class:`GreedyLane`) runs its prefill and
decode segments as CUDA graphs on the card, one per static signature,
the counterpart of the reference's cached jitted programs. Sampled
requests run one graphed ``generate`` program per shape and sampler
variant, and streams one graphed decode step and sample a token
(:class:`SampledLane`), drawing from one ``torch.Generator`` that each
request seeds: a seed samples the same tokens streamed or not, and its
draws differ from ``jax.random``'s.

Greedy default requests batch in one of two ways:

* **Round batching** (SERVER_BATCH > 1, :class:`_Batcher`): concurrent
  requests coalesce, within SERVER_BATCH_WINDOW_MS (default 5), into one
  ragged batch of SERVER_BATCH rows (pad rows replicate row 0) that runs
  on the greedy lane; each row is cut to its own budget, so co-riding
  never changes a response. MoE models serve solo here: their expert
  capacity depends on the batch.
* **Continuous batching** (SERVE_CONTINUOUS_BATCHING=1,
  :class:`ContinuousEngine`): a scheduler thread owns a fixed
  (slots, max_seq) cache (SERVER_BATCH slots, default 4) and decodes all
  slots in segments; between segments it hands finished rows back,
  clears their slots and admits queued requests, each prefilled at its
  own width and grafted into a free slot. Its insert, segment and clear
  programs are CUDA graphs on the card. MoE models ride it too. With
  SERVE_KV_POOL_MB > 0 the slots' positions live in a pool of
  SERVE_KV_PAGE_SIZE-position pages (default 16) instead: admission gates
  on free pages, so concurrency is bounded by live tokens, not by the
  worst-case context.

The generation lock serializes the card: the engine takes it per
prefill and per segment, so solo, sampled and streamed requests
interleave with a busy engine. ``warm()`` runs the default request's
paths once before going ready.

The prefix cache (SERVE_PREFIX_CACHE_MB > 0) keeps the K/V of recent
prompts in a byte-capped LRU (``serve/prefix_cache.py``): a greedy or
streamed request whose prompt shares at least MIN_PREFIX_TOKENS tokens
with a stored one prefills only the rest (a power-of-two floor of the
match reused), warm, into the cold path's cache, so its tokens are the
cold path's; the dense slot engine admits through the same policy point,
and the paged engine keeps its own store of pinned pages. ``/healthz``
then carries ``prefix_cache``: entries, bytes, cap, signature and the
hit / partial / miss lookups.

Speculation (greedy requests only; sampled ones bypass it, as in the
reference): SERVE_PROMPT_LOOKUP=1 serves a solo request through the
lookup rounds of :meth:`GreedyLane.lookup_rounds` (``models/speculative.py``'s
graphed ``("spec_round", "lookup<n>", width, span, k)`` program a round:
n-gram proposals, verify window and acceptance on the device; a round's
accepted tokens surfaced at once, streamed or not); with the
slot engine, SERVE_PROMPT_LOOKUP or a SERVE_DRAFT_MODEL preset (random
weights, seed 1; it wins when both are set) turns its segments into
verify rounds (:meth:`ContinuousEngine._run_segment_spec`). Either way
the tokens are the target's own greedy ones: proposals move the speed,
never the output. Every request reserves SERVE_DRAFT_K positions of the
span for the verify window past its budget. ``/healthz`` then carries
``prompt_lookup``: the proposer, draft_k, ngram and the rounds, drafted
and accepted totals.

The operations layer follows the reference's: the serving families of
``tpu_serve_*`` in the process registry (``obs/metrics.py``), the goodput
ledger (``obs/ledger.py``: every token the device produced settles as
useful, cancelled, expired, shed-spent, speculative waste or bubble), the
phase profiler (``obs/profile.py``: a program's first call is "compile",
a replay "execute", timed by CUDA events on the card; the engine's segment
closes on the readback it already makes, so the layer adds no host-device
sync to a segment or a verify round), request tracing (``traceparent``
and ``X-Request-Id`` in and out, the span ring of ``util/trace.py``),
fault injection at the reference's sites (``TPU_K8S_FAULTS``, fired on
the host before a replay, never inside a program's body), deadlines
(SERVE_DEADLINE_MS or a body's ``deadline_ms``: 504), admission control
(SERVE_MAX_QUEUE: 429 with ``Retry-After``), the engine's watchdog
(SERVE_MAX_ENGINE_RESTARTS, SERVE_WATCHDOG_INTERVAL_S: a dead scheduler
restarts cold, its cache and pool wiped in place so the captured graphs
stay valid; past the bound ``/healthz`` hard-fails), the drain (``POST
/drain`` or SIGTERM, bounded by SERVE_DRAIN_TIMEOUT_S) and SERVE_ROLE
(``tpu_serve_role_info``). With the engine, its black box rides the
scheduler as in the reference: the flight recorder (``obs/flightrec.py``:
one record a segment, postmortem dumps on a cold reset, a hard-fail and a
drain, ``GET /debug/flightrec``), the engine-local tripwires
(``obs/alerts.py``, evaluated on the scheduler thread, ``GET
/debug/alerts``, mirrored into ``/healthz``) and the incident correlator
(``obs/incidents.py``). The mesh comes with a later slice
(:data:`LATER_KNOBS`).
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import os
import queue
import sys
import threading
import time
import uuid
import weakref
from dataclasses import replace
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import torch

from tpu_kubernetes_torch.models.decode import (
    KVCache,
    SlotState,
    cache_clear_row,
    cache_insert_row,
    decode_segment,
    decode_segment_paged,
    decode_segment_slots,
    decode_step,
    decode_verify_paged,
    decode_verify_slots,
    gather_pages,
    generate_into,
    init_cache,
    init_paged_pool,
    page_bytes,
    paged_clear_pages,
    paged_insert_row,
    prefill,
    prefill_resume,
    sample_tokens,
    sampling_knobs,
    sampling_variant,
)
from tpu_kubernetes_torch.models.moe import MoEConfig
from tpu_kubernetes_torch.models.quant import is_quantized, matmul_weight_bytes
from tpu_kubernetes_torch.models.speculative import (
    check_draft_k,
    ngram_propose_host,
    prompt_lookup_rounds,
)
from tpu_kubernetes_torch.obs import REGISTRY, events
from tpu_kubernetes_torch.obs import metrics as obs_metrics
from tpu_kubernetes_torch.obs import tracing
from tpu_kubernetes_torch.obs.faults import FAULTS
from tpu_kubernetes_torch.obs.ledger import LEDGER
from tpu_kubernetes_torch.obs.profile import (
    COMPILE,
    EXECUTE,
    PhaseProfiler,
    program_cost,
)
from tpu_kubernetes_torch.serve.job import (
    load_draft,
    load_serving_stack,
    refuse_knobs,
    truthy_env,
)
from tpu_kubernetes_torch.serve.pages import PagePool
from tpu_kubernetes_torch.serve.prefix_cache import PrefixCache
from tpu_kubernetes_torch.serve.resilience import (
    CANCELLED_TOTAL,
    DEADLINE_TOTAL,
    ENGINE_RESTARTS,
    AdmissionController,
    Cancelled,
    DeadlineExceeded,
    DrainController,
    Draining,
    Overloaded,
    Watchdog,
    deadline_from,
    expired,
    warn_once,
)
from tpu_kubernetes_torch.util import log
from tpu_kubernetes_torch.util.envparse import (
    env_bool,
    env_float,
    env_int,
    env_str,
)
from tpu_kubernetes_torch.util.graphs import Programs
from tpu_kubernetes_torch.util.trace import TRACER, span_tree


# -- serving telemetry (obs/metrics.py): registered at import so every
# family is present in GET /metrics from the first scrape, samples or not.
_LATENCY_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
    2.5, 5.0, 10.0, 30.0, 60.0,
)
REQUEST_SECONDS = REGISTRY.histogram(
    "tpu_serve_request_seconds",
    "end-to-end request latency by endpoint",
    labelnames=("endpoint",), buckets=_LATENCY_BUCKETS,
)
TTFT_SECONDS = REGISTRY.histogram(
    "tpu_serve_time_to_first_token_seconds",
    "streaming requests: receipt to first emitted piece",
    buckets=_LATENCY_BUCKETS,
)
QUEUE_SECONDS = REGISTRY.histogram(
    "tpu_serve_batch_queue_seconds",
    "dynamic batching: enqueue to dispatch wait",
    buckets=_LATENCY_BUCKETS,
)
BATCH_SIZE = REGISTRY.histogram(
    "tpu_serve_batch_size",
    "dynamic batching: rows per dispatched batch",
    buckets=(1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0),
)
REQUESTS_TOTAL = REGISTRY.counter(
    "tpu_serve_requests_total",
    "HTTP requests served, by endpoint and status code",
    labelnames=("endpoint", "code"),
)
TOKENS_GENERATED = REGISTRY.counter(
    "tpu_serve_tokens_generated_total",
    "completion tokens emitted (warm-up excluded)",
)
PROMPT_TOKENS = REGISTRY.counter(
    "tpu_serve_prompt_tokens_total",
    "prompt tokens consumed (warm-up excluded)",
)
SPEC_ROUNDS = REGISTRY.counter(
    "tpu_serve_spec_rounds_total",
    "speculative decoding: target verify passes (solo lookup rounds, "
    "prefill included, plus slot-engine verify rounds)",
)
SPEC_DRAFTED = REGISTRY.counter(
    "tpu_serve_spec_drafted_total",
    "speculative decoding: tokens proposed, by proposer (ngram = "
    "host-side prompt lookup, draft = the draft model)",
    labelnames=("source",),
)
SPEC_ACCEPTED = REGISTRY.counter(
    "tpu_serve_spec_accepted_total",
    "speculative decoding: proposed tokens the target kept, by "
    "proposer (accepted/drafted is the acceptance rate the monitor's "
    "SPEC% column shows)",
    labelnames=("source",),
)
PROGRAM_CACHE = REGISTRY.counter(
    "tpu_serve_program_cache_total",
    "compiled-program cache lookups (miss = a fresh jit wrapper)",
    labelnames=("result",),
)
INFLIGHT = REGISTRY.gauge(
    "tpu_serve_inflight_requests",
    "requests currently inside a handler (the server-side queue depth "
    "a fleet monitor watches — generation serializes on one lock)",
)
PREFIX_CACHE_TOTAL = REGISTRY.counter(
    "tpu_serve_prefix_cache_total",
    "prefix KV-cache lookups by outcome (hit = a stored prefix fully "
    "reused, partial = the prompt diverged inside a stored prefix, "
    "miss = cold prefill; warm-up excluded)",
    labelnames=("result",),
)
PREFIX_CACHED_TOKENS = REGISTRY.histogram(
    "tpu_serve_prefix_cached_tokens",
    "prompt tokens served from the prefix cache per warm prefill",
    buckets=(16.0, 32.0, 64.0, 128.0, 256.0, 512.0, 1024.0, 2048.0),
)
PREFIX_CACHE_BYTES = REGISTRY.gauge(
    "tpu_serve_prefix_cache_bytes",
    "resident bytes of cached KV prefix segments (LRU-evicted under "
    "the SERVE_PREFIX_CACHE_MB cap)",
)
DECODE_STEPS_SAVED = REGISTRY.counter(
    "tpu_serve_decode_steps_saved_total",
    "decode scan steps skipped by the all-rows-done early exit "
    "(per dispatched generation, vs the bucketed run length)",
)
BATCH_TAINT = REGISTRY.counter(
    "tpu_serve_batch_taint_total",
    "dispatcher selection failures that tainted a whole pending round "
    "(every selected entry fails out; submit() never hangs)",
)
SLOT_OCCUPANCY = REGISTRY.gauge(
    "tpu_serve_slot_occupancy",
    "continuous batching: slots holding a live request (out of the "
    "engine's fixed slot count — sustained saturation means add slots "
    "or replicas)",
)
ADMISSION_WAIT = REGISTRY.histogram(
    "tpu_serve_admission_wait_seconds",
    "continuous batching: enqueue to slot-insert wait (how long a "
    "request waited for a free slot + its prefill)",
    buckets=_LATENCY_BUCKETS,
)
SLOTS_RECYCLED = REGISTRY.counter(
    "tpu_serve_slots_recycled_total",
    "continuous batching: finished rows drained and their slots freed "
    "for the next queued request",
)
KV_PAGES = REGISTRY.gauge(
    "tpu_serve_kv_pages",
    "paged KV pool pages by state (free = wiped, on the free list; "
    "live = referenced by a resident slot; pinned = owned by the "
    "prefix store) — free+live+pinned always equals the pool size, a "
    "drifting sum is a page leak",
    labelnames=("state",),
)
PAGE_STALLS = REGISTRY.counter(
    "tpu_serve_kv_page_stalls_total",
    "paged engine: admissions or segment top-ups blocked on an empty "
    "free list (the paged analog of slot exhaustion — sustained stalls "
    "mean grow SERVE_KV_POOL_MB; each stall feeds the ledger's bubble "
    "fraction an explanation)",
)
PAGE_PREEMPTIONS = REGISTRY.counter(
    "tpu_serve_kv_page_preemptions_total",
    "paged engine: resident rows preempted (pages reclaimed, entry "
    "requeued for deterministic greedy recompute) to top up an older "
    "row's table",
)
# phase attribution (obs/profile.py): prefill / decode / generate device
# seconds split by mode — "compile" is a program's first call (the eager
# warm-up and the CUDA-graph capture ride on it), "execute" is a replay.
# Summarized at GET /debug/profile, scraped as this histogram.
PROFILER = PhaseProfiler(
    metric="tpu_serve_phase_seconds",
    help="device-synced serving phase seconds (mode=compile is a "
         "program's first call including trace+compile; mode=execute "
         "is steady state)",
)
# the *_info idiom (register_build_info): constant-1 gauge whose payload
# is the label — the fleet aggregator joins this onto its saturation
# family and the monitor's ROLE column, so disaggregated tiers
# (SERVE_ROLE=prefill / decode / …) balance independently
ROLE_INFO = REGISTRY.gauge(
    "tpu_serve_role_info",
    "this instance's serving role (SERVE_ROLE; constant 1, the role "
    "rides the label)",
    labelnames=("role",),
)


def _bucket(n: int, lo: int = 16) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


# prompts below this length are not worth a prefix-cache entry (warm-up
# probes would pollute the store) and matches below it are not worth a
# resume program; also the floor of _pow2_floor, and the page-size rule:
# width buckets and reused-prefix lengths must be page-aligned
MIN_PREFIX_TOKENS = 16

# how long an IDLE scheduler waits before waking to run an alert tick
# anyway (alerts must resolve and incidents must close on a quiet engine,
# not only while traffic flows)
_ALERT_IDLE_WAIT_S = 0.5


def _pow2_floor(n: int, lo: int = MIN_PREFIX_TOKENS) -> int:
    """Largest power of two <= n (0 when n < lo). Reused-prefix lengths
    are quantized DOWN to powers of two so the warm programs keep the
    O(log max_seq) count of every other key: a raw match length would
    mean one program per distinct prefix."""
    if n < lo:
        return 0
    b = lo
    while b * 2 <= n:
        b *= 2
    return b


def _pad_rows(rows: list, width: int) -> torch.Tensor:
    """Token-id lists → a right-padded (len(rows), width) int32 tensor."""
    padded = torch.zeros((len(rows), width), dtype=torch.int32)
    for i, r in enumerate(rows):
        padded[i, :len(r)] = torch.tensor(r, dtype=torch.int32)
    return padded


def _is_greedy(temperature, top_k, top_p) -> bool:
    """Default sampling: greedy argmax, no filters."""
    return (
        float(temperature) == 0.0 and int(top_k) == 0
        and float(top_p) == 0.0
    )


def _bucket_max_new(n: int, cap: int) -> int:
    """Round a requested max_new up to a power-of-two bucket (≤ cap).
    Responses still truncate to the REQUESTED budget."""
    return min(_bucket(n, lo=8), cap)


def _prefill_cost(cfg, b: int, width: int, q: int = 0, **opts) -> dict:
    """The analytic cost (``obs/profile.py`` :func:`program_cost`) of a
    prefill of ``b`` rows at ``width``, resumed after ``q`` cached
    positions: ``b · (width - q)`` tokens, each attending causally up to
    its own position. ``opts``: a lane's ``cost_opts`` (int8 weights and
    cache)."""
    return program_cost(
        cfg, tokens=b * (width - q),
        attended=b * (width * (width + 1) - q * (q + 1)) // 2,
        kv_positions=b * width, **opts)


def _decode_cost(cfg, rows, steps: int, **opts) -> dict:
    """The analytic cost of ``steps`` decode positions of each row (a
    segment's steps, or a verify round's window), ``rows`` holding each
    row's (prompt length, prompt slots, first position): a position ``pos
    + j`` attends the row's real prompt and its generated slots up to
    itself, ``prompt length + pos + j - prompt slots + 1`` positions."""
    attended = kv = 0
    for pl, ps, pos in rows:
        live = max(int(pl) + int(pos) - int(ps) + 1, 1)
        attended += steps * live + steps * (steps - 1) // 2
        kv += live + steps - 1
    return program_cost(cfg, tokens=len(rows) * steps, attended=attended,
                        kv_positions=kv, **opts)


def _host_lengths(lengths: torch.Tensor, width: int) -> list:
    """Prompt lengths as a list, read only from a host tensor: a device
    tensor's would cost a sync, so its rows count as ``width``."""
    if lengths.device.type != "cpu":
        return [width] * lengths.shape[0]
    return lengths.tolist()


def _add_costs(a: dict, b: dict) -> dict:
    return {k: a[k] + b[k] for k in a}


def _count_program_lookup(hit: bool) -> None:
    PROGRAM_CACHE.labels("hit" if hit else "miss").inc()


# The reference server's knobs that the port does not serve yet: name →
# (how the reference reads it, its default there, the ROADMAP.md item
# that brings it). ServingState refuses a value other than the default,
# so a deployment never gets a different server than it asked for.
LATER_KNOBS = {
    "SERVE_MESH": (env_str, "", "queue 1 item 7c (sharded serving)"),
}


def refuse_later_knobs(env: dict) -> None:
    """Raise ValueError for a knob of :data:`LATER_KNOBS` set to anything
    but the reference's default."""
    refuse_knobs(env, LATER_KNOBS)


class _Slots:
    """The buffers one (batch, width, span) shares between its prefill
    programs (cold and warm) and its decode programs: the static inputs
    (tokens, lengths, the decode's first slot), the cache and the carry
    (the prefill's logits, token, done). They live outside the graphs'
    pool. ``kv_quant``: the cache is int8."""

    def __init__(self, cfg, b: int, width: int, span: int, device,
                 kv_quant: bool = False):
        self.tokens = torch.zeros((b, width), dtype=torch.int32,
                                  device=device)
        self.lengths = torch.zeros((b,), dtype=torch.int32, device=device)
        cache = init_cache(cfg, b, span, kv_quant=kv_quant, device=device)
        self.cache = replace(cache, length=width,
                             prompt_lengths=self.lengths, prompt_slots=width)
        self.start = torch.zeros((), dtype=torch.int64, device=device)
        self.logits = torch.zeros((b, cfg.vocab_size), dtype=torch.float32,
                                  device=device)
        self.token = torch.zeros((b,), dtype=torch.int32, device=device)
        self.done = torch.zeros((b,), dtype=torch.bool, device=device)
        self.length = width            # the host's count of filled slots
        # the prompt lengths as the host knows them, for the profiler's
        # analytic cost (the width where they came in on the device)
        self.lengths_host = [width] * b


def _first_token(st: _Slots, logits: torch.Tensor, eos_id) -> None:
    """A prefill body's tail: its logits, greedy token and EOS flag into
    the slots' carry."""
    st.logits.copy_(logits)
    st.token.copy_(torch.argmax(logits, dim=-1))
    if eos_id is None:
        st.done.zero_()
    else:
        st.done.copy_(st.token == eos_id)


def _expand_prefix(cache: KVCache, k: torch.Tensor, v: torch.Tensor,
                   q: int, k_scale=None, v_scale=None) -> None:
    """A stored segment → the resume base (the reference's
    ``_expand_prefix``): its first ``q`` positions (``k``/``v`` (L, 1, kv,
    >= q, hd), an int8 segment's scales (L, 1, kv, >= q)) copied into the
    first ``q`` slots of every row of ``cache``, in place (batch warm
    starts replicate row 0)."""
    if (cache.k_scale is None) != (k_scale is None):
        raise ValueError("cache/segment kv-quant mismatch (one has int8 "
                         "scales)")
    cache.k[:, :, :, :q].copy_(k[:, :, :, :q])
    cache.v[:, :, :, :q].copy_(v[:, :, :, :q])
    if k_scale is not None:
        cache.k_scale[:, :, :, :q].copy_(k_scale[:, :, :, :q])
        cache.v_scale[:, :, :, :q].copy_(v_scale[:, :, :, :q])


def _kv_arrays(cache: KVCache, row: int, n: int) -> dict:
    """Row ``row``'s first ``n`` positions of a cache as a prefix entry's
    arrays (clones): "k", "v" and, int8, "k_scale", "v_scale"."""
    arrays = {"k": cache.k[:, row:row + 1, :, :n].clone(),
              "v": cache.v[:, row:row + 1, :, :n].clone()}
    if cache.k_scale is not None:
        arrays["k_scale"] = cache.k_scale[:, row:row + 1, :, :n].clone()
        arrays["v_scale"] = cache.v_scale[:, row:row + 1, :, :n].clone()
    return arrays


class GreedyLane:
    """The greedy serving programs, cached by key in one
    :class:`~tpu_kubernetes_torch.util.graphs.Programs` (the reference's
    ``_cached_program``): a ragged ``prefill`` per ("prefill", batch,
    width, span), a warm-prefix resume per ("prefill_warm", batch, q,
    width, span) and a ``decode_segment`` per ("decode", batch, width,
    span, steps); the EOS id is the lane's. On the card each program is a
    CUDA graph captured at its key's first call; ``graphs=False`` runs the
    same bodies eagerly (comparisons only).

    ``prefix`` (SERVE_PREFIX_CACHE_MB) is the lane's byte store of prompt
    prefixes: :meth:`prefill_any`, the reference's policy point, prefills
    a prompt that shares a stored prefix warm and stores every prompt it
    prefills. ``prefix_lookups`` counts the lookups by outcome ("hit":
    the prompt extends a stored prefix, "partial": it diverged inside
    one, "miss"), the paged engine's store's included.

    ``kv_quant`` (SERVE_KV_QUANT) makes every cache of the lane int8, its
    slots' and, through them, the engine's; a lane holds one kind of
    cache, so its program keys need not name it. The analytic roofline
    (``cost_opts``) counts the bytes of int8 weights and of an int8 cache
    as they are read."""

    def __init__(self, params: dict, cfg, eos_id: int | None = None, *,
                 graphs: bool = True, prefix: PrefixCache | None = None,
                 kv_quant: bool = False):
        self.params, self.cfg, self.eos_id = params, cfg, eos_id
        self.kv_quant = bool(kv_quant)
        self.cost_opts = {
            "weight_nbytes": (matmul_weight_bytes(params)
                              if is_quantized(params["lm_head"]) else None),
            "kv_quant": self.kv_quant}
        self.device = params["embed"].device
        self.programs = Programs(self.device, graphs=graphs,
                                 on_lookup=_count_program_lookup)
        self._slots: dict[tuple, _Slots] = {}
        self.prefix = prefix
        self.prefix_lookups = {"hit": 0, "partial": 0, "miss": 0}
        # whether traffic counts in the token counters and the ledger: the
        # server turns it off for its warm-up (the reference's ready gate)
        self.counting = True

    def _phase(self, name: str, program, cost: dict, tokens: int):
        """The profiler's phase around one program call: its analytic cost
        recorded, "compile" on the program's first call, CUDA-event timed
        on the card (no wait). The span goes to the tracer only inside a
        request's run: the engine's scheduler thread has none, and its
        spans would only push requests' spans out of the ring."""
        PROFILER.record_cost(name, cost, tokens=tokens)
        return PROFILER.phase(
            name, tracer=TRACER if events.current_run_id() else None,
            first=not program.captures, device=self.device)

    def slots(self, b: int, width: int, span: int) -> _Slots:
        key = (b, width, span)
        if key not in self._slots:
            self._slots[key] = _Slots(self.cfg, b, width, span, self.device,
                                      self.kv_quant)
        return self._slots[key]

    def prefill(self, rows: torch.Tensor, lengths: torch.Tensor,
                span: int) -> _Slots:
        """Copy the right-padded ``rows`` (b, width) and their ``lengths``
        in, run the prefill program → its slots, whose ``token`` holds
        each row's first greedy token and ``done`` whether it is EOS."""
        b, width = rows.shape
        st = self.slots(b, width, span)
        # the body closes over the lane's parts, never the lane, so a
        # dropped lane frees its graphs by reference count
        params, cfg, eos_id = self.params, self.cfg, self.eos_id

        def build():
            def body():
                logits, _ = prefill(params, st.tokens, cfg, max_seq=span,
                                    lengths=st.lengths, cache=st.cache)
                _first_token(st, logits, eos_id)
            return body

        program = self.programs.get(("prefill", b, width, span), build)
        st.tokens.copy_(rows, non_blocking=True)
        st.lengths.copy_(lengths, non_blocking=True)
        with self._phase("prefill", program, _prefill_cost(cfg, b, width,
                                       **self.cost_opts),
                         b * width) as ph:
            program()
            ph.sync(st.token)
        st.length = width
        st.lengths_host = _host_lengths(lengths, width)
        return st

    def prefill_warm(self, rows: torch.Tensor, lengths: torch.Tensor,
                     prefix_k: torch.Tensor, prefix_v: torch.Tensor, q: int,
                     span: int, prefix_k_scale: torch.Tensor | None = None,
                     prefix_v_scale: torch.Tensor | None = None) -> _Slots:
        """Resume from ``q`` cached prefix positions (the reference's
        ``_prefill_warm``): prefill ONLY the suffix [q, width) of the
        right-padded ``rows`` (every row sharing the prefix), into the
        cold prefill's slots, so every decode and insert program is shared
        with the cold path. The stored segment (``prefix_k``/``prefix_v``,
        (L, 1, kv, >= q, hd), with its scales ``prefix_k_scale``/
        ``prefix_v_scale`` (L, 1, kv, >= q) on an int8 lane) is a different
        tensor every call, so it is
        copied in before the program runs, as the rows are; the program
        (:func:`~tpu_kubernetes_torch.models.decode.prefill_resume`)
        writes the suffix's positions and zeros past the width, so outside
        the real slots a warm cache is bitwise a cold one. → the slots, as
        :meth:`prefill`."""
        b, width = rows.shape
        if not 0 < q < width:
            raise ValueError(f"a warm prefill reuses 0 < q < width "
                             f"positions; got q {q} at width {width}")
        st = self.slots(b, width, span)
        params, cfg, eos_id = self.params, self.cfg, self.eos_id

        def build():
            def body():
                c = st.cache
                c.k[:, :, :, width:].zero_()
                c.v[:, :, :, width:].zero_()
                if c.k_scale is not None:
                    c.k_scale[:, :, :, width:].fill_(1.0)
                    c.v_scale[:, :, :, width:].fill_(1.0)
                logits, _ = prefill_resume(
                    params, st.tokens[:, q:], cfg,
                    KVCache(c.k, c.v, length=q, k_scale=c.k_scale,
                            v_scale=c.v_scale),
                    lengths=st.lengths - q)
                _first_token(st, logits, eos_id)
            return body

        program = self.programs.get(("prefill_warm", b, q, width, span),
                                    build)
        st.tokens.copy_(rows, non_blocking=True)
        st.lengths.copy_(lengths, non_blocking=True)
        _expand_prefix(st.cache, prefix_k, prefix_v, q, prefix_k_scale,
                       prefix_v_scale)
        with self._phase("prefill_warm", program,
                         _prefill_cost(cfg, b, width, q, **self.cost_opts),
                         b * (width - q)) as ph:
            program()
            ph.sync(st.token)
        st.length = width
        st.lengths_host = _host_lengths(lengths, width)
        return st

    def prefix_lookup(self, ids: list, store: PrefixCache | None = None
                      ) -> tuple[int, object | None]:
        """Longest match of ``ids`` in ``store`` (the lane's by default),
        floored to a power of two (the program count) and capped at
        len(ids) - 1 (the resume needs one real suffix token for its
        last-position logits) → (reused positions, the entry), or (0,
        None) below MIN_PREFIX_TOKENS; the outcome is counted in
        ``prefix_lookups``."""
        store = self.prefix if store is None else store
        m, entry = store.lookup(ids)
        q = _pow2_floor(min(m, len(ids) - 1))
        if entry is None or q < MIN_PREFIX_TOKENS:
            q, entry, result = 0, None, "miss"
        else:
            result = "hit" if m >= len(entry.ids) else "partial"
        self.prefix_lookups[result] += 1
        if self.counting:
            PREFIX_CACHE_TOTAL.labels(result).inc()
            if q:
                PREFIX_CACHED_TOKENS.observe(float(q))
        return q, entry

    def prefix_insert(self, ids: list, cache: KVCache, row: int = 0) -> None:
        """Store row ``row``'s first len(ids) cache positions, its REAL
        prompt positions, which by causality are what a fresh prefill of
        those tokens computes: valid for ANY continuation. Clones, never
        views: the cache belongs to a program, whose next replay
        overwrites it. Best-effort: the store is an accelerator, so a
        failed insert (the ``serve.prefix_insert`` fault site) is logged
        once and the request keeps its tokens."""
        n = len(ids)
        if self.prefix is None or n < MIN_PREFIX_TOKENS:
            return
        try:
            FAULTS.fire("serve.prefix_insert")
            self.prefix.insert(ids, _kv_arrays(cache, row, n))
        except Exception as e:  # noqa: BLE001 — accelerator only
            warn_once(
                "prefix_insert_failed",
                f"prefix-cache insert failed (serving continues without "
                f"storing): {type(e).__name__}: {e}")

    def prefill_any(self, ids: list, width: int, span: int,
                    b: int = 1) -> _Slots:
        """Warm-or-cold prefill of ``b`` identical rows of ``ids`` at this
        width and span (the reference's ``_prefill_any``, the one policy
        point of the solo paths and the dense engine): a prompt sharing
        at least MIN_PREFIX_TOKENS positions with a stored prefix resumes
        from them (:meth:`prefill_warm`), any other prefills cold; either
        way the prompt is stored after (the ``serve.prefill`` fault site
        fires first). → the slots, as :meth:`prefill`."""
        FAULTS.fire("serve.prefill")
        rows = _pad_rows([ids] * b, width)
        lengths = torch.tensor([len(ids)] * b, dtype=torch.int32)
        q, entry = (self.prefix_lookup(ids) if self.prefix is not None
                    else (0, None))
        if entry is None:
            st = self.prefill(rows, lengths, span)
        else:
            a = entry.arrays
            st = self.prefill_warm(rows, lengths, a["k"], a["v"], q, span,
                                   a.get("k_scale"), a.get("v_scale"))
        self.prefix_insert(ids, st.cache)
        return st

    def decode(self, st: _Slots, steps: int) -> torch.Tensor:
        """``steps`` greedy decode steps from the slots' carry, in place →
        the emitted tokens (b, steps) int32 (a copy: the program's own
        output is overwritten by its next replay)."""
        b, width = st.tokens.shape
        span = st.cache.k.shape[3]
        if st.length + steps > span:
            raise ValueError(f"cache span {span} cannot take {steps} more "
                             f"steps after {st.length}")

        params, cfg, eos_id = self.params, self.cfg, self.eos_id

        def build():
            out = torch.zeros((b, steps), dtype=torch.int32,
                              device=st.token.device)

            def body():
                # st.cache's host length is the prompt's; the slot the
                # segment starts at is read from st.start at every replay
                toks, tok, done, _ = decode_segment(
                    params, st.cache, st.token, st.done, cfg, steps,
                    eos_id=eos_id, pad_id=0, start=st.start)
                out.copy_(toks)
                st.token.copy_(tok)
                st.done.copy_(done)
            body.out = out
            return body

        program = self.programs.get(("decode", b, width, span, steps), build)
        st.start.fill_(st.length)
        cost = _decode_cost(cfg, [(pl, width, st.length)
                                  for pl in st.lengths_host], steps,
                            **self.cost_opts)
        with self._phase("decode", program, cost, b * steps) as ph:
            program()
            ph.sync(program.body.out)
        st.length += steps
        return program.body.out.clone()

    def run(self, rows: torch.Tensor, lengths: torch.Tensor, budgets: list,
            run_max_new: int, k_steps: int) -> tuple[list, int]:
        """Prefill cold at span ``width + run_max_new``, then
        :meth:`decode_greedy`."""
        st = self.prefill(rows, lengths, rows.shape[1] + run_max_new)
        return self.decode_greedy(st, budgets, k_steps)

    def decode_greedy(self, st: _Slots, budgets: list, k_steps: int
                      ) -> tuple[list, int]:
        """Greedy decode from prefilled slots to their span, in segments
        of ``k_steps`` steps (the last one shorter, its own key) with a
        host-side liveness check between them: a row is live until its
        EOS appears or its own budget is emitted; once none is, the rest
        of the run is skipped. → (tokens (b, 1+steps_run) list of lists,
        steps_run)."""
        b, width = st.tokens.shape
        total = st.cache.k.shape[3] - width - 1   # after the first token
        k_steps = k_steps if k_steps > 0 else total
        pieces = [st.token[:, None].clone()]
        emitted = 1
        steps_run = 0
        while steps_run < total:
            done_h = st.done.tolist()
            if not any(budgets[i] > emitted and not done_h[i]
                       for i in range(b)):
                break
            steps = min(k_steps, total - steps_run)
            pieces.append(self.decode(st, steps))
            emitted += steps
            steps_run += steps
        saved = total - steps_run
        if saved > 0 and self.counting:
            DECODE_STEPS_SAVED.inc(saved)
        return torch.cat(pieces, dim=1).tolist(), steps_run

    def lookup_rounds(self, ids: list, width: int, span: int, max_new: int,
                      k: int, ngram: int, finish: dict | None = None):
        """Prompt-lookup speculation for one greedy request (the
        reference's ``_lookup_rounds``): the rounds of
        :func:`~tpu_kubernetes_torch.models.speculative.
        prompt_lookup_rounds` in the lane's programs, a cold ragged
        prefill at ``width`` into a cache of ``span`` (the caller reserves
        ``k`` positions past the budget), then one graphed verify round a
        round, its n-gram proposals, acceptance and state on the device
        and one host read of its tokens. Yields each round's accepted
        tokens (the first yield is the prefill's token), up to ``max_new``
        or EOS. The caller holds the generation lock. ``finish`` receives
        "reason" at a natural end and, even when the caller stops early,
        "spec" (rounds, counting the prefill, drafted and accepted) and
        the ledger's counts: "produced" (the prefill's token and k + 1 a
        round), "emitted" (accepted tokens, an EOS included), "delivered"
        (yielded) and "device_s" (host seconds inside the rounds). The
        profiler sees the prefill and the rounds as the reference's
        "prefill" and "decode" phases."""
        rounds = drafted = accepted = 0
        produced = emitted = delivered = 0
        dev_s = tail_s = 0.0
        eos_id = self.eos_id
        done = False
        batches = prompt_lookup_rounds(
            self.params, self.cfg, ids, max_new, draft_k=k, ngram=ngram,
            width=width, span=span, programs=self.programs)
        firsts = (PROFILER.mark_first("prefill", ("lookup", width, span)),
                  PROFILER.mark_first("decode", ("lookup", width, span, k)))
        try:
            i = 0
            while True:
                t0 = time.perf_counter()
                item = next(batches, None)
                d = time.perf_counter() - t0
                if item is None:
                    break
                new, acc = item
                dev_s += d
                if i == 0:
                    produced += 1
                    PROFILER.record_cost("prefill",
                                         _prefill_cost(self.cfg, 1, width,
                                                       **self.cost_opts),
                                         tokens=width)
                    PROFILER.observe("prefill", d, mode=(
                        COMPILE if firsts[0] else EXECUTE))
                else:
                    rounds += 1
                    drafted += k
                    accepted += acc
                    produced += k + 1
                    PROFILER.record_cost("decode", _decode_cost(
                        self.cfg, [(len(ids), width, width + emitted - 1)],
                        k + 1, **self.cost_opts), tokens=k + 1)
                    if firsts[1] and rounds == 1:
                        PROFILER.observe("decode", d, mode=COMPILE)
                    else:
                        tail_s += d
                emitted += len(new)
                i += 1
                if eos_id is not None and eos_id in new:
                    new = new[:new.index(eos_id)]  # EOS itself is not emitted
                    done = True
                delivered += len(new)
                yield new
                if done:
                    break
            if finish is not None:
                finish["reason"] = "stop" if done else "length"
        finally:
            batches.close()
            n_tail = rounds - (1 if firsts[1] and rounds else 0)
            if n_tail > 0:
                PROFILER.observe("decode", tail_s, mode=EXECUTE,
                                 calls=n_tail)
            if finish is not None:
                finish["spec"] = {"rounds": rounds + 1, "drafted": drafted,
                                  "accepted": accepted}
                finish.update(produced=produced, emitted=emitted,
                              delivered=delivered, device_s=dev_s)


class SampledLane:
    """The sampled and streamed serving programs (the reference's jitted
    ``generate`` per (max_new, temperature, top_k, top_p) and its
    ``("step", temperature, top_k, top_p)`` stream program), kept in the
    greedy lane's :class:`Programs` (one graph pool) over its
    :class:`_Slots`, so their cache and token buffers are shared by shape
    and memory grows with the width buckets, not with the knobs:

    * ``("generate", b, width, span, max_new, variant)``: the whole
      request (:func:`~tpu_kubernetes_torch.models.decode.generate_into`:
      prefill, first sample, ``max_new - 1`` steps) into an output buffer;
    * ``("draw", b, width, span, variant)``: a stream's first token from
      its prefill's logits;
    * ``("step", b, width, span, variant)``: one decode step and its
      sample, a stream's next token (greedy streams included).

    ``variant`` (:func:`~tpu_kubernetes_torch.models.decode.sampling_variant`)
    says which parts of the sampler run; the knob values are copied into
    one device buffer before each call, so one program per shape serves
    every request. The reference keys by value; this lane keys by shape;
    either way every key captures once. The draws come from the lane's
    one generator, which each request seeds (``seed``) and every program
    registers (``util/graphs.py``), in ``generate``'s order: a seeded
    request samples the same tokens eagerly, through a replay and
    streamed. The caller serialises requests (the server's generation
    lock)."""

    def __init__(self, greedy: GreedyLane):
        self.greedy = greedy
        self.generator = torch.Generator(device=greedy.device)
        self.knobs = torch.zeros((3,), dtype=torch.float32,
                                 device=greedy.device)

    @property
    def programs(self) -> Programs:
        return self.greedy.programs

    def _request(self, temperature, top_k, top_p, seed) -> str:
        """Copy a request's knob values in and seed the generator (None:
        the draws carry on) → its variant."""
        self.knobs.copy_(sampling_knobs(temperature, top_k, top_p),
                         non_blocking=True)
        if seed is not None:
            self.generator.manual_seed(int(seed))
        return sampling_variant(temperature, top_k, top_p)

    def generate(self, rows: torch.Tensor, lengths: torch.Tensor,
                 max_new: int, span: int, *, temperature: float = 0.0,
                 top_k: int = 0, top_p: float = 0.0, seed: int | None = None
                 ) -> torch.Tensor:
        """The right-padded ``rows`` (b, width) with their ``lengths``
        through the generate program: ``max_new`` tokens a row in a cache
        of ``span``, EOS rows padded after their EOS (the greedy lane's
        EOS id) → (b, max_new) int32 (a copy: the program's buffer is
        overwritten by its next replay)."""
        b, width = rows.shape
        if width + max_new > span:
            raise ValueError(f"cache span {span} cannot take {max_new} "
                             f"tokens after a prompt of {width}")
        variant = self._request(temperature, top_k, top_p, seed)
        st = self.greedy.slots(b, width, span)
        g = self.greedy
        params, cfg, eos_id = g.params, g.cfg, g.eos_id
        knobs, gen = self.knobs, self.generator

        def build():
            out = torch.zeros((b, max_new), dtype=torch.int32,
                              device=st.token.device)

            def body():
                generate_into(params, st.tokens, cfg, out, st.cache, knobs,
                              variant, generator=gen,
                              prompt_lengths=st.lengths, eos_id=eos_id)
            body.out = out
            return body

        program = self.programs.get(
            ("generate", b, width, span, max_new, variant), build, (gen,))
        st.tokens.copy_(rows, non_blocking=True)
        st.lengths.copy_(lengths, non_blocking=True)
        cost = _add_costs(_prefill_cost(cfg, b, width, **g.cost_opts),
                          _decode_cost(cfg, [(pl, width, width) for pl in
                                             _host_lengths(lengths, width)],
                                       max_new - 1, **g.cost_opts))
        with g._phase("generate", program, cost, b * (width + max_new - 1)
                      ) as ph:
            program()
            ph.sync(program.body.out)
        return program.body.out.clone()

    def _sampler(self, kind: str, st: _Slots, variant: str):
        """The "draw" or "step" program of ``st``'s shape: the slots'
        token from their logits, or one decode step from their token at
        the slot in ``st.start`` and its sample."""
        b, width = st.tokens.shape
        span = st.cache.k.shape[3]
        g = self.greedy
        params, cfg = g.params, g.cfg
        knobs, gen = self.knobs, self.generator

        def build():
            def body():
                logits = st.logits
                if kind == "step":
                    # st.cache's host length is the prompt's: the slot is
                    # read from st.start at every replay
                    logits, _ = decode_step(params, st.cache, st.token, cfg,
                                            start=st.start)
                st.token.copy_(sample_tokens(logits, knobs, variant, gen))
            return body

        return self.programs.get((kind, b, width, span, variant), build,
                                 (gen,))

    def stream(self, ids: list, width: int, span: int, *,
               temperature: float = 0.0, top_k: int = 0, top_p: float = 0.0,
               seed: int | None = None):
        """Yield the request's token ids one at a time, up to the span:
        the prefill through the greedy lane's ``prefill_any`` (warm or
        cold), the first token drawn from its logits ("draw"; a greedy
        stream takes the prefill's argmax), then one "step" replay a token
        and one int read back for it. The draws follow ``generate``'s
        order, so a seeded stream yields the generate program's tokens.
        The profiler sees the first step as its own "decode" phase and the
        rest as one execute observation, each timed up to the read of its
        token and never across a yield."""
        variant = self._request(temperature, top_k, top_p, seed)
        st = self.greedy.prefill_any(ids, width, span)
        if variant != "greedy":
            self._sampler("draw", st, variant)()
        yield int(st.token[0])
        step = self._sampler("step", st, variant)
        cfg, pl = self.greedy.cfg, len(ids)
        tail_s, tail_n = 0.0, 0
        try:
            for slot in range(width, span - 1):
                first = not step.captures
                t0 = time.perf_counter()
                st.start.fill_(slot)
                step()
                tok = int(st.token[0])
                d = time.perf_counter() - t0
                PROFILER.record_cost("decode", _decode_cost(
                    cfg, [(pl, width, slot)], 1, **self.greedy.cost_opts),
                    tokens=1)
                if slot == width:
                    PROFILER.observe("decode", d,
                                     mode=COMPILE if first else EXECUTE)
                else:
                    tail_s += d
                    tail_n += 1
                yield tok
        finally:
            if tail_n:
                PROFILER.observe("decode", tail_s, mode=EXECUTE,
                                 calls=tail_n)


class _Batcher:
    """Coalesce concurrent greedy requests into one ragged batch (round
    batching, the reference's ``_Batcher``).

    Requests enqueue and block; a dispatcher thread wakes on the first
    arrival, waits ``window_ms`` for co-riders (waking early once
    ``max_batch`` are queued), takes up to ``max_batch`` that ``fits``
    admits, runs ONE batched program and fans the per-row results back.
    Each row is truncated to its own requested max_new_tokens, so
    co-riding never changes a response. An entry whose deadline has
    passed is failed out at dispatch, never selected; ``on_wait`` hears
    each selected entry's queue wait (the admission controller's service
    time)."""

    def __init__(self, run_batch, max_batch: int, window_ms: float,
                 fits=None, on_wait=None):
        self._run_batch = run_batch        # (entries) → None, sets results
        self.max_batch = max_batch
        self.window_s = window_ms / 1e3
        # fits(selected, entry): may entry join this batch? Two
        # individually valid requests can be jointly invalid
        self._fits = fits or (lambda selected, entry: True)
        self._on_wait = on_wait
        self._queue: list[dict] = []
        self._cond = threading.Condition()
        self._thread = threading.Thread(target=self._dispatch, daemon=True)
        self._thread.start()

    def enqueue(self, ids: list, max_new: int,
                budget: int | None = None,
                deadline: float | None = None) -> dict:
        """Queue a request → its entry. ``entry["dispatched"]`` fires when
        it is selected into a batch, ``entry["event"]`` when its tokens
        are ready. ``budget`` is the REQUESTED max_new (≤ the bucketed
        ``max_new`` the program runs): the decode loop stops counting a
        row live once its own budget is emitted. ``deadline`` (monotonic)
        makes the dispatcher fail the entry out once expired."""
        entry = {
            "ids": ids, "max_new": max_new, "t_enq": time.monotonic(),
            "budget": max_new if budget is None else budget,
            "deadline": deadline,
            "event": threading.Event(), "dispatched": threading.Event(),
            "tokens": None, "error": None,
        }
        with self._cond:
            self._queue.append(entry)
            self._cond.notify()
        return entry

    def depth(self) -> int:
        with self._cond:
            return len(self._queue)

    @staticmethod
    def result(entry: dict) -> list:
        entry["event"].wait()
        if entry["error"] is not None:
            raise entry["error"]
        return entry["tokens"]

    def _dispatch(self) -> None:
        # the loop body never raises: a dead dispatcher would block every
        # submitter, so a failure fails the affected entries out instead
        while True:
            with self._cond:
                while not self._queue:
                    self._cond.wait()
                deadline = time.monotonic() + self.window_s
                while len(self._queue) < self.max_batch:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        break
                    self._cond.wait(timeout=left)
                pending, self._queue = self._queue, []
            # deadline reaping happens here, before an entry costs device
            # time: an expired entry fails out (504), never selected
            now = time.monotonic()
            live: list[dict] = []
            for entry in pending:
                if expired(entry.get("deadline"), now):
                    DEADLINE_TOTAL.labels("queued").inc()
                    entry["error"] = DeadlineExceeded(
                        "deadline expired while queued for dispatch")
                    entry["dispatched"].set()
                    entry["event"].set()
                else:
                    live.append(entry)
            pending = live
            if not pending:
                continue
            batch: list[dict] = []
            rest: list[dict] = []
            err: Exception | None = None
            try:
                for entry in pending:
                    if (len(batch) < self.max_batch
                            and self._fits(batch, entry)):
                        batch.append(entry)
                    else:
                        rest.append(entry)   # next dispatch round
                if not batch:
                    # fits([], head) admits every validated request; if
                    # that breaks, fail the round rather than spin
                    raise RuntimeError(
                        "dispatcher selected nothing from a nonempty queue")
            except Exception as e:  # noqa: BLE001 — selection failure
                batch, rest = pending, []    # taints the whole round
                err = e
                BATCH_TAINT.inc()
            else:
                # queue wait = enqueue → dispatch; batch size = co-riders
                now = time.monotonic()
                for entry in batch:
                    QUEUE_SECONDS.observe(now - entry["t_enq"])
                    if self._on_wait is not None:
                        self._on_wait(now - entry["t_enq"])
                    entry["dispatched"].set()
                BATCH_SIZE.observe(len(batch))
                try:
                    self._run_batch(batch)
                except Exception as e:  # noqa: BLE001 — fan the error out
                    err = e
            for entry in batch:
                if err is not None:
                    entry["error"] = err
                entry["dispatched"].set()
                entry["event"].set()
            if rest:
                with self._cond:
                    self._queue = rest + self._queue


class ContinuousEngine:
    """Continuous in-flight batching (SERVE_CONTINUOUS_BATCHING=1), the
    reference's ``_ContinuousEngine`` with a dense or a paged KV cache.

    One scheduler thread owns a fixed (slots, max_seq) batch cache,
    allocated once outside the graph pool. Between segments of
    ``seg_steps`` greedy steps over every slot
    (:func:`~tpu_kubernetes_torch.models.decode.decode_segment_slots`) it
    hands finished rows back to their waiting callers, clears their slots
    and admits queued requests: each is prefilled at its own power-of-two
    width with span == width (the lane's ``("prefill", 1, width, width)``
    program) and grafted into a free slot. A request arriving mid-decode
    waits at most one segment for admission.

    With ``pool_mb`` > 0 (SERVE_KV_POOL_MB) the cache is a pool of
    ``page_size``-position pages instead
    (:class:`~tpu_kubernetes_torch.models.decode.PagedKVCache`), with a
    (slots, max_seq // page_size) page table and the host's
    :class:`~tpu_kubernetes_torch.serve.pages.PagePool`. Admission gates
    on free pages (the prompt's and the first decode write's); before
    every segment each live row's table is topped up to cover the
    positions the segment writes, preempting the youngest other resident
    row (requeued at the head of the queue: greedy decode re-emits its
    tokens) when the pool runs dry, or failing the row out when nothing
    is left to preempt; a cleared row releases its pages, and the pages
    that frees are wiped.

    With the lane's prefix store on (SERVE_PREFIX_CACHE_MB), a dense
    admission prefills through the lane's ``prefill_any``, warm where the
    store holds a match. The paged engine keeps a store of its own over
    its pool instead: each admitted prompt's whole pages are pinned into
    it, and a warm admission gathers the matched pages into the resume
    base, references them from its table (zero-copy) and scatters only
    the suffix's pages. The store's pinned pages are the first thing
    reclaimed when the pool runs dry; an evicted entry's pages are
    unpinned and, where no slot reads them, wiped. The store is mutated,
    and pages are wiped, only outside ``lock``.

    The programs live in the lane's :class:`Programs` (one graph pool
    with the solo lane): ``("slot_insert", width)``, ``("slot_segment",
    steps)`` and ``("slot_clear",)``, or paged ``("paged_insert",
    width, skip)`` (``skip`` positions already in shared pages),
    ``("paged_segment", steps)`` and ``("page_clear", max_pages)``, CUDA
    graphs on the card. The slot number is a 0-d device
    buffer and the pages of an insert or a clear a static device buffer,
    so one program a width (one clear program) serves every slot. The slot
    state, and the page table, live in device buffers that the host's
    mirrors (pinned on the card) are copied into, in one copy, before
    each segment; after it the host reads the emitted tokens, ``tok``,
    ``pos`` and ``remaining`` back in ONE transfer, the reference's one
    host read a segment. Everything the engine does on the device runs
    under ``lock``, the server's generation lock, taken per prefill,
    segment and clear and released between them.

    With ``spec`` ("ngram" or "draft": SERVE_PROMPT_LOOKUP or
    SERVE_DRAFT_MODEL) a segment is up to ``seg_steps`` speculative verify
    rounds instead (:meth:`_run_segment_spec`): each live row's window is
    its token and ``draft_k`` proposals from its own host buffer, refilled
    at admission and after every round from the row's prompt and tokens
    so far, by n-gram lookup or by the draft lane's graphed batch-1
    ``("spec_draft", width, k)`` program (``draft``, a
    :class:`GreedyLane` of the draft model). A round is one replay of
    ``("verify", slots, k)`` (paged ``("verify_paged", slots, k)``) after
    the proposals are uploaded with the slot state, and one host read;
    paged, each live row's table is topped up to cover the round's
    ``k + 1`` positions first and truncated to its accepted extent after.
    An admission reserves ``draft_k`` positions past its budget for the
    window. ``spec_totals`` counts rounds, drafted and accepted tokens.

    The engine takes the greedy lane (its params, config, EOS id and
    programs; ``GreedyLane(..., graphs=False)`` runs the same bodies
    eagerly), the slot count and the segment length; one engine a lane.
    Entries share :class:`_Batcher`'s shape, so ``complete()`` consumes
    both the same way. Per-row tokens equal solo greedy decode (the
    ragged-row independence argument of
    :class:`~tpu_kubernetes_torch.models.decode.SlotState`), up to the
    float ties of a different cache span and batch; the paged engine's
    equal the dense engine's. ``close()`` stops the scheduler thread.

    The operations layer rides the scheduler as in the reference: an
    entry's ``deadline`` or ``cancel`` fails it out of the queue, or
    retires its resident row after the segment it is in (:meth:`_reap`,
    through the graphed clear program: the segment itself is never cut
    short); every token the device produced settles in the goodput
    ledger (useful at ``complete()``, bubble for dead row-steps,
    shed-spent for work a failure threw away, speculative waste for a
    round's rejected cells); the segment's device seconds are CUDA-event
    times read after the readback the segment already makes; the fault
    sites ``serve.slot_insert``, ``serve.prefill``, ``serve.segment``,
    ``serve.spec_verify`` and ``serve.prefix_insert`` fire on the host
    before their replays. :meth:`restart` (the server's :class:`Watchdog`)
    replaces a dead scheduler thread after a cold reset that wipes the
    cache, pool and slot state IN PLACE: the captured graphs hold their
    addresses, so nothing is reallocated and nothing recaptured.
    ``admission`` (an :class:`AdmissionController`) hears each
    admission's wait. ``flightrec`` (a
    :class:`~tpu_kubernetes_torch.obs.flightrec.FlightRecorder`) gets one
    record a segment and a postmortem dump before every cold reset;
    ``alerts`` (an :class:`~tpu_kubernetes_torch.obs.alerts.AlertManager`
    over :func:`~tpu_kubernetes_torch.obs.alerts.engine_tripwires`) is
    evaluated on the scheduler thread between passes and, idle, every
    ``_ALERT_IDLE_WAIT_S``, at most once every ``alert_tick_s``
    (TPU_K8S_ALERT_TICK_S)."""

    def __init__(self, lane: GreedyLane, slots: int, seg_steps: int,
                 lock: threading.Lock | None = None, *,
                 pool_mb: float = 0.0, page_size: int = 16,
                 spec: str | None = None, draft_k: int = 8, ngram: int = 2,
                 draft: GreedyLane | None = None,
                 admission: AdmissionController | None = None,
                 flightrec=None, alerts=None, alert_tick_s: float = 1.0):
        if spec not in (None, "ngram", "draft"):
            raise ValueError(f"spec must be None, 'ngram' or 'draft'; got "
                             f"{spec!r}")
        if spec == "draft" and draft is None:
            raise ValueError("spec='draft' needs the draft model's lane")
        if spec is not None:
            check_draft_k(draft_k)
        self.lane = lane
        self.admission = admission
        # the black box (obs/flightrec.py, obs/alerts.py): set before the
        # scheduler thread starts, so the first segment feeds them
        self._flightrec = flightrec
        self._alerts = alerts
        self._alert_tick_s = alert_tick_s
        self._last_alert_tick = 0.0
        self.spec_source = spec
        self.draft_k = draft_k if spec is not None else 0
        self.ngram = ngram
        self._draft = draft
        self.spec_totals = {"rounds": 0, "drafted": 0, "accepted": 0}
        self.slots = slots
        self.seg_steps = max(1, seg_steps)
        self.span = lane.cfg.max_seq
        self._lock = lock if lock is not None else threading.Lock()
        device = lane.device
        self.paged = pool_mb > 0
        self._cache = self._pool = None
        self._prefix = None
        self.max_pages = 0
        if self.paged:
            ps = int(page_size)
            if ps < 1 or (ps & (ps - 1)) or MIN_PREFIX_TOKENS % ps:
                raise ValueError(
                    f"SERVE_KV_PAGE_SIZE must be a power of two dividing "
                    f"{MIN_PREFIX_TOKENS}, got {ps} (width buckets and "
                    "reused-prefix lengths must be page-aligned)")
            if self.span % ps:
                raise ValueError(f"SERVE_KV_PAGE_SIZE {ps} must divide "
                                 f"max_seq {self.span}")
            self.page_size = ps
            # every row's table covers a full span: the same attention
            # span (and reduction order) as the dense engine's
            self.max_pages = self.span // ps
            nbytes = page_bytes(lane.cfg, ps, lane.kv_quant)
            num_pages = int(pool_mb * 2 ** 20) // nbytes
            if num_pages < self.max_pages:
                raise ValueError(
                    f"SERVE_KV_POOL_MB={pool_mb} holds {num_pages} pages of "
                    f"{ps} positions ({nbytes} B each); one full-span row "
                    f"needs {self.max_pages}")
            self._page_nbytes = nbytes
            self._pages = PagePool(num_pages)
            self._pool = init_paged_pool(lane.cfg, num_pages, ps,
                                         kv_quant=lane.kv_quant,
                                         device=device)
            if lane.prefix is not None:
                # the engine's OWN store holds page ids over THIS pool
                # (zero-copy warm starts); the lane's byte store keeps
                # serving the solo and streaming paths. It reaches the
                # engine weakly: a store holding the engine would keep it,
                # and the lane's graphs, alive in a reference cycle
                evict = weakref.WeakMethod(self._on_prefix_evict)
                self._prefix = PrefixCache(
                    lane.prefix.max_bytes, sig=lane.prefix.sig,
                    on_evict=lambda entry: evict()(entry))
            self._slot_pages: list[list[int]] = [[] for _ in range(slots)]
            # admission order, for youngest-first preemption
            self._admit_seq = [0] * slots
            self._seq = 0
            self.page_stalls = 0
            self.preemptions = 0
            # the pages of an insert or a clear, read by their programs
            self._page_buf = torch.zeros((self.max_pages,),
                                         dtype=torch.int64, device=device)
        else:
            self._cache = init_cache(lane.cfg, slots, self.span,
                                     kv_quant=lane.kv_quant, device=device)
        # the slot state (tok, pos, remaining, prompt_lengths,
        # prompt_slots), the page table and the round's proposals: host
        # mirrors (numpy views of one pinned tensor, owned by the scheduler
        # thread) and the device buffers of the segment and verify
        # programs, each one flat tensor
        nt = 5 * slots + slots * self.max_pages
        n = nt + slots * self.draft_k
        pin = device.type == "cuda"
        self._host_all = torch.zeros((n,), dtype=torch.int32, pin_memory=pin)
        self._dev_all = torch.zeros((n,), dtype=torch.int32, device=device)
        self._host = self._host_all[:5 * slots].view(5, slots)
        self._tok, self._pos, self._rem, self._pl, self._ps = (
            a.numpy() for a in self._host)
        self._table = self._host_all[5 * slots:nt].view(
            slots, self.max_pages).numpy()
        self._state = SlotState(*self._dev_all[:5 * slots].view(5, slots))
        self._table_dev = self._dev_all[5 * slots:nt].view(slots,
                                                           self.max_pages)
        self._drafts = self._host_all[nt:].view(slots, self.draft_k).numpy()
        self._drafts_dev = self._dev_all[nt:].view(slots, self.draft_k)
        self._proposals: list[list[int]] = [[] for _ in range(slots)]
        self._slot = torch.zeros((), dtype=torch.int64, device=device)
        self._cond = threading.Condition()
        self._queue: list[dict] = []
        # _entries[i] is the request holding slot i (None = free)
        self._entries: list[dict | None] = [None] * slots
        self._collected: list[list[int]] = [[] for _ in range(slots)]
        self.recycled = 0
        # cold resets after a failure (the reference counts its watchdog's
        # restarts of a dead scheduler; this loop never dies)
        self.restarts = 0
        # segments run and the row-steps of live rows in them: the mean
        # slot occupancy is live_steps / (segments * seg_steps)
        self.segments = 0
        self.live_steps = 0
        # admissions and reaps since the last segment (the ledger's
        # timeline), scheduler thread only
        self._last_admitted = 0
        self._last_reaped = 0
        # the CUDA events around a segment's replay (read after its
        # readback) and whether that replay was its program's first call
        self._events = ((torch.cuda.Event(enable_timing=True),
                         torch.cuda.Event(enable_timing=True))
                        if device.type == "cuda" else None)
        self._first_call = False
        if self.paged:
            self._update_page_gauge()
        self._closed = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def enqueue(self, ids: list, max_new: int,
                deadline: float | None = None,
                cancel: threading.Event | None = None) -> dict:
        """Queue a request → its entry (:meth:`_Batcher.enqueue`'s shape;
        ``dispatched`` fires at the slot insert, ``event`` when the row's
        tokens are ready). ``deadline`` (monotonic) and ``cancel`` make
        the scheduler fail the entry out of the queue, or retire its row
        mid-flight, once it stops being worth serving; the submitter's
        trace id rides along for the segment spans and exemplars."""
        entry = {
            "ids": ids, "max_new": max_new, "budget": max_new,
            "t_enq": time.monotonic(), "deadline": deadline,
            "cancel": cancel, "trace": tracing.current_trace_id(),
            "event": threading.Event(), "dispatched": threading.Event(),
            "tokens": None, "error": None,
        }
        with self._cond:
            if self._closed:
                raise RuntimeError("the continuous engine is closed")
            self._queue.append(entry)
            self._cond.notify()
        return entry

    def depth(self) -> int:
        with self._cond:
            return len(self._queue)

    def stats(self) -> dict:
        """One-glance engine state for /healthz; paged, ``pages`` holds the
        pool's free / live / pinned partition (it sums to ``total``: a
        drift IS a page leak), the page size, the admissions and top-ups
        that found too few free pages (``stalls``) and the preemptions;
        speculating, ``speculation`` holds the proposer, draft_k and the
        rounds, drafted and accepted totals."""
        out = {
            "slots": self.slots,
            "occupied": sum(e is not None for e in self._entries),
            "queued": self.depth(),
            "segment_steps": self.seg_steps,
            "recycled": self.recycled,
            "restarts": self.restarts,
        }
        if self.paged:
            out["pages"] = dict(self._pages.stats(),
                                page_size=self.page_size,
                                stalls=self.page_stalls,
                                preemptions=self.preemptions)
            if self._prefix is not None:
                out["pages"]["prefix_entries"] = len(self._prefix)
        if self.spec_source is not None:
            out["speculation"] = dict(self.spec_totals,
                                      source=self.spec_source,
                                      draft_k=self.draft_k)
        return out

    def close(self) -> None:
        """Stop the scheduler thread once its current pass ends; entries
        still queued or resident fail out."""
        with self._cond:
            self._closed = True
            self._cond.notify()
        self._thread.join()
        if self._queue or any(e is not None for e in self._entries):
            self._fail_out(RuntimeError("the continuous engine is closed"))

    # -- the programs (bodies close over buffers, never over the engine) ---

    def _insert_program(self, width: int, skip: int = 0):
        row = self.lane.slots(1, width, width).cache
        if self.paged:
            pool, pages = self._pool, self._page_buf[:width // self.page_size]
            return self.lane.programs.get(
                ("paged_insert", width, skip),
                lambda: lambda: paged_insert_row(pool, row, pages,
                                                 skip=skip))
        cache, slot = self._cache, self._slot
        return self.lane.programs.get(
            ("slot_insert", width),
            lambda: lambda: cache_insert_row(cache, row, slot))

    def _clear_program(self):
        if self.paged:
            pool, pages = self._pool, self._page_buf
            return self.lane.programs.get(
                ("page_clear", self.max_pages),
                lambda: lambda: paged_clear_pages(pool, pages))
        cache, slot = self._cache, self._slot
        return self.lane.programs.get(
            ("slot_clear",), lambda: lambda: cache_clear_row(cache, slot))

    def _segment_program(self):
        lane, steps = self.lane, self.seg_steps
        params, cfg, eos_id = lane.params, lane.cfg, lane.eos_id
        cache, st = self._cache, self._state
        pool, table = self._pool, self._table_dev
        paged = self.paged

        def build():
            # the one buffer the host reads: emitted tokens, tok, pos,
            # remaining, side by side
            out = torch.zeros((st.tok.shape[0], steps + 3),
                              dtype=torch.int32, device=st.tok.device)

            def body():
                if paged:
                    toks, _, _ = decode_segment_paged(
                        params, pool, table, st, cfg, steps, eos_id=eos_id,
                        pad_id=0)
                else:
                    toks, _, _ = decode_segment_slots(
                        params, cache, st, cfg, steps, eos_id=eos_id,
                        pad_id=0)
                out.copy_(torch.cat((toks, st.tok[:, None], st.pos[:, None],
                                     st.remaining[:, None]), dim=1))
            body.out = out
            return body

        key = ("paged_segment" if paged else "slot_segment", steps)
        return lane.programs.get(key, build)

    def _verify_program(self):
        lane, k = self.lane, self.draft_k
        params, cfg, eos_id = lane.params, lane.cfg, lane.eos_id
        cache, st, drafts = self._cache, self._state, self._drafts_dev
        pool, table = self._pool, self._table_dev
        paged = self.paged

        def build():
            # emitted window tokens, tok, pos, remaining, side by side
            out = torch.zeros((st.tok.shape[0], k + 4), dtype=torch.int32,
                              device=st.tok.device)

            def body():
                if paged:
                    toks, _, _ = decode_verify_paged(
                        params, pool, table, st, drafts, cfg, eos_id=eos_id,
                        pad_id=0)
                else:
                    toks, _, _ = decode_verify_slots(
                        params, cache, st, drafts, cfg, eos_id=eos_id,
                        pad_id=0)
                out.copy_(torch.cat((toks, st.tok[:, None], st.pos[:, None],
                                     st.remaining[:, None]), dim=1))
            body.out = out
            return body

        key = ("verify_paged" if paged else "verify", self.slots, k)
        return lane.programs.get(key, build)

    def launch_segment(self) -> torch.Tensor:
        """Upload the host's slot state (and page table, and proposals) and
        run one segment, or speculating one verify round, with no host read
        (caller holds the lock) → the program's output buffer (slots, w +
        3): w emitted tokens (the segment's steps, or the round's k + 1
        window cells), then tok, pos, remaining."""
        program = (self._verify_program() if self.spec_source is not None
                   else self._segment_program())
        self._dev_all.copy_(self._host_all, non_blocking=True)
        self._first_call = not program.captures
        if self._events is not None:
            self._events[0].record()
        program()
        if self._events is not None:
            self._events[1].record()
        return program.body.out

    @staticmethod
    def _readback(out: torch.Tensor):
        """The segment's (or round's) one host read."""
        return out.cpu().numpy()

    def _device_seconds(self, t0: float) -> float:
        """The last launch's device seconds: its CUDA events' interval on
        the card (both complete: the readback came after them), the host
        clock since ``t0`` elsewhere."""
        if self._events is None:
            return time.perf_counter() - t0
        return self._events[0].elapsed_time(self._events[1]) / 1e3

    @property
    def _counting(self) -> bool:
        return self.lane.counting

    def _update_page_gauge(self) -> None:
        s = self._pages.stats()
        for state in ("free", "live", "pinned"):
            KV_PAGES.labels(state).set(s[state])

    def _upload_pages(self, pages: list[int]) -> None:
        """Copy page ids into the insert and clear programs' buffer, from a
        fresh host tensor (pinned on the card, so the copy does not wait;
        the caching host allocator keeps it until the copy has run)."""
        src = torch.tensor(pages, dtype=torch.int64)
        if self._page_buf.is_cuda:
            src = src.pin_memory()
        self._page_buf[:len(pages)].copy_(src, non_blocking=True)

    def warm(self) -> None:
        """Run the default bucket's insert (width 16, into slot 0), one
        segment over idle slots and a clear of slot 0, so that on the card
        all three are captured before the server goes ready; paged, the
        insert and the clear touch only the sink page. Call it while no
        request is queued or resident."""
        with self._lock:
            self._slot.fill_(0)
            if self.paged:
                self._upload_pages([0] * self.max_pages)
            self._insert_program(16)()
            self.launch_segment().cpu()
            self._clear_program()()

    # -- the scheduler thread ---------------------------------------------

    def _loop(self) -> None:
        # the body never raises: a dead scheduler would hang every
        # submitter, so a failure fails the affected entries out and
        # resets the engine cold (an escape past this is the watchdog's)
        while True:
            with self._cond:
                while (not self._closed and not self._queue
                       and all(e is None for e in self._entries)):
                    if self._alerts is None:
                        self._cond.wait()
                    elif not self._cond.wait(timeout=_ALERT_IDLE_WAIT_S):
                        # idle timeout: fall through so the tripwires
                        # still evaluate (alerts resolve and incidents
                        # close on a quiet engine)
                        break
                if self._closed:
                    return
                idle = not self._queue and all(
                    e is None for e in self._entries)
            try:
                if not idle:
                    self._reap()
                    self._admit()
                    self._run_segment()
            except Exception as e:  # noqa: BLE001 — surfaced per entry
                self.restarts += 1
                self._fail_out(e)
            self._alerts_tick()

    def _alerts_tick(self) -> None:
        """Evaluate the engine-local tripwires on the scheduler thread,
        at most once every ``alert_tick_s``. Never raises, never blocks on
        sink I/O (deliveries ride the manager's notifier thread)."""
        if self._alerts is None:
            return
        now = time.time()
        if now - self._last_alert_tick < self._alert_tick_s:
            return
        self._last_alert_tick = now
        try:
            from tpu_kubernetes_torch.obs.alerts import engine_local_context

            self._alerts.evaluate(engine_local_context(
                self._alerts.rules, now,
                store=(self._flightrec.store
                       if self._flightrec is not None else None)))
        except Exception:  # noqa: BLE001 — alerting must not take down
            pass           # the scheduler

    def is_alive(self) -> bool:
        """The watchdog's probe: a closed engine counts as alive (its
        thread ended on purpose)."""
        return self._closed or self._thread.is_alive()

    def restart(self) -> None:
        """The watchdog's recovery: wait for the device work the dead
        thread left (on this path only, never on a segment's), fail every
        queued and resident entry out, wipe the cache, pool and slot state
        in place (the graphs stay valid) and start a fresh scheduler
        thread."""
        if self.lane.device.type == "cuda":
            torch.cuda.synchronize(self.lane.device)
        self._fail_out(RuntimeError(
            "continuous engine scheduler died — restarted cold"),
            reason="watchdog-restart")
        thread = threading.Thread(target=self._loop, daemon=True)
        thread.start()
        self._thread = thread
        self.restarts += 1
        ENGINE_RESTARTS.inc()

    def _reap(self) -> None:
        """Retire expired or cancelled RESIDENT rows between segments: the
        entry fails out (504 / cancelled), its decoded tokens settle as
        expired or cancelled, and its slot is cleared through the graphed
        clear program (paged: its pages released and wiped), so it admits
        in this same pass."""
        now = time.monotonic()
        reaped = False
        for i, entry in enumerate(self._entries):
            if entry is None:
                continue
            cancel = entry.get("cancel")
            if cancel is not None and cancel.is_set():
                CANCELLED_TOTAL.labels("engine").inc()
                cls = "cancelled"
                entry["error"] = Cancelled(
                    "request cancelled — slot retired mid-flight")
            elif expired(entry.get("deadline"), now):
                DEADLINE_TOTAL.labels("resident").inc()
                cls = "expired"
                entry["error"] = DeadlineExceeded(
                    "deadline expired mid-decode — slot retired")
            else:
                continue
            # settle before _retire clears the collected tokens
            if self._counting:
                LEDGER.settle(cls, len(self._collected[i]),
                              device_s=entry.get("_device_s") or 0.0)
            entry["dispatched"].set()
            entry["event"].set()
            self._retire(i)
            self._last_reaped += 1
            reaped = True
        if reaped:
            SLOT_OCCUPANCY.set(sum(e is not None for e in self._entries))

    def _pages_needed(self, width: int) -> int:
        """A paged admission's pages: its prompt's and, where the span has
        room, the page of its first decode write (position ``width``)."""
        return min(width // self.page_size + 1, self.max_pages)

    def _admit(self) -> None:
        """Fill free slots from the queue (FIFO). Paged, the head entry
        waits (a stall, counted) until resident rows free the pages it
        needs (conservatively: a warm hit needs fewer), after the prefix
        store's pinned pages are reclaimed. An entry whose deadline passed
        while queued fails out without a prefill. A failed admission fails
        that entry out (the token its prefill made settles as shed-spent)
        and scrubs the slot; the engine keeps serving."""
        while True:
            free = next(
                (i for i, e in enumerate(self._entries) if e is None), None)
            if free is None:
                return
            with self._cond:
                if not self._queue:
                    return
                entry = self._queue[0]
                stalled = (self.paged and self._pages.free_count()
                           < self._pages_needed(_bucket(len(entry["ids"]))))
                if not stalled:
                    self._queue.pop(0)
            if stalled:
                self.page_stalls += 1
                PAGE_STALLS.inc()
                if self._prefix is not None and len(self._prefix):
                    # reclaim the store's pinned pages before making the
                    # entry wait on live traffic (outside the locks: the
                    # eviction handler wipes pages)
                    self._prefix.clear(notify=True)
                    self._update_page_gauge()
                    continue
                # resident rows hold the pages: the next segments drain
                # them, and admission retries every pass
                return
            if expired(entry.get("deadline")):
                DEADLINE_TOTAL.labels("queued").inc()
                entry["error"] = DeadlineExceeded(
                    "deadline expired while queued for a slot")
                entry["dispatched"].set()
                entry["event"].set()
                continue
            try:
                self._insert(entry, free)
            except Exception as e:  # noqa: BLE001 — this entry only
                entry["error"] = e
                entry["dispatched"].set()
                entry["event"].set()
                if self._counting:
                    LEDGER.settle("shed-spent", entry.get("_decoded") or 0,
                                  device_s=entry.get("_device_s") or 0.0)
                # the graft may have half-landed: scrub the row so the
                # slot the next admission reuses is bitwise cold
                self._clear_row(free, best_effort=True)

    def _insert(self, entry: dict, slot: int) -> None:
        FAULTS.fire("serve.slot_insert")
        ids, budget = entry["ids"], entry["budget"]
        width = _bucket(len(ids))
        if width + budget + self.draft_k > self.span:
            # a retired row keeps writing at its frozen pos (and, when
            # speculating, its window of draft_k more), which must stay
            # inside the cache
            raise ValueError(
                f"prompt bucket {width} + budget {budget}"
                + (f" + draft_k {self.draft_k}" if self.draft_k else "")
                + f" exceeds max_seq {self.span}")
        eos_id = self.lane.eos_id
        t0 = time.perf_counter()
        with self._lock:
            # per-row width bucket, span == width: the prefill programs are
            # the solo lane's, and so is the dense engine's prefix store
            if self.paged:
                st, shared = self._prefill_paged(ids, width)
            else:
                st = self.lane.prefill_any(ids, width, width)
            first = int(st.token[0])
            # the prefill's token exists now: if the graft below fails,
            # _admit settles it shed-spent through this mark
            if self._counting:
                LEDGER.emitted(1)
            entry["_decoded"] = 1
            if budget <= 1 or (eos_id is not None and first == eos_id):
                entry["tokens"] = [first]     # done without a slot
            elif self.paged:
                self._admit_paged(slot, width, shared)
            else:
                self._slot.fill_(slot)
                self._insert_program(width)()
        entry["_device_s"] = time.perf_counter() - t0
        wait = time.monotonic() - entry["t_enq"]
        entry["_wait"] = wait
        ADMISSION_WAIT.observe(wait, exemplar=entry.get("trace") or None)
        if self.admission is not None:
            self.admission.observe_service(wait)
        if entry["tokens"] is not None:
            entry["dispatched"].set()
            entry["event"].set()
            return
        self._entries[slot] = entry
        self._collected[slot] = [first]
        self._pos[slot] = width
        self._tok[slot] = first
        self._rem[slot] = budget - 1          # the first token is emitted
        self._pl[slot] = len(ids)
        self._ps[slot] = width
        if self.paged:
            self._admit_seq[slot] = self._seq
            self._seq += 1
            # outside the lock: an eviction the insert triggers wipes pages
            self._prefix_store_paged(ids, slot)
        if self.spec_source is not None:
            self._refill_proposal(slot)
        self._last_admitted += 1
        if self.paged:
            self._update_page_gauge()
        entry["dispatched"].set()
        SLOT_OCCUPANCY.set(sum(e is not None for e in self._entries))

    # -- paged mode (scheduler thread only) -------------------------------

    def _prefill_paged(self, ids: list, width: int) -> tuple[_Slots, list]:
        """→ (the prefilled row's slots, the shared page ids). The
        engine's own store serves warm starts: a hit gathers the pinned
        pages into the resume base (the bytes ``paged_insert_row``
        scattered) and prefills only the suffix, and reports the pages so
        that :meth:`_admit_paged` references instead of copying them
        (caller holds the lock). Fires the ``serve.prefill`` site first."""
        FAULTS.fire("serve.prefill")
        rows = _pad_rows([ids], width)
        lengths = torch.tensor([len(ids)], dtype=torch.int32)
        q, entry = 0, None
        if self._prefix is not None:
            q, entry = self.lane.prefix_lookup(ids, self._prefix)
        if entry is None:
            return self.lane.prefill(rows, lengths, width), []
        # q is a power of two >= MIN_PREFIX_TOKENS, which the page size
        # divides: the reuse is whole pages, and q < len(ids) <= width
        # leaves at least one suffix page to scatter
        shared = list(entry.pages[:q // self.page_size])
        base = gather_pages(self._pool, torch.tensor(
            shared, dtype=torch.int64, device=self._pool.k.device))
        return self.lane.prefill_warm(rows, lengths, base.k, base.v, q,
                                      width, base.k_scale,
                                      base.v_scale), shared

    def _admit_paged(self, slot: int, width: int, shared: list) -> None:
        """Allocate an admission's pages past the ``shared`` ones, all or
        nothing, reference the shared ones, record them all (before the
        scatter: if it fails, the scrub releases exactly these) and
        scatter the prefilled row into the prompt's fresh pages (caller
        holds the lock)."""
        ps = self.page_size
        n_prompt = width // ps
        need = self._pages_needed(width) - len(shared)
        got = self._pages.allocate(need)
        if got is None:
            self.page_stalls += 1
            PAGE_STALLS.inc()
            raise RuntimeError(
                f"page pool exhausted at admission ({need} pages needed, "
                f"{self._pages.free_count()} free)")
        self._pages.ref(shared)
        row_pages = shared + got[:n_prompt - len(shared)]
        self._slot_pages[slot] = row_pages + got[n_prompt - len(shared):]
        self._table[slot, :] = 0
        self._table[slot, :len(self._slot_pages[slot])] = \
            self._slot_pages[slot]
        self._upload_pages(row_pages)
        self._insert_program(width, len(shared) * ps)()

    def _prefix_store_paged(self, ids: list, slot: int) -> None:
        """Pin the new row's whole-page prompt prefix into the engine's
        store (best-effort, as the lane's ``prefix_insert``): a stored
        entry pins its pages, so they outlive the slot for later warm
        hits. The stored ids are cut to a page boundary, so ids map to
        pages exactly. The caller must NOT hold the lock: an eviction
        this triggers wipes pages."""
        if self._prefix is None:
            return
        n_pages = len(ids) // self.page_size
        n_store = n_pages * self.page_size
        if n_store < MIN_PREFIX_TOKENS:
            return
        try:
            FAULTS.fire("serve.prefix_insert")
            pages = self._slot_pages[slot][:n_pages]
            if self._prefix.insert_paged(ids[:n_store], pages,
                                         n_pages * self._page_nbytes):
                self._pages.pin(pages)
        except Exception as e:  # noqa: BLE001 — accelerator only
            warn_once(
                "prefix_insert_failed",
                f"prefix-cache insert failed (serving continues without "
                f"storing): {type(e).__name__}: {e}")

    def _on_prefix_evict(self, entry) -> None:
        """The store dropped an entry → unpin its pages; those no resident
        slot still reads are wiped and freed. The store fires this after
        releasing its own lock, and the engine mutates the store only
        outside its lock, so the wipe can take it."""
        self._wipe_pages(self._pages.unpin(list(entry.pages)))
        self._update_page_gauge()

    def _wipe_pages(self, pages: list[int]) -> None:
        """Wipe freed pages back to zeros before the free list reuses them,
        through ONE program: the pages padded to max_pages with an
        out-of-range sentinel."""
        sentinel = self._pages.total + 1
        with self._lock:
            for i in range(0, len(pages), self.max_pages):
                part = pages[i:i + self.max_pages]
                self._upload_pages(
                    part + [sentinel] * (self.max_pages - len(part)))
                self._clear_program()()

    def _topup_pages(self, adv_cap: int | None = None) -> None:
        """Before a segment: grow every live row's table to cover the
        positions the segment writes (programs never allocate); a verify
        round passes ``adv_cap`` = k + 1, the positions a round can emit
        (its window's writes past them land in the page-0 sink, and the
        budget clips what they would give). When the pool runs dry, drop
        the prefix store's pinned pages, then preempt the youngest other
        resident row, else fail this row out (the pool cannot hold it);
        each rung shrinks demand, so the loop ends."""
        ps = self.page_size
        cap = self.seg_steps if adv_cap is None else adv_cap
        changed = False
        for i, entry in enumerate(self._entries):
            if entry is None:
                continue
            adv = min(cap, int(self._rem[i]))
            need = min(-(-(int(self._pos[i]) + adv) // ps), self.max_pages)
            while (self._entries[i] is not None
                   and len(self._slot_pages[i]) < need):
                got = self._pages.allocate(need - len(self._slot_pages[i]))
                changed = True
                if got is not None:
                    n = len(self._slot_pages[i])
                    self._slot_pages[i].extend(got)
                    self._table[i, n:n + len(got)] = got
                    continue
                self.page_stalls += 1
                PAGE_STALLS.inc()
                if self._prefix is not None and len(self._prefix):
                    self._prefix.clear(notify=True)
                    continue
                victim = self._pick_victim(exclude=i)
                if victim is not None:
                    self._preempt(victim)
                    continue
                self._fail_entry(i, RuntimeError(
                    f"page pool ({self._pages.total} pages) too small for "
                    f"a resident row needing {need}"))
        if changed:
            self._update_page_gauge()

    def _pick_victim(self, exclude: int) -> int | None:
        """The youngest resident row by admission order (the least decode
        work to redo), never the row being topped up."""
        best, best_seq = None, -1
        for j, e in enumerate(self._entries):
            if e is not None and j != exclude and self._admit_seq[j] > best_seq:
                best, best_seq = j, self._admit_seq[j]
        return best

    def _preempt(self, slot: int) -> None:
        """Evict a resident row to reclaim its pages and requeue its entry
        at the HEAD of the queue, to be recomputed from its prompt: greedy
        decode re-emits its tokens identically, so preemption costs
        latency, never correctness. Its decoded tokens settle as
        shed-spent (that work is repeated)."""
        self.preemptions += 1
        PAGE_PREEMPTIONS.inc()
        entry = self._entries[slot]
        if self._counting:
            LEDGER.settle("shed-spent", len(self._collected[slot]),
                          device_s=entry.get("_device_s") or 0.0)
        entry["_decoded"] = 0
        entry["_device_s"] = 0.0
        self._release_slot(slot)
        with self._cond:
            self._queue.insert(0, entry)
            self._cond.notify()

    def _fail_entry(self, slot: int, err: Exception) -> None:
        """Fail ONE resident row out (the top-up's dead end) and free its
        pages; its decoded tokens settle as shed-spent. The engine keeps
        serving the others."""
        entry = self._entries[slot]
        if self._counting:
            LEDGER.settle("shed-spent", len(self._collected[slot]),
                          device_s=entry.get("_device_s") or 0.0)
        entry["error"] = err
        entry["dispatched"].set()
        entry["event"].set()
        self._retire(slot)

    def _run_segment(self) -> None:
        """One segment over every slot, then drain the finished rows. The
        device's steps x slots row-steps are produced here: the rows that
        advanced settle at their terminal site, the rest (empty slots,
        rows done inside the segment) are bubble now."""
        if all(e is None for e in self._entries):
            return
        if self.spec_source is not None:
            self._run_segment_spec()
            return
        FAULTS.fire("serve.segment")
        if self.paged:
            # host allocation happens HERE, outside the program; it may
            # preempt or fail rows, so liveness is checked again
            self._topup_pages()
            if all(e is None for e in self._entries):
                return
        steps = self.seg_steps
        occupied = sum(e is not None for e in self._entries)
        row_steps = steps * self.slots
        rows = list(zip(self._pl, self._ps, self._pos))
        PROFILER.record_cost("decode", _decode_cost(
            self.lane.cfg, rows, steps, **self.lane.cost_opts),
            tokens=row_steps)
        t0 = time.perf_counter()
        with self._lock:
            # the segment's one host read, after the replay on one stream
            res = self._readback(self.launch_segment())
        elapsed = self._device_seconds(t0)
        PROFILER.observe("decode", elapsed,
                         mode=COMPILE if self._first_call else EXECUTE)
        toks = res[:, :steps]
        new_pos = res[:, steps + 1]
        live = 0
        for i, entry in enumerate(self._entries):
            if entry is None:
                continue
            # a row emitted exactly as many tokens as its pos advanced
            emitted = int(new_pos[i] - self._pos[i])
            live += emitted
            self._collected[i].extend(toks[i, :emitted].tolist())
            # the segment's device time by advance share; the dead share
            # settles as bubble
            entry["_device_s"] = (entry.get("_device_s") or 0.0) + \
                elapsed * emitted / row_steps
        self._tok[:] = res[:, steps]
        self._pos[:] = new_pos
        self._rem[:] = res[:, steps + 2]
        self.segments += 1
        self.live_steps += live
        if self._counting:
            LEDGER.emitted(row_steps)
            LEDGER.bubble(row_steps - live,
                          device_s=elapsed * (row_steps - live) / row_steps)
        self._finish_segment(steps, occupied, live, row_steps, elapsed)

    def _finish_segment(self, steps: int, occupied: int, live: int,
                        cells: int, elapsed: float) -> None:
        """After a segment (or a speculative one's rounds): link its span
        to every resident request's trace (taken before the drain, so a
        request finishing in it still links to it), drain the finished
        rows, and feed the ledger's timeline and the occupancy gauge."""
        seg_traces = sorted({e["trace"] for e in self._entries
                             if e is not None and e.get("trace")})
        drained = self._drain()
        if self._flightrec is not None:
            # the black-box feed, BEFORE the per-segment counters zero: a
            # postmortem's last record carries this segment's admissions
            # and reaps, the page partition and the ledger state
            self._flightrec.record_segment(
                steps=steps, slots=self.slots, occupied=occupied,
                live_steps=live, admitted=self._last_admitted,
                drained=drained, reaped=self._last_reaped,
                seconds=round(elapsed, 6), queued=self.depth(),
                pages=dict(self._pages.stats()) if self.paged else None,
                ledger={"emitted_delta": cells if self._counting else 0,
                        "unsettled": LEDGER.unsettled()},
                trace_ids=seg_traces)
        if seg_traces:
            TRACER.record(
                "segment", elapsed, links=seg_traces, steps=steps,
                live_steps=live, drained=drained,
                device_s=round(elapsed, 6), tokens_live=live,
                tokens_bubble=cells - live)
        if self._counting:
            LEDGER.segment(
                steps=steps, slots=self.slots, occupied=occupied,
                live_steps=live, admitted=self._last_admitted,
                drained=drained, reaped=self._last_reaped, seconds=elapsed)
            self._last_admitted = 0
            self._last_reaped = 0
        # the MEAN live rows across the segment's steps (a row finishing
        # mid-segment counts fractionally); a drained engine reads 0
        resident = any(e is not None for e in self._entries)
        SLOT_OCCUPANCY.set(live / steps if resident and steps else 0.0)

    def _drain(self) -> int:
        """Hand every finished row's tokens back and free its slot → the
        rows drained."""
        drained = 0
        for i, entry in enumerate(self._entries):
            if entry is not None and self._rem[i] <= 0:
                entry["tokens"] = self._collected[i]
                entry["event"].set()
                self._retire(i)
                drained += 1
        return drained

    def _run_segment_spec(self) -> None:
        """The speculative segment (the reference's ``_run_segment_spec``):
        up to ``seg_steps`` verify rounds, then drain the finished rows. A
        round is one (slots, k + 1) target pass over every row's window
        (its token and ``k`` proposals), with ragged acceptance: a row
        keeps its matched draft prefix plus the target's correction token
        and its position advances by exactly that. Dense, the position IS
        the rollback (the rejected K/V above it is masked, then rewritten
        by the next window); paged, :meth:`_truncate_pages` returns whole
        pages past it to the pool. The tokens are the target's own greedy
        choices at valid context, so they are the sequential engine's.
        Every round settles all its cells in the ledger (rejected cells of
        live rows as speculative waste, dead rows' as bubble), and the
        ``serve.spec_verify`` site fires before each, so a fault leaves
        every completed round settled."""
        FAULTS.fire("serve.segment")
        k = self.draft_k
        cells = k + 1
        src = self.spec_source
        occupied = sum(e is not None for e in self._entries)
        rounds = live = cells_total = 0
        elapsed_total = 0.0
        for _ in range(self.seg_steps):
            if not any(e is not None and self._rem[i] > 0
                       for i, e in enumerate(self._entries)):
                break
            FAULTS.fire("serve.spec_verify")
            if self.paged:
                # may preempt or fail rows: liveness is checked again
                self._topup_pages(adv_cap=cells)
                if all(e is None for e in self._entries):
                    break
            old_rem = self._rem.copy()
            self._drafts[:] = 0
            for i, e in enumerate(self._entries):
                if e is not None and old_rem[i] > 0:
                    buf = self._proposals[i][:k]
                    self._drafts[i, :len(buf)] = buf
            row_cells = self.slots * cells
            rows = list(zip(self._pl, self._ps, self._pos))
            PROFILER.record_cost("decode", _decode_cost(
                self.lane.cfg, rows, cells, **self.lane.cost_opts),
                                 tokens=row_cells)
            t0 = time.perf_counter()
            with self._lock:
                # the round's one host read, after the replay
                res = self._readback(self.launch_segment())
            elapsed = self._device_seconds(t0)
            PROFILER.observe("decode", elapsed,
                             mode=COMPILE if self._first_call else EXECUTE)
            elapsed_total += elapsed
            rounds += 1
            cells_total += row_cells
            new_pos = res[:, k + 2]
            emitted_round = accepted = live_rows = 0
            for i, entry in enumerate(self._entries):
                if entry is None:
                    continue
                n = int(new_pos[i] - self._pos[i])
                out = res[i, :n].tolist()
                self._collected[i].extend(out)
                emitted_round += n
                entry["_device_s"] = (entry.get("_device_s") or 0.0) + \
                    elapsed * n / row_cells
                if old_rem[i] > 0:
                    live_rows += 1
                    # accepted: the emitted prefix that IS the draft (the
                    # rest is the target's own correction token)
                    for t in range(min(n, k)):
                        if out[t] != int(self._drafts[i, t]):
                            break
                        accepted += 1
            live += emitted_round
            live_cells = live_rows * cells
            if self._counting:
                LEDGER.emitted(row_cells)
                LEDGER.settle(
                    "speculative-waste", live_cells - emitted_round,
                    device_s=elapsed * (live_cells - emitted_round)
                    / row_cells)
                LEDGER.bubble(
                    row_cells - live_cells,
                    device_s=elapsed * (row_cells - live_cells) / row_cells)
            SPEC_ROUNDS.inc(1)
            SPEC_DRAFTED.labels(src).inc(k * live_rows)
            SPEC_ACCEPTED.labels(src).inc(accepted)
            self._tok[:] = res[:, k + 1]
            self._pos[:] = new_pos
            self._rem[:] = res[:, k + 3]
            self.spec_totals["rounds"] += 1
            self.spec_totals["drafted"] += k * live_rows
            self.spec_totals["accepted"] += accepted
            if self.paged:
                for i, e in enumerate(self._entries):
                    if e is not None:
                        self._truncate_pages(i)
                self._update_page_gauge()
            for i, e in enumerate(self._entries):
                if e is not None and self._rem[i] > 0:
                    self._refill_proposal(i)
        self.segments += 1
        self.live_steps += live
        self._finish_segment(rounds * cells, occupied, live, cells_total,
                             elapsed_total)

    def _truncate_pages(self, slot: int) -> None:
        """Roll a row's page table back to its accepted extent: the pages
        the window wrote past the accepted position go back to the pool,
        wiped (counted references keep shared prefix pages, which the kept
        prefix always covers). The kept tail page may hold rejected K/V
        above the position; the next window rewrites exactly those
        positions before anything attends to them."""
        pos = int(self._pos[slot])
        keep = (pos - 1) // self.page_size + 1 if pos > 0 else 0
        pages = self._slot_pages[slot]
        if len(pages) <= keep:
            return
        excess = pages[keep:]
        self._slot_pages[slot] = pages[:keep]
        self._table[slot, keep:] = 0
        self._wipe_pages(self._pages.release(excess))

    def _refill_proposal(self, slot: int) -> None:
        """Refill the row's proposal buffer to ``draft_k`` tokens from the
        proposer, over the row's whole context (prompt and tokens so far):
        at admission and after every round, so no proposal outlives the
        context it was made from."""
        ctx = list(self._entries[slot]["ids"]) + self._collected[slot]
        if self.spec_source == "draft":
            self._proposals[slot] = self._draft_propose(ctx)
        else:
            self._proposals[slot] = ngram_propose_host(
                ctx, self.ngram, self.draft_k, int(self._tok[slot]))

    def _draft_propose(self, ctx: list) -> list:
        """``draft_k`` greedy tokens of the draft model over (a suffix of)
        ``ctx``: the draft lane's ("spec_draft", width, k) program, a
        batch-1 ragged prefill at the context's width bucket and ``k - 1``
        steps in a cache of ``width + k`` (the reference's jitted
        ``generate``), one per width. The context is cut to the largest
        bucket the draft's max_seq holds: proposals move the acceptance
        rate, never the tokens."""
        lane, k = self._draft, self.draft_k
        width = _bucket(len(ctx))
        while width + k > lane.cfg.max_seq and width > 1:
            width //= 2
        ctx = ctx[-width:]
        st = lane.slots(1, width, width + k)
        params, cfg = lane.params, lane.cfg

        def build():
            out = torch.zeros((1, k), dtype=torch.int32,
                              device=st.token.device)
            knobs = torch.zeros((3,), dtype=torch.float32,
                                device=st.token.device)

            def body():
                generate_into(params, st.tokens, cfg, out, st.cache, knobs,
                              "greedy", prompt_lengths=st.lengths,
                              eos_id=None)
            body.out = out
            return body

        program = lane.programs.get(("spec_draft", width, k), build)
        with self._lock:
            st.tokens.copy_(_pad_rows([ctx], width), non_blocking=True)
            st.lengths.copy_(torch.tensor([len(ctx)], dtype=torch.int32),
                             non_blocking=True)
            program()
            return program.body.out[0].tolist()

    def _clear_row(self, slot: int, best_effort: bool = False) -> None:
        """Reset slot ``slot`` to cold: dense, its cache row to zeros;
        paged, its table row to the sink, its pages released and the
        pages that frees wiped. With ``best_effort`` (the failed insert's
        scrub) a failure is swallowed: the row is inert for attention
        either way, and the scrub must not mask the original error."""
        try:
            if self.paged:
                pages, self._slot_pages[slot] = self._slot_pages[slot], []
                self._table[slot, :] = 0
                self._wipe_pages(self._pages.release(pages))
                self._update_page_gauge()
                return
            with self._lock:
                self._slot.fill_(slot)
                self._clear_program()()
        except Exception:  # noqa: BLE001 — scrub only
            if not best_effort:
                raise

    def _release_slot(self, slot: int) -> None:
        self._clear_row(slot)
        self._entries[slot] = None
        self._collected[slot] = []
        self._proposals[slot] = []
        self._host[:, slot] = 0

    def _retire(self, slot: int) -> None:
        self._release_slot(slot)
        self.recycled += 1
        SLOTS_RECYCLED.inc()

    def _fail_out(self, err: Exception, reason: str = "engine-reset") -> None:
        """Fail every queued AND resident entry out (no caller may hang)
        and reset the cache (paged: the pool and its free list) and the
        slot state cold, in place. The flight recorder dumps a postmortem
        first (the reset wipes the state it preserves); the device work
        already spent on those entries settles as shed-spent."""
        log.warn(f"continuous engine reset: {type(err).__name__}: {err}")
        if self._flightrec is not None:
            self._flightrec.dump(reason, extra={
                "error": f"{type(err).__name__}: {err}"[:500],
                "restarts": self.restarts,
            })
        with self._cond:
            queued, self._queue = self._queue, []
        affected = queued + [e for e in self._entries if e is not None]
        if self._counting:
            for e in queued:
                LEDGER.settle("shed-spent", e.get("_decoded") or 0,
                              device_s=e.get("_device_s") or 0.0)
            for i, e in enumerate(self._entries):
                if e is not None:
                    LEDGER.settle("shed-spent", len(self._collected[i]),
                                  device_s=e.get("_device_s") or 0.0)
        self._entries = [None] * self.slots
        self._collected = [[] for _ in range(self.slots)]
        self._proposals = [[] for _ in range(self.slots)]
        self._host_all.zero_()
        with self._lock:
            kv = self._pool if self.paged else self._cache
            kv.k.zero_()
            kv.v.zero_()
            if kv.k_scale is not None:
                kv.k_scale.fill_(1.0)
                kv.v_scale.fill_(1.0)
        if self.paged:
            # the wiped pool invalidates every stored page id: drop the
            # store without unpinning (those pages no longer exist)
            if self._prefix is not None:
                self._prefix.clear()
            self._pages = PagePool(self._pages.total)
            self._slot_pages = [[] for _ in range(self.slots)]
            self._update_page_gauge()
        for e in affected:
            e["error"] = err
            e["dispatched"].set()
            e["event"].set()
        SLOT_OCCUPANCY.set(0)


def build_black_box(env: dict, stats_fn) -> tuple:
    """The engine's black box, as the reference's server wires it, from
    the server's env dict → (flight recorder, incident correlator, alert
    manager): the recorder (TPU_K8S_FLIGHTREC_*: one record a segment,
    postmortem dumps on a reset, a hard-fail and a drain, live at GET
    /debug/flightrec), the correlator over the recorder's history store
    (TPU_K8S_INCIDENTS_*: dumps and alerts cross-referenced both ways) and
    the manager of the engine-local tripwires over ``stats_fn`` (the
    engine's ``stats()``) and the goodput ledger: page partition, ledger
    conservation, restart / 5xx / fault deltas, counter stall and queue
    runaway (TPU_K8S_ALERT_*, TPU_K8S_ALERTS_FILE; live at GET
    /debug/alerts, mirrored into /healthz). The engine takes the recorder
    and the manager (``ContinuousEngine(flightrec=..., alerts=...)``)."""
    from tpu_kubernetes_torch.obs.alerts import (
        AlertManager,
        engine_tripwires,
        sinks_from_env,
    )
    from tpu_kubernetes_torch.obs.flightrec import FlightRecorder
    from tpu_kubernetes_torch.obs.incidents import IncidentCorrelator

    flightrec = FlightRecorder.from_env(env)
    incidents = IncidentCorrelator.from_env(
        env, store=flightrec.store, flightrec=flightrec)
    flightrec.incidents = incidents
    alerts = AlertManager(
        engine_tripwires(
            stats_fn=stats_fn, ledger=LEDGER,
            for_s=env_float("TPU_K8S_ALERT_FOR_S", 5.0, env=env),
            resolve_for_s=env_float("TPU_K8S_ALERT_RESOLVE_FOR_S", 10.0,
                                    env=env),
            queue_max_depth=float(env_int("SERVE_MAX_QUEUE", 256, env=env))),
        sinks=sinks_from_env(env),
        group_interval_s=env_float("TPU_K8S_ALERT_GROUP_S", 60.0, env=env),
        incidents=incidents)
    return flightrec, incidents, alerts


class ServingState:
    """The resident model, its device, the generation lock, the prefix
    store (SERVE_PREFIX_CACHE_MB, on the greedy lane), the batching mode
    (round batcher or slot engine, when configured), speculation
    (SERVE_PROMPT_LOOKUP on the solo lane; the engine's proposer) and the
    resilience policy: SERVE_DEADLINE_MS, admission control
    (SERVE_MAX_QUEUE), the drain and, with the engine, its watchdog."""

    def __init__(self, env: dict):
        refuse_later_knobs(env)
        self.env = env
        params, cfg, encode, decode_text = load_serving_stack(env)
        self.params, self.cfg = params, cfg
        self.device = params["embed"].device
        # the profiler times on this device (CUDA events on the card)
        PROFILER.device = self.device
        self.encode, self.decode_text = encode, decode_text
        self.max_new_cap = env_int("SERVE_MAX_NEW", 64, env=env)
        eos_env = env.get("SERVE_EOS_ID", "")
        self.eos_id = int(eos_env) if eos_env else None
        self.model_name = env.get("SERVE_MODEL", "llama-test")
        # SERVE_ROLE: this instance's tier in a disaggregated fleet, on the
        # tpu_serve_role_info gauge
        self.role = env_str("SERVE_ROLE", "", env=env).strip() or "serve"
        ROLE_INFO.labels(self.role).set(1.0)
        # distributed tracing: inbound traceparent, head and tail sampling,
        # the bounded span exporter (TPU_K8S_TRACE_*)
        self.tracing = tracing.TraceRuntime(tracing.TraceConfig.from_env(env))
        # SERVE_DEADLINE_MS (0 = off): every request's deadline unless its
        # body carries "deadline_ms"; the clock starts at receipt
        self.deadline_ms = env_float("SERVE_DEADLINE_MS", 0.0, env=env)
        # SERVE_MAX_QUEUE (0 disables): a full queue sheds with 429 and
        # Retry-After instead of queueing without bound
        self.admission = AdmissionController(
            env_int("SERVE_MAX_QUEUE", 256, env=env))
        self.drain = DrainController()
        self.failed = False          # the watchdog gave up: /healthz 503
        self._busy = 0               # requests inside complete()/stream()
        self._busy_lock = threading.Lock()
        self._http_server = None     # set by make_server (drain shutdown)
        self._watchdog = None
        self.flightrec = None
        self.alerts = None       # engine-local AlertManager (obs/alerts.py)
        self._incidents = None   # IncidentCorrelator (obs/incidents.py)
        self.early_exit_steps = env_int("SERVE_EARLY_EXIT_STEPS", 8, env=env)
        # SERVE_KV_QUANT: every lane's cache int8 (the engine's included);
        # SERVE_DRAFT_KV_QUANT: the draft model's alone
        self.kv_quant = truthy_env(env, "SERVE_KV_QUANT")
        self.draft_kv_quant = truthy_env(env, "SERVE_DRAFT_KV_QUANT")
        # SERVE_PREFIX_CACHE_MB (> 0 enables): a bounded LRU of prompt-
        # prefix KV segments. A request sharing a stored prefix prefills
        # only its suffix, into the cold prefill's cache, so every
        # downstream program is shared
        self.prefix_cache = None
        prefix_mb = env_float("SERVE_PREFIX_CACHE_MB", 0.0, env=env)
        if prefix_mb > 0:
            self.prefix_cache = PrefixCache(
                int(prefix_mb * 2 ** 20),
                sig=(self.model_name, str(cfg.dtype).removeprefix("torch."),
                     bool(self.kv_quant)),
                on_bytes=PREFIX_CACHE_BYTES.set)
        self.greedy = GreedyLane(params, cfg, self.eos_id,
                                 prefix=self.prefix_cache,
                                 kv_quant=self.kv_quant)
        # the warm-up's traffic counts nowhere
        self.greedy.counting = False
        self.sampled = SampledLane(self.greedy)
        self._lock = threading.Lock()
        self.ready = False
        batch = env_int("SERVER_BATCH", 1, env=env)
        self._batcher = None
        self._engine = None
        continuous = truthy_env(env, "SERVE_CONTINUOUS_BATCHING")
        self._configure_speculation(env, continuous, batch)
        # SERVE_KV_POOL_MB (> 0 enables, engine only): back the slot engine
        # with a paged KV pool of SERVE_KV_PAGE_SIZE-position pages
        page_size = env_int("SERVE_KV_PAGE_SIZE", 16, env=env)
        pool_mb = env_float("SERVE_KV_POOL_MB", 0.0, env=env)
        if pool_mb > 0 and not continuous:
            raise ValueError(
                "SERVE_KV_POOL_MB needs SERVE_CONTINUOUS_BATCHING=1 "
                "(the page pool backs the slot engine; other request "
                "modes keep their dense caches)")
        if continuous:
            self.flightrec, self._incidents, self.alerts = build_black_box(
                env, lambda: (self._engine.stats()
                              if self._engine is not None else None))
            # SERVER_BATCH doubles as the slot count (4 when unset or 1);
            # segments are the early-exit interval. MoE rides the engine:
            # it always decodes at the fixed slot batch
            self._engine = ContinuousEngine(
                self.greedy, slots=batch if batch > 1 else 4,
                seg_steps=(self.early_exit_steps
                           if self.early_exit_steps > 0 else 8),
                lock=self._lock, pool_mb=pool_mb, page_size=page_size,
                spec=self.spec_source, draft_k=self.draft_k,
                ngram=self.ngram, draft=self.draft,
                admission=self.admission, flightrec=self.flightrec,
                alerts=self.alerts,
                alert_tick_s=env_float("TPU_K8S_ALERT_TICK_S", 1.0,
                                       env=env))
            # self-healing: a dead scheduler thread would hang every later
            # submitter, so it restarts cold, at most
            # SERVE_MAX_ENGINE_RESTARTS times; then /healthz hard-fails
            self._watchdog = Watchdog(
                self._engine.is_alive, self._engine.restart,
                max_restarts=env_int("SERVE_MAX_ENGINE_RESTARTS", 3,
                                     env=env),
                interval_s=env_float("SERVE_WATCHDOG_INTERVAL_S", 0.5,
                                     env=env),
                on_give_up=self._mark_failed,
            ).start()
        elif batch > 1 and isinstance(cfg, MoEConfig):
            # a round batch's expert capacity depends on its rows, so
            # co-riders could change a response: serve MoE solo
            log.warn("SERVER_BATCH ignored: MoE capacity is batch-width-"
                     "dependent, dynamic batching could change responses")
        elif batch > 1:
            def fits(selected: list, entry: dict) -> bool:
                # the batch runs at (widest bucket, largest max_new)
                width = _bucket(max(
                    [len(entry["ids"])] + [len(e["ids"]) for e in selected]))
                max_new = max(
                    [entry["max_new"]] + [e["max_new"] for e in selected])
                return width + max_new <= cfg.max_seq

            self._batcher = _Batcher(
                self._run_greedy_batch, batch,
                env_float("SERVER_BATCH_WINDOW_MS", 5.0, env=env), fits=fits,
                on_wait=self.admission.observe_service)

    def _configure_speculation(self, env: dict, continuous: bool,
                               batch: int) -> None:
        """SERVE_PROMPT_LOOKUP, SERVE_DRAFT_K, SERVE_NGRAM,
        SERVE_DRAFT_MODEL and SERVE_DRAFT_HF_CHECKPOINT, with the
        reference's checks: a dense target, draft_k and ngram at least 1
        (and the verify window within the chunk route's MAX_CHUNK), solo
        lookup without a round batcher. The engine's proposer
        (``spec_source``): the draft model (an HF checkpoint, or a
        preset's random weights from seed 1; in the target's dtype; it
        wins over lookup), or n-gram lookup, or None. A draft model
        without the engine is not used, as in the reference: the solo lane
        speculates by lookup alone."""
        self.prompt_lookup = truthy_env(env, "SERVE_PROMPT_LOOKUP")
        self.draft_k = env_int("SERVE_DRAFT_K", 8, env=env)
        self.ngram = env_int("SERVE_NGRAM", 2, env=env)
        draft_hf = env_str("SERVE_DRAFT_HF_CHECKPOINT", "", env=env)
        draft_name = env_str("SERVE_DRAFT_MODEL", "", env=env)
        drafting = bool(draft_hf or draft_name)
        self.spec_source = None
        self.draft = None
        self._solo_spec = {"rounds": 0, "drafted": 0, "accepted": 0}
        self._spec_lock = threading.Lock()
        if self.prompt_lookup or (continuous and drafting):
            if isinstance(self.cfg, MoEConfig):
                raise ValueError(
                    "speculative decoding needs a dense target model (MoE "
                    "chunk verification is not token-exact)")
            if self.draft_k < 1 or self.ngram < 1:
                raise ValueError(f"SERVE_DRAFT_K ({self.draft_k}) and "
                                 f"SERVE_NGRAM ({self.ngram}) must be >= 1")
            check_draft_k(self.draft_k)
        if self.prompt_lookup and not continuous:
            # the solo lookup loop's restrictions: the slot engine lifts
            # both (its verify rounds decode the whole slot batch, and int8
            # verification stays exact: rejected quantized writes are
            # masked and rewritten, accepted ones are the bits sequential
            # int8 decode writes)
            if self.kv_quant:
                raise ValueError(
                    "SERVE_PROMPT_LOOKUP with SERVE_KV_QUANT needs "
                    "SERVE_CONTINUOUS_BATCHING=1 (the solo verification "
                    "cache is full-precision)")
            if batch > 1:
                raise ValueError(
                    "SERVE_PROMPT_LOOKUP with SERVER_BATCH needs "
                    "SERVE_CONTINUOUS_BATCHING=1 (the solo speculation loop "
                    "is batch-1; the slot engine verifies the whole batch a "
                    "round)")
        if continuous and drafting:
            def check(draft_cfg):
                if isinstance(draft_cfg, MoEConfig):
                    raise ValueError("the draft model must be dense (the "
                                     "proposer runs the plain decode path)")
                if draft_cfg.vocab_size != self.cfg.vocab_size:
                    raise ValueError(f"draft vocab {draft_cfg.vocab_size} "
                                     f"!= target vocab {self.cfg.vocab_size}")
                if draft_cfg.max_seq < self.cfg.max_seq:
                    raise ValueError(
                        f"draft max_seq {draft_cfg.max_seq} < target max_seq "
                        f"{self.cfg.max_seq}: the proposer re-reads the full "
                        f"slot context")

            params, draft_cfg = load_draft(draft_hf, draft_name,
                                           self.cfg.dtype, self.device,
                                           ValueError, check)
            self.draft = GreedyLane(params, draft_cfg,
                                    kv_quant=self.draft_kv_quant)
            self.spec_source = "draft"
        elif continuous and self.prompt_lookup:
            self.spec_source = "ngram"
        elif self.draft_kv_quant and not drafting:
            raise ValueError(
                "SERVE_DRAFT_KV_QUANT needs a draft model "
                "(SERVE_DRAFT_MODEL / SERVE_DRAFT_HF_CHECKPOINT)")
        elif drafting:
            log.warn("SERVE_DRAFT_MODEL drives the slot engine's proposer "
                     "(SERVE_CONTINUOUS_BATCHING=1); the solo lane "
                     "speculates with SERVE_PROMPT_LOOKUP alone")

    @property
    def speculating(self) -> bool:
        return self.prompt_lookup or self.spec_source is not None

    @property
    def spec_totals(self) -> dict:
        """Rounds (a solo request's prefill counts as one), drafted and
        accepted tokens, of the solo lookup lane and the engine together."""
        with self._spec_lock:
            out = dict(self._solo_spec)
        if self._engine is not None:
            for key, n in self._engine.spec_totals.items():
                out[key] += n
        return out

    def warm(self) -> None:
        """Run the default request's paths once before going ready: the
        kernel libraries are built, and on the card the slot engine's
        insert, segment and clear programs and the default bucket's
        greedy programs captured, on these first calls; then a streamed
        request drains once."""
        if self._engine is not None:
            self._engine.warm()
        self.complete("")
        for _ in self.stream(""):
            pass
        # the prefix lookups, token counters and ledger count from the
        # first request served
        self.greedy.prefix_lookups.update(hit=0, partial=0, miss=0)
        self.greedy.counting = True
        self.ready = True
        log.info("server: warm — serving")

    # -- resilience ---------------------------------------------------------

    def _mark_failed(self) -> None:
        self.failed = True
        events.emit("serve_engine_failed",
                    restarts=self._engine.restarts if self._engine else 0)
        if self.flightrec is not None:
            # the terminal postmortem: the watchdog gave up, the fleet
            # replaces this instance, and this dump is what is left
            self.flightrec.dump("hard-fail", extra={
                "restarts": self._engine.restarts if self._engine else 0,
            })

    @contextlib.contextmanager
    def _track_busy(self):
        """Count a request through generation: the drain waits for this to
        reach zero."""
        with self._busy_lock:
            self._busy += 1
        try:
            yield
        finally:
            with self._busy_lock:
                self._busy -= 1

    def _preflight(self, deadline: float | None) -> None:
        """Admission gate before any generation work: a draining instance
        refuses (503), an expired deadline fails fast (504, no prefill
        spent), and the admission controller sheds (429) when the queue is
        full or the estimated wait has already doomed the deadline. The
        warm-up is exempt."""
        if not self.ready:
            return
        if self.failed:
            raise RuntimeError(
                "serving engine failed permanently (watchdog restarts "
                "exhausted) — this instance must be replaced")
        if self.drain.is_draining:
            raise Draining(
                "server is draining — retry against a sibling instance")
        if expired(deadline):
            DEADLINE_TOTAL.labels("preflight").inc()
            raise DeadlineExceeded(
                "deadline expired before generation started")
        if self._engine is not None:
            depth = self._engine.depth()
        elif self._batcher is not None:
            depth = self._batcher.depth()
        else:
            with self._busy_lock:
                depth = self._busy
        self.admission.admit(depth, deadline)

    def _quiesced(self) -> bool:
        with self._busy_lock:
            if self._busy:
                return False
        if self._engine is not None:
            s = self._engine.stats()
            if s["occupied"] or s["queued"]:
                return False
        if self._batcher is not None and self._batcher.depth():
            return False
        return True

    def begin_drain(self, reason: str = "") -> bool:
        """Stop admission now (new requests 503), finish resident work in
        the background and shut the HTTP server down once quiesced (within
        SERVE_DRAIN_TIMEOUT_S). The first caller starts the worker; later
        calls return False."""
        if not self.drain.begin(reason):
            return False
        threading.Thread(target=self._drain_worker, daemon=True,
                         name="serve-drain").start()
        return True

    def _drain_worker(self) -> None:
        timeout = env_float("SERVE_DRAIN_TIMEOUT_S", 30.0, env=self.env)
        t_end = time.monotonic() + timeout
        while time.monotonic() < t_end and not self._quiesced():
            time.sleep(0.05)
        forced = not self._quiesced()
        if self._watchdog is not None:
            self._watchdog.stop()
        events.emit("serve_drained", reason=self.drain.reason,
                    forced=forced)
        if self.flightrec is not None:
            # drain covers SIGTERM too (its handler begins the drain): the
            # trigger rides in the payload
            self.flightrec.dump("drain", extra={
                "trigger": self.drain.reason, "forced": forced,
            })
        self.drain.mark_drained()
        log.info("server: drained"
                 + (" (timeout — residual work abandoned)" if forced
                    else ""))
        srv = self._http_server
        if srv is not None:
            srv.shutdown()

    @contextlib.contextmanager
    def _locked_phase(self):
        """The generation lock under a "queue" span: on a busy server the
        wait for the card IS the queue."""
        with TRACER.phase("queue", quiet=True):
            self._lock.acquire()
        try:
            yield
        finally:
            self._lock.release()

    def _validate(self, prompt: str, max_new_tokens: int | None):
        """→ (prompt ids, requested max_new, run_max_new, width)."""
        max_new = (
            self.max_new_cap if max_new_tokens is None
            else int(max_new_tokens)   # 0 is a VALUE (and rejected), not unset
        )
        max_new = min(max_new, self.max_new_cap)
        if max_new < 1:
            raise ValueError("max_new_tokens must be >= 1")
        ids = self.encode(prompt) or [0]      # empty prompt → one pad row
        width = _bucket(len(ids))
        # speculation reserves draft_k positions for the verify window past
        # the budget, for every request, so every request sees one limit
        head = self.draft_k if self.speculating else 0
        if width + max_new + head > self.cfg.max_seq:
            raise ValueError(
                f"prompt ({len(ids)} tokens, bucket {width}) + "
                f"max_new_tokens ({max_new})"
                + (f" + draft_k ({head})" if head else "")
                + f" exceeds max_seq {self.cfg.max_seq}")
        run_max_new = min(
            _bucket_max_new(max_new, self.max_new_cap),
            self.cfg.max_seq - width - head,
        )
        return ids, max_new, run_max_new, width

    def _run_greedy_batch(self, entries: list) -> None:
        """The round batcher's callback: up to SERVER_BATCH queued greedy
        requests as ONE ragged batch on the greedy lane (a static batch:
        pad rows replicate row 0 with budget 1, so they never keep the
        batch alive), each entry's tokens cut to its own max_new. A round
        of one entry is b copies of one prompt, so it prefills warm or
        cold through the lane's policy point; a mixed round prefills cold
        and stores each row's prompt."""
        b = self._batcher.max_batch
        max_new = max(e["max_new"] for e in entries)
        width = _bucket(max(len(e["ids"]) for e in entries))
        rows = [e["ids"] for e in entries]
        rows += [rows[0]] * (b - len(rows))
        budgets = [e["budget"] for e in entries]
        budgets += [1] * (b - len(entries))
        span = width + max_new
        t0 = time.perf_counter()
        with self._lock:
            if len(entries) == 1:
                st = self.greedy.prefill_any(rows[0], width, span, b)
            else:
                lengths = torch.tensor([len(r) for r in rows],
                                       dtype=torch.int32)
                st = self.greedy.prefill(_pad_rows(rows, width), lengths,
                                         span)
                for i, entry in enumerate(entries):
                    self.greedy.prefix_insert(entry["ids"], st.cache, row=i)
            out, _ = self.greedy.decode_greedy(st, budgets,
                                               self.early_exit_steps)
        for i, entry in enumerate(entries):
            entry["tokens"] = out[i][:entry["max_new"]]
        self._ledger_batch(entries, b * len(out[0]), b,
                           time.perf_counter() - t0)

    def _ledger_batch(self, entries: list, produced: int, b: int,
                      elapsed: float) -> None:
        """Goodput accounting for one static batch: the device produced
        ``produced`` tokens (the whole (b, L) grid); what each entry takes
        home settles in ``complete()``, the rest (pad rows, decode past a
        row's own budget) is bubble here. Device seconds split evenly
        across rows (the pad rows' share is bubble)."""
        handed = 0
        for e in entries:
            handed += len(e["tokens"])
            e["_device_s"] = elapsed / max(1, b)
        if self.greedy.counting:
            LEDGER.emitted(produced)
            LEDGER.bubble(produced - handed,
                          device_s=elapsed * (b - len(entries)) / max(1, b))

    def complete(self, prompt: str, max_new_tokens: int | None = None,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 0.0, seed: int = 0,
                 deadline: float | None = None) -> dict:
        self._preflight(deadline)
        ids, max_new, run_max_new, width = self._validate(
            prompt, max_new_tokens
        )
        greedy = _is_greedy(temperature, top_k, top_p)
        counting = self.greedy.counting
        spec = None
        ledger_device_s = 0.0
        batch_span = None    # annotated with the ledger's token classes
        if self.prompt_lookup and greedy and self._engine is None:
            # the solo lookup rounds: the greedy tokens at this span
            # (with the slot engine up, speculation rides its rounds);
            # they settle in the ledger inside _lookup
            finish: dict = {}
            with self._locked_phase():
                with TRACER.phase("batch", quiet=True, mode="lookup"):
                    tokens = [t for new in self._lookup(
                        ids, width, run_max_new, max_new, finish)
                        for t in new]
            spec = finish["spec"]
        elif self._engine is not None and greedy:
            # the scheduler thread owns the decode loop: the request waits
            # for a free slot (the queue span), and its tokens come back
            # when its row drains
            entry = self._engine.enqueue(ids, max_new, deadline=deadline)
            with TRACER.phase("queue", quiet=True):
                entry["dispatched"].wait()
            with TRACER.phase("batch", quiet=True,
                              mode="continuous") as batch_span:
                tokens = _Batcher.result(entry)
                batch_span.meta["admission_wait_s"] = round(
                    entry.get("_wait") or 0.0, 6)
                batch_span.meta["device_s"] = round(
                    entry.get("_device_s") or 0.0, 6)
            ledger_device_s = entry.get("_device_s") or 0.0
        elif self._batcher is not None and greedy:
            entry = self._batcher.enqueue(ids, run_max_new, budget=max_new,
                                          deadline=deadline)
            with TRACER.phase("queue", quiet=True):
                entry["dispatched"].wait()
            with TRACER.phase("batch", quiet=True, mode="batched"):
                tokens = _Batcher.result(entry)
            ledger_device_s = entry.get("_device_s") or 0.0
        else:
            rows = _pad_rows([ids], width)
            lengths = torch.tensor([len(ids)], dtype=torch.int32)
            t0 = time.perf_counter()
            with self._locked_phase():
                with TRACER.phase("batch", quiet=True, mode="solo"):
                    if greedy:
                        st = self.greedy.prefill_any(ids, width,
                                                     width + run_max_new)
                        out, _ = self.greedy.decode_greedy(
                            st, [max_new], self.early_exit_steps)
                        tokens = out[0]
                    else:
                        out = self.sampled.generate(
                            rows, lengths, run_max_new, width + run_max_new,
                            temperature=float(temperature),
                            top_k=int(top_k), top_p=float(top_p),
                            seed=int(seed))
                        tokens = out[0].tolist()
            ledger_device_s = time.perf_counter() - t0
            if counting:
                # solo production: every decoded cell is this request's
                LEDGER.emitted(len(tokens))
        decoded = len(tokens)
        tokens = tokens[:max_new]              # bucketed run → requested budget
        if self.eos_id is not None and self.eos_id in tokens:
            tokens = tokens[:tokens.index(self.eos_id)]
        if spec is None and counting:
            TOKENS_GENERATED.inc(len(tokens))
            PROMPT_TOKENS.inc(len(ids))
            # what the client takes is useful; the trims (budget, EOS) are
            # bubble
            LEDGER.settle_request("useful", delivered=len(tokens),
                                  decoded=decoded, device_s=ledger_device_s)
        if batch_span is not None:
            batch_span.meta["tokens"] = {
                "useful": len(tokens), "trimmed": decoded - len(tokens)}
        with TRACER.phase("decode", quiet=True, tokens=len(tokens)):
            text = self.decode_text(tokens)
        result = {
            "text": text,
            "tokens": len(tokens),
            "prompt_tokens": len(ids),
            # a full budget means truncation, anything shorter means EOS
            "finish_reason": "length" if len(tokens) >= max_new else "stop",
            "model": self.model_name,
        }
        if spec is not None:
            # the request's speculation: tokens a target pass is the speedup
            result["spec"] = spec
        return result

    def _lookup(self, ids: list, width: int, run_max_new: int, max_new: int,
                finish: dict):
        """The greedy lane's lookup rounds at the span ``width +
        run_max_new + draft_k``, their totals added to ``spec_totals``,
        the speculation counters and, after the warm-up, the token
        counters and the ledger at the end (a stream's early close
        included). Caller holds the lock."""
        try:
            yield from self.greedy.lookup_rounds(
                ids, width, width + run_max_new + self.draft_k, max_new,
                self.draft_k, self.ngram, finish)
        finally:
            spec = finish.get("spec", {})
            with self._spec_lock:
                for key, n in spec.items():
                    self._solo_spec[key] += n
            if spec:
                SPEC_ROUNDS.inc(spec["rounds"])
                SPEC_DRAFTED.labels("ngram").inc(spec["drafted"])
                SPEC_ACCEPTED.labels("ngram").inc(spec["accepted"])
            if self.greedy.counting and "produced" in finish:
                produced, delivered = finish["produced"], finish["delivered"]
                TOKENS_GENERATED.inc(finish["emitted"])
                PROMPT_TOKENS.inc(len(ids))
                LEDGER.emitted(produced)
                LEDGER.settle("useful", delivered,
                              device_s=finish["device_s"])
                LEDGER.bubble(produced - delivered)

    @staticmethod
    def _stop_on_cancel(batches, cancel: threading.Event | None):
        """``batches`` until ``cancel`` is set (a client that went away),
        closing the generator then."""
        try:
            for new in batches:
                if cancel is not None and cancel.is_set():
                    return
                yield new
        finally:
            batches.close()

    def _safe_deltas(self, token_batches):
        """Token batches → UTF-8-safe text deltas: a trailing U+FFFD is
        usually an INCOMPLETE multi-byte sequence that the next token
        completes, so it is held back until it resolves or stops being
        the tail; the final text flushes at the end."""
        emitted: list[int] = []
        sent = ""
        for new in token_batches:
            if not new:
                continue
            emitted.extend(new)
            text = self.decode_text(emitted)
            stable = text[:-1] if text.endswith("�") else text
            if stable.startswith(sent) and len(stable) > len(sent):
                yield stable[len(sent):]
                sent = stable
        final = self.decode_text(emitted)
        if final.startswith(sent) and len(final) > len(sent):
            yield final[len(sent):]            # flush any held-back tail

    def stream(self, prompt: str, max_new_tokens: int | None = None,
               temperature: float = 0.0, top_k: int = 0,
               top_p: float = 0.0, seed: int = 0,
               finish: dict | None = None,
               deadline: float | None = None,
               cancel: threading.Event | None = None):
        """Yield text pieces as tokens decode: the sampled lane's token
        loop (:meth:`SampledLane.stream`) at the span of the solo path
        (``width + run_max_new``): a warm or cold prefill, then one graphed
        decode step and sample a token, drawing in ``generate``'s order,
        so a seeded request samples the same tokens streamed or not. The
        generation lock is held from the first piece to the last;
        ``cancel`` (a client that went away) ends the loop and releases
        it at once, and a passed ``deadline`` ends it with
        :class:`DeadlineExceeded`. ``finish["reason"]`` becomes "stop"
        (EOS) or "length". Each token is pending in the ledger until its
        yield hands it over (then useful); one still pending when the
        loop ends settles as cancelled (or expired)."""
        self._preflight(deadline)
        ids, max_new, run_max_new, width = self._validate(
            prompt, max_new_tokens
        )
        if (self.prompt_lookup and not self.kv_quant
                and _is_greedy(temperature, top_k, top_p)):
            # the lookup rounds surface a round's accepted tokens at once;
            # under SERVE_KV_QUANT (speculation rides the engine alone)
            # streams take the int8 per-token loop
            spec_finish = finish if finish is not None else {}
            with self._locked_phase():
                for new in self._safe_deltas(self._stop_on_cancel(
                        self._lookup(ids, width, run_max_new, max_new,
                                     spec_finish), cancel)):
                    yield new
            return
        counting = self.greedy.counting

        def tokens():
            # the lane's slots: the lock keeps every other request off them
            # until this stream ends
            if counting:
                PROMPT_TOKENS.inc(len(ids))
            lane = self.sampled.stream(
                ids, width, width + run_max_new,
                temperature=float(temperature), top_k=int(top_k),
                top_p=float(top_p), seed=int(seed))
            t0 = time.perf_counter()
            t = next(lane)                 # the prefill's token
            dev_s = time.perf_counter() - t0
            if counting:
                LEDGER.emitted(1)
            pending, term_cls = 1, "cancelled"
            try:
                for i in range(max_new):
                    if cancel is not None and cancel.is_set():
                        return
                    if expired(deadline):
                        DEADLINE_TOTAL.labels("resident").inc()
                        term_cls = "expired"
                        raise DeadlineExceeded("deadline expired mid-stream")
                    if self.eos_id is not None and t == self.eos_id:
                        if finish is not None:
                            finish["reason"] = "stop"
                        if counting:     # the EOS token is never handed
                            LEDGER.bubble(pending, device_s=dev_s)
                        pending = 0
                        return
                    if counting:
                        TOKENS_GENERATED.inc()
                    yield [t]
                    if counting:
                        LEDGER.settle("useful", pending, device_s=dev_s)
                    pending, dev_s = 0, 0.0
                    if i + 1 == max_new:
                        if finish is not None:
                            finish["reason"] = "length"
                        return
                    t0 = time.perf_counter()
                    t = next(lane)
                    dev_s += time.perf_counter() - t0
                    if counting:
                        LEDGER.emitted(1)
                    pending = 1
            finally:
                lane.close()
                if pending and counting:
                    LEDGER.settle(term_cls, pending, device_s=dev_s)

        with self._locked_phase():
            yield from self._safe_deltas(tokens())


class _Handler(BaseHTTPRequestHandler):
    state: ServingState  # set by make_server
    protocol_version = "HTTP/1.1"

    # the bounded endpoint-label vocabulary: anything else is "other", so
    # a path-scanning client cannot mint label cardinality
    _ENDPOINTS = frozenset({
        "/healthz", "/metrics", "/v1/models", "/debug/profile",
        "/debug/ledger", "/debug/flightrec", "/debug/alerts",
        "/v1/completions", "/v1/chat/completions", "/drain",
    })

    def log_message(self, fmt, *args):
        log.debug(f"server: {self.address_string()} {fmt % args}")

    def _json(self, code: int, obj: dict,
              headers: dict | None = None) -> None:
        self._code = code
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler contract
        with self._observed():
            self._get()

    def do_POST(self):  # noqa: N802
        with self._observed():
            self._post()

    def _endpoint(self) -> str:
        # /debug/trace/<id> is one label value: the id is per request
        if self.path.startswith("/debug/trace"):
            return "/debug/trace"
        return self.path if self.path in self._ENDPOINTS else "other"

    def send_response(self, code, message=None):
        super().send_response(code, message)
        # every response carries the request's id (GET /debug/trace/<id>
        # answers for it) and the W3C trace context, this server's span
        # as the caller's parent
        rid = getattr(self, "_rid", "")
        if rid:
            self.send_header("X-Request-Id", rid)
        tctx = getattr(self, "_trace", None)
        if tctx is not None:
            self.send_header(tracing.TRACEPARENT,
                             tracing.render_traceparent(tctx))

    @contextlib.contextmanager
    def _observed(self):
        """Correlate, count and time this request: an inbound X-Request-Id
        becomes the run id (or one is minted), an inbound ``traceparent``
        continues the caller's trace (or a root is minted), the handler
        runs under both, and the registry is observed however it exits (a
        crash counts as 500)."""
        endpoint = self._endpoint()
        inbound = (self.headers.get("X-Request-Id") or "").strip()
        self._rid = inbound[:64] or events.new_id()
        self._trace = self.state.tracing.extract(
            self.headers.get(tracing.TRACEPARENT))
        self._code = 500
        self._t0 = time.monotonic()
        INFLIGHT.inc()
        try:
            with events.run_context(self._rid):
                with tracing.trace_scope(self._trace):
                    try:
                        with TRACER.phase("request", quiet=True,
                                          endpoint=endpoint,
                                          trace=self._trace.trace_id):
                            yield
                    finally:
                        events.emit("http_request", path=self.path,
                                    code=getattr(self, "_code", 0))
        finally:
            INFLIGHT.dec()
            REQUESTS_TOTAL.labels(endpoint, str(self._code)).inc()
            wall = time.monotonic() - self._t0
            REQUEST_SECONDS.labels(endpoint).observe(
                wall, exemplar=(self._trace.trace_id
                                if self._trace.sampled else None))
            # the export decision and the hand-off to the bounded
            # exporter: never blocks, never raises into the handler
            self.state.tracing.finish_request(
                TRACER, self._rid, self._trace, code=self._code,
                wall_s=wall)

    def _get(self):  # noqa: C901 — one dispatch ladder
        st = self.state
        if self.path == "/v1/models":
            return self._json(200, {
                "object": "list",
                "data": [{"id": st.model_name, "object": "model"}],
            })
        if self.path == "/metrics":
            body = REGISTRY.render().encode("utf-8")
            self._code = 200
            self.send_response(200)
            self.send_header("Content-Type", obs_metrics.CONTENT_TYPE)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return None
        if self.path == "/debug/profile":
            return self._json(200, PROFILER.summary())
        if self.path == "/debug/ledger":
            # the goodput ledger, the analytic roofline and, paged, the
            # page partition beside the token classes
            payload = LEDGER.snapshot()
            payload["roofline"] = PROFILER.roofline()
            if st._engine is not None and st._engine.paged:
                payload["kv_pages"] = st._engine._pages.stats()
            return self._json(200, payload)
        if self.path == "/debug/flightrec":
            # the engine's black box, live and without writing a file:
            # segment ring, ledger, SLO alerts, recent history samples
            if st.flightrec is None:
                return self._json(404, {
                    "error": "no flight recorder on this instance",
                    "hint": "the recorder rides the continuous-batching "
                            "engine (SERVE_CONTINUOUS_BATCHING=1)",
                })
            return self._json(200, st.flightrec.snapshot())
        if self.path == "/debug/alerts":
            # the engine-local tripwire state: active and resolved alerts,
            # silences, the registered rules
            if st.alerts is None:
                return self._json(404, {
                    "error": "no alert manager on this instance",
                    "hint": "engine-local tripwires ride the continuous-"
                            "batching engine (SERVE_CONTINUOUS_BATCHING=1)",
                })
            return self._json(200, st.alerts.snapshot())
        if self.path.startswith("/debug/trace/"):
            rid = self.path[len("/debug/trace/"):]
            tree = span_tree(TRACER.spans, rid)
            if tree:
                return self._json(200, {"run": rid, "spans": tree})
            # not a run id: try it as a distributed trace id
            payload = tracing.trace_payload(TRACER.spans, rid)
            if payload["spans"] or payload["segments"]:
                return self._json(200, payload)
            return self._json(404, {
                "error": f"no spans recorded for run {rid!r}",
                "hint": "pass an X-Request-Id a response returned; "
                        "old runs age out of the span ring",
            })
        if self.path != "/healthz":
            return self._json(404, {"error": "unknown path"})
        if st.failed:
            # the watchdog gave up: replace this instance, don't wait
            return self._json(503, {
                "status": "failed",
                "reason": "engine watchdog exhausted its restarts",
                "restarts": (st._engine.restarts
                             if st._engine is not None else 0),
            })
        if not st.ready:
            return self._json(503, {"status": "warming"})
        if st.drain.is_draining:
            return self._json(503, {
                "status": st.drain.state,
                "reason": st.drain.reason,
                "busy": st._busy,
            })
        body = {
            "status": "ok",
            "model": st.model_name,
            "kv_quant": st.kv_quant,
            "max_new_tokens_cap": st.max_new_cap,
            "device": str(st.device),
            "metrics": {
                "tokens_generated": int(TOKENS_GENERATED.value),
                "prompt_tokens": int(PROMPT_TOKENS.value),
            },
            "goodput": {
                "ratio": LEDGER.goodput(),
                "bubble_fraction": LEDGER.bubble_fraction(),
                "unsettled": LEDGER.unsettled(),
            },
        }
        if st.prefix_cache is not None:
            # entries, bytes against the cap, the signature, and the
            # lookups by outcome since the server went ready
            body["prefix_cache"] = dict(
                st.prefix_cache.stats(),
                lookups=dict(st.greedy.prefix_lookups))
        if st._engine is not None:
            body["continuous_batching"] = st._engine.stats()
        if st.alerts is not None:
            # firing / pending counts by severity (the full list lives at
            # /debug/alerts)
            body["alerts"] = st.alerts.summary()
        body["resilience"] = {
            "state": st.drain.state,
            "deadline_ms_default": st.deadline_ms,
            "max_queue": st.admission.max_queue,
        }
        if st.speculating:
            body["prompt_lookup"] = dict(
                st.spec_totals, draft_k=st.draft_k, ngram=st.ngram,
                source=st.spec_source or "ngram")
        return self._json(200, body)

    @staticmethod
    def _chat_prompt(messages) -> str:
        """OpenAI-style messages → one prompt string: a plain
        role-prefixed transcript (the byte tokenizer has no chat
        template)."""
        if not isinstance(messages, list) or not messages:
            raise ValueError('"messages" must be a non-empty list')
        parts = []
        for m in messages:
            if not isinstance(m, dict):
                raise ValueError("each message must be an object")
            role = m.get("role")
            content = m.get("content")
            if role not in ("system", "user", "assistant"):
                raise ValueError(f"unknown message role {role!r}")
            if not isinstance(content, str):
                raise ValueError('message "content" must be a string')
            parts.append(f"{role}: {content}")
        parts.append("assistant:")
        return "\n".join(parts)

    def _post(self):
        st = self.state
        if self.path == "/drain":
            # the preStop contract: stop admission now, finish resident
            # work, close the listener; 202, the drain ends after this
            accepted = st.begin_drain("POST /drain")
            return self._json(202, {"status": st.drain.state,
                                    "accepted": accepted})
        chat = self.path == "/v1/chat/completions"
        if self.path != "/v1/completions" and not chat:
            return self._json(404, {"error": "unknown path"})
        if not st.ready:
            return self._json(503, {"error": "warming"})
        if st.failed:
            return self._json(503, {
                "error": "serving engine failed — instance is being "
                         "replaced"})
        stream_ctx = None
        try:
            with st._track_busy():
                length = int(self.headers.get("Content-Length", "0"))
                body = json.loads(self.rfile.read(length) or b"{}")
                if not isinstance(body, dict):
                    raise ValueError("body must be a JSON object")
                if chat:
                    prompt = self._chat_prompt(body.get("messages"))
                    # OpenAI chat spells the budget "max_tokens"
                    max_new = body.get("max_tokens",
                                       body.get("max_new_tokens"))
                else:
                    if "prompt" not in body:
                        raise ValueError(
                            'body must be a JSON object with "prompt"')
                    prompt = str(body["prompt"])
                    max_new = body.get("max_new_tokens",
                                       body.get("max_tokens"))
                dl_ms = body.get("deadline_ms")
                if dl_ms is not None:
                    dl_ms = float(dl_ms)
                    if dl_ms <= 0:
                        raise ValueError('"deadline_ms" must be > 0')
                # anchored at receipt: reading and parsing count
                deadline = deadline_from(self._t0, dl_ms,
                                         default_ms=st.deadline_ms)
                kwargs = dict(
                    max_new_tokens=max_new,
                    temperature=body.get("temperature", 0.0),
                    top_k=body.get("top_k", 0),
                    top_p=body.get("top_p", 0.0),
                    seed=body.get("seed", 0),
                    deadline=deadline,
                )
                if body.get("stream"):
                    # validate (and pay the first device call) BEFORE the
                    # 200 status goes out, so errors are still a 400
                    finish: dict = {}
                    cancel = threading.Event()
                    pieces = st.stream(prompt, finish=finish, cancel=cancel,
                                       **kwargs)
                    first = next(pieces, None)
                    TTFT_SECONDS.observe(
                        time.monotonic() - self._t0,
                        exemplar=(self._trace.trace_id
                                  if self._trace.sampled else None))
                    stream_ctx = (first, pieces, finish, cancel)
                else:
                    result = st.complete(prompt, **kwargs)
        except Overloaded as e:
            # load shed: the client's retry policy absorbs the spike
            return self._json(429, {"error": str(e)}, headers={
                "Retry-After": str(e.retry_after_s)})
        except DeadlineExceeded as e:
            return self._json(504, {"error": str(e)})
        except Draining as e:
            return self._json(503, {"error": str(e)},
                              headers={"Retry-After": "1"})
        except (ValueError, TypeError, json.JSONDecodeError) as e:
            return self._json(400, {"error": str(e)})
        except Exception as e:  # noqa: BLE001 — a generation failure must
            # be a JSON 500 the client can parse, not a dropped socket
            log.warn(f"request failed: {type(e).__name__}: {e}")
            return self._json(500, {"error": f"{type(e).__name__}: {e}"})
        if stream_ctx is not None:
            first, pieces, finish, cancel = stream_ctx
            with st._track_busy():
                return self._stream_sse(first, pieces, chat, finish, cancel)
        if chat:
            return self._json(200, {
                "id": f"chatcmpl-{uuid.uuid4().hex}",
                "object": "chat.completion",
                "created": int(time.time()),
                "model": result["model"],
                "choices": [{
                    "index": 0,
                    "message": {
                        "role": "assistant", "content": result["text"],
                    },
                    "finish_reason": result["finish_reason"],
                }],
                "usage": {
                    "prompt_tokens": result["prompt_tokens"],
                    "completion_tokens": result["tokens"],
                    "total_tokens": (
                        result["prompt_tokens"] + result["tokens"]),
                },
            })
        return self._json(200, result)

    def _stream_sse(self, first: str | None, pieces, chat: bool,
                    finish: dict, cancel: threading.Event) -> None:
        """Write text pieces as Server-Sent Events (``data: {json}``
        frames, then ``data: [DONE]``) without coupling the card to the
        client: a producer thread drains the generator (which holds the
        generation lock) into a queue at the card's speed, while this
        thread writes at the client's pace. A client that goes away sets
        ``cancel``, which ends the generation and releases the lock."""
        q: queue.Queue = queue.Queue()
        failed_sentinel = object()   # a mid-stream generation error
        # contextvars do not cross thread creation: the producer runs in
        # the handler's context, so its "decode" span lands in this trace
        ctx = contextvars.copy_context()

        def produce():
            try:
                with TRACER.phase("decode", quiet=True):
                    for piece in pieces:
                        q.put(piece)
                q.put(None)
            except Exception as e:  # noqa: BLE001 — surfaced via sentinel
                log.warn(f"stream producer failed: {type(e).__name__}: {e}")
                q.put(failed_sentinel)

        producer = None
        sid = (f"chatcmpl-{uuid.uuid4().hex}" if chat
               else f"cmpl-{uuid.uuid4().hex}")
        created = int(time.time())
        try:
            # the header writes sit inside the disconnect handler: a
            # client gone before the status line still leaves the
            # generator suspended inside the lock, which the finally
            # below releases
            self._code = 200
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            failed = False
            if first is not None:
                producer = threading.Thread(target=lambda: ctx.run(produce),
                                            daemon=True)
                producer.start()
                self._write_sse(first, chat, sid, created)
                while (piece := q.get()) is not None:
                    if piece is failed_sentinel:
                        failed = True
                        break
                    self._write_sse(piece, chat, sid, created)
            if failed:
                # no [DONE] and no terminal chunk: aborting the chunked
                # body is the in-band error signal
                log.warn("aborting stream after mid-generation failure")
                self.close_connection = True
                self.wfile.flush()
            else:
                # the closing frame: an empty delta with the finish reason
                # the generation loop set, then [DONE]
                reason = finish.get("reason", "stop")
                final_choice = (
                    {"index": 0, "delta": {}, "finish_reason": reason}
                    if chat else
                    {"index": 0, "text": "", "finish_reason": reason})
                self._write_raw(self._sse_frame(chat, sid, created,
                                                final_choice))
                self._write_raw(b"data: [DONE]\n\n")
                self.wfile.write(b"0\r\n\r\n")
        except (BrokenPipeError, ConnectionResetError):
            cancel.set()
            CANCELLED_TOTAL.labels("disconnect").inc()
            log.info("server: client disconnected mid-stream — generation "
                     "cancelled")
        finally:
            if producer is not None:
                producer.join()
            else:
                # no producer (headers failed, or an empty stream): close
                # the generator so stream() releases the lock now
                pieces.close()

    def _sse_frame(self, chat: bool, sid: str, created: int,
                   choice: dict) -> bytes:
        """One SSE data: frame in the OpenAI chunk envelope."""
        obj = {
            "id": sid,
            "object": "chat.completion.chunk" if chat else "text_completion",
            "created": created,
            "model": self.state.model_name,
            "choices": [choice],
        }
        return f"data: {json.dumps(obj)}\n\n".encode("utf-8")

    def _write_sse(self, piece: str, chat: bool, sid: str,
                   created: int) -> None:
        if not piece:
            return
        if chat:
            choice = {"index": 0, "delta": {"content": piece},
                      "finish_reason": None}
        else:
            choice = {"index": 0, "text": piece, "finish_reason": None}
        self._write_raw(self._sse_frame(chat, sid, created, choice))

    def _write_raw(self, data: bytes) -> None:
        """One HTTP/1.1 chunk carrying one SSE frame."""
        self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
        self.wfile.flush()


def make_server(env: dict | None = None) -> ThreadingHTTPServer:
    """Build (but don't run) the server; the model is loaded and warmed
    before this returns."""
    env = dict(os.environ if env is None else env)
    state = ServingState(env)
    state.warm()
    handler = type("Handler", (_Handler,), {"state": state})
    host = env_str("SERVER_HOST", "127.0.0.1", env=env)
    port = env_int("SERVER_PORT", 8000, env=env)
    server = ThreadingHTTPServer((host, port), handler)
    # the drain worker shuts this listener down once quiesced
    state._http_server = server
    return server


def main(argv: list[str] | None = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="tpu-kubernetes-torch-server",
        description="OpenAI-style completions over the PyTorch port "
                    "(configured by SERVE_* / SERVER_* env vars)",
    )
    parser.add_argument("-q", "--quiet", action="store_true",
                        help="warnings and errors only")
    parser.add_argument("--verbose", action="store_true",
                        help="debug detail (per-request access lines)")
    args = parser.parse_args(argv)
    log.set_verbosity(quiet=args.quiet, verbose=args.verbose)
    try:
        server = make_server()
    except ValueError as e:
        raise SystemExit(f"config error: {e}") from e
    host, port = server.server_address[:2]
    log.info(f"server: listening on {host}:{port}")
    # SIGTERM drains instead of dying mid-generation: admission stops,
    # resident work finishes, the listener closes and the process exits 0
    import signal

    state = server.RequestHandlerClass.state
    signal.signal(signal.SIGTERM,
                  lambda signum, frame: state.begin_drain("SIGTERM"))
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
    if state.drain.is_draining:
        state.drain.wait_drained(timeout=5)
        log.info("server: exiting after drain")
    return 0


if __name__ == "__main__":
    sys.exit(main())
