"""The fault-injection harness (``obs/faults.py``) and the chaos contract
it proves, as the reference's ``tests/test_faults.py`` holds the JAX
server to it, against the port's server on the CPU at ``llama-test``:
under an injected fault at any serve site the port reaches (at prob 1.0
and at a seeded 0.5) every request reaches a terminal state, the goodput
ledger and the page pool are conserved, the health surface stays
consistent and serving recovers once faults clear; a paged restart resets
the pool cold. The test after them pins where ``serve.segment`` fires: on
the host, before the segment program is fetched, so a fault never enters
a program's first call. Then the black-box half: a parseable flight
recorder dump after chaos at every site, the automatic dumps on an engine
reset and a cold restart, the live ``/debug/flightrec``, the alerting
chaos matrix (a tripwire, exactly one incident bundle, webhook dedup) and
the HTTP and CLI surfaces, rendered by the reference's CLI; last, the
port's ``/debug/alerts`` and ``/debug/flightrec`` against the JAX
server's. The reference's sharded chaos tests (``serve.shard_segment``
needs a mesh) wait for the port's mesh (ROADMAP.md queue 1 item 7)."""

import json
import threading
import time

import pytest

from tests.torch_ops_support import clean_singletons  # noqa: F401 — autouse
from tpu_kubernetes_torch.obs.faults import (
    ENV_VAR,
    FAULTS,
    SITES,
    FaultError,
    FaultInjector,
    injected,
)
from tests.torch_ops_support import keep_jax_ledger  # noqa: F401 — autouse
from tests.torch_ops_support import black_box_dirs  # noqa: F401 — autouse


def test_spec_parsing_and_loud_validation():
    fi = FaultInjector()
    fi.configure("serve.prefill:0.5:7, fleet.scrape:1.0")
    assert fi.armed("serve.prefill") and fi.armed("fleet.scrape")
    assert not fi.armed("serve.segment")
    fi.clear()
    assert not fi.armed()
    with pytest.raises(ValueError, match="unknown fault site"):
        fi.configure("serve.nope:1.0")
    with pytest.raises(ValueError, match="not in"):
        fi.configure("serve.prefill:1.5")
    with pytest.raises(ValueError, match="site:prob"):
        fi.configure("serve.prefill")
    # a bad spec must not half-arm: the old arming survives the raise
    fi.configure("serve.prefill:1.0")
    with pytest.raises(ValueError):
        fi.configure("serve.prefill:1.0,bogus:1.0")
    assert fi.armed("serve.prefill")


def test_seeded_probability_is_deterministic():
    def pattern(seed: int) -> list[int]:
        fi = FaultInjector(f"serve.prefill:0.5:{seed}")
        out = []
        for _ in range(64):
            try:
                fi.fire("serve.prefill")
                out.append(0)
            except FaultError:
                out.append(1)
        return out

    assert pattern(3) == pattern(3)       # (seed, i) fully determines it
    assert pattern(3) != pattern(4)
    assert 0 < sum(pattern(3)) < 64       # prob 0.5 actually interleaves


def test_probability_bounds():
    never = FaultInjector("serve.prefill:0.0")
    for _ in range(32):
        never.fire("serve.prefill")       # prob 0 never fires
    always = FaultInjector("serve.prefill:1.0")
    with pytest.raises(FaultError):
        always.fire("serve.prefill")


def test_unarmed_sites_are_noops():
    fi = FaultInjector("serve.prefill:1.0")
    fi.fire("serve.segment")              # armed elsewhere ≠ armed here
    FaultInjector().fire("serve.prefill")  # nothing armed at all


def test_injected_context_manager_always_disarms():
    with injected("serve.prefill:1.0"):
        assert FAULTS.armed("serve.prefill")
    assert not FAULTS.armed()
    with pytest.raises(FaultError):
        with injected("serve.prefill:1.0"):
            FAULTS.fire("serve.prefill")
    assert not FAULTS.armed()             # disarmed even on the raise


def test_site_vocabulary_is_closed():
    """The chaos matrix below + the fleet/shell suites must together
    cover every registered site — a site added to SITES without a chaos
    test fails here until the matrix learns about it."""
    assert set(SITES) == {
        "serve.prefill", "serve.slot_insert", "serve.segment",
        "serve.shard_segment", "serve.spec_verify", "serve.prefix_insert",
        "serve.page_alloc", "fleet.scrape", "fleet.remediate",
        "shell.terraform", "obs.alert_sink", "obs.trace_export",
    }
    assert ENV_VAR == "TPU_K8S_FAULTS"


ENV = {
    "SERVE_MODEL": "llama-test",
    "SERVE_MAX_NEW": "16",
    "SERVE_DTYPE": "float32",
}


PROMPTS = [
    "the quick brown fox jumps over the lazy dog",
    "pack my box",
    "sphinx of black quartz judge my vow",
    "jived fox nymph grabs quick waltz",
]


SERVE_SITES = [
    "serve.prefill", "serve.slot_insert", "serve.segment",
    "serve.prefix_insert",
]


@pytest.fixture(scope="module")
def chaos_server():
    """One live continuous-batching server (prefix cache on, so the
    serve.prefix_insert site sits on the hot path) shared by the whole
    matrix — chaos runs must leave it reusable, which is itself part of
    the contract under test."""
    from tpu_kubernetes_torch.serve.server import make_server

    srv = make_server(dict(
        ENV, SERVE_DEVICE="cpu", SERVER_HOST="127.0.0.1", SERVER_PORT="0",
        SERVE_CONTINUOUS_BATCHING="1", SERVER_BATCH="2",
        SERVE_PREFIX_CACHE_MB="4",
    ))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield srv
    srv.shutdown()


def _fan_out_chaotic(state, prompts):
    """Submit concurrently; collect a result dict OR the exception —
    the assertion is that every slot of ``outs`` is filled (terminal
    state) and every thread exits (no deadlock)."""
    outs: list[object] = [None] * len(prompts)

    def worker(i):
        try:
            outs[i] = state.complete(prompts[i], max_new_tokens=4)
        except Exception as e:  # noqa: BLE001 — the terminal state itself
            outs[i] = e

    threads = [
        threading.Thread(target=worker, args=(i,))
        for i in range(len(prompts))
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert all(not t.is_alive() for t in threads), "request thread hung"
    return outs


@pytest.mark.parametrize("prob", [1.0, 0.5])
@pytest.mark.parametrize("site", SERVE_SITES)
def test_chaos_every_request_terminates(chaos_server, site, prob):
    state = chaos_server.RequestHandlerClass.state
    with injected(f"{site}:{prob}:11"):
        outs = _fan_out_chaotic(state, PROMPTS)
    for o in outs:
        assert o is not None                     # terminal, not hung
        assert isinstance(o, (dict, Exception))
    if site == "serve.prefix_insert":
        # the prefix store is best-effort by design: its failures must
        # never fail the request that already has its tokens
        assert all(isinstance(o, dict) for o in outs)
    # chaos over: the same engine serves clean traffic immediately
    ok = state.complete("pack my box", max_new_tokens=3)
    assert ok["text"]


@pytest.mark.parametrize("prob", [1.0, 0.5])
@pytest.mark.parametrize("site", SERVE_SITES)
def test_chaos_ledger_conservation(chaos_server, site, prob):
    """The goodput ledger's conservation invariant under chaos: every
    decoded token lands in exactly one class, so the classes sum to
    tokens emitted even while faults shed requests, fail residents out,
    and abort mid-decode — nothing counted twice, nothing dropped."""
    from tpu_kubernetes_torch.obs.ledger import LEDGER

    state = chaos_server.RequestHandlerClass.state
    before = LEDGER.snapshot(timeline=0)
    with injected(f"{site}:{prob}:11"):
        _fan_out_chaotic(state, PROMPTS)
    # chaos over: one clean request drains the engine, then settlement
    # (engine-thread reaps/fail-outs) converges back to the unsettled
    # floor the session started this test with (delta form — an earlier
    # test using the engine's private API may leave a fixed floor)
    state.complete("pack my box", max_new_tokens=3)
    deadline = time.time() + 10
    while (time.time() < deadline
           and LEDGER.unsettled() != before["unsettled"]):
        time.sleep(0.02)
    after = LEDGER.snapshot(timeline=0)
    assert after["unsettled"] == before["unsettled"]
    assert (sum(after["classes"].values()) - sum(before["classes"].values())
            == after["emitted"] - before["emitted"])
    assert after["emitted"] > before["emitted"]      # traffic was counted


def test_chaos_http_surface_stays_consistent(chaos_server):
    """Over HTTP, injected faults surface as parseable 5xx JSON (never
    a dropped socket) and /healthz keeps answering 200/ok throughout."""
    import http.client

    host, port = chaos_server.server_address[:2]

    def req(method, path, body=None):
        conn = http.client.HTTPConnection(host, port, timeout=120)
        conn.request(
            method, path,
            body=None if body is None else json.dumps(body),
            headers={"Content-Type": "application/json"},
        )
        resp = conn.getresponse()
        data = resp.read()
        conn.close()
        return resp.status, data

    with injected("serve.prefill:0.5:3"):
        statuses = []
        for p in PROMPTS * 2:
            status, data = req("POST", "/v1/completions",
                               {"prompt": p, "max_new_tokens": 3})
            statuses.append(status)
            payload = json.loads(data)           # always parseable JSON
            assert ("text" in payload) or ("error" in payload)
            h_status, h_data = req("GET", "/healthz")
            assert h_status == 200
            assert json.loads(h_data)["status"] == "ok"
    assert 200 in statuses                       # prob 0.5: some succeed
    assert 500 in statuses                       # ... and some fault
    # faults cleared: fully healthy again
    status, data = req("POST", "/v1/completions",
                       {"prompt": "pack my box", "max_new_tokens": 3})
    assert status == 200 and json.loads(data)["text"]


def test_trace_export_chaos_drops_spans_silently(chaos_server, tmp_path):
    """obs.trace_export at prob 1.0 never blocks or fails a request:
    every completion succeeds with text, /healthz stays 200/ok, the
    dropped batches are counted by tpu_trace_spans_dropped_total, and
    the same exporter delivers again the moment faults clear."""
    import http.client

    from tpu_kubernetes_torch.obs import tracing
    from tpu_kubernetes_torch.obs.tracing import SPANS_DROPPED, SPANS_EXPORTED

    host, port = chaos_server.server_address[:2]
    state = chaos_server.RequestHandlerClass.state

    def req(method, path, body=None):
        conn = http.client.HTTPConnection(host, port, timeout=120)
        conn.request(
            method, path,
            body=None if body is None else json.dumps(body),
            headers={"Content-Type": "application/json"},
        )
        resp = conn.getresponse()
        data = resp.read()
        conn.close()
        return resp.status, data

    spans_file = tmp_path / "spans.jsonl"
    runtime = tracing.TraceRuntime(
        tracing.TraceConfig(sample=1.0, export_path=str(spans_file)),
    )
    old_runtime = state.tracing
    state.tracing = runtime              # arm a live export sink
    try:
        dropped_before = SPANS_DROPPED.value
        with injected("obs.trace_export:1.0"):
            for p in PROMPTS:
                status, data = req("POST", "/v1/completions",
                                   {"prompt": p, "max_new_tokens": 3})
                assert status == 200 and json.loads(data)["text"]
                h_status, h_data = req("GET", "/healthz")
                assert h_status == 200
                assert json.loads(h_data)["status"] == "ok"
            # every accepted batch was ATTEMPTED (and dropped) while
            # the fault was armed — flush is the test-only wait
            assert runtime.exporter.flush(10.0)
        assert SPANS_DROPPED.value > dropped_before
        assert not spans_file.exists() or spans_file.read_text() == ""

        # faults cleared: the same exporter delivers without a restart
        exported_before = SPANS_EXPORTED.value
        status, data = req("POST", "/v1/completions",
                           {"prompt": "pack my box", "max_new_tokens": 3})
        assert status == 200 and json.loads(data)["text"]
        assert runtime.exporter.flush(10.0)
        assert SPANS_EXPORTED.value > exported_before
        recs = [json.loads(x)
                for x in spans_file.read_text().splitlines()]
        assert recs and all(r["trace"] for r in recs)
        assert any(r["name"] == "request" for r in recs)
    finally:
        state.tracing = old_runtime
        runtime.close()


# the paged engine threads every site the dense engine does PLUS the
# page allocator — the chaos matrix must cover all of them against the
# page-accounting invariant below
PAGED_SITES = SERVE_SITES + ["serve.page_alloc"]


@pytest.fixture(scope="module")
def paged_chaos_server():
    """A continuous-batching server in PAGED KV mode (SERVE_KV_POOL_MB),
    prefix cache on so pinned pages participate — the conservation
    matrix must hold across all three page states."""
    from tpu_kubernetes_torch.serve.server import make_server

    srv = make_server(dict(
        ENV, SERVE_DEVICE="cpu", SERVER_HOST="127.0.0.1", SERVER_PORT="0",
        SERVE_CONTINUOUS_BATCHING="1", SERVER_BATCH="2",
        SERVE_PREFIX_CACHE_MB="4",
        SERVE_KV_POOL_MB="0.25", SERVE_KV_PAGE_SIZE="16",
    ))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield srv
    srv.shutdown()


def _page_stats(state) -> dict:
    return state._engine._pages.stats()


def _assert_pages_conserved(state):
    """free + live + pinned == total, recomputed from the pool's ground
    truth — the no-leak invariant. Polls briefly: the scheduler thread
    may still be draining reaped rows."""
    deadline = time.time() + 10
    while time.time() < deadline:
        s = _page_stats(state)
        if s["free"] + s["live"] + s["pinned"] == s["total"]:
            return s
        time.sleep(0.02)
    s = _page_stats(state)
    assert s["free"] + s["live"] + s["pinned"] == s["total"], s


@pytest.mark.parametrize("prob", [1.0, 0.5])
@pytest.mark.parametrize("site", PAGED_SITES)
def test_paged_chaos_terminates_and_conserves_pages(
    paged_chaos_server, site, prob,
):
    """Every request terminates under chaos at every paged-engine site
    (including the allocator itself), and afterwards no page has leaked
    — failed admissions, mid-graft faults, and engine resets must all
    hand their pages back."""
    state = paged_chaos_server.RequestHandlerClass.state
    with injected(f"{site}:{prob}:11"):
        outs = _fan_out_chaotic(state, PROMPTS)
    for o in outs:
        assert o is not None
        assert isinstance(o, (dict, Exception))
    _assert_pages_conserved(state)
    # chaos over: the same paged engine serves clean traffic — and the
    # clean pass conserves too
    ok = state.complete("pack my box", max_new_tokens=3)
    assert ok["text"]
    _assert_pages_conserved(state)


def test_paged_deadline_reap_returns_pages(paged_chaos_server):
    """A resident row reaped mid-flight by its deadline releases its
    pages: occupancy returns to the free list, conservation holds."""
    import time as _time

    from tpu_kubernetes_torch.serve.server import _Batcher

    state = paged_chaos_server.RequestHandlerClass.state
    eng = state._engine
    entry = eng.enqueue(state.encode(PROMPTS[0]), 16,
                        deadline=_time.monotonic() + 30)
    assert entry["dispatched"].wait(30)          # resident, pages held
    # expire it while resident: the next reap pass retires the row
    # mid-decode and must hand every page back
    entry["deadline"] = _time.monotonic() - 1
    assert entry["event"].wait(30)
    with pytest.raises(Exception, match="deadline expired"):
        _Batcher.result(entry)
    _assert_pages_conserved(state)


def _restart_resets_pool_cold(state):
    """The watchdog-restart contract in paged mode: a cold reset
    rebuilds the pool with every page free (stored prefixes dropped
    wholesale — their page ids died with the old pool) and serves
    immediately. Shared by the single-device and sharded matrices."""
    state.complete(PROMPTS[2], max_new_tokens=4)     # populate store
    # quiesce first: restart() is dead-scheduler recovery — firing it
    # mid-retirement would shed-spent-settle a row complete() already
    # settled useful
    deadline = time.monotonic() + 10
    while (state._engine.stats()["occupied"]
           and time.monotonic() < deadline):
        time.sleep(0.005)
    assert state._engine.stats()["occupied"] == 0
    state._engine.restart()
    s = _page_stats(state)
    assert s["free"] == s["total"] and s["live"] == s["pinned"] == 0
    assert len(state._engine._prefix) == 0
    out = state.complete("pack my box", max_new_tokens=3)
    assert out["text"]
    _assert_pages_conserved(state)


def test_paged_engine_restart_resets_pool_cold(paged_chaos_server):
    _restart_resets_pool_cold(paged_chaos_server.RequestHandlerClass.state)


# the speculating engine replaces plain segments with verify rounds, so
# serve.spec_verify sits on ITS decode hot path (never fired by the
# plain fixtures above); serve.segment rides along to prove the
# engine-level fault handling is unchanged by the spec loop
SPEC_SITES = ["serve.spec_verify", "serve.segment"]


@pytest.fixture(scope="module")
def spec_chaos_server():
    """A speculating PAGED server (prompt lookup + page pool + prefix
    cache): rejected-draft cells flow to the speculative-waste ledger
    class and page-table truncates return pages every round, so both
    conservation invariants are live while verify rounds fail."""
    from tpu_kubernetes_torch.serve.server import make_server

    srv = make_server(dict(
        ENV, SERVE_DEVICE="cpu", SERVER_HOST="127.0.0.1", SERVER_PORT="0",
        SERVE_CONTINUOUS_BATCHING="1", SERVER_BATCH="2",
        SERVE_PREFIX_CACHE_MB="4",
        SERVE_KV_POOL_MB="0.25", SERVE_KV_PAGE_SIZE="16",
        SERVE_PROMPT_LOOKUP="1", SERVE_DRAFT_K="4",
    ))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield srv
    srv.shutdown()


@pytest.mark.parametrize("prob", [1.0, 0.5])
@pytest.mark.parametrize("site", SPEC_SITES)
def test_spec_chaos_terminates_conserves_ledger_and_pages(
    spec_chaos_server, site, prob,
):
    """A verify round failing mid-segment: every request reaches a
    terminal state, the ledger conservation invariant holds WITH
    speculative-waste in play (classes sum to emitted — completed
    rounds settled their cells before the fault fired), every page is
    back on an accountable list, and the same engine serves clean
    traffic immediately after."""
    from tpu_kubernetes_torch.obs.ledger import LEDGER

    state = spec_chaos_server.RequestHandlerClass.state
    assert state._engine.spec_source == "ngram"
    before = LEDGER.snapshot(timeline=0)
    with injected(f"{site}:{prob}:11"):
        outs = _fan_out_chaotic(state, PROMPTS)
    for o in outs:
        assert o is not None                     # terminal, not hung
        assert isinstance(o, (dict, Exception))
    # chaos over: clean traffic immediately, then settlement converges
    ok = state.complete("pack my box", max_new_tokens=3)
    assert ok["text"]
    deadline = time.time() + 10
    while (time.time() < deadline
           and LEDGER.unsettled() != before["unsettled"]):
        time.sleep(0.02)
    after = LEDGER.snapshot(timeline=0)
    assert after["unsettled"] == before["unsettled"]
    assert (sum(after["classes"].values()) - sum(before["classes"].values())
            == after["emitted"] - before["emitted"])
    assert after["emitted"] > before["emitted"]
    _assert_pages_conserved(state)


def test_spec_clean_run_settles_speculative_waste(spec_chaos_server):
    """No faults armed: the speculating engine's rejected draft cells
    land in the speculative-waste class (nonzero — this random-init
    model rejects most proposals) while conservation stays exact."""
    from tpu_kubernetes_torch.obs.ledger import LEDGER

    state = spec_chaos_server.RequestHandlerClass.state
    before = LEDGER.snapshot(timeline=0)
    outs = _fan_out_chaotic(state, PROMPTS)
    assert all(isinstance(o, dict) for o in outs)
    deadline = time.time() + 10
    while (time.time() < deadline
           and LEDGER.unsettled() != before["unsettled"]):
        time.sleep(0.02)
    after = LEDGER.snapshot(timeline=0)
    assert after["unsettled"] == before["unsettled"]
    assert (sum(after["classes"].values()) - sum(before["classes"].values())
            == after["emitted"] - before["emitted"])
    waste = (after["classes"].get("speculative-waste", 0)
             - before["classes"].get("speculative-waste", 0))
    assert waste > 0
    _assert_pages_conserved(state)


def test_segment_fault_fires_before_the_program_is_called():
    """``serve.segment`` armed before an engine's first segment: the
    request fails out and the segment program was never called (its first
    call, the capture on the card, never entered); disarmed, the next
    request calls it once and its tokens are a clean engine's."""
    from tests.torch_ops_support import torch_state
    from tpu_kubernetes_torch.serve.server import (
        ContinuousEngine,
        GreedyLane,
        _Batcher,
    )

    st = torch_state(jax_weights_too=False)
    ids = st.encode(PROMPTS[0])

    def engine():
        return ContinuousEngine(GreedyLane(st.params, st.cfg), slots=2,
                                seg_steps=4)

    clean = engine()
    want = _Batcher.result(clean.enqueue(ids, 6))
    clean.close()
    eng = engine()
    key = ("slot_segment", 4)
    try:
        with injected("serve.segment:1.0"):
            entry = eng.enqueue(ids, 6)
            assert entry["event"].wait(60)
            with pytest.raises(FaultError):
                _Batcher.result(entry)
        assert key not in eng.lane.programs.captures
        assert _Batcher.result(eng.enqueue(ids, 6)) == want
        assert eng.lane.programs.captures[key] == 1
    finally:
        eng.close()


# ---------------------------------------------------------------------------
# flight recorder under chaos: a parseable black box after every fault
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def blackbox_chaos_server(tmp_path_factory):
    """A paged continuous-batching server with the flight recorder
    dumping into a per-module tmp dir (TPU_K8S_FLIGHTREC_DIR rides the
    server env dict, not os.environ)."""
    from tpu_kubernetes_torch.serve.server import make_server

    dump_dir = str(tmp_path_factory.mktemp("flightrec"))
    srv = make_server(dict(
        ENV, SERVE_DEVICE="cpu", SERVER_HOST="127.0.0.1", SERVER_PORT="0",
        SERVE_CONTINUOUS_BATCHING="1", SERVER_BATCH="2",
        SERVE_PREFIX_CACHE_MB="4",
        SERVE_KV_POOL_MB="0.25", SERVE_KV_PAGE_SIZE="16",
        TPU_K8S_FLIGHTREC_DIR=dump_dir, TPU_K8S_FLIGHTREC_KEEP="64",
    ))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield srv, dump_dir
    srv.shutdown()


def _quiesce(state, timeout=10.0):
    deadline = time.monotonic() + timeout
    while (state._engine.stats()["occupied"]
           and time.monotonic() < deadline):
        time.sleep(0.005)


def _load_dump(path):
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _dumps_with_reason(dump_dir, reason):
    import os

    return sorted(
        os.path.join(dump_dir, n) for n in os.listdir(dump_dir)
        if n.startswith("flightrec-") and reason in n and n.endswith(".json")
    )


def _last_pages_segment(payload):
    for seg in reversed(payload.get("segments", [])):
        if seg.get("pages"):
            return seg["pages"]
    return None


@pytest.mark.parametrize("site", PAGED_SITES)
def test_flightrec_dump_after_chaos_at_every_site(
    blackbox_chaos_server, site,
):
    """After killing every serve site the port reaches at prob 1.0 the
    on-demand dump is present, parseable, and consistent — the embedded
    ledger balances (classes + unsettled == emitted, unsettled back to
    the pre-test floor) and the last recorded page partition sums to the
    pool total."""
    from tpu_kubernetes_torch.obs.ledger import LEDGER

    srv, dump_dir = blackbox_chaos_server
    state = srv.RequestHandlerClass.state
    assert state.flightrec is not None
    floor = LEDGER.unsettled()
    with injected(f"{site}:1.0:11"):
        _fan_out_chaotic(state, PROMPTS)
    # chaos over: drain with one clean request, wait for settlement
    state.complete("pack my box", max_new_tokens=3)
    deadline = time.time() + 10
    while time.time() < deadline and LEDGER.unsettled() != floor:
        time.sleep(0.02)
    _quiesce(state)
    _assert_pages_conserved(state)

    path = state.flightrec.dump(f"chaos-{site}")
    assert path is not None
    payload = _load_dump(path)                       # parseable postmortem
    assert payload["schema"].startswith("tpu-k8s-flightrec/")
    assert payload["recorder"]["segments"] > 0
    assert payload["faults_injected"].get(site, 0) > 0

    ledger = payload["ledger"]
    assert ledger["unsettled"] == floor
    assert (sum(ledger["classes"].values()) + ledger["unsettled"]
            == ledger["emitted"])

    pages = _last_pages_segment(payload)
    assert pages is not None
    assert pages["free"] + pages["live"] + pages["pinned"] == pages["total"]


def test_flightrec_auto_dumps_on_engine_reset(blackbox_chaos_server):
    """A segment-site fault fails the engine out — the recorder must
    have written an engine-reset postmortem on its own, carrying the
    error string."""
    srv, dump_dir = blackbox_chaos_server
    state = srv.RequestHandlerClass.state
    with injected("serve.segment:1.0:11"):
        _fan_out_chaotic(state, PROMPTS)
    state.complete("pack my box", max_new_tokens=3)  # engine recovered
    dumps = _dumps_with_reason(dump_dir, "engine-reset")
    assert dumps
    payload = _load_dump(dumps[-1])
    assert payload["reason"] == "engine-reset"
    assert "error" in payload["extra"]
    assert "injected fault" in payload["extra"]["error"]


def test_flightrec_dumps_on_cold_restart(blackbox_chaos_server):
    """The watchdog-restart path writes its own postmortem before the
    reset wipes the engine state."""
    srv, dump_dir = blackbox_chaos_server
    state = srv.RequestHandlerClass.state
    state.complete(PROMPTS[1], max_new_tokens=3)
    _quiesce(state)
    before = len(_dumps_with_reason(dump_dir, "watchdog-restart"))
    state._engine.restart()
    dumps = _dumps_with_reason(dump_dir, "watchdog-restart")
    assert len(dumps) == before + 1
    payload = _load_dump(dumps[-1])
    assert payload["reason"] == "watchdog-restart"
    # the count of restarts BEFORE this one — the dump happens first
    assert payload["extra"]["restarts"] >= 0
    # restarted engine serves immediately, black box still recording
    assert state.complete("pack my box", max_new_tokens=3)["text"]


def test_flightrec_http_endpoint_live(blackbox_chaos_server):
    """GET /debug/flightrec returns the same payload without writing a
    file, and the reference's CLI renderer summarizes it."""
    from tpu_kubernetes.obs.flightrec import fetch_flightrec, render_flightrec

    srv, _dump_dir = blackbox_chaos_server
    state = srv.RequestHandlerClass.state
    state.complete(PROMPTS[0], max_new_tokens=3)
    host, port = srv.server_address[:2]
    payload = fetch_flightrec(f"{host}:{port}")
    assert payload["reason"] == "on-demand"
    assert payload["recorder"]["segments"] > 0
    text = render_flightrec(payload)
    assert "flight recorder" in text and "segments in ring" in text


# ---------------------------------------------------------------------------
# alerting chaos matrix: every paged site at prob 1.0 trips an engine
# tripwire, correlates into exactly one incident bundle, and notifies
# the webhook once per fingerprint (obs/alerts.py + obs/incidents.py)
# ---------------------------------------------------------------------------


class _AlertWebhook:
    """A live HTTP endpoint capturing every alert notification POST."""

    def __init__(self):
        import http.server

        self.posts = []
        self._lock = threading.Lock()
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *args):  # noqa: ARG002 — quiet tests
                pass

            def do_POST(self):  # noqa: N802
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length)
                with outer._lock:
                    outer.posts.append(json.loads(body))
                self.send_response(200)
                self.send_header("Content-Length", "0")
                self.end_headers()

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                      Handler)
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()

    @property
    def url(self):
        host, port = self.server.server_address[:2]
        return f"http://{host}:{port}/alerts"

    def snapshot(self):
        with self._lock:
            return list(self.posts)

    def stop(self):
        self.server.shutdown()
        self.server.server_close()


def _await_all_clear(state, timeout=60.0):
    """Poll until no tripwire is pending/firing and no incident is open
    — the scheduler's idle alert tick resolves alerts and closes
    incidents on a quiet engine, so this converges without traffic."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        summary = state.alerts.summary()
        if (summary["firing"] == 0 and summary["pending"] == 0
                and state._incidents.current_incident_id() is None):
            return
        time.sleep(0.05)
    raise AssertionError(
        f"alerts never cleared: {state.alerts.summary()}, "
        f"open incident {state._incidents.current_incident_id()}"
    )


@pytest.fixture(scope="module")
def alerting_chaos_server(tmp_path_factory):
    """A paged continuous-batching server with the full incident
    pipeline armed: tripwires firing instantly (FOR_S=0), a short
    symmetric resolve hold bridging sub-second clean gaps mid-chaos
    (RESOLVE_FOR_S=2), incidents closing 2s after all-clear, and a live
    webhook flushed every evaluate (GROUP_S=0) so the dedup under test
    is the firing-transition contract itself, not batching."""
    from tpu_kubernetes_torch.obs.ledger import LEDGER
    from tpu_kubernetes_torch.serve.server import make_server

    # the ledger tripwire reads the process ledger: start it balanced (an
    # earlier test's engine, driven without complete(), leaves its tokens
    # unsettled, which would hold ledger-conservation firing throughout)
    LEDGER.reset()
    recv = _AlertWebhook()
    incidents_dir = str(tmp_path_factory.mktemp("incidents"))
    srv = make_server(dict(
        ENV, SERVE_DEVICE="cpu", SERVER_HOST="127.0.0.1", SERVER_PORT="0",
        SERVE_CONTINUOUS_BATCHING="1", SERVER_BATCH="2",
        SERVE_PREFIX_CACHE_MB="4",
        SERVE_KV_POOL_MB="0.25", SERVE_KV_PAGE_SIZE="16",
        TPU_K8S_FLIGHTREC_DIR=str(tmp_path_factory.mktemp("fr-alerts")),
        TPU_K8S_INCIDENTS_DIR=incidents_dir,
        TPU_K8S_INCIDENTS_CLOSE_S="2",
        TPU_K8S_ALERT_FOR_S="0",
        TPU_K8S_ALERT_RESOLVE_FOR_S="2",
        TPU_K8S_ALERT_TICK_S="0",
        TPU_K8S_ALERT_GROUP_S="0",
        TPU_K8S_ALERT_WEBHOOK=recv.url,
    ))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    state = srv.RequestHandlerClass.state
    # warm-up: let the first traffic's transient tripwires (with FOR_S=0
    # the ledger is legitimately "unbalanced" while tokens are in flight)
    # resolve and any warm-up incident close before the matrix starts
    # counting bundles and webhook posts
    state.complete("pack my box", max_new_tokens=3)
    _await_all_clear(state)
    yield srv, incidents_dir, recv
    srv.shutdown()
    recv.stop()


def _bundle_files(incidents_dir):
    import os

    return {
        n for n in os.listdir(incidents_dir)
        if n.startswith("incident-") and n.endswith(".json")
    }


@pytest.mark.parametrize("site", PAGED_SITES)
def test_chaos_alerting_tripwire_incident_and_dedup(
    alerting_chaos_server, site,
):
    """Chaos at every serve site the port reaches at prob 1.0 trips at
    least one engine tripwire, correlates into EXACTLY one closed
    incident bundle — atomic, redacted, cross-referenced with
    flight-recorder dumps, conservation-checkable offline — and the
    webhook saw one firing notification per tripwire fingerprint."""
    import os

    srv, incidents_dir, recv = alerting_chaos_server
    state = srv.RequestHandlerClass.state
    before_files = _bundle_files(incidents_dir)
    posts_before = len(recv.snapshot())

    with injected(f"{site}:1.0:11"):
        _fan_out_chaotic(state, PROMPTS)
    # chaos over: drain immediately — the clean request keeps the engine
    # evaluating while every tripwire that fired holds through its clean
    # window, so they all merge into one incident instead of flapping
    state.complete("pack my box", max_new_tokens=3)
    _quiesce(state)
    _await_all_clear(state)

    new = sorted(_bundle_files(incidents_dir) - before_files)
    assert len(new) == 1, new                       # exactly one incident
    assert not [n for n in os.listdir(incidents_dir) if ".tmp" in n]

    with open(os.path.join(incidents_dir, new[0]), encoding="utf-8") as f:
        raw = f.read()
    for prompt in PROMPTS:                          # redaction holds
        assert prompt not in raw
    bundle = json.loads(raw)                        # atomic + parseable
    assert bundle["schema"] == "tpu-k8s-incident/1"
    assert bundle["status"] == "closed"
    assert bundle["alerts"]                         # ≥1 firing tripwire
    assert "fault-injected" in bundle["rules"]      # the universal canary
    assert bundle["faults_injected"].get(site, 0) > 0

    # cross-refs both ways: the bundle lists the incident-open dump, and
    # that dump carries this incident's id back
    assert bundle["flightrec_dumps"]
    stamped = [_load_dump(p) for p in bundle["flightrec_dumps"]
               if os.path.exists(p)]
    assert any(d.get("incident_id") == bundle["incident_id"]
               for d in stamped)

    # the embedded ledger is conservation-checkable from the file alone
    ledger = bundle["ledger"]
    assert (sum(ledger["classes"].values()) + ledger["unsettled"]
            == ledger["emitted"])

    # webhook dedup: a held firing state is never re-notified — at most
    # one firing post per fingerprint (two only if a tripwire genuinely
    # resolved and re-fired inside this window), and the fault-injected
    # canary fires exactly once
    firing_counts: dict[str, int] = {}
    canary_fps = set()
    for batch in recv.snapshot()[posts_before:]:
        for a in batch["alerts"]:
            if a["state"] == "firing":
                firing_counts[a["fingerprint"]] = (
                    firing_counts.get(a["fingerprint"], 0) + 1
                )
                if a["rule"] == "fault-injected":
                    canary_fps.add(a["fingerprint"])
    assert firing_counts                            # the webhook saw chaos
    assert len(canary_fps) == 1
    assert firing_counts[next(iter(canary_fps))] == 1
    assert all(n <= 2 for n in firing_counts.values()), firing_counts


def test_alerting_http_and_cli_surfaces(alerting_chaos_server, capsys):
    """GET /debug/alerts serves the manager snapshot, /healthz mirrors
    the summary, and the reference's CLI (its ``render_alerts`` and
    ``render_incidents``) renders the port's live alerts and offline
    incident bundles."""
    import http.client

    from tpu_kubernetes.cli.main import main as cli_main
    from tpu_kubernetes.obs.alerts import fetch_alerts

    srv, incidents_dir, _recv = alerting_chaos_server
    state = srv.RequestHandlerClass.state
    state.complete(PROMPTS[0], max_new_tokens=3)
    host, port = srv.server_address[:2]

    payload = fetch_alerts(f"{host}:{port}")         # GET /debug/alerts
    assert payload["schema"] == "tpu-k8s-alerts/1"
    names = {r["name"] for r in payload["rules"]}
    assert {"page-partition-leak", "ledger-conservation",
            "fault-injected", "queue-runaway"} <= names

    conn = http.client.HTTPConnection(host, port, timeout=30)
    conn.request("GET", "/healthz")
    resp = conn.getresponse()
    body = json.loads(resp.read())
    conn.close()
    assert resp.status == 200
    assert set(body["alerts"]) == {"firing", "pending", "by_severity"}

    assert cli_main(["get", "alerts",
                     "--target", f"{host}:{port}"]) == 0
    out = capsys.readouterr().out
    assert "rules" in out
    assert cli_main(["get", "alerts", "--target", f"{host}:{port}",
                     "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["schema"] \
        == "tpu-k8s-alerts/1"

    assert cli_main(["get", "flightrec", "--target", f"{host}:{port}"]) == 0
    assert "segments in ring" in capsys.readouterr().out

    assert cli_main(["get", "incidents", "--dir", incidents_dir,
                     "--json"]) == 0
    bundles = json.loads(capsys.readouterr().out)
    assert isinstance(bundles, list) and bundles
    assert cli_main(["get", "incidents", "--dir", incidents_dir]) == 0
    capsys.readouterr()


def test_black_box_endpoints_match_the_jax_server(tmp_path):
    """The JAX server and the port's server, from the same weights (paged
    engine, ``llama-test`` f32), answer the same request sequence; their
    ``/debug/alerts`` list the same rules and their ``/debug/flightrec``
    the same top-level keys and segment-record fields, and both mirror
    the alert summary into ``/healthz`` alike."""
    import http.client

    from tests.torch_ops_support import jax_weights
    from tpu_kubernetes.serve.server import make_server as jmake_server
    from tpu_kubernetes_torch.serve import job as tjob
    from tpu_kubernetes_torch.serve.server import make_server

    common = dict(
        ENV, SERVER_HOST="127.0.0.1", SERVER_PORT="0",
        SERVE_CONTINUOUS_BATCHING="1", SERVER_BATCH="2",
        SERVE_KV_POOL_MB="0.25", SERVE_KV_PAGE_SIZE="16")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tjob, "init_params", jax_weights)
        tsrv = make_server(dict(common, SERVE_DEVICE="cpu",
                                TPU_K8S_FLIGHTREC_DIR=str(tmp_path / "t")))
    jsrv = jmake_server(dict(common,
                             TPU_K8S_FLIGHTREC_DIR=str(tmp_path / "j")))
    threads = [threading.Thread(target=s.serve_forever, daemon=True)
               for s in (tsrv, jsrv)]
    for t in threads:
        t.start()

    def get(srv, path):
        host, port = srv.server_address[:2]
        conn = http.client.HTTPConnection(host, port, timeout=60)
        conn.request("GET", path)
        resp = conn.getresponse()
        body = json.loads(resp.read())
        conn.close()
        assert resp.status == 200, (path, body)
        return body

    try:
        texts = {}
        for srv in (tsrv, jsrv):
            state = srv.RequestHandlerClass.state
            texts[srv] = [state.complete(p, max_new_tokens=6)["text"]
                          for p in PROMPTS[:3]]
        assert texts[tsrv] == texts[jsrv]
        alerts = {s: get(s, "/debug/alerts") for s in (tsrv, jsrv)}
        assert [r["name"] for r in alerts[tsrv]["rules"]] == \
            [r["name"] for r in alerts[jsrv]["rules"]]
        assert set(alerts[tsrv]) == set(alerts[jsrv])
        recs = {s: get(s, "/debug/flightrec") for s in (tsrv, jsrv)}
        assert set(recs[tsrv]) == set(recs[jsrv])
        assert recs[tsrv]["segments"] and recs[jsrv]["segments"]
        assert set(recs[tsrv]["segments"][-1]) == \
            set(recs[jsrv]["segments"][-1])
        assert set(recs[tsrv]["segments"][-1]["pages"]) == \
            set(recs[jsrv]["segments"][-1]["pages"])
        health = {s: get(s, "/healthz") for s in (tsrv, jsrv)}
        assert set(health[tsrv]["alerts"]) == set(health[jsrv]["alerts"])
    finally:
        for s in (tsrv, jsrv):
            s.shutdown()
