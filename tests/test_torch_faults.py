"""The fault-injection harness (``obs/faults.py``) and the chaos contract
it proves, as the reference's ``tests/test_faults.py`` holds the JAX
server to it, against the port's server on the CPU at ``llama-test``:
under an injected fault at any serve site the port reaches (at prob 1.0
and at a seeded 0.5) every request reaches a terminal state, the goodput
ledger and the page pool are conserved, the health surface stays
consistent and serving recovers once faults clear; a paged restart resets
the pool cold. The reference's sharded (``serve.shard_segment`` needs a
mesh), flight-recorder and alerting chaos tests wait for the port's mesh
and its flight recorder (ROADMAP.md queue 1 items 7 and 3.5b). The last
test pins where ``serve.segment`` fires: on the host, before the segment
program is fetched, so a fault never enters a program's first call."""

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
