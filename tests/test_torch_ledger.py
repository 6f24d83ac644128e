"""The goodput ledger (``obs/ledger.py``) and the port server's feeds of it,
as the reference's ``tests/test_ledger.py`` holds the JAX server's: the
ledger's arithmetic, the conservation identity on the solo, round-batched,
continuous and streamed paths (the classes sum to the tokens emitted at
quiescence), the slot engine's bubble fraction on a staggered workload,
the analytic roofline (FLOPs a token exact on the CPU, utilization null)
and ``GET /debug/ledger``. The reference's ``get goodput`` CLI and monitor
column are not here (the port has no CLI). Then the port against the JAX
server from the same weights at ``llama-test`` in f32: the ledger's token
classes after the same greedy sequence are equal on the solo,
round-batched, continuous dense and continuous paged paths (seconds
excluded)."""

import http.client
import json
import threading
import time

import pytest

from tests.torch_ops_support import (
    clean_singletons,  # noqa: F401 — autouse
    jax_state,
    reset_singletons,
    torch_state,
)
from tpu_kubernetes_torch.obs.ledger import (
    CLASSES,
    LEDGER,
    TokenLedger,
    fetch_ledger,
    render_ledger,
)
from tpu_kubernetes_torch.obs.metrics import Registry
from tests.torch_ops_support import keep_jax_ledger  # noqa: F401 — autouse
from tests.torch_ops_support import black_box_dirs  # noqa: F401 — autouse


def _state(**extra):
    return torch_state(jax_weights_too=False, **extra)


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


BUDGETS = [12, 3, 5, 8]


def test_ledger_classes_and_conservation_arithmetic():
    led = TokenLedger(registry=Registry())
    led.emitted(10)
    assert led.unsettled() == 10 and led.goodput() == 0.0
    led.settle("useful", 6, device_s=0.5)
    led.settle("cancelled", 1)
    led.settle("expired", 1)
    led.settle("shed-spent", 1)
    led.bubble(1)
    snap = led.snapshot()
    assert snap["unsettled"] == 0
    assert sum(snap["classes"].values()) == snap["emitted"] == 10
    assert snap["goodput"] == 0.6
    assert snap["device_seconds"]["useful"] == 0.5
    assert set(snap["classes"]) == set(CLASSES)
    with pytest.raises(ValueError, match="unknown ledger class"):
        led.settle("wat", 1)
    # clamping: negative/zero amounts are no-ops, not errors
    led.emitted(-5)
    led.settle("useful", -3)
    assert led.snapshot()["emitted"] == 10


def test_ledger_settle_request_trims_to_bubble():
    led = TokenLedger(registry=Registry())
    led.emitted(8)
    # 8 decoded, 5 delivered: the budget-trimmed 3 are bubble
    led.settle_request("useful", delivered=5, decoded=8, device_s=1.0)
    snap = led.snapshot()
    assert snap["classes"]["useful"] == 5
    assert snap["classes"]["bubble"] == 3
    assert snap["unsettled"] == 0
    # decoded is clamped up to delivered (never negative bubble)
    led.emitted(2)
    led.settle_request("cancelled", delivered=2, decoded=1)
    assert led.snapshot()["classes"]["cancelled"] == 2
    assert led.snapshot()["unsettled"] == 0


def test_ledger_segment_timeline_and_bubble_fraction():
    led = TokenLedger(registry=Registry())
    assert led.bubble_fraction() is None
    led.segment(steps=8, slots=4, occupied=4, live_steps=32, admitted=4)
    assert led.bubble_fraction() == 0.0
    led.segment(steps=8, slots=4, occupied=2, live_steps=8, drained=2)
    # 64 row-steps total, 40 live → 37.5% bubble, and the gauge tracks
    assert led.bubble_fraction() == pytest.approx(0.375)
    assert led._bubble_gauge.value == pytest.approx(0.375)
    snap = led.snapshot()
    eng = snap["slot_engine"]
    assert eng["segments"] == 2 and eng["row_steps"] == 64
    assert eng["live_steps"] == 40
    assert [t["live_steps"] for t in snap["timeline"]] == [32, 8]
    assert snap["timeline"][1]["drained"] == 2
    # live is clamped to the grid (a miscount cannot go negative-bubble)
    led.segment(steps=1, slots=2, occupied=2, live_steps=99)
    assert led.snapshot()["slot_engine"]["live_steps"] == 42


def test_ledger_reset_rebinds_after_registry_reset():
    reg = Registry()
    led = TokenLedger(registry=reg)
    led.emitted(4)
    led.settle("useful", 4)
    reg.reset()                   # drops the families out from under it
    led.reset()                   # re-binds: counting works again
    led.emitted(2)
    led.settle("useful", 2)
    assert led.snapshot()["emitted"] == 2
    assert "tpu_serve_tokens_emitted_total 2" in reg.render()


def test_ledger_render_table():
    led = TokenLedger(registry=Registry())
    led.emitted(10)
    led.settle("useful", 9, device_s=2.0)
    led.bubble(1)
    led.segment(steps=4, slots=2, occupied=1, live_steps=3)
    payload = led.snapshot()
    payload["roofline"] = {
        "device_kind": "cpu", "peak_flops": None,
        "programs": {"decode": {
            "flops_per_token": 1.5e6, "bytes_per_token": 4.1e6,
            "arithmetic_intensity": 0.37, "utilization": None,
        }},
    }
    text = render_ledger(payload)
    assert "useful" in text and "90.0%" in text
    assert "goodput=90.0%" in text and "unsettled=0" in text
    assert "slot engine: segments=1" in text
    assert "null" in text           # CPU utilization renders as null
    assert "1.5e+06" in text


def _fan_out(state, prompts, budgets):
    outs: list[dict | None] = [None] * len(prompts)

    def worker(i):
        outs[i] = state.complete(prompts[i], max_new_tokens=budgets[i])

    threads = [
        threading.Thread(target=worker, args=(i,))
        for i in range(len(prompts))
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert all(o is not None for o in outs)
    return outs


def _settled_snapshot(baseline=None, timeout=10.0):
    """Wait out engine-thread settlement tails, then snapshot.

    Without a *baseline*, wait for the unsettled count to go *stable*
    rather than zero: a prior test that drives the engine's private
    API (enqueue + ``_Batcher.result``, never ``complete()``) leaves a
    fixed unsettled floor — that's outside the conservation contract,
    which settles drained entries in ``complete()``. With a baseline,
    wait until the count returns exactly to that floor.
    """
    deadline = time.monotonic() + timeout
    if baseline is None:
        last, since = LEDGER.unsettled(), time.monotonic()
        while time.monotonic() < deadline:
            cur = LEDGER.unsettled()
            if cur != last:
                last, since = cur, time.monotonic()
            elif time.monotonic() - since > 0.25:
                break
            time.sleep(0.01)
    else:
        while (time.monotonic() < deadline
               and LEDGER.unsettled() != baseline):
            time.sleep(0.01)
    return LEDGER.snapshot(timeline=0)


def _assert_conserved(before, after, delivered):
    # delta form: conservation must hold exactly for THIS test's
    # traffic on top of whatever floor the session already carries
    assert after["unsettled"] == before["unsettled"]
    d_classes = (sum(after["classes"].values())
                 - sum(before["classes"].values()))
    assert d_classes == after["emitted"] - before["emitted"]
    assert after["emitted"] >= before["emitted"] + delivered
    assert (after["classes"]["useful"] - before["classes"]["useful"]
            == delivered)


def test_ledger_identity_solo_path():
    st = _state(SERVE_EARLY_EXIT_STEPS="0")
    before = _settled_snapshot()
    outs = [st.complete(p, max_new_tokens=b)
            for p, b in zip(PROMPTS, BUDGETS)]
    after = _settled_snapshot(before["unsettled"])
    _assert_conserved(before, after, sum(o["tokens"] for o in outs))


def test_ledger_identity_batched_path():
    st = _state(SERVER_BATCH="4", SERVE_EARLY_EXIT_STEPS="0")
    before = _settled_snapshot()
    outs = _fan_out(st, PROMPTS, BUDGETS)
    after = _settled_snapshot(before["unsettled"])
    _assert_conserved(before, after, sum(o["tokens"] for o in outs))
    # the static batch pads every row to the same grid: the trim beyond
    # each request's budget is bubble, not useful
    assert (after["classes"]["bubble"] > before["classes"]["bubble"])


def test_ledger_identity_continuous_path():
    st = _state(SERVE_CONTINUOUS_BATCHING="1", SERVER_BATCH="4")
    before = _settled_snapshot()
    outs = _fan_out(st, PROMPTS, BUDGETS)
    after = _settled_snapshot(before["unsettled"])
    _assert_conserved(before, after, sum(o["tokens"] for o in outs))


def test_ledger_identity_streaming_path():
    st = _state()
    before = _settled_snapshot()
    pieces = list(st.stream("pack my box", max_new_tokens=6))
    assert pieces
    after = _settled_snapshot(before["unsettled"])
    assert after["unsettled"] == before["unsettled"]
    assert (sum(after["classes"].values()) - sum(before["classes"].values())
            == after["emitted"] - before["emitted"])
    assert after["classes"]["useful"] > before["classes"]["useful"]


def test_ledger_identity_stream_abandoned_is_cancelled():
    st = _state()
    before = _settled_snapshot()
    gen = st.stream("sphinx of black quartz judge my vow",
                    max_new_tokens=8)
    next(gen)
    gen.close()                       # client walks away mid-decode
    after = _settled_snapshot(before["unsettled"])
    assert after["unsettled"] == before["unsettled"]
    assert (sum(after["classes"].values()) - sum(before["classes"].values())
            == after["emitted"] - before["emitted"])


def test_continuous_staggered_bubble_fraction():
    """The acceptance-criteria workload: staggered budgets on the slot
    engine leave rows done while the segment grid keeps stepping — the
    bubble gauge must reflect those intra-segment dead row-steps."""
    st = _state(SERVE_CONTINUOUS_BATCHING="1", SERVER_BATCH="4")
    base = _settled_snapshot()
    before = base["slot_engine"]
    _fan_out(st, PROMPTS, [16, 2, 2, 2])      # one long row, three short
    after = _settled_snapshot(base["unsettled"])["slot_engine"]
    d_rows = after["row_steps"] - before["row_steps"]
    d_live = after["live_steps"] - before["live_steps"]
    assert d_rows > 0 and 0 < d_live < d_rows  # real intra-segment bubble
    assert after["bubble_fraction"] is not None
    # and the timeline carries per-segment live-row counts
    tl = LEDGER.snapshot()["timeline"]
    assert any(t["live_steps"] < t["steps"] * t["slots"] for t in tl)


def test_roofline_cpu_flops_per_token_exact_utilization_null():
    from tpu_kubernetes_torch.obs.profile import backend_peak_flops
    from tpu_kubernetes_torch.serve.server import PROFILER

    _state().complete("pack my box", max_new_tokens=4)
    assert backend_peak_flops("cpu") is None
    assert backend_peak_flops("TPU v6e") == 918e12
    roof = PROFILER.summary()["roofline"]
    assert roof["device_kind"] == "cpu"
    assert roof["peak_flops"] is None
    prog = roof["programs"]["prefill"]
    assert prog["flops_per_token"] and prog["flops_per_token"] > 0
    assert prog["bytes_per_token"] and prog["arithmetic_intensity"]
    assert prog["utilization"] is None       # null on CPU, by design
    assert "decode" in roof["programs"]


@pytest.fixture(scope="module")
def ledger_server():
    from tpu_kubernetes_torch.serve.server import make_server

    srv = make_server(dict(
        ENV, SERVE_DEVICE="cpu", SERVER_HOST="127.0.0.1", SERVER_PORT="0",
        SERVE_CONTINUOUS_BATCHING="1", SERVER_BATCH="2",
    ))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    host, port = srv.server_address[:2]

    conn = http.client.HTTPConnection(host, port, timeout=120)
    conn.request("POST", "/v1/completions",
                 body=json.dumps({"prompt": "pack my box",
                                  "max_new_tokens": 4}),
                 headers={"Content-Type": "application/json"})
    assert conn.getresponse().status == 200
    conn.close()
    yield srv, f"{host}:{port}"
    srv.shutdown()


def test_debug_ledger_endpoint(ledger_server):
    srv, target = ledger_server
    payload = fetch_ledger(target)
    assert set(payload["classes"]) == set(CLASSES)
    assert payload["emitted"] > 0
    assert payload["unsettled"] == 0
    assert payload["goodput"] is not None
    assert payload["slot_engine"]["segments"] > 0
    assert payload["timeline"]
    # the roofline rides the same payload, with CPU-null utilization
    prog = payload["roofline"]["programs"]["prefill"]
    assert prog["flops_per_token"] > 0 and prog["utilization"] is None


def test_ledger_metrics_exposition(ledger_server):
    srv, target = ledger_server
    host, port = target.split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=30)
    conn.request("GET", "/metrics")
    text = conn.getresponse().read().decode()
    conn.close()
    assert 'tpu_serve_tokens_total{class="useful"}' in text
    assert "tpu_serve_tokens_emitted_total" in text
    assert "tpu_serve_slot_bubble_fraction" in text
    assert 'tpu_serve_device_seconds_total{class="useful"}' in text



# ---------------------------------------------------------------------------
# the port against the JAX server: equal token classes
# ---------------------------------------------------------------------------

PATHS = {
    "solo": {"SERVE_EARLY_EXIT_STEPS": "0"},
    "round_batched": {"SERVER_BATCH": "4", "SERVE_EARLY_EXIT_STEPS": "0"},
    "continuous_dense": {"SERVE_CONTINUOUS_BATCHING": "1",
                         "SERVER_BATCH": "4"},
    "continuous_paged": {"SERVE_CONTINUOUS_BATCHING": "1",
                         "SERVER_BATCH": "4", "SERVE_KV_POOL_MB": "0.25"},
}


def _classes_after(state, ledger, concurrent: bool) -> dict:
    """The ledger's token classes and emitted count that this greedy
    sequence adds: the four prompts at their budgets (at once where the
    path batches), then a streamed request."""
    deadline = time.monotonic() + 10
    while ledger.unsettled() and time.monotonic() < deadline:
        time.sleep(0.01)
    before = ledger.snapshot(timeline=0)
    if concurrent:
        outs = _fan_out(state, PROMPTS, BUDGETS)
    else:
        outs = [state.complete(p, max_new_tokens=b)
                for p, b in zip(PROMPTS, BUDGETS)]
    text = "".join(state.stream("pack my box", max_new_tokens=6))
    deadline = time.monotonic() + 10
    while (ledger.unsettled() != before["unsettled"]
           and time.monotonic() < deadline):
        time.sleep(0.01)
    after = ledger.snapshot(timeline=0)
    delta = {k: after["classes"][k] - before["classes"][k]
             for k in after["classes"]}
    delta["emitted"] = after["emitted"] - before["emitted"]
    delta["unsettled"] = after["unsettled"] - before["unsettled"]
    return delta, [o["text"] for o in outs] + [text]


@pytest.mark.parametrize("path", sorted(PATHS))
def test_ledger_classes_equal_jax(path):
    """One request at a time (so the round batcher and the engine see the
    same arrivals on both servers; the engine's segments then line up row
    for row): every token class, the emitted count and the responses are
    the JAX server's."""
    from tpu_kubernetes.obs.ledger import LEDGER as JLEDGER

    reset_singletons()
    js = jax_state(**PATHS[path])
    ts = torch_state(**PATHS[path])
    want = _classes_after(js, JLEDGER, concurrent=False)
    got = _classes_after(ts, LEDGER, concurrent=False)
    assert got == want
    assert got[0]["unsettled"] == 0 and got[0]["useful"] > 0
    if path == "round_batched":
        assert got[0]["bubble"] > 0       # the static batch's pad rows
