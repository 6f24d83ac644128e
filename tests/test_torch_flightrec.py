"""The reference's ``tests/test_flightrec.py`` against the port's copy of the
flight recorder (``tpu_kubernetes_torch/obs/flightrec.py``), then parity
cases that put the same inputs through both packages.

The reference's docstring:

The serve-engine flight recorder (obs/flightrec.py): bounded segment
ring, atomic dumps with runs/-style retention, user-content redaction,
and the never-raises operational stance."""

import json
import os
import time

from tpu_kubernetes_torch.obs.flightrec import (
    DEFAULT_KEEP,
    DEFAULT_SEGMENTS,
    SCHEMA,
    FlightRecorder,
    redact,
    render_flightrec,
)
from tpu_kubernetes_torch.obs.metrics import Registry


def _recorder(tmp_path, **kw):
    kw.setdefault("registry", Registry())
    return FlightRecorder(directory=str(tmp_path / "flightrec"), **kw)


# -- the segment ring --------------------------------------------------------


def test_segment_ring_is_bounded(tmp_path):
    rec = _recorder(tmp_path, capacity=4)
    for i in range(10):
        rec.record_segment(steps=i, occupied=1, slots=2)
    snap = rec.snapshot()
    assert len(snap["segments"]) == 4                  # ring holds newest 4
    assert [s["steps"] for s in snap["segments"]] == [6, 7, 8, 9]
    assert snap["recorder"]["segments"] == 10          # but counts them all
    assert all("ts" in s for s in snap["segments"])


def test_snapshot_shape_and_extra(tmp_path):
    reg = Registry()
    reg.counter("tpu_serve_requests_total", "req",
                labelnames=("endpoint", "code")).labels("/x", "200").inc(5)
    rec = _recorder(tmp_path, registry=reg)
    rec.record_segment(steps=1)
    snap = rec.snapshot(reason="unit-test", extra={"trigger": "manual"})
    assert snap["schema"] == SCHEMA
    assert snap["reason"] == "unit-test"
    assert snap["pid"] == os.getpid()
    assert snap["extra"] == {"trigger": "manual"}
    for key in ("recorder", "segments", "ledger", "alerts",
                "faults_injected", "spans", "history"):
        assert key in snap
    # the forced observe pulled the registry into the history store
    hist = snap["history"]["tpu_serve_requests_total"]
    assert hist[0]["samples"][-1][1] == 5.0
    json.dumps(snap)                                   # JSON-clean whole


# -- dumps: atomic write, retention, never-raises ----------------------------


def test_dump_writes_parseable_json_and_prunes(tmp_path):
    rec = _recorder(tmp_path, keep=3)
    rec.record_segment(steps=1, occupied=2, slots=4)
    paths = []
    for i in range(5):
        p = rec.dump("engine-reset", extra={"round": i})
        assert p is not None
        paths.append(p)
        time.sleep(0.002)          # distinct millisecond filenames
    kept = sorted(os.listdir(rec.directory))
    assert len(kept) == 3                              # pruned to keep=3
    assert all(n.startswith("flightrec-") and n.endswith(".json")
               for n in kept)                          # no tmp leftovers
    assert [os.path.basename(p) for p in paths[-3:]] == kept
    with open(paths[-1], encoding="utf-8") as f:
        payload = json.load(f)
    assert payload["schema"] == SCHEMA
    assert payload["reason"] == "engine-reset"
    assert payload["extra"] == {"round": 4}
    assert rec.snapshot()["recorder"]["dumps"] == 5


def test_dump_reason_is_filename_safe(tmp_path):
    rec = _recorder(tmp_path)
    p = rec.dump("weird reason/../../etc")
    assert p is not None
    assert os.path.dirname(p) == rec.directory         # no traversal
    assert "/.." not in os.path.basename(p)


def test_dump_never_raises_on_unwritable_dir():
    rec = FlightRecorder(directory="/proc/definitely/not/writable",
                         registry=Registry())
    assert rec.dump("hard-fail") is None               # swallowed, reported
    assert rec.snapshot()["recorder"]["dump_failures"] == 1


def test_record_segment_never_raises(tmp_path):
    rec = _recorder(tmp_path)

    class Boom:
        def __deepcopy__(self, *a):
            raise RuntimeError("no")

    rec.record_segment(steps=1, weird=Boom())          # must not raise
    assert rec.snapshot()["recorder"]["segments"] >= 1


# -- redaction ---------------------------------------------------------------


def test_redact_strips_user_content_keys():
    payload = {
        "prompt": "the secret user prompt",
        "nested": {"messages": ["hi", "there"], "steps": 3},
        "token_ids": [1, 2, 3],
        "note": "x" * 600,
    }
    out = redact(payload)
    assert out["prompt"] == "<redacted:22>"
    assert out["nested"]["messages"] == "<redacted:2>"
    assert out["nested"]["steps"] == 3                 # telemetry untouched
    assert out["token_ids"] == "<redacted:3>"
    assert len(out["note"]) < 600 and "truncated" in out["note"]


def test_dump_payload_is_redacted_end_to_end(tmp_path):
    rec = _recorder(tmp_path)
    rec.record_segment(steps=1, prompt="leak me")
    p = rec.dump("drain")
    with open(p, encoding="utf-8") as f:
        text = f.read()
    assert "leak me" not in text
    assert "<redacted:7>" in text


# -- configuration -----------------------------------------------------------


def test_from_env_reads_the_server_env_dict(tmp_path):
    rec = FlightRecorder.from_env({
        "TPU_K8S_FLIGHTREC_DIR": str(tmp_path / "bb"),
        "TPU_K8S_FLIGHTREC_KEEP": "2",
        "TPU_K8S_FLIGHTREC_SEGMENTS": "16",
    })
    assert rec.directory == str(tmp_path / "bb")
    assert rec.keep == 2
    assert rec._segments.maxlen == 16

    defaults = FlightRecorder.from_env({
        "TPU_K8S_FLIGHTREC_KEEP": "not-a-number",
    })
    assert defaults.keep == DEFAULT_KEEP
    assert defaults._segments.maxlen == DEFAULT_SEGMENTS


# -- operator rendering ------------------------------------------------------


def test_render_flightrec_summarizes(tmp_path):
    rec = _recorder(tmp_path)
    rec.record_segment(steps=3, occupied=2, slots=4, live_steps=5,
                       admitted=1, reaped=0, queued=2,
                       pages={"free": 10, "live": 5, "pinned": 1,
                              "total": 16, "stalls": 0})
    text = render_flightrec(rec.snapshot())
    assert "flight recorder" in text
    assert "occupied 2/4" in text
    assert "free=10" in text and "total=16" in text


# -- parity with the reference's module ---------------------------------------

SEGMENTS = [
    {"steps": 8, "slots": 4, "occupied": 2, "live_steps": 13,
     "admitted": 2, "drained": 1, "reaped": 0, "seconds": 0.0123,
     "queued": 3,
     "pages": {"total": 64, "free": 50, "live": 12, "pinned": 2,
               "stalls": 1},
     "ledger": {"emitted_delta": 32, "unsettled": 13},
     "trace_ids": ["4bf92f3577b34da6a3ce929d0e0e4736"]},
    {"steps": 8, "slots": 4, "occupied": 0, "live_steps": 0,
     "admitted": 0, "drained": 1, "reaped": 1, "seconds": 0.0101,
     "queued": 0, "pages": None,
     "ledger": {"emitted_delta": 0, "unsettled": 0}, "trace_ids": [],
     "prompt": "user text never leaves the process"},
]


def _payload(pkg, tmp_path):
    import importlib
    import types

    flightrec = importlib.import_module(f"{pkg}.obs.flightrec")
    metrics = importlib.import_module(f"{pkg}.obs.metrics")
    reg = metrics.Registry()
    reg.counter("tpu_serve_requests_total", "req",
                labelnames=("endpoint", "code")).labels("/x", "200").inc(5)
    reg.counter("tpu_k8s_faults_injected_total", "faults",
                labelnames=("site",)).labels("serve.segment").inc(2)
    ledger = types.SimpleNamespace(snapshot=lambda **kw: {
        "emitted": 45, "classes": {"useful": 40, "bubble": 5},
        "unsettled": 0})
    rec = flightrec.FlightRecorder(
        directory=str(tmp_path / pkg), capacity=8, registry=reg,
        ledger=ledger, tracer=types.SimpleNamespace(spans=[]))
    for seg in SEGMENTS:
        rec.record_segment(**seg)
    path = rec.dump("engine-reset", extra={"error": "RuntimeError: x"})
    with open(path, encoding="utf-8") as f:
        return json.load(f), flightrec


def _without_clocks(payload):
    out = {k: v for k, v in payload.items() if k not in ("ts", "history")}
    out["segments"] = [{k: v for k, v in s.items() if k != "ts"}
                       for s in payload["segments"]]
    return out


def test_dump_equals_the_reference(tmp_path):
    """The same records through both recorders dump the same payload but
    for its clocks (the keys and the segment fields among it), and each
    package renders either payload alike."""
    port, port_mod = _payload("tpu_kubernetes_torch", tmp_path)
    ref, ref_mod = _payload("tpu_kubernetes", tmp_path)
    assert set(port) == set(ref)
    assert _without_clocks(port) == _without_clocks(ref)
    assert set(port["history"]) == set(ref["history"])
    assert port["segments"][-1]["prompt"].startswith("<redacted:")
    assert port_mod.render_flightrec(port) == ref_mod.render_flightrec(port)
    assert port_mod.render_flightrec(ref) == ref_mod.render_flightrec(ref)
    nested = {"a": [{"messages": ["x"], "n": "y" * 600}], "tokens": [1, 2]}
    assert port_mod.redact(nested) == ref_mod.redact(nested)
