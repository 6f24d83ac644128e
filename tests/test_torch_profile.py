"""The reference's phase-profiler tests (``tests/test_profile.py``) against
the port's ``obs/profile.py`` (the one module of this layer rewritten, not
copied: CUDA events instead of ``jax.block_until_ready``, the caching
allocator's memory stats, ``torch.cuda.get_device_name`` for the device
kind, and an analytic roofline in place of XLA's cost model), plus the
port's own: the analytic count against a hand count at ``llama-test``, the
program's first call as "compile", and the roofline's per-call means. The
event-timed path runs on the card (``tests/test_torch_kernel_cuda.py``)."""

from __future__ import annotations

import io
from dataclasses import replace

import pytest
import torch

from tpu_kubernetes_torch.models import CONFIGS
from tpu_kubernetes_torch.obs.metrics import Registry
from tpu_kubernetes_torch.obs.profile import (
    PhaseProfiler,
    backend_peak_flops,
    device_kind,
    device_memory_stats,
    fetch_profile,
    matmul_params,
    program_cost,
    render_profile,
)


def _profiler(**kw):
    return PhaseProfiler(registry=Registry(), sample_hbm=False, **kw)


def test_first_call_is_compile_then_execute():
    p = _profiler()
    with p.phase("step", key="k") as h:
        assert h.mode == "compile"
    with p.phase("step", key="k") as h:
        assert h.mode == "execute"
    with p.phase("step", key="k") as h:
        assert h.mode == "execute"
    s = p.summary()["phases"]["step"]
    assert s["compile"]["count"] == 1
    assert s["execute"]["count"] == 2


def test_distinct_keys_compile_separately():
    p = _profiler()
    with p.phase("prefill", key=("prefill", 32)) as h:
        assert h.mode == "compile"
    with p.phase("prefill", key=("prefill", 64)) as h:
        assert h.mode == "compile"       # a different program compiles too
    with p.phase("prefill", key=("prefill", 32)) as h:
        assert h.mode == "execute"
    s = p.summary()["phases"]["prefill"]
    assert s["compile"]["count"] == 2
    assert s["execute"]["count"] == 1


def test_exception_does_not_consume_first_call():
    p = _profiler()
    with pytest.raises(RuntimeError):
        with p.phase("step", key="k"):
            raise RuntimeError("trace failed")
    # the failed block recorded nothing and the NEXT call still compiles
    assert p.summary()["phases"] == {}
    with p.phase("step", key="k") as h:
        assert h.mode == "compile"


def test_sync_blocks_on_device_value():
    """A host-timed phase waits for the synced value (a CPU tensor is
    ready at once; on the card ``_block_until_ready`` waits on an event
    of the tensor's stream, tests/test_torch_kernel_cuda.py)."""
    p = _profiler()
    with p.phase("mul", key="mul") as h:
        out = h.sync(torch.ones(8) * 2)
    assert float(out[0]) == 2.0
    assert p.summary()["phases"]["mul"]["compile"]["count"] == 1


def test_sync_tolerates_host_values():
    p = _profiler()
    with p.phase("host") as h:
        assert h.sync(42) == 42    # non-device values must not crash exit


def test_observe_spreads_calls():
    p = _profiler()
    p.observe("step", 1.0, mode="execute", calls=10)
    d = p.summary()["phases"]["step"]["execute"]
    assert d["count"] == 10
    assert d["total_seconds"] == pytest.approx(1.0)
    assert d["mean_seconds"] == pytest.approx(0.1)


def test_compile_overhead_in_summary():
    p = _profiler()
    p.observe("step", 2.0, mode="compile")
    p.observe("step", 1.0, mode="execute", calls=10)   # 0.1 s/step steady
    s = p.summary()["phases"]["step"]
    assert s["compile_overhead_seconds"] == pytest.approx(2.0 - 0.1)


def test_mark_first_checks_and_marks():
    p = _profiler()
    assert p.mark_first("decode", ("step", 0.0)) is True
    assert p.mark_first("decode", ("step", 0.0)) is False
    assert p.mark_first("decode", ("step", 1.0)) is True


def test_record_ring_is_bounded():
    p = _profiler(max_records=4)
    for i in range(10):
        p.observe("step", 0.001, mode="execute", i=i)
    recs = p.records(100)
    assert len(recs) == 4
    assert recs[-1]["meta"]["i"] == 9
    # aggregates stay exact past the ring
    assert p.summary()["phases"]["step"]["execute"]["count"] == 10


def test_wrap_decorator_times_calls():
    p = _profiler()

    @p.wrap("work", key="w")
    def work(x):
        return x + 1

    assert work(1) == 2
    assert work(2) == 3
    s = p.summary()["phases"]["work"]
    assert s["compile"]["count"] == 1
    assert s["execute"]["count"] == 1


def test_tracer_span_carries_mode_meta():
    from tpu_kubernetes_torch.obs import events
    from tpu_kubernetes_torch.util.trace import Tracer, span_tree

    p = _profiler()
    tr = Tracer(stream=io.StringIO())
    with events.run_context("run-1"):
        with p.phase("prefill", key="pf", tracer=tr, width=16):
            pass
    tree = span_tree(tr.spans, "run-1")
    assert len(tree) == 1
    meta = tree[0]["meta"]
    assert meta["mode"] == "compile"
    assert meta["width"] == 16
    assert meta["device_seconds"] >= 0


def test_histogram_lands_in_registry():
    reg = Registry()
    p = PhaseProfiler(registry=reg, metric="tpu_test_phase_seconds",
                      sample_hbm=False)
    with p.phase("prefill", key="a"):
        pass
    text = reg.render()
    assert 'tpu_test_phase_seconds_count{mode="compile",phase="prefill"}' \
        in text or 'phase="prefill"' in text


def test_reset_clears_everything():
    p = _profiler()
    with p.phase("step", key="k"):
        pass
    p.reset()
    assert p.summary()["phases"] == {}
    with p.phase("step", key="k") as h:
        assert h.mode == "compile"


def test_device_memory_stats_graceful():
    # CPU backends either report stats or None — never raise
    stats = device_memory_stats()
    assert stats is None or (
        isinstance(stats, dict)
        and all(isinstance(v, int) for v in stats.values())
    )


def test_render_profile_table():
    p = _profiler()
    p.observe("prefill", 0.5, mode="compile")
    p.observe("prefill", 0.01, mode="execute", calls=5)
    p.observe("decode", 0.02, mode="execute", calls=7)
    text = render_profile(p.summary())
    assert "prefill" in text and "decode" in text
    assert "compile" in text and "execute" in text
    assert "compile overhead" in text


def test_render_profile_empty():
    assert "no phases recorded" in render_profile({"phases": {}})


def test_fetch_profile_normalizes_target():
    # bad port → URLError, but only after the URL was built — proves the
    # host:port form normalizes without a scheme or path
    with pytest.raises(Exception):
        fetch_profile("127.0.0.1:1", timeout=0.2)



# -- the port's own -----------------------------------------------------------


def test_program_cost_equals_a_hand_count_at_llama_test():
    """llama-test: d 64, 2 layers, 4 heads of 16, 2 KV heads, d_ff 128,
    vocab 256. A token multiplies through 2 · (64·64 + 2·64·32 + 64·64 +
    3·64·128) + 64·256 = 2 · 36,864 + 16,384 = 90,112 parameters, so 8
    tokens cost 2 · 90,112 · 8 FLOPs of matmuls; 100 attended positions
    add 4 · 2 · 4 · 16 · 100 FLOPs. The weights are 90,112 · 4 bytes in
    f32, and 10 cached positions of K and V over both layers 2 · 2 · 2 ·
    16 · 4 · 10 bytes."""
    cfg = replace(CONFIGS["llama-test"], dtype=torch.float32)
    assert matmul_params(cfg) == 90_112
    cost = program_cost(cfg, tokens=8, attended=100, kv_positions=10)
    assert cost["flops"] == 2 * 90_112 * 8 + 4 * 2 * 4 * 16 * 100
    assert cost["bytes"] == 90_112 * 4 + 2 * 2 * 2 * 16 * 4 * 10
    bf16 = program_cost(replace(cfg, dtype=torch.bfloat16), tokens=8,
                        attended=100, kv_positions=10)
    assert bf16["flops"] == cost["flops"]
    assert bf16["bytes"] == cost["bytes"] / 2


def test_moe_cost_counts_the_routed_experts_and_reads_every_one():
    from tpu_kubernetes_torch.models.moe import MOE_CONFIGS

    cfg = MOE_CONFIGS["moe-test"]
    d, ff, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    dense = replace(CONFIGS["llama-test"], dtype=cfg.dtype)
    extra = L * ((cfg.experts_per_token - 1) * 3 * d * ff
                 + d * cfg.n_experts)
    assert matmul_params(cfg) == matmul_params(dense) + extra
    one = program_cost(cfg, tokens=1, attended=0, kv_positions=0)
    ref = program_cost(dense, tokens=1, attended=0, kv_positions=0)
    itemsize = cfg.dtype.itemsize
    assert one["bytes"] - ref["bytes"] == (
        L * 3 * d * ff * (cfg.n_experts - 1) * itemsize)


def test_device_kind_and_memory_on_the_cpu():
    assert device_kind("cpu") == "cpu"
    assert device_memory_stats("cpu") is None
    assert device_memory_stats(None) is None
    assert backend_peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert backend_peak_flops("cpu") is None


def test_first_argument_overrides_first_sighting():
    """A program knows its own first call (``Program.captures``): two
    lanes' programs under one key both compile once each."""
    p = _profiler()
    with p.phase("decode", key="k", first=True) as h:
        assert h.mode == "compile"
    with p.phase("decode", key="k", first=False) as h:
        assert h.mode == "execute"
    with p.phase("decode", key="k", first=True) as h:
        assert h.mode == "compile"
    assert p.summary()["phases"]["decode"]["compile"]["count"] == 2


def test_roofline_takes_the_mean_cost_of_a_call():
    p = _profiler()
    p.record_cost("decode", {"flops": 100.0, "bytes": 10.0}, tokens=2)
    p.record_cost("decode", lambda: {"flops": 300.0, "bytes": 30.0},
                  tokens=6)
    prog = p.roofline()["programs"]["decode"]
    assert prog["flops"] == 200.0 and prog["bytes"] == 20.0
    assert prog["tokens_per_call"] == 4.0
    assert prog["flops_per_token"] == 50.0
    assert prog["arithmetic_intensity"] == 10.0
    assert prog["utilization"] is None            # no peak on the CPU
    p.reset()
    assert p.roofline()["programs"] == {}


def test_cpu_phase_with_a_cuda_profiler_device_is_never_event_timed():
    """A phase opened on the CPU device is timed by the host clock even
    when the profiler's own device is the card."""
    p = _profiler(device="cuda")
    with p.phase("prefill", device="cpu") as h:
        h.sync(torch.zeros(2))
    assert p.summary()["phases"]["prefill"]["compile"]["count"] == 1
