"""The reference's ``tests/test_tsdb.py`` against the port's copy of the
history store (``tpu_kubernetes_torch/obs/tsdb.py``), then parity
cases that put the same inputs through both packages.

The reference's docstring:

The bounded in-memory time-series store (obs/tsdb.py): ring wrap,
downsample-tier boundaries, the hard memory cap's cold-series eviction,
reset-aware counter math, windowed quantiles, and the sparkline feed.

Everything uses injected timestamps — no sleeps, no wall clock."""

import threading

import pytest

from tpu_kubernetes_torch.obs.tsdb import (
    SPARK_BARS,
    TSDB,
    _reset_aware_increase,
    sparkline,
)


# -- raw ring + downsample tiers ---------------------------------------------


def test_raw_ring_wrap_answers_old_history_from_tiers():
    """A tiny raw ring drops old samples, but queries older than the
    ring still answer: the downsample buckets kept first/last per
    window, so increase() over the whole span survives the wrap."""
    db = TSDB(raw_max=4, tiers=((10.0, 100),))
    for i in range(100):                       # 1/s counter, 100s of data
        db.append("c", float(i), ts=1000.0 + i, kind="counter")

    # the raw ring only holds the newest 4 samples …
    (_labels, samples), = db.window("c", 0.0, 2000.0)
    assert samples[0][0] < 1096.0              # … but merged history reaches
    assert samples[-1] == (1099.0, 99.0)       # further back via the tiers

    inc = db.increase("c", 95.0, 1099.0)
    assert inc == pytest.approx(95.0, abs=10.0)
    assert db.rate_over_time("c", 95.0, 1099.0) == pytest.approx(1.0, abs=0.1)


def test_tier_boundary_bucket_rollover():
    """Samples straddling a bucket boundary land in distinct buckets;
    within one bucket the fold keeps first/last/min/max."""
    db = TSDB(raw_max=2, tiers=((10.0, 4),))
    db.append("g", 5.0, ts=100.0)              # bucket [100, 110)
    db.append("g", 9.0, ts=109.9)              # same bucket
    db.append("g", 2.0, ts=110.0)              # boundary: next bucket
    s = db._series[("g", ())]
    _w, _cap, ring = s.tiers[0]
    assert [b.start for b in ring] == [100.0, 110.0]
    assert ring[0].first == 5.0 and ring[0].last == 9.0
    assert ring[0].vmin == 5.0 and ring[0].vmax == 9.0 and ring[0].count == 2

    # tier cap: old buckets fall off once the ring is full
    for i in range(6):
        db.append("g", float(i), ts=120.0 + 10.0 * i)
    _w, _cap, ring = s.tiers[0]
    assert len(ring) == 4
    assert ring[0].start == 140.0              # 100/110/120/130 evicted


def test_max_over_time_sees_spike_that_left_the_raw_ring():
    db = TSDB(raw_max=2, tiers=((10.0, 100),))
    db.append("g", 1.0, ts=100.0)
    db.append("g", 99.0, ts=101.0)             # the spike
    db.append("g", 1.0, ts=102.0)
    db.append("g", 1.0, ts=103.0)              # raw ring now [102, 103]
    assert all(v < 99.0 for _, v in db._series[("g", ())].raw)
    assert db.max_over_time("g", 10.0, 105.0) == 99.0


def test_stale_timestamp_keeps_closed_buckets_immutable():
    db = TSDB(raw_max=8, tiers=((10.0, 4),))
    db.append("g", 1.0, ts=100.0)
    db.append("g", 2.0, ts=115.0)
    db.append("g", 50.0, ts=101.0)             # stale: bucket 100 is closed
    s = db._series[("g", ())]
    _w, _cap, ring = s.tiers[0]
    assert ring[0].last == 1.0 and ring[0].vmax == 1.0
    assert (101.0, 50.0) in list(s.raw)        # raw still records it


# -- the memory cap ----------------------------------------------------------


def test_memory_cap_evicts_coldest_series_first():
    db = TSDB(max_bytes=2048, raw_max=16, tiers=((10.0, 8),))
    db.append("cold", 1.0, labels={"i": "old"}, ts=100.0)
    for i in range(200):                       # hot series appends forever
        db.append("hot", float(i), labels={"i": "new"}, ts=200.0 + i)
    stats = db.stats()
    assert stats["evicted_series"] >= 1
    # the cap holds unless a single hot series alone exceeds it (the
    # appended-to series is never evicted)
    assert (stats["bytes_estimated"] <= stats["max_bytes"]
            or stats["series"] == 1)
    assert not db.has_samples("cold")          # coldest went first
    assert db.has_samples("hot")               # the appender survives


def test_memory_cap_holds_across_many_series():
    db = TSDB(max_bytes=8192, raw_max=8, tiers=((10.0, 4),))
    for i in range(100):                       # label explosion: 100 series
        db.append("g", 1.0, labels={"i": str(i)}, ts=100.0 + i)
    stats = db.stats()
    assert stats["bytes_estimated"] <= stats["max_bytes"]
    assert stats["series"] < 100 and stats["evicted_series"] > 0
    # the newest (hottest) labels survived
    assert db.has_samples("g", lambda lbl: lbl["i"] == "99")


def test_eviction_never_removes_the_series_being_appended():
    db = TSDB(max_bytes=1, raw_max=16, tiers=())   # cap below one series
    for i in range(10):
        db.append("only", float(i), ts=100.0 + i)
    assert db.has_samples("only")              # sole series is never evicted
    assert db.latest("only") == 9.0


# -- counter-reset semantics -------------------------------------------------


def test_reset_aware_increase_counts_post_restart_value():
    samples = [(0.0, 100.0), (10.0, 110.0), (20.0, 4.0), (30.0, 10.0)]
    # 10 before the reset, 4 after it (the new value), then 6 more
    assert _reset_aware_increase(samples) == pytest.approx(20.0)


def test_rate_over_time_survives_counter_reset():
    db = TSDB()
    db.append("c", 100.0, ts=1000.0, kind="counter")
    db.append("c", 150.0, ts=1010.0, kind="counter")
    db.append("c", 5.0, ts=1020.0, kind="counter")    # worker restarted
    assert db.increase("c", 20.0, 1020.0) == pytest.approx(55.0)
    rate = db.rate_over_time("c", 20.0, 1020.0)
    assert rate == pytest.approx(55.0 / 20.0)
    assert rate > 0                            # never negative on reset


def test_rate_uses_actual_data_span_not_nominal_window():
    """Two samples 1s apart inside a 60s window: the rate divides by 1s
    of covered span (what --once relies on), not by 60."""
    db = TSDB()
    db.append("c", 10.0, ts=100.0, kind="counter")
    db.append("c", 15.0, ts=101.0, kind="counter")
    assert db.rate_over_time("c", 60.0, 101.0) == pytest.approx(5.0)


def test_rate_sums_across_matching_series():
    db = TSDB()
    for inst, v0, v1 in (("a", 0.0, 10.0), ("b", 0.0, 30.0)):
        db.append("c", v0, labels={"instance": inst}, ts=100.0, kind="counter")
        db.append("c", v1, labels={"instance": inst}, ts=110.0, kind="counter")
    assert db.rate_over_time("c", 10.0, 110.0) == pytest.approx(4.0)
    only_a = db.rate_over_time(
        "c", 10.0, 110.0, lambda lbl: lbl.get("instance") == "a"
    )
    assert only_a == pytest.approx(1.0)


# -- point lookups (what the SLO burn windows use) ---------------------------


def test_sample_at_or_before_falls_back_to_tiers():
    db = TSDB(raw_max=2, tiers=((10.0, 100),))
    for i in range(50):
        db.append("c", float(i), ts=1000.0 + i)
    # 1010 left the raw ring long ago; a tier bucket still answers
    got = db.sample_at_or_before("c", (), 1010.0)
    assert got is not None
    ts, v = got
    assert ts <= 1010.0 and v <= 10.0
    assert db.sample_at_or_before("c", (), 999.0) is None   # before any data
    assert db.first_sample("c", ()) == (1000.0, 0.0)
    assert db.sample_at_or_before("nope", (), 1e12) is None


def test_latest_sums_series_and_window_filters():
    db = TSDB()
    db.append("g", 3.0, labels={"i": "a"}, ts=100.0)
    db.append("g", 4.0, labels={"i": "b"}, ts=100.0)
    assert db.latest("g") == 7.0
    assert db.latest("g", lambda lbl: lbl["i"] == "b") == 4.0
    assert db.latest("missing") is None
    assert db.avg_over_time("g", 10.0, 105.0) == pytest.approx(3.5)


# -- windowed histogram quantiles --------------------------------------------


def test_quantile_over_time_from_bucket_increases():
    db = TSDB()
    # cumulative le-buckets at two instants: 8 new observations land in
    # le=0.1, 2 in (0.1, 0.5] → p50 inside the first bucket
    for le, v0, v1 in (("0.1", 0.0, 8.0), ("0.5", 0.0, 10.0),
                       ("+Inf", 0.0, 10.0)):
        db.append("lat_bucket", v0, labels={"le": le}, ts=100.0,
                  kind="counter")
        db.append("lat_bucket", v1, labels={"le": le}, ts=160.0,
                  kind="counter")
    q50 = db.quantile_over_time("lat", 0.5, 60.0, 160.0)
    assert q50 is not None and 0.0 < q50 <= 0.1
    q99 = db.quantile_over_time("lat", 0.99, 60.0, 160.0)
    assert 0.1 < q99 <= 0.5
    assert db.quantile_over_time("lat", 0.5, 1.0, 99.0) is None  # no data


# -- sparkline feed ----------------------------------------------------------


def test_binned_rate_and_value_modes():
    db = TSDB()
    for i in range(9):                         # 1/s for 8s
        db.append("c", float(i), ts=100.0 + i, kind="counter")
        db.append("g", float(i % 3), ts=100.0 + i)
    bins = db.binned("c", 8.0, 108.0, bins=4, mode="rate")
    assert len(bins) == 4
    assert all(b is not None and b > 0 for b in bins)
    gbins = db.binned("g", 8.0, 108.0, bins=4, mode="value")
    assert all(b is not None for b in gbins)
    # a window with no samples at all: every bin is None
    assert db.binned("c", 8.0, 50.0, bins=4, mode="rate") == [None] * 4


def test_sparkline_renders_gaps_and_scale():
    text = sparkline([0.0, 1.0, 2.0, None, 4.0])
    assert len(text) == 5
    assert text[3] == "·"                      # the gap stays visible
    assert text[4] == SPARK_BARS[-1]           # max maps to the top bar
    assert text[0] == SPARK_BARS[0]
    assert sparkline([]) == ""
    assert sparkline([None, None]) == "··"
    assert sparkline([0.0, 0.0]) == SPARK_BARS[0] * 2   # flat zero line


def test_tail_returns_recent_raw_samples():
    db = TSDB()
    for i in range(50):
        db.append("c", float(i), labels={"i": "a"}, ts=100.0 + i,
                  kind="counter")
    entry, = db.tail("c", n=5)
    assert entry["name"] == "c" and entry["kind"] == "counter"
    assert entry["labels"] == {"i": "a"}
    assert len(entry["samples"]) == 5
    assert entry["samples"][-1] == [149.0, 49.0]


# -- concurrency -------------------------------------------------------------


def test_concurrent_append_and_query_is_safe():
    db = TSDB(max_bytes=64 << 10, raw_max=64, tiers=((10.0, 16),))
    stop = threading.Event()
    errors: list[BaseException] = []

    def writer(tag: str):
        i = 0
        try:
            while not stop.is_set():
                db.append("c", float(i), labels={"w": tag},
                          ts=1000.0 + i * 0.01, kind="counter")
                i += 1
        except BaseException as exc:  # noqa: BLE001 — surfacing to assert
            errors.append(exc)

    def reader():
        try:
            while not stop.is_set():
                db.rate_over_time("c", 5.0, 1010.0)
                db.binned("c", 5.0, 1010.0, bins=4, mode="rate")
                db.stats()
        except BaseException as exc:  # noqa: BLE001
            errors.append(exc)

    threads = [threading.Thread(target=writer, args=(t,)) for t in "ab"]
    threads.append(threading.Thread(target=reader))
    for t in threads:
        t.start()
    stop.wait(0.3)
    stop.set()
    for t in threads:
        t.join(timeout=5.0)
    assert not errors
    assert db.has_samples("c")


# -- parity with the reference's module ---------------------------------------


def _feed(db) -> None:
    """One series set: a counter that resets mid-way, a gauge with a
    spike, and cumulative histogram buckets, over 400 s of samples at an
    uneven cadence (past the raw ring of 64, into the 10 s tier)."""
    t, c = 1000.0, 0.0
    for i in range(200):
        t += 1.0 + (i % 3)
        c = 5.0 if i == 120 else c + 1.0 + (i % 5)
        db.append("req_total", c, labels={"code": "200"}, ts=t,
                  kind="counter")
        db.append("depth", 50.0 if i == 90 else float(i % 7), ts=t)
        for le, share in (("0.1", 0.5), ("0.5", 0.8), ("+Inf", 1.0)):
            db.append("lat_bucket", c * share, labels={"le": le}, ts=t,
                      kind="counter")


def test_one_series_set_gives_the_reference_answers():
    """The same samples fed to both stores answer every query alike."""
    from tpu_kubernetes.obs.tsdb import TSDB as JTSDB

    port, ref = TSDB(raw_max=64), JTSDB(raw_max=64)
    _feed(port)
    _feed(ref)
    now = 1000.0 + sum(1.0 + (i % 3) for i in range(200))
    queries = [
        ("names", ()), ("stats", ()),
        ("latest", ("req_total",)), ("latest", ("depth",)),
        ("increase", ("req_total", 120.0, now)),
        ("rate_over_time", ("req_total", 300.0, now)),
        ("rate_over_time", ("req_total", 30.0, now - 200.0)),
        ("avg_over_time", ("depth", 200.0, now)),
        ("max_over_time", ("depth", 400.0, now)),
        ("quantile_over_time", ("lat", 0.5, 120.0, now)),
        ("quantile_over_time", ("lat", 0.99, 300.0, now)),
        ("binned", ("req_total", 240.0, now)),
        ("binned", ("depth", 240.0, now, 6, "value")),
        ("tail", ("depth", 8)),
        ("window", ("depth", now - 50.0, now)),
        ("sample_at_or_before", ("depth", (), now - 350.0)),
    ]
    for name, args in queries:
        assert repr(getattr(port, name)(*args)) == \
            repr(getattr(ref, name)(*args)), name


def test_sparkline_equals_the_reference():
    from tpu_kubernetes.obs.tsdb import sparkline as jsparkline

    for values in ([0.0, 1.0, 2.0, None, 4.0], [], [None], [3.0, 3.0],
                   [0.5 * i for i in range(17)]):
        assert sparkline(values) == jsparkline(values)
