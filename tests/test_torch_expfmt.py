"""The reference's ``tests/test_expfmt.py`` against the port's copy of the
exposition parser and renderer (``tpu_kubernetes_torch/obs/expfmt.py``), then parity
cases that put the same inputs through both packages.

The reference's docstring:

Exposition round-trip contract: obs/expfmt.py must parse everything
obs/metrics.py emits and re-render it byte-identically — the fleet
aggregator re-exposes scraped numbers, so any drift would corrupt the
merged view."""

import math

import pytest

from tpu_kubernetes_torch.obs import expfmt
from tpu_kubernetes_torch.obs.metrics import Registry


def _busy_registry() -> Registry:
    """One of everything the emitter can produce: labeled/unlabeled
    counters, a gauge, histograms (+Inf bucket, float sums), label
    values needing every escape, and a registered-but-never-sampled
    labeled family."""
    reg = Registry()
    c = reg.counter("jobs_total", "jobs processed",
                    labelnames=("kind", "status"))
    c.labels("train", "ok").inc(3)
    c.labels("serve", "error").inc()
    reg.gauge("queue_depth", "requests waiting").set(7)
    h = reg.histogram("latency_seconds", "request latency",
                      buckets=(0.1, 0.5, 1.0))
    for v in (0.05, 0.3, 0.7, 2.0):
        h.observe(v)
    esc = reg.counter("weird_total", "escape gauntlet",
                      labelnames=("path",))
    esc.labels('a\\b"c\nd').inc()
    reg.counter("unsampled_total", "registered but never incremented",
                labelnames=("kind",))
    reg.counter("bare_total", "").inc(2)  # empty help line
    return reg


def test_round_trip_byte_identical():
    text = _busy_registry().render()
    assert expfmt.render(expfmt.parse(text)) == text


def test_empty_registry_round_trips():
    text = Registry().render()
    assert text == ""
    assert expfmt.parse(text) == []
    assert expfmt.render([]) == ""


def test_double_round_trip_is_stable():
    # parse(render(parse(x))) must not drift either
    text = _busy_registry().render()
    once = expfmt.render(expfmt.parse(text))
    assert expfmt.render(expfmt.parse(once)) == once


def test_parse_structure():
    fams = {f.name: f for f in expfmt.parse(_busy_registry().render())}
    jobs = fams["jobs_total"]
    assert jobs.kind == "counter" and jobs.help == "jobs processed"
    by_labels = {s.labels: s.value for s in jobs.samples}
    assert by_labels[(("kind", "serve"), ("status", "error"))] == 1
    assert by_labels[(("kind", "train"), ("status", "ok"))] == 3

    lat = fams["latency_seconds"]
    assert lat.kind == "histogram"
    # _bucket/_sum/_count rows all land under the declaring family
    names = {s.name for s in lat.samples}
    assert names == {"latency_seconds_bucket", "latency_seconds_sum",
                     "latency_seconds_count"}
    inf_bucket = next(
        s for s in lat.samples
        if s.name == "latency_seconds_bucket"
        and s.labels_dict()["le"] == "+Inf"
    )
    assert inf_bucket.value == 4
    count = next(s for s in lat.samples
                 if s.name == "latency_seconds_count")
    assert count.value == 4

    # registered-but-unsampled labeled family: headers survive, no rows
    assert fams["unsampled_total"].samples == []
    assert fams["bare_total"].help == ""


def test_label_escaping_survives_round_trip():
    fams = expfmt.parse(_busy_registry().render())
    weird = next(f for f in fams if f.name == "weird_total")
    assert weird.samples[0].labels_dict()["path"] == 'a\\b"c\nd'


def test_with_label_appends_preserving_order():
    s = expfmt.Sample("x_total", (("a", "1"),), 2.0)
    tagged = s.with_label("instance", "h:8000")
    assert tagged.labels == (("a", "1"), ("instance", "h:8000"))
    assert s.labels == (("a", "1"),)  # original untouched
    assert expfmt.render_sample(tagged) == (
        'x_total{a="1",instance="h:8000"} 2'
    )


def test_value_formatting_matches_emitter():
    assert expfmt.format_value(3.0) == "3"
    assert expfmt.format_value(0.25) == "0.25"
    assert expfmt.format_value(math.inf) == "+Inf"
    assert expfmt.format_value(-math.inf) == "-Inf"
    assert expfmt.parse_value("+Inf") == math.inf
    assert expfmt.parse_value("-Inf") == -math.inf
    assert expfmt.parse_value("1e3") == 1000.0


def test_tolerates_foreign_exposition():
    # untyped samples, stray comments, and trailing timestamps are all
    # legal exposition from other exporters — parsed, not fatal
    fams = expfmt.parse(
        "# a free-form comment\n"
        "no_headers_metric 4\n"
        'stamped{x="y"} 1.5 1712345678\n'
    )
    by_name = {f.name: f for f in fams}
    assert by_name["no_headers_metric"].kind == "untyped"
    assert by_name["no_headers_metric"].samples[0].value == 4
    assert by_name["stamped"].samples[0].value == 1.5


@pytest.mark.parametrize("line", [
    "garbage that is not exposition",
    "name_only",
    'x{y="unterminated} 1',
    'x{no_equals} 1',
])
def test_malformed_lines_raise(line):
    with pytest.raises(expfmt.ParseError):
        expfmt.parse(line + "\n")


def test_bucket_quantile_interpolation():
    buckets = [(0.1, 10.0), (0.5, 20.0), (math.inf, 20.0)]
    assert expfmt.bucket_quantile(buckets, 0.5) == pytest.approx(0.1)
    assert expfmt.bucket_quantile(buckets, 0.75) == pytest.approx(0.3)
    # rank in the +Inf bucket answers with the highest finite bound
    assert expfmt.bucket_quantile([(1.0, 0.0), (math.inf, 5.0)], 0.5) == 1.0
    # empty / all-zero histograms have no quantiles
    assert expfmt.bucket_quantile([], 0.9) is None
    assert expfmt.bucket_quantile([(1.0, 0.0), (math.inf, 0.0)], 0.9) is None


def test_bucket_quantile_all_mass_in_inf_bucket():
    """Regression: every observation above the largest finite bound used
    to interpolate against +Inf and answer inf/NaN. The quantile clamps
    to the largest finite bound instead — finite, plottable, honest
    about the histogram's resolution."""
    buckets = [(0.1, 0.0), (0.5, 0.0), (math.inf, 7.0)]
    for q in (0.01, 0.5, 0.99):
        got = expfmt.bucket_quantile(buckets, q)
        assert got == 0.5
        assert math.isfinite(got)


def test_bucket_quantile_only_inf_bucket_is_none():
    # a histogram with no finite bounds at all has nothing to clamp to
    assert expfmt.bucket_quantile([(math.inf, 9.0)], 0.5) is None
    assert expfmt.bucket_quantile([(math.inf, 0.0)], 0.5) is None


# ---------------------------------------------------------------------------
# OpenMetrics exemplars + # EOF (the distributed-tracing additions)
# ---------------------------------------------------------------------------

TID = "4bf92f3577b34da6a3ce929d0e0e4736"


def _exemplar_registry() -> Registry:
    reg = Registry()
    h = reg.histogram("latency_seconds", "request latency",
                      buckets=(0.1, 0.5, 1.0))
    h.observe(0.05)
    h.observe(0.3, exemplar=TID)         # exemplar lands on the 0.5 bucket
    h.observe(2.0, exemplar="a" * 32)    # ... and one on +Inf
    return reg


def test_eof_marker_tolerated():
    # OpenMetrics exposition ends with `# EOF`; parse must not choke
    fams = expfmt.parse("x_total 1\n# EOF\n")
    assert fams[0].samples[0].value == 1


def test_exemplar_parses_into_sample():
    text = _exemplar_registry().render()
    assert '# {trace_id="' + TID + '"} 0.3' in text
    fams = {f.name: f for f in expfmt.parse(text)}
    with_ex = [s for s in fams["latency_seconds"].samples
               if s.exemplar is not None]
    assert len(with_ex) == 2
    ex = next(s.exemplar for s in with_ex
              if s.labels_dict()["le"] == "0.5")
    assert ex.labels == (("trace_id", TID),)
    assert ex.value == 0.3


def test_exemplars_survive_round_trip():
    text = _exemplar_registry().render()
    assert expfmt.render(expfmt.parse(text)) == text
    # and exemplars ride with_label (the aggregator's instance tagging)
    sample = next(s for s in expfmt.parse(text)[0].samples
                  if s.exemplar is not None)
    tagged = sample.with_label("instance", "h:8000")
    assert tagged.exemplar == sample.exemplar
    assert '# {trace_id="' in expfmt.render_sample(tagged)


def test_exemplar_free_input_round_trips_byte_identical():
    # the pre-exemplar contract is untouched: no `# {` marker anywhere
    text = _busy_registry().render()
    assert " # {" not in text
    assert expfmt.render(expfmt.parse(text)) == text


def test_exemplar_marker_inside_quoted_label_not_split():
    line = 'x_total{path="a # {b} c"} 1\n'
    fams = expfmt.parse(line)
    sample = fams[0].samples[0]
    assert sample.labels_dict()["path"] == "a # {b} c"
    assert sample.exemplar is None
    assert expfmt.render_sample(sample) + "\n" == line


@pytest.mark.parametrize("line", [
    'x_total 1 # {trace_id="abc"',        # unterminated exemplar labels
    'x_total 1 # {trace_id="abc"}',       # missing exemplar value
    'x_total 1 # {no_equals} 2',          # malformed exemplar label
])
def test_malformed_exemplars_raise(line):
    with pytest.raises(expfmt.ParseError):
        expfmt.parse(line + "\n")


# -- parity with the reference's module ---------------------------------------

FOREIGN = (
    "# a free-form comment\n"
    "no_headers_metric 4\n"
    'stamped{x="y"} 1.5 1712345678\n'
    "# TYPE odd gauge\n"
    "odd NaN\n"
    'odd{k="inf"} +Inf\n'
    'odd{k="neg"} -Inf\n'
    "# EOF\n"
)


def _expositions():
    return {
        "busy": _busy_registry().render(),
        "exemplars": _exemplar_registry().render(),
        "foreign": FOREIGN,
    }


@pytest.mark.parametrize("which", ["busy", "exemplars", "foreign"])
def test_parse_and_render_equal_the_reference(which):
    """One exposition through both parsers gives equal families (NaN
    compared by its repr), and both render them back to the same text."""
    import dataclasses

    from tpu_kubernetes.obs import expfmt as jexpfmt

    text = _expositions()[which]
    port, ref = expfmt.parse(text), jexpfmt.parse(text)
    assert repr([dataclasses.asdict(f) for f in port]) == \
        repr([dataclasses.asdict(f) for f in ref])
    assert expfmt.render(port) == jexpfmt.render(ref)


@pytest.mark.parametrize("q", [0.0, 0.25, 0.5, 0.9, 0.99, 1.0])
def test_bucket_quantile_equals_the_reference(q):
    from tpu_kubernetes.obs import expfmt as jexpfmt

    buckets = [(0.1, 4.0), (0.5, 9.0), (1.0, 9.0), (math.inf, 12.0)]
    assert expfmt.bucket_quantile(buckets, q) == \
        jexpfmt.bucket_quantile(buckets, q)
