"""Prometheus text-exposition parser (and its inverse renderer).

The port's copy of ``tpu_kubernetes/obs/expfmt.py`` (the port imports nothing of
the JAX package): the same names, families and behaviour.

obs/metrics.py renders the process registry as text exposition version
0.0.4; this module is the other direction — what a scraper needs to turn
a worker's ``GET /metrics`` body back into structured samples so the
fleet aggregator (obs/aggregate.py) can merge many workers into one
view. Same stance as the rest of obs/: stdlib only, the scrape path must
stay air-gap friendly.

The grammar handled is exactly what our emitter produces (``# HELP`` /
``# TYPE`` headers followed by ``name{label="value"} number`` samples,
histograms as ``_bucket``/``_sum``/``_count`` rows), tolerating other
comment lines and untyped samples from foreign exporters. The contract
tests lean on: ``render(parse(text)) == text`` byte-for-byte for any
registry exposition — label escaping, ``+Inf`` bounds, and the empty
registry included — so scraped numbers re-expose losslessly.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace


class ParseError(ValueError):
    """A line the exposition grammar cannot account for."""


@dataclass
class Exemplar:
    """An OpenMetrics exemplar riding a sample line (``# {…} value``):
    the trace-id labels and the observed value that landed in that
    bucket — how a p99 bucket points at a real slow trace."""

    labels: tuple[tuple[str, str], ...]
    value: float


@dataclass
class Sample:
    """One exposed time series value. ``name`` is the full sample name
    (``foo_bucket``, ``foo_sum``, … for histogram rows); ``labels`` keeps
    the rendered pair order so re-emission is byte-identical. An
    exemplar, when present, survives parse → merge → render untouched
    (``with_label`` copies carry it via ``replace``)."""

    name: str
    labels: tuple[tuple[str, str], ...]
    value: float
    exemplar: Exemplar | None = None

    def labels_dict(self) -> dict[str, str]:
        return dict(self.labels)

    def with_label(self, key: str, value: str) -> "Sample":
        """A copy with one more label appended (how the aggregator tags
        scraped samples with their ``instance``)."""
        return replace(self, labels=(*self.labels, (key, str(value))))


@dataclass
class Family:
    """One metric family as exposed: header lines plus its samples in
    file order."""

    name: str
    help: str = ""
    kind: str = "untyped"
    samples: list[Sample] = field(default_factory=list)


def _unescape_label(raw: str) -> str:
    out: list[str] = []
    i = 0
    while i < len(raw):
        c = raw[i]
        if c == "\\" and i + 1 < len(raw):
            nxt = raw[i + 1]
            if nxt == "\\":
                out.append("\\")
            elif nxt == '"':
                out.append('"')
            elif nxt == "n":
                out.append("\n")
            else:  # unknown escape: keep verbatim (foreign exporter)
                out.append(c + nxt)
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _escape_label(value: str) -> str:
    return (
        value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


def parse_value(raw: str) -> float:
    if raw == "+Inf":
        return math.inf
    if raw == "-Inf":
        return -math.inf
    try:
        return float(raw)
    except ValueError as e:
        raise ParseError(f"unparseable sample value {raw!r}") from e


def format_value(v: float) -> str:
    """The emitter's number formatting (obs/metrics.py) — integers bare,
    floats via repr (which round-trips exactly), infinities spelled the
    Prometheus way — so a parsed value re-renders to the same bytes."""
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


def _parse_labels(raw: str, line: str) -> tuple[tuple[str, str], ...]:
    """``key="value",…`` (the part between braces) → ordered pairs."""
    pairs: list[tuple[str, str]] = []
    i = 0
    while i < len(raw):
        eq = raw.find("=", i)
        if eq < 0 or eq + 1 >= len(raw) or raw[eq + 1] != '"':
            raise ParseError(f"malformed labels in line {line!r}")
        key = raw[i:eq].strip()
        # scan the quoted value, honoring backslash escapes
        j = eq + 2
        buf: list[str] = []
        while j < len(raw):
            c = raw[j]
            if c == "\\" and j + 1 < len(raw):
                buf.append(raw[j:j + 2])
                j += 2
                continue
            if c == '"':
                break
            buf.append(c)
            j += 1
        else:
            raise ParseError(f"unterminated label value in line {line!r}")
        pairs.append((key, _unescape_label("".join(buf))))
        i = j + 1
        if i < len(raw) and raw[i] == ",":
            i += 1
    return tuple(pairs)


def _split_exemplar(line: str) -> tuple[str, str]:
    """Split an OpenMetrics exemplar suffix (`` # {…} value``) off a
    sample line, honoring quotes — a label *value* containing the
    marker must not trigger the split. Returns (body, raw_exemplar);
    raw_exemplar is "" when the line carries none."""
    in_quotes = False
    i = 0
    while i < len(line):
        c = line[i]
        if in_quotes:
            if c == "\\":
                i += 2
                continue
            if c == '"':
                in_quotes = False
        elif c == '"':
            in_quotes = True
        elif c == "#" and line.startswith(" # {", i - 1):
            return line[:i - 1], line[i + 2:]
        i += 1
    return line, ""


def _parse_exemplar(raw: str, line: str) -> Exemplar:
    """``{labels} value [timestamp]`` → :class:`Exemplar`."""
    if not raw.startswith("{"):
        raise ParseError(f"malformed exemplar in line {line!r}")
    # quote-aware scan for the closing brace
    in_quotes = False
    j = 1
    while j < len(raw):
        c = raw[j]
        if in_quotes:
            if c == "\\":
                j += 2
                continue
            if c == '"':
                in_quotes = False
        elif c == '"':
            in_quotes = True
        elif c == "}":
            break
        j += 1
    else:
        raise ParseError(f"unterminated exemplar in line {line!r}")
    labels = _parse_labels(raw[1:j], line)
    rest = raw[j + 1:].strip()
    if not rest:
        raise ParseError(f"exemplar missing value in line {line!r}")
    return Exemplar(labels=labels, value=parse_value(rest.split(" ")[0]))


def _base_name(sample_name: str, families: dict[str, Family]) -> str:
    """Histogram rows are exposed under ``<family>_bucket/_sum/_count``;
    map a sample name back to the family that declared it."""
    if sample_name in families:
        return sample_name
    for suffix in ("_bucket", "_sum", "_count"):
        if sample_name.endswith(suffix):
            base = sample_name[: -len(suffix)]
            if base in families:
                return base
    return sample_name


def parse(text: str) -> list[Family]:
    """Exposition text → families in file order. Raises
    :class:`ParseError` on lines that are neither comments nor samples."""
    families: dict[str, Family] = {}
    order: list[str] = []

    def family(name: str) -> Family:
        fam = families.get(name)
        if fam is None:
            fam = families[name] = Family(name=name)
            order.append(name)
        return fam

    for line in text.split("\n"):
        if not line.strip():
            continue
        if line.startswith("#"):
            parts = line.split(" ", 3)
            if len(parts) >= 3 and parts[1] == "HELP":
                family(parts[2]).help = parts[3] if len(parts) > 3 else ""
            elif len(parts) >= 3 and parts[1] == "TYPE":
                family(parts[2]).kind = (
                    parts[3].strip() if len(parts) > 3 else "untyped"
                )
            # other comments (OpenMetrics `# EOF` included) are legal
            # exposition — ignored
            continue
        # an OpenMetrics exemplar suffix must come off before the
        # rfind("}") below — its braces would corrupt the label scan
        body, raw_exemplar = _split_exemplar(line)
        exemplar = _parse_exemplar(raw_exemplar, line) if raw_exemplar \
            else None
        brace = body.find("{")
        if brace >= 0:
            close = body.rfind("}")
            if close < brace:
                raise ParseError(f"malformed sample line {line!r}")
            name = body[:brace]
            labels = _parse_labels(body[brace + 1:close], line)
            rest = body[close + 1:].strip()
        else:
            name, _, rest = body.partition(" ")
            labels = ()
            rest = rest.strip()
        if not name or not rest:
            raise ParseError(f"malformed sample line {line!r}")
        value = parse_value(rest.split(" ")[0])  # a timestamp may follow
        family(_base_name(name, families)).samples.append(
            Sample(name=name, labels=labels, value=value,
                   exemplar=exemplar)
        )
    return [families[n] for n in order]


def render_sample(sample: Sample) -> str:
    labels = ",".join(
        f'{k}="{_escape_label(v)}"' for k, v in sample.labels
    )
    body = "{" + labels + "}" if labels else ""
    line = f"{sample.name}{body} {format_value(sample.value)}"
    if sample.exemplar is not None:
        ex_labels = ",".join(
            f'{k}="{_escape_label(v)}"' for k, v in sample.exemplar.labels
        )
        line += " # {" + ex_labels + "} " + format_value(sample.exemplar.value)
    return line


def render(families: list[Family]) -> str:
    """Families → exposition text, the exact inverse of :func:`parse`
    over anything obs/metrics.py emits (the round-trip contract)."""
    lines: list[str] = []
    for fam in families:
        lines.append(f"# HELP {fam.name} {fam.help}")
        lines.append(f"# TYPE {fam.name} {fam.kind}")
        for sample in fam.samples:
            lines.append(render_sample(sample))
    return "\n".join(lines) + "\n" if lines else ""


def bucket_quantile(buckets: list[tuple[float, float]],
                    q: float) -> float | None:
    """Estimate quantile ``q`` from cumulative ``(le, count)`` pairs —
    Prometheus ``histogram_quantile`` semantics: linear interpolation
    inside the bucket holding the rank; the ``+Inf`` bucket answers with
    the highest finite bound (never inf/NaN). None when the histogram is
    empty or only a ``+Inf`` bucket exists — with no finite bound at all
    there is no honest estimate to return."""
    if not buckets:
        return None
    buckets = sorted(buckets)
    total = buckets[-1][1]
    if total <= 0:
        return None
    rank = q * total
    prev_le, prev_n = 0.0, 0.0
    seen_finite = False
    for le, n in buckets:
        if n >= rank:
            if math.isinf(le):
                return prev_le if seen_finite else None
            if n == prev_n:
                return le
            return prev_le + (le - prev_le) * ((rank - prev_n) / (n - prev_n))
        prev_le, prev_n = le, n
        seen_finite = seen_finite or not math.isinf(le)
    return prev_le if seen_finite else None
