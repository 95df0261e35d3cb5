"""Prometheus text-format exposition (version 0.0.4) for a MetricsRegistry.

One render pass walks the registry snapshot-free: counters and gauges are
single samples; histograms expose the standard ``_bucket{le=...}`` /
``_sum`` / ``_count`` triplet with CUMULATIVE bucket counts ending at
``+Inf``. Family names are sanitized to the Prometheus grammar (dots and
dashes become underscores) so tracer-style dotted names render scrapeable.

Counters, gauges and histograms may all carry a pre-labelled name
(``family{host="h1"}``): the base name is sanitized, the label block
passes through verbatim, and the TYPE line is emitted once per base.
Histogram buckets that recorded an exemplar render an OpenMetrics-style
suffix (`` # {trace_id="..."} value ts``) so a scrape links each latency
band to a concrete distributed trace.

:func:`render_state` renders the same text from an exported (or
fleet-merged) registry state dict — the one code path both the live
``/metrics`` surface and the federation's merged scrape go through.
"""

from __future__ import annotations

import math
import re

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_NAME_OK = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_BAD_CHARS = re.compile(r"[^a-zA-Z0-9_:]")


def sanitize(name: str) -> str:
    if _NAME_OK.match(name):
        return name
    cleaned = _BAD_CHARS.sub("_", name)
    if not cleaned or not _NAME_OK.match(cleaned[0]):
        cleaned = "_" + cleaned
    return cleaned


def _fmt(value: float) -> str:
    if value != value:  # NaN
        return "NaN"
    if value == math.inf:
        return "+Inf"
    if value == -math.inf:
        return "-Inf"
    if isinstance(value, int) or float(value).is_integer():
        return str(int(value))
    return repr(float(value))


def _escape_label(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _split_labels(name: str) -> tuple[str, str]:
    """``family{a="b"}`` -> (sanitized base, inner label text or "")."""
    base, brace, rest = name.partition("{")
    return sanitize(base), rest[:-1] if brace and rest.endswith("}") else ""


def _exemplar_suffix(exemplar) -> str:
    """OpenMetrics-style exemplar: `` # {trace_id="..."} value ts``."""
    value, trace_id, ts = exemplar
    return (
        f' # {{trace_id="{_escape_label(str(trace_id))}"}}'
        f" {_fmt(float(value))} {float(ts):.3f}"
    )


def _histogram_lines(
    lines: list[str],
    name: str,
    labels: str,
    buckets,
    h_sum: float,
    h_count: int,
    exemplars=None,
) -> None:
    """Emit one histogram's sample lines. ``buckets`` is the cumulative
    (bound, count) list ending at +Inf; ``labels`` is the inner label
    text (without braces) prepended to each sample's label set."""
    prefix = f"{labels}," if labels else ""
    suffix = f"{{{labels}}}" if labels else ""
    for idx, (bound, cumulative) in enumerate(buckets):
        line = f'{name}_bucket{{{prefix}le="{_fmt(bound)}"}} {cumulative}'
        if exemplars and idx in exemplars:
            line += _exemplar_suffix(exemplars[idx])
        lines.append(line)
    lines.append(f"{name}_sum{suffix} {_fmt(h_sum)}")
    lines.append(f"{name}_count{suffix} {h_count}")


def _cumulative(bounds, counts) -> list[tuple[float, int]]:
    out = []
    running = 0
    for bound, n in zip(bounds, counts):
        running += n
        out.append((bound, running))
    out.append((math.inf, running + counts[len(bounds)]))
    return out


def render(registry) -> str:
    lines: list[str] = []
    with registry._lock:
        counters = sorted(registry._counters.values(), key=lambda c: c.name)
        gauges = sorted(registry._gauges.values(), key=lambda g: g.name)
        histograms = sorted(registry._histograms.values(), key=lambda h: h.name)
        infos = sorted(registry._infos.values(), key=lambda i: i.name)
    for i in infos:
        name = sanitize(i.name)
        labels = ",".join(
            f'{sanitize(k)}="{_escape_label(v)}"'
            for k, v in sorted(i.labels().items())
        )
        lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name}{{{labels}}} 1")
    # Counters may carry a pre-labelled name (``family{rule="x"}``, the
    # health layer's per-rule alert counters): the base name is sanitized,
    # the label block passes through verbatim, and the TYPE line is
    # emitted once per base — the sort above keeps a family's labelled
    # samples adjacent to the bare one, as the text format requires.
    prev_base = None
    for c in counters:
        base, brace, labels = c.name.partition("{")
        name = sanitize(base)
        if name != prev_base:
            lines.append(f"# TYPE {name} counter")
            prev_base = name
        lines.append(f"{name}{brace}{labels} {_fmt(c.value)}")
    prev_base = None
    for g in gauges:
        base, brace, labels = g.name.partition("{")
        name = sanitize(base)
        if name != prev_base:
            lines.append(f"# TYPE {name} gauge")
            prev_base = name
        lines.append(f"{name}{brace}{labels} {_fmt(g.value)}")
    prev_base = None
    for h in histograms:
        name, labels = _split_labels(h.name)
        # One locked copy per histogram: bucket/sum/count must describe
        # the same moment (the format requires +Inf == count).
        buckets, h_sum, h_count = h.exposition()
        if name != prev_base:
            lines.append(f"# TYPE {name} histogram")
            prev_base = name
        _histogram_lines(
            lines, name, labels, buckets, h_sum, h_count, h.exemplars()
        )
    return "\n".join(lines) + "\n"


def render_state(state: dict) -> str:
    """Render an exported registry state (:meth:`MetricsRegistry
    .export_state`) — or a fleet-merged one of the same shape — in the
    same text format :func:`render` produces from live instruments."""
    lines: list[str] = []
    prev_base = None
    for iname in sorted(state.get("infos", {})):
        name, pre = _split_labels(iname)
        labels = ",".join(
            f'{sanitize(k)}="{_escape_label(str(v))}"'
            for k, v in sorted(state["infos"][iname].items())
        )
        if pre:
            labels = f"{pre},{labels}" if labels else pre
        if name != prev_base:
            lines.append(f"# TYPE {name} gauge")
            prev_base = name
        lines.append(f"{name}{{{labels}}} 1")
    for kind, type_name in (("counters", "counter"), ("gauges", "gauge")):
        prev_base = None
        for raw in sorted(state.get(kind, {})):
            base, brace, labels = raw.partition("{")
            name = sanitize(base)
            if name != prev_base:
                lines.append(f"# TYPE {name} {type_name}")
                prev_base = name
            lines.append(f"{name}{brace}{labels} {_fmt(state[kind][raw])}")
    prev_base = None
    for raw in sorted(state.get("histograms", {})):
        h = state["histograms"][raw]
        name, labels = _split_labels(raw)
        if name != prev_base:
            lines.append(f"# TYPE {name} histogram")
            prev_base = name
        exemplars = {
            int(i): tuple(v) for i, v in (h.get("exemplars") or {}).items()
        }
        _histogram_lines(
            lines,
            name,
            labels,
            _cumulative(h["bounds"], h["counts"]),
            h["sum"],
            h["count"],
            exemplars,
        )
    return "\n".join(lines) + "\n"


_EXEMPLAR_RE = re.compile(
    r'\s#\s\{trace_id="(?P<trace>[^"]*)"\}\s(?P<value>\S+)\s(?P<ts>\S+)$'
)


def parse_exemplars(text: str) -> dict[str, list[dict]]:
    """Parse the OpenMetrics-style exemplar suffixes out of rendered text:
    {family_bucket_sample_name: [{"le", "trace_id", "value", "ts"}]} —
    the round-trip half the exemplar tests (and incident tooling that
    only holds a scrape) use to recover trace links from plain text."""
    out: dict[str, list[dict]] = {}
    for line in text.splitlines():
        if line.startswith("#") or " # " not in line:
            continue
        m = _EXEMPLAR_RE.search(line)
        if m is None:
            continue
        sample = line[: m.start()].rsplit(" ", 1)[0]
        name, _, labeltext = sample.partition("{")
        le = None
        for part in labeltext.rstrip("}").split(","):
            k, _, v = part.partition("=")
            if k == "le":
                le = v.strip('"')
        out.setdefault(name, []).append(
            {
                "le": le,
                "trace_id": m.group("trace"),
                "value": float(m.group("value")),
                "ts": float(m.group("ts")),
            }
        )
    return out
