"""Prometheus text exposition (format version 0.0.4) for MetricsRegistry.

One function, :func:`render_prometheus`, turns one or more registries into
the plain-text family format every scraper understands:

* counters gain the ``_total`` suffix on exposition (instruments store the
  base name, e.g. ``serving_rows`` -> ``serving_rows_total``), matching
  the official client-library convention;
* histograms expand to cumulative ``<name>_bucket{le="..."}`` series
  (``+Inf`` included) plus ``<name>_sum`` / ``<name>_count``;
* label values escape backslash, double-quote, and newline; ``# HELP``
  text escapes backslash and newline.

``GET /metrics`` in :mod:`repro_torch.launch.serve_http` and the offline
:mod:`repro_torch.launch.metrics` dump CLI both call this; serve it with
:data:`CONTENT_TYPE` so Prometheus autodetects the format.
"""
from __future__ import annotations

from repro_torch.obs.metrics import Counter, Histogram, MetricsRegistry

__all__ = ["render_prometheus", "CONTENT_TYPE"]

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _escape_label(v: str) -> str:
    return v.replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")


def _escape_help(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n")


def _fmt(v: float) -> str:
    """Value formatting: integers bare (``7`` not ``7.0``), floats repr."""
    f = float(v)
    if f != f:
        return "NaN"
    if f in (float("inf"), float("-inf")):
        return "+Inf" if f > 0 else "-Inf"
    if f.is_integer() and abs(f) < 2**53:
        return str(int(f))
    return repr(f)


def _labels_str(labelnames, key, extra=()) -> str:
    pairs = [f'{ln}="{_escape_label(val)}"'
             for ln, val in zip(labelnames, key)]
    pairs.extend(f'{ln}="{_escape_label(val)}"' for ln, val in extra)
    return "{" + ",".join(pairs) + "}" if pairs else ""


def render_prometheus(*registries: MetricsRegistry) -> str:
    """Render registries to Prometheus text; duplicates collapse by id.

    Accepts several registries because serving components each own a
    private one unless the caller wires a shared registry through — the
    exporter unions them (instrument names are namespaced per subsystem,
    so families never collide; a genuine name collision raises).
    """
    seen_regs, regs = set(), []
    for r in registries:
        if id(r) not in seen_regs:
            seen_regs.add(id(r))
            regs.append(r)

    lines = []
    seen_names = set()
    for reg in regs:
        for inst in reg.collect():
            name = inst.name
            if isinstance(inst, Counter) and not name.endswith("_total"):
                name = name + "_total"
            if name in seen_names:
                raise ValueError(
                    f"metric family {name!r} exported by two registries")
            seen_names.add(name)

            if inst.help:
                lines.append(f"# HELP {name} {_escape_help(inst.help)}")
            lines.append(f"# TYPE {name} {inst.kind}")

            series = inst.series()
            if isinstance(inst, Histogram):
                for key in sorted(series):
                    s = series[key]
                    acc = 0
                    for bound, n in zip(inst.buckets, s["buckets"]):
                        acc += n
                        ls = _labels_str(inst.labelnames, key,
                                         extra=(("le", _fmt(bound)),))
                        lines.append(f"{name}_bucket{ls} {_fmt(acc)}")
                    ls = _labels_str(inst.labelnames, key,
                                     extra=(("le", "+Inf"),))
                    lines.append(f"{name}_bucket{ls} {_fmt(s['count'])}")
                    ls = _labels_str(inst.labelnames, key)
                    lines.append(f"{name}_sum{ls} {_fmt(s['sum'])}")
                    lines.append(f"{name}_count{ls} {_fmt(s['count'])}")
            else:
                for key in sorted(series):
                    ls = _labels_str(inst.labelnames, key)
                    lines.append(f"{name}{ls} {_fmt(series[key])}")
    return "\n".join(lines) + "\n"
