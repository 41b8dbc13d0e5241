"""repro_torch.obs — metrics, exposition, span tracing and resource
telemetry for the port.

Three stdlib-only pieces, copies of the JAX package's ``repro.obs``:

* :mod:`repro_torch.obs.metrics` — :class:`MetricsRegistry` of typed
  instruments (Counter / Gauge / fixed-bucket Histogram with labels),
  all behind one lock so snapshots are consistent cuts.
* :mod:`repro_torch.obs.export` — Prometheus text exposition
  (:func:`render_prometheus`), dumped offline by
  ``repro_torch.launch.metrics``.
* :mod:`repro_torch.obs.tracing` — ring-buffered :class:`Tracer` spans
  threaded through the serving hot path, the fit (``fit.batch``), the
  generate path (``sample.*``:
  :func:`repro_torch.tabgen.sampling.sample_async` and
  ``SampleHandle.result``; ``sample.solve`` carries ``steps``, the
  solver steps, ``lanes``, the sub-forests of an ensemble, ``trees``,
  the trees of a sub-forest, ``graph``: ``"eager"``, or for a
  bucketed call on a CUDA device ``"capture"`` the first time and
  ``"replay"`` after, :mod:`repro_torch.tabgen.solve_graph`, and
  ``sum_tma`` / ``sum_plain``: the multi-output summing kernels of the
  solve by kind, as the ``tree_predict`` launcher reports them) and
  ``DatasetStore`` ingest, with optional
  JSONL export and a mirror of each scoped span into ``torch.profiler``
  as a ``record_function`` range of the same name
  (``REPRO_OBS_TORCH_TRACE=1``, or ``Tracer(torch_annotations=True)``).

and two with torch probes of their own:

* :mod:`repro_torch.obs.resources` — :class:`ResourceMonitor`, a
  background sampler publishing ``resource_*`` gauges (RSS, CUDA
  allocator bytes, kernel libraries loaded, queue depths, hot-model
  bytes).
* :mod:`repro_torch.obs.profiling` — :class:`Profiler`, serialized bounded
  ``torch.profiler`` captures behind ``POST /debug/profile``.

Serving components (scheduler / admission / model registry) each default
to a private registry+tracer; ``serve_http`` wires one shared pair through
all of them. Offline single-pipeline processes (``train_forest``,
``ingest``) use the process-wide defaults below, which
``repro_torch.launch.metrics`` dumps.
"""
from __future__ import annotations

import threading

from repro_torch.obs.export import CONTENT_TYPE, render_prometheus
from repro_torch.obs.metrics import (
    DEFAULT_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)
from repro_torch.obs.profiling import ProfileInProgress, Profiler
from repro_torch.obs.resources import ResourceMonitor
from repro_torch.obs.tracing import SlowLog, Span, Tracer

__all__ = [
    "CONTENT_TYPE",
    "Counter",
    "DEFAULT_BUCKETS",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "ProfileInProgress",
    "Profiler",
    "ResourceMonitor",
    "SlowLog",
    "Span",
    "Tracer",
    "default_registry",
    "default_tracer",
    "render_prometheus",
]

_defaults: dict = {}
_defaults_lock = threading.Lock()


def default_registry() -> MetricsRegistry:
    """The process-wide registry used by offline paths (fit, ingest)."""
    with _defaults_lock:
        if "registry" not in _defaults:
            _defaults["registry"] = MetricsRegistry()
        return _defaults["registry"]


def default_tracer() -> Tracer:
    """The process-wide tracer used by offline paths (fit, ingest) and by
    every generate call (eight ``sample.*`` spans a call). It holds the
    newest 16,384 spans: 2,048 calls' worth."""
    with _defaults_lock:
        if "tracer" not in _defaults:
            _defaults["tracer"] = Tracer(capacity=16384)
        return _defaults["tracer"]
