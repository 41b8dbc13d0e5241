"""Offline metrics dump: Prometheus text without an HTTP server.

Long-running services scrape ``GET /metrics`` (see
:mod:`repro_torch.launch.serve_http`); the port's batch runs
(``train_forest``, ``ingest``, ``serve_forest``, ``refresh``) have no
server to scrape, so their ``--metrics-dump`` flag writes the exposition
format at exit through :func:`dump`, from the process-wide
:func:`repro_torch.obs.default_registry` that ``DatasetStore`` ingest
instruments (``serve_forest`` passes its server's own registry).

The module is also a tiny CLI for smoke tests and docs examples:

  PYTHONPATH=src python -m repro_torch.launch.metrics --demo

fabricates a counter/histogram pair in a scratch registry and prints the
rendered exposition, exercising the full render path with no model fit.
``--resource`` takes one :class:`repro_torch.obs.ResourceMonitor` sample
first (RSS, CUDA allocator bytes, kernel libraries loaded).
"""
from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

from repro_torch.obs import (MetricsRegistry, default_registry,
                             render_prometheus)


def dump(path: Optional[str] = None, *,
         registries: Optional[Sequence[MetricsRegistry]] = None) -> str:
    """Render ``registries`` (default: the process-wide default registry)
    to Prometheus text; write to ``path`` (``"-"``/``None`` = stdout) and
    return the text."""
    regs = list(registries) if registries else [default_registry()]
    text = render_prometheus(*regs)
    if path is None or path == "-":
        sys.stdout.write(text)
    else:
        with open(path, "w") as f:
            f.write(text)
        print(f"wrote metrics to {path}")
    return text


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="dump a metrics registry in Prometheus text format")
    ap.add_argument("--out", default="-", metavar="PATH",
                    help="output file ('-' = stdout)")
    ap.add_argument("--demo", action="store_true",
                    help="populate a scratch registry with sample "
                         "instruments and dump it (render-path smoke)")
    ap.add_argument("--resource", action="store_true",
                    help="take one ResourceMonitor sample (RSS, CUDA "
                         "allocator bytes, kernel libraries loaded) onto "
                         "the default registry before dumping")
    args = ap.parse_args(argv)

    if args.resource:
        from repro_torch.obs import ResourceMonitor
        ResourceMonitor().sample()

    if args.demo:
        reg = MetricsRegistry()
        c = reg.counter("demo_requests", "Demo requests served",
                        ("tenant",))
        c.inc(3, tenant="a")
        c.inc(2, tenant="b")
        h = reg.histogram("demo_latency_seconds", "Demo latencies",
                          buckets=(0.01, 0.1, 1.0))
        for v in (0.005, 0.05, 0.5, 5.0):
            h.observe(v)
        reg.gauge("demo_inflight", "Demo in-flight work").set(1)
        dump(args.out, registries=[reg])
        return
    dump(args.out)


if __name__ == "__main__":
    main()
