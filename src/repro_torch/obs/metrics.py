"""Typed metric instruments behind one lock: the process metrics model.

A :class:`MetricsRegistry` holds named instruments — :class:`Counter`,
:class:`Gauge`, and fixed-bucket :class:`Histogram` — each carrying an
optional label set.  Every instrument in a registry shares the registry's
single re-entrant lock, so ``snapshot()`` is a *consistent* cut: no reader
can observe a counter from before an update and a histogram from after it.
That is the property ``/statz`` and ``/metrics`` lean on to never disagree
(both are views over the same snapshot).

Design points, deliberately boring:

* stdlib-only — ``threading`` + ``bisect``; importable anywhere, worker
  threads included, without touching torch.
* get-or-create registration — ``registry.counter("serving_rows", ...)``
  returns the existing instrument when called twice with the same schema
  and raises on a type/label mismatch, so modules can declare their
  instruments at construction time without coordinating import order.
* label values key a dict per instrument; series appear on first touch
  (Prometheus semantics: an unobserved series does not exist).
* counters are monotonic (negative increments raise); the one sanctioned
  exception is :meth:`Counter.reset`, used by ``ModelRegistry.register``
  to mimic the legacy "re-register wipes that model's stats" behavior.

Instruments here are *storage*; the text exposition format lives in
:mod:`repro_torch.obs.export` and span timing in :mod:`repro_torch.obs.tracing`.
"""
from __future__ import annotations

import bisect
import re
import threading
from typing import Dict, List, Sequence, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "DEFAULT_BUCKETS",
]

# latency-ish default edges (seconds): sub-ms through tens of seconds.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)

_NAME_OK = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_OK = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def _check_name(name: str) -> None:
    if not _NAME_OK.match(name):
        raise ValueError(f"invalid metric name {name!r}")


class _Instrument:
    """Shared plumbing: name/help/labelnames + the registry lock."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: Sequence[str],
                 lock: threading.RLock):
        _check_name(name)
        for ln in labelnames:
            if not _LABEL_OK.match(ln):
                raise ValueError(f"invalid label name {ln!r} on {name!r}")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = lock
        self._series: Dict[Tuple[str, ...], object] = {}

    def _key(self, labels: Dict[str, object]) -> Tuple[str, ...]:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: got labels {sorted(labels)}, "
                f"declared {list(self.labelnames)}")
        return tuple(str(labels[ln]) for ln in self.labelnames)

    def series(self) -> Dict[Tuple[str, ...], object]:
        """Label-tuple -> value map (a copy; values are plain data)."""
        with self._lock:
            return dict(self._series)

    def reset(self, **labels) -> None:
        """Drop series whose labels match the given subset (all if empty).

        Two users: the one legacy surface that wipes stats in place
        (model re-registration), and sampled gauges whose label sets
        shrink between passes — ``ResourceMonitor`` resets its per-device
        gauge before republishing so a freed device's series disappears
        instead of reporting its last value forever.  Scrapers see a
        dropped counter series restart at zero, which Prometheus treats
        as a counter reset.
        """
        with self._lock:
            if not labels:
                self._series.clear()
                return
            idx = [(self.labelnames.index(k), str(v))
                   for k, v in labels.items()]
            for key in [k for k in self._series
                        if all(k[i] == v for i, v in idx)]:
                del self._series[key]


class Counter(_Instrument):
    """Monotonically increasing float, one value per label set."""

    kind = "counter"

    def inc(self, value: float = 1.0, **labels) -> float:
        if value < 0:
            raise ValueError(f"{self.name}: counter increment {value} < 0")
        key = self._key(labels)
        with self._lock:
            v = self._series.get(key, 0.0) + value
            self._series[key] = v
            return v

    def get(self, **labels) -> float:
        with self._lock:
            return float(self._series.get(self._key(labels), 0.0))

    def sum(self, **labels) -> float:
        """Total over every series matching the given label subset."""
        idx = [(self.labelnames.index(k), str(v)) for k, v in labels.items()]
        with self._lock:
            return float(sum(
                v for k, v in self._series.items()
                if all(k[i] == want for i, want in idx)))


class Gauge(_Instrument):
    """Settable value that can go up and down."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._series[key] = float(value)

    def inc(self, value: float = 1.0, **labels) -> float:
        key = self._key(labels)
        with self._lock:
            v = self._series.get(key, 0.0) + value
            self._series[key] = v
            return v

    def dec(self, value: float = 1.0, **labels) -> float:
        return self.inc(-value, **labels)

    def set_max(self, value: float, **labels) -> None:
        """Ratchet: keep the running maximum of observed values."""
        key = self._key(labels)
        with self._lock:
            if value > self._series.get(key, float("-inf")):
                self._series[key] = float(value)

    def get(self, **labels) -> float:
        with self._lock:
            return float(self._series.get(self._key(labels), 0.0))


class Histogram(_Instrument):
    """Fixed-bucket histogram: per-series bucket counts + sum + count.

    ``buckets`` are finite upper bounds (inclusive, Prometheus ``le``
    semantics); the ``+Inf`` bucket is implicit.  ``observe`` costs one
    bisect and three writes under the registry lock.
    """

    kind = "histogram"

    def __init__(self, name, help, labelnames, lock,
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help, labelnames, lock)
        bs = tuple(float(b) for b in buckets)
        if not bs or list(bs) != sorted(set(bs)):
            raise ValueError(f"{name}: buckets must be sorted and unique")
        if any(b != b or b in (float("inf"), float("-inf")) for b in bs):
            raise ValueError(f"{name}: buckets must be finite")
        self.buckets = bs

    def observe(self, value: float, **labels) -> None:
        key = self._key(labels)
        i = bisect.bisect_left(self.buckets, float(value))
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = {"buckets": [0] * len(self.buckets), "sum": 0.0,
                     "count": 0}
                self._series[key] = s
            if i < len(self.buckets):
                s["buckets"][i] += 1
            s["sum"] += float(value)
            s["count"] += 1

    def get(self, **labels) -> Dict[str, object]:
        """``{"buckets": [per-bucket counts], "sum": float, "count": int}``
        (zeros for an untouched series)."""
        key = self._key(labels)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                return {"buckets": [0] * len(self.buckets), "sum": 0.0,
                        "count": 0}
            return {"buckets": list(s["buckets"]), "sum": s["sum"],
                    "count": s["count"]}

    def sum(self, **labels) -> float:
        """Total of ``sum`` over series matching the label subset."""
        idx = [(self.labelnames.index(k), str(v)) for k, v in labels.items()]
        with self._lock:
            return float(sum(
                s["sum"] for k, s in self._series.items()
                if all(k[i] == want for i, want in idx)))

    def count(self, **labels) -> int:
        """Total of ``count`` over series matching the label subset."""
        idx = [(self.labelnames.index(k), str(v)) for k, v in labels.items()]
        with self._lock:
            return int(sum(
                s["count"] for k, s in self._series.items()
                if all(k[i] == want for i, want in idx)))

    def series(self):
        with self._lock:
            return {k: {"buckets": list(s["buckets"]), "sum": s["sum"],
                        "count": s["count"]}
                    for k, s in self._series.items()}


class MetricsRegistry:
    """Process- or component-scoped set of instruments, one shared lock.

    Serving components default to a *private* registry apiece so tests and
    benchmark arms never bleed counters into each other; ``serve_http``
    hands one shared registry to every component so ``/metrics`` is a
    single family set.  Offline paths (fit, ingest) use the
    module-level default registry from :func:`repro_torch.obs.default_registry`.
    """

    def __init__(self):
        self._lock = threading.RLock()
        self._instruments: Dict[str, _Instrument] = {}

    @property
    def lock(self) -> threading.RLock:
        """The shared instrument lock (re-entrant).  Hold it to make a
        multi-instrument read one consistent cut — e.g. the serving
        ``stats_snapshot()`` folds several instruments into one dict."""
        return self._lock

    # -- registration (get-or-create, schema-checked) -----------------------

    def _get_or_create(self, cls, name, help, labelnames, **kwargs):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is not None:
                if not isinstance(inst, cls) or \
                        inst.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"{name!r} re-registered as {cls.kind}"
                        f"{tuple(labelnames)}, was {inst.kind}"
                        f"{inst.labelnames}")
                return inst
            inst = cls(name, help, labelnames, self._lock, **kwargs)
            self._instruments[name] = inst
            return inst

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)

    # -- read side -----------------------------------------------------------

    def collect(self) -> List[_Instrument]:
        """Instruments sorted by name (stable exposition order)."""
        with self._lock:
            return [self._instruments[n] for n in sorted(self._instruments)]

    def snapshot(self) -> Dict[str, dict]:
        """One consistent cut of every instrument in the registry.

        ``{name: {"kind", "help", "labelnames", "values": {labels: v}}}``
        where ``v`` is a float for counters/gauges and a
        ``{"buckets", "sum", "count"}`` dict (plus ``"bucket_bounds"`` at
        the instrument level) for histograms.  Taken under the shared lock,
        so cross-instrument invariants (requests vs rows, sum vs count)
        hold within one snapshot.
        """
        with self._lock:
            out = {}
            for name in sorted(self._instruments):
                inst = self._instruments[name]
                entry = {
                    "kind": inst.kind,
                    "help": inst.help,
                    "labelnames": list(inst.labelnames),
                    "values": inst.series(),
                }
                if isinstance(inst, Histogram):
                    entry["bucket_bounds"] = list(inst.buckets)
                out[name] = entry
            return out
